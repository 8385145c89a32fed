"""The port stands alone: importing every module of kubernetes_tpu_torch
brings in neither JAX nor anything of the JAX package, no source of the
port (or chip_smoke.py) imports either, and an entry point asked for no
device does not fall back to the CPU when CUDA is absent."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kubernetes_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import kubernetes_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(
    k for k in sys.modules
    if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
    or k == "kubernetes_tpu" or k.startswith("kubernetes_tpu.")
)
print("count=%d" % len(names))
print("bad=" + ",".join(bad))
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_every_module_leaves_jax_and_reference_out():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = dict(
        line.split("=", 1) for line in proc.stdout.splitlines() if "=" in line
    )
    assert int(out["count"]) >= 20, f"only {out['count']} modules found"
    assert out["bad"] == "", f"forbidden modules imported: {out['bad']}"


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_imports_jax_or_reference(path):
    found = [n for n in _imports(ROOT / path) if _forbidden(n)]
    assert not found, f"{path} imports {found}"


def test_solve_without_device_raises_when_cuda_absent(monkeypatch):
    from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
    from kubernetes_tpu_torch.solver.exact import ExactSolver
    from kubernetes_tpu_torch.tensorize.schema import (
        build_node_batch,
        build_pod_batch,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = [MakeNode().name("n0").capacity({"cpu": "1", "pods": "4"}).obj()]
    pods = [MakePod().name("p0").req({"cpu": "100m"}).obj()]
    nb = build_node_batch(nodes)
    pb = build_pod_batch(pods, nb.vocab)
    used = nb.used.copy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactSolver().solve(nb, pb)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactSolver().solve(nb, pb, device="cuda")
    np.testing.assert_array_equal(nb.used, used)  # nothing ran
    assert list(ExactSolver().solve(nb, pb, device="cpu")) == [0]


@pytest.mark.parametrize(
    "kwargs",
    [
        {"col_versions": np.zeros(128, np.int64)},
        {"split": 2},
        {"mesh": object()},
        {"defer_read": True},
        {"chain_occupancy": True},
        {"stream_carry_out": True},
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_branches_raise(kwargs):
    from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
    from kubernetes_tpu_torch.solver.exact import ExactSolver
    from kubernetes_tpu_torch.tensorize.schema import (
        build_node_batch,
        build_pod_batch,
    )

    nodes = [MakeNode().name("n0").capacity({"cpu": "1", "pods": "4"}).obj()]
    pods = [MakePod().name("p0").req({"cpu": "100m"}).obj()]
    nb = build_node_batch(nodes)
    pb = build_pod_batch(pods, nb.vocab)
    with pytest.raises(NotImplementedError, match=next(iter(kwargs))):
        ExactSolver().solve(nb, pb, device="cpu", **kwargs)


def test_nominated_pods_raise():
    from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
    from kubernetes_tpu_torch.solver.exact import ExactSolver
    from kubernetes_tpu_torch.tensorize.schema import (
        build_node_batch,
        build_nominated_tensors,
        build_pod_batch,
    )

    nodes = [MakeNode().name("n0").capacity({"cpu": "1", "pods": "4"}).obj()]
    pods = [MakePod().name("p0").req({"cpu": "100m"}).obj()]
    nb = build_node_batch(nodes)
    pb = build_pod_batch(pods, nb.vocab)
    nom = build_nominated_tensors([(pods[0], 0)], nb.vocab, nb.padded)
    with pytest.raises(NotImplementedError, match="nominated"):
        ExactSolver().solve(nb, pb, nominated=nom, device="cpu")
