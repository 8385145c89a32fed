"""The port stands alone: importing every module of kubernetes_tpu_torch
brings in neither JAX nor anything of the JAX package, nor
``prometheus_client``, ``yaml``, ``aiohttp`` or ``grpc`` (the card's
machine is not known to have them: the import check runs with all four
blocked), no source of the port (or chip_smoke.py) imports any of them —
``yaml`` only inside the function that parses YAML text
(``config.types._parse_text``), ``aiohttp`` only inside the extender's
``make_app`` / ``run_server`` and ``grpc`` only inside the bulk path's
functions that open a server or a channel (and the fleet's remote hub
client and HA rotation), never at module level (``perf/runner.py`` and ``tuning/profile.py``
import ``yaml`` inside their loaders too) — the simulator, the perf
runner, the CLI and its ``__main__``, the obs and metrics tools, leader
election and structured logging import with the rest, as do the fleet
(``fleet/*``) and its simulator drive (``sim/fleet.py``), the analyzer
(``analysis/*``), the oracle scheduler (``ops/oracle/scheduler.py``) and the
kernel build cache (``utils/compile_cache.py``), the config bridge
loads a mapping and JSON text
with ``yaml`` blocked, the extender's ``make_app`` names ``aiohttp`` when
it is missing, and an entry point asked for no device does not fall back
to the CPU when CUDA is absent."""

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
import importlib, importlib.abc, pkgutil, sys


class _Block(importlib.abc.MetaPathFinder):
    # packages the card's machine may lack: importing one is an error
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("prometheus_client", "yaml", "aiohttp", "grpc"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Block())
try:
    import yaml  # noqa: F401
except ImportError:
    print("blocked=1")
import kubernetes_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(
    k for k in sys.modules
    if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
    or k == "kubernetes_tpu" or k.startswith("kubernetes_tpu.")
    or k.split(".")[0] in ("prometheus_client", "yaml", "aiohttp", "grpc")
)
print("count=%d" % len(names))
print("bad=" + ",".join(bad))
from kubernetes_tpu_torch.config import types as ct
from kubernetes_tpu_torch.scheduler import SchedulerConfig
sc = ct.scheduler_config(ct.load({"tpuSolver": {"batchSize": 64}}))
assert isinstance(sc, SchedulerConfig) and sc.batch_size == 64
cfg = ct.load('{"tpuSolver": {"streamDepth": 2}, "tuning": {"enabled": true}}')
assert ct.scheduler_config(cfg).stream_depth == 2
assert ct.scheduler_config(cfg).tuning is not None
try:
    ct.load("tpuSolver: {batchSize: 64}")
except ImportError as e:
    print("yaml_error=" + ("yaml" in str(e)).__str__())
print("config=ok")
print("slice6=" + ",".join(
    n for n in ("solver.evaluate", "server.extender", "obs.sentinel", "obs.timeseries",
                "obs.bundle")
    if "kubernetes_tpu_torch." + n in sys.modules
))
print("slice7=" + ",".join(
    n for n in ("sim", "sim.harness", "sim.invariants", "sim.faults",
                "sim.generators", "sim.profiles", "sim.trace", "sim.__main__",
                "perf.runner", "cli", "__main__", "obs.__main__",
                "metrics.__main__", "utils.leaderelection", "utils.logging")
    if "kubernetes_tpu_torch." + n in sys.modules
))
print("slice8=" + ",".join(
    n for n in ("solver.single_shot", "solver.relax", "server.tensorcodec", "server.bulk",
                "rebalance", "rebalance.detector", "rebalance.planner", "rebalance.runtime")
    if "kubernetes_tpu_torch." + n in sys.modules
))
print("slice9=" + ",".join(
    n for n in ("fleet", "fleet.ring", "fleet.membership", "fleet.drain",
                "fleet.occupancy", "fleet.reconciler", "fleet.ha", "fleet.leasestore",
                "fleet.runtime", "sim.fleet")
    if "kubernetes_tpu_torch." + n in sys.modules
))
print("slice10=" + ",".join(
    n for n in ("analysis", "analysis.__main__", "analysis.callgraph", "analysis.core",
                "analysis.project", "analysis.ratchet", "analysis.registry",
                "analysis.sarif", "analysis.passes", "analysis.passes.dtypes",
                "analysis.passes.fence", "analysis.passes.hostsync",
                "analysis.passes.lockorder", "analysis.passes.locks",
                "analysis.passes.metricnames", "analysis.passes.metricsdoc",
                "analysis.passes.retry", "analysis.passes.tracedbranch",
                "analysis.passes.xsync", "ops.oracle.scheduler", "utils.compile_cache")
    if "kubernetes_tpu_torch." + n in sys.modules
))
from kubernetes_tpu_torch.server.extender import ExtenderCore, make_app
from kubernetes_tpu_torch.state.cluster import ClusterState
core = ExtenderCore(ClusterState(), backend="oracle")
try:
    make_app(core)
except ImportError as e:
    print("aiohttp_error=" + ("aiohttp" in str(e)).__str__())
"""


# optional packages a module may import inside a function body only
LAZY_ONLY = ("yaml", "aiohttp", "grpc")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu", "prometheus_client") + LAZY_ONLY


def _imports(path: Path):
    """(module name, inside a function body) for every absolute import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    lazy = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lazy.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in lazy
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, id(node) in lazy


def test_import_every_module_leaves_jax_and_reference_out():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = dict(
        line.split("=", 1) for line in proc.stdout.splitlines() if "=" in line
    )
    assert int(out["count"]) >= 90, f"only {out['count']} modules found"
    assert out["blocked"] == "1"
    assert out["bad"] == "", f"forbidden modules imported: {out['bad']}"
    assert out["config"] == "ok"
    assert out["yaml_error"] == "True"  # YAML text names the missing package
    assert out["slice6"].split(",") == [
        "solver.evaluate", "server.extender", "obs.sentinel", "obs.timeseries", "obs.bundle"]
    assert out["aiohttp_error"] == "True"  # make_app names the missing package
    assert out["slice7"].split(",") == [
        "sim", "sim.harness", "sim.invariants", "sim.faults", "sim.generators",
        "sim.profiles", "sim.trace", "sim.__main__", "perf.runner", "cli",
        "__main__", "obs.__main__", "metrics.__main__", "utils.leaderelection",
        "utils.logging"]
    assert out["slice8"].split(",") == [
        "solver.single_shot", "solver.relax", "server.tensorcodec", "server.bulk",
        "rebalance", "rebalance.detector", "rebalance.planner", "rebalance.runtime"]
    assert out["slice9"].split(",") == [
        "fleet", "fleet.ring", "fleet.membership", "fleet.drain", "fleet.occupancy",
        "fleet.reconciler", "fleet.ha", "fleet.leasestore", "fleet.runtime", "sim.fleet"]
    assert out["slice10"].split(",") == [
        "analysis", "analysis.__main__", "analysis.callgraph", "analysis.core",
        "analysis.project", "analysis.ratchet", "analysis.registry", "analysis.sarif",
        "analysis.passes", "analysis.passes.dtypes", "analysis.passes.fence",
        "analysis.passes.hostsync", "analysis.passes.lockorder", "analysis.passes.locks",
        "analysis.passes.metricnames", "analysis.passes.metricsdoc",
        "analysis.passes.retry", "analysis.passes.tracedbranch", "analysis.passes.xsync",
        "ops.oracle.scheduler", "utils.compile_cache"]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_imports_jax_or_reference(path):
    found = [
        n for n, lazy in _imports(ROOT / path)
        if _forbidden(n) and not (lazy and n.split(".")[0] in LAZY_ONLY)
    ]
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


def test_mesh_raises():
    """A node-axis mesh naming a device that is not there raises at
    construction; a mesh of two CPU shards solves as the unsharded path
    does."""
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
    from kubernetes_tpu_torch.parallel.sharding import NodeMesh

    with pytest.raises(ValueError, match="NodeMesh names cuda:7"):
        NodeMesh(("cuda:7",))
    want = ExactSolver().solve(nb, pb, device="cpu")
    got = ExactSolver().solve(build_node_batch(nodes), pb, mesh=NodeMesh(("cpu", "cpu")))
    assert list(got) == list(want)
