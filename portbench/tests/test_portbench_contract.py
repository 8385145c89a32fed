"""BENCHMARK.json against the rules a benchmark file keeps, the files the harness
finds by name, and the imports: nothing the benchmark loads is JAX's or the
JAX package's, compared by whole top-level name."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_entries_keys_names_and_files():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        _, _, params = harness.load_cell(w["name"], BENCH)
        assert (harness.BENCH_DIR / "processes" / f"{params['process']}.py").exists()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(names) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(harness.load_reader(m["name"]).read)
        for cell in m.get("workloads", ()):
            assert harness.applies(e2e[m["moves"]], cell)
    for w in BENCH["workloads"]:
        reported = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness.applies(m, w["name"]) for m in BENCH["per_layer"])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["kubernetes_tpu_torch", "kubernetes_tpu_torch.scheduler", "numpy",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["kubernetes_tpu", "kubernetes_tpu.ops.oracle", "jax", "jax.numpy",
                                      "jaxlib.xla_client", "flax"]) == sorted(
        ["kubernetes_tpu", "kubernetes_tpu.ops.oracle", "jax", "jax.numpy", "jaxlib.xla_client", "flax"])


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in harness.BENCH_DIR.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(ROOT / path) & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    stdlib = set(sys.stdlib_module_names)
    assert _imports(harness.BENCH_DIR / "reference.py") - stdlib == {"numpy"}


def test_loading_the_benchmark_and_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, run, control, roofline\n"
            "from kubernetes_tpu_torch.scheduler import Scheduler\n"
            "from kubernetes_tpu_torch.state.cluster import ClusterState\n"
            "for m in harness.load_json(harness.ROOT / 'BENCHMARK.json')['per_layer']:\n"
            "    harness.load_reader(m['name'])\n"
            "harness.load_process('waves')\n"
            "print(harness.forbidden_modules(sys.modules))\n") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
