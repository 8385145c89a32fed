"""The spread5k.backlog cell on the CPU at a small size, and its two readers of
the program's chunk counters on a fabricated registry: the share of chunk
pods that spread chunks placed and the grouped loop's iterations per spread
chunk, None where the program has no such counter, as a program that
predates the chunk counters has not."""

from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch import metrics
from portbench import harness
from portbench.tests.small import run_small

CELL = "spread5k.backlog"


def test_the_cell_reads_correct():
    out = run_small(CELL)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}
    assert all(c["value"] == 0 for c in out["checks"].values())


def _fresh_counters(monkeypatch) -> None:
    """Zeroed chunk counters in a registry of the test's own: the registry
    is the process's, and a benchmark run is a process of its own, while
    these tests run every cell in one."""
    from kubernetes_tpu_torch.metrics.prom import CollectorRegistry, Counter

    registry = CollectorRegistry()
    for name in ("solve_chunks_total", "solve_chunk_pods_total", "solve_chunk_iterations_total"):
        old = getattr(metrics, name)
        monkeypatch.setattr(metrics, name, Counter(old._name, "", ["kind"], registry=registry))


def test_a_traced_run_reads_the_counters_and_the_stage_shares(monkeypatch):
    _fresh_counters(monkeypatch)
    out = run_small(CELL, trace=True)
    assert out["correct"] is True
    # the CPU has no device trace: the chunk counters and the program's own
    # stage seconds read, the slice's idle share and launches do not
    assert set(out["metrics"]) == {"spread_chunk_pct.spread5k", "spread_iters_per_chunk.spread5k",
                                   "solve_share.spread5k", "card_read_share.spread5k",
                                   "tensorize_share.spread5k"}
    assert out["metrics"]["spread_chunk_pct.spread5k"]["value"] >= 90.0
    assert out["metrics"]["spread_iters_per_chunk.spread5k"]["value"] >= 1.0


def _by_kind(values: dict):
    return SimpleNamespace(labels=lambda kind: SimpleNamespace(value=lambda: values.get(kind, 0.0)))


@pytest.mark.parametrize("pods,expected", [
    ({"slow": 64.0, "spread": 9_936.0}, 99.36),
    ({"plain": 512.0}, 0.0),
    ({"spread": 1_024.0}, 100.0),
])
def test_spread_chunk_pct(monkeypatch, pods, expected):
    monkeypatch.setattr(metrics, "solve_chunk_pods_total", _by_kind(pods))
    assert harness.load_reader("spread_chunk_pct.spread5k").read(None) == pytest.approx(expected)


@pytest.mark.parametrize("chunks,iterations,expected", [
    (155.0, 3_100.0, 20.0),
    (16.0, 16.0, 1.0),
])
def test_spread_iters_per_chunk(monkeypatch, chunks, iterations, expected):
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind({"spread": chunks, "slow": 3.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total",
                        _by_kind({"spread": iterations, "plain": 50.0}))
    assert harness.load_reader("spread_iters_per_chunk.spread5k").read(None) == pytest.approx(expected)


def test_the_readers_are_silent_without_work(monkeypatch):
    monkeypatch.setattr(metrics, "solve_chunk_pods_total", _by_kind({}))
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind({"plain": 4.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total", _by_kind({"plain": 4.0}))
    assert harness.load_reader("spread_chunk_pct.spread5k").read(None) is None
    assert harness.load_reader("spread_iters_per_chunk.spread5k").read(None) is None


@pytest.mark.parametrize("counter", ["solve_chunk_pods_total", "solve_chunks_total",
                                     "solve_chunk_iterations_total"])
def test_the_readers_are_silent_without_the_counters(monkeypatch, counter):
    monkeypatch.delattr(metrics, counter)
    reader = {"solve_chunk_pods_total": "spread_chunk_pct.spread5k"}.get(
        counter, "spread_iters_per_chunk.spread5k")
    assert harness.load_reader(reader).read(None) is None


def test_the_cell_and_its_metrics_are_declared():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["config"] == "spread5k" and cell["traffic"] == "backlog" and cell["chips"] == 1
    config = {c["name"]: c for c in bench["configs"]}["spread5k"]
    assert config["reduced"] == ["init_pods"]
    spec = harness.load_json(harness.ROOT / config["file"])
    assert spec["node_count"] == 5_000 and spec["wave_pods"] == 10_000
    (kind,) = spec["pod_kinds"]
    (constraint,) = kind["pod"]["spec"]["topologySpreadConstraints"]
    assert constraint["maxSkew"] == 5 and constraint["whenUnsatisfiable"] == "DoNotSchedule"
    assert constraint["labelSelector"]["matchLabels"] == kind["pod"]["metadata"]["labels"]
    mine = [m for m in bench["per_layer"] if m.get("workloads") == [CELL]]
    assert [m["name"] for m in mine] == [
        "spread_chunk_pct.spread5k", "spread_iters_per_chunk.spread5k", "solve_share.spread5k",
        "card_read_share.spread5k", "tensorize_share.spread5k", "device_idle_pct.spread5k",
        "launches_per_pod.spread5k"]
    assert bench["per_layer"][-len(mine):] == mine  # appended, after the accepted entries
    assert CELL in {m["name"]: m for m in bench["end_to_end"]}["pods_per_s"]["workloads"]
    assert not any(m["name"] == "domain_counts_roofline" and harness.applies(m, CELL)
                   for m in bench["per_layer"])
