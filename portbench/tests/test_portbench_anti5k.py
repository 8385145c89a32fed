"""The anti5k.rollout cell on the CPU at a small size: the ``rollout``
process (one namespace, at most two waves live, keys that round-trip), what
the check catches in this deployment, the cell's readers of the program's
anti-chunk counters and capture stage on fabricated counters and stages,
None where the program has no such counter or stage, and the cell's
declaration, pinned by name."""

from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch import metrics
from portbench import harness
from portbench.tests.small import run_small, small_cell

CELL = "anti5k.rollout"
SIZE = dict(nodes=320, wave=64, batch=64)
SEED = 4_000_000_007


def _process():
    cell, config, params, _ = small_cell(CELL, **SIZE)
    return harness.load_process(params["process"])(cell, config, params, SEED, "cpu", False)


def test_the_process_keeps_one_namespace_and_two_waves_live():
    run = _process()
    live = []
    top_up = run.top_up

    def counted():
        top_up()
        live.append(len(run.cs.list_pods()))

    run.top_up = counted
    try:
        run.warmup()
        run.window(1.0)
    finally:
        run.spans.restore()
    wave = run.traffic.wave_pods
    assert len(live) > 4 and max(live) == 2 * wave
    keys = [k for kind, items in run.events for k in
            (items if kind == "delete" else (key for key, _ in items))]
    assert any(kind == "delete" for kind, _ in run.events)
    assert {k.split("/", 1)[0] for k in keys} == {"rollout"}
    assert {p.key.split("/", 1)[0] for p in run.cs.list_pods()} == {"rollout"}


def test_keys_round_trip_through_position():
    run = _process()
    t = run.traffic
    for j in list(range(0, 3 * t.wave_pods, 7)) + [10**6 + 3]:
        key = t.key(j)
        assert t.position(key) == j
        w, i = divmod(j, t.wave_pods)
        meta = t.pod(w, i)["metadata"]
        assert f"{meta['namespace']}/{meta['name']}" == key
    assert t.key(5) == "rollout/green-000005"
    for foreign in ("wave-00000/green-000005", "rollout/green-5", "rollout/green-0000005",
                    "rollout/red-000005", "other/green-000005"):
        assert t.position(foreign) is None
    run.pods.created = 10
    assert t.key(9) in run.pods and t.key(10) not in run.pods


def _fresh_counters(monkeypatch) -> None:
    """Zeroed chunk counters in a registry of the test's own: the registry
    is the process's, and a benchmark run is a process of its own, while
    these tests run every cell in one."""
    from kubernetes_tpu_torch.metrics.prom import CollectorRegistry, Counter

    registry = CollectorRegistry()
    for name in ("solve_chunks_total", "solve_chunk_pods_total", "solve_chunk_iterations_total"):
        old = getattr(metrics, name)
        monkeypatch.setattr(metrics, name, Counter(old._name, "", ["kind"], registry=registry))


def test_the_cell_reads_correct_and_its_traced_run_reads_the_counters(monkeypatch):
    out = run_small(CELL, seed=SEED, **SIZE)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}
    _fresh_counters(monkeypatch)
    out = run_small(CELL, seed=SEED + 1, trace=True, **SIZE)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())
    # the CPU has no device trace and captures no graph: the counters and
    # the stage shares read, the graph share, idle and launches do not
    assert set(out["metrics"]) == {"anti_chunk_pct.anti5k", "anti_iters_per_chunk.anti5k",
                                   "capture_share.anti5k", "solve_share.anti5k",
                                   "card_read_share.anti5k", "tensorize_share.anti5k"}
    assert out["metrics"]["anti_chunk_pct.anti5k"]["value"] >= 99.0
    assert out["metrics"]["anti_iters_per_chunk.anti5k"]["value"] >= 1.0
    assert out["metrics"]["capture_share.anti5k"]["value"] == 0.0


@pytest.mark.parametrize("variants,caught", [
    (("no_filters",), False),
    (("most_allocated",), False),
    (("no_filters", "most_allocated"), True),
])
def test_the_check_catches_pods_packed_onto_one_node(variants, caught):
    """Every feasible node of this deployment is empty, so any feasible pick
    scores the best and ``score_gap`` reads 0 whatever the scoring; and
    LeastAllocated alone keeps one pod a node, so switching the filters off
    breaks nothing. MostAllocated with the filters off packs the pods, and
    the reference refuses them."""
    from portbench.control import VARIANTS

    overrides = {k: v for name in variants for k, v in VARIANTS[name].items()}
    out = run_small(CELL, seed=SEED, solver_overrides=overrides, **SIZE)
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] is not caught
    assert (checks["infeasible_binds"] > 0) is caught
    assert checks["score_gap"] == checks["double_or_unknown_binds"] == checks["readback_mismatches"] == 0


def _by_kind(values: dict):
    return SimpleNamespace(labels=lambda kind: SimpleNamespace(value=lambda: values.get(kind, 0.0)))


def _on(device: str):
    return SimpleNamespace(run=SimpleNamespace(sched=SimpleNamespace(device=SimpleNamespace(type=device))))


@pytest.mark.parametrize("pods,expected", [
    ({"slow": 16.0, "anti": 1_008.0}, 100.0 * 1_008 / 1_024),
    ({"plain": 512.0, "spread": 64.0}, 0.0),
    ({"anti": 1_024.0}, 100.0),
])
def test_anti_chunk_pct(monkeypatch, pods, expected):
    monkeypatch.setattr(metrics, "solve_chunk_pods_total", _by_kind(pods))
    assert harness.load_reader("anti_chunk_pct.anti5k").read(None) == pytest.approx(expected)


@pytest.mark.parametrize("chunks,iterations,expected", [
    (16.0, 16.0, 1.0),
    (160.0, 400.0, 2.5),
])
def test_anti_iters_per_chunk(monkeypatch, chunks, iterations, expected):
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind({"anti": chunks, "spread": 3.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total",
                        _by_kind({"anti": iterations, "spread": 50.0}))
    assert harness.load_reader("anti_iters_per_chunk.anti5k").read(None) == pytest.approx(expected)


@pytest.mark.parametrize("replays,iterations,expected", [
    (12.0, 16.0, 75.0),
    (0.0, 16.0, 0.0),
])
def test_anti_graph_pct(monkeypatch, replays, iterations, expected):
    monkeypatch.setattr(metrics, "solve_grouped_graph_replays_total",
                        _by_kind({"anti": replays, "spread": 99.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total",
                        _by_kind({"anti": iterations, "spread": 100.0}))
    reader = harness.load_reader("anti_graph_pct.anti5k")
    assert reader.read(_on("cuda")) == pytest.approx(expected)
    assert reader.read(_on("cpu")) is None  # graphs are captured on the card alone


@pytest.mark.parametrize("stages,expected", [
    ({"capture": 0.5, "issue": 4.0}, 1.0),
    ({"capture": 0.0, "issue": 4.0}, 0.0),
    ({"issue": 4.0}, None),  # a program with no capture stage
    ({}, None),
])
def test_capture_share(stages, expected):
    ctx = SimpleNamespace(stage_s=stages, window_s=50.0)
    got = harness.load_reader("capture_share.anti5k").read(ctx)
    assert got == (None if expected is None else pytest.approx(expected))


def test_the_readers_are_silent_without_work(monkeypatch):
    monkeypatch.setattr(metrics, "solve_chunk_pods_total", _by_kind({}))
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind({"plain": 4.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total", _by_kind({"plain": 4.0}))
    monkeypatch.setattr(metrics, "solve_grouped_graph_replays_total", _by_kind({}))
    assert harness.load_reader("anti_chunk_pct.anti5k").read(None) is None
    assert harness.load_reader("anti_iters_per_chunk.anti5k").read(None) is None
    assert harness.load_reader("anti_graph_pct.anti5k").read(_on("cuda")) is None


@pytest.mark.parametrize("reader,counter", [
    ("anti_chunk_pct.anti5k", "solve_chunk_pods_total"),
    ("anti_iters_per_chunk.anti5k", "solve_chunks_total"),
    ("anti_iters_per_chunk.anti5k", "solve_chunk_iterations_total"),
    ("anti_graph_pct.anti5k", "solve_grouped_graph_replays_total"),
    ("anti_graph_pct.anti5k", "solve_chunk_iterations_total"),
])
def test_the_readers_are_silent_without_the_counters(monkeypatch, reader, counter):
    monkeypatch.delattr(metrics, counter)
    assert harness.load_reader(reader).read(_on("cuda")) is None


NEW = ["anti_chunk_pct.anti5k", "anti_iters_per_chunk.anti5k", "anti_graph_pct.anti5k",
       "capture_share.anti5k", "solve_share.anti5k", "card_read_share.anti5k",
       "tensorize_share.anti5k", "device_idle_pct.anti5k", "launches_per_pod.anti5k"]


def test_the_cell_and_its_metrics_are_declared():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["config"] == "anti5k" and cell["traffic"] == "rollout" and cell["chips"] == 1
    config = {c["name"]: c for c in bench["configs"]}["anti5k"]
    assert config["reduced"] == ["namespaces", "init_pods"]
    spec = harness.load_json(harness.ROOT / config["file"])
    assert spec["node_count"] == 5_000 and spec["wave_pods"] == 1_000
    assert "zones" not in spec["nodes"]
    (kind,) = spec["pod_kinds"]
    assert kind["pod"]["metadata"]["labels"] == {"color": "green", "name": "test"}
    (term,) = kind["pod"]["spec"]["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]
    assert term == {"labelSelector": {"matchLabels": {"color": "green"}},
                    "topologyKey": "kubernetes.io/hostname"}  # no namespaces: its own
    _, _, params = harness.load_cell(CELL, bench)
    assert params["process"] == "rollout" and params["batches_per_call"] == 1
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert by_name[name]["workloads"] == [CELL] and by_name[name]["moves"] == "pods_per_s"
    assert [m["name"] for m in bench["per_layer"] if harness.applies(m, CELL)] == NEW
    assert CELL in {m["name"]: m for m in bench["end_to_end"]}["pods_per_s"]["workloads"]
    assert not any(m["name"] == "domain_counts_roofline" and harness.applies(m, CELL)
                   for m in bench["per_layer"])
