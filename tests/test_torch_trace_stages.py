"""The port's stages inside the program: the solve's sub-stages (prepare,
upload, issue, card_read) as ExactSolver.solve times them and the Scheduler
hands them to its StageProfiler; the watch handler's ``enqueue`` stage and
the collector's ``gc`` stage; the program's bare counters folded once per
batch into the registry; the spans' Unix-nanosecond stamps; and the
``utils/tracing`` session's ranges. All on the CPU, the port alone."""

from __future__ import annotations

import gc
import json
import time

import pytest

from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.obs.profile import ALL_STAGES, NESTED_STAGES, STAGES, StageProfiler, render_top
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.ops import threefry as tf
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver import timing
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.utils import tracing
from kubernetes_tpu_torch.utils.clock import Clock, FakeClock

SUB = ("upload", "prepare", "issue")


def _nodes(cs: ClusterState, n: int = 16) -> None:
    for i in range(n):
        cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": "20"})
                       .label("zone", f"z{i % 2}").obj())


def _pods(cs: ClusterState, n: int, start: int = 0, spread: bool = False) -> None:
    for i in range(start, start + n):
        b = MakePod().name(f"p{i}").req({"cpu": "100m"}).label("app", "w")
        if spread and i % 3 == 0:
            b = b.spread_constraint(1, "zone", "DoNotSchedule", {"app": "w"})
        cs.create_pod(b.obj())


def _sched(cs: ClusterState, *, group: int, obs: ObsConfig | None, clock=None,
           tie_break: str = "random", batch: int = 64) -> Scheduler:
    return Scheduler(cs, SchedulerConfig(
        batch_size=batch, obs=obs,
        solver=ExactSolverConfig(tie_break=tie_break, group_size=group, seed=7),
    ), clock=clock, device="cpu")


# the per-pod scan (no grouping), and the grouped random loop
SHAPES = {"scan": dict(group=1), "grouped_random": dict(group=16)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_solve_sub_stages_fit_inside_dispatch(shape):
    cs = ClusterState()
    _nodes(cs)
    _pods(cs, 48)
    sched = _sched(cs, obs=ObsConfig(profile=True), **SHAPES[shape])
    sites0 = dict(timing.COUNTS)
    res = sched.run_pipelined()
    assert sum(len(r.scheduled) for r in res) == 48
    prof = sched.telemetry.profiler.snapshot()
    entries = prof["recent"]
    assert entries
    for e in entries:
        st = e["stages"]
        assert all(st[s] > 0.0 for s in SUB), st
        # the solve's parts nest inside dispatch's own timer pair
        assert sum(st[s] for s in SUB) <= st["dispatch"]
        assert st["card_read"] <= st["issue"]
    # plain ints: the ledger is served as JSON (/debug/profile)
    assert all(type(e[k]) is int for e in entries for k in ("scan_steps", "grouped_iterations"))
    json.dumps(prof)
    steps = sum(e["scan_steps"] for e in entries)
    iterations = sum(e["grouped_iterations"] for e in entries)
    reads = sum(e["card_reads.grouped"] for e in entries)
    if shape == "scan":
        assert steps == 48 and iterations == 0
        assert prof["stage_seconds"]["card_read"] == 0.0 and reads == 0
    else:
        assert steps == 0 and iterations > 0
        # the random loop's one read an iteration, timed at its site
        assert reads == timing.COUNTS["grouped"] - sites0["grouped"] == iterations
        assert prof["stage_seconds"]["card_read"] > 0.0
    assert set(prof["stage_seconds"]) == set(ALL_STAGES)
    assert sum(prof["stage_fraction"].values()) == pytest.approx(1.0, abs=1e-3)
    assert set(prof["stage_fraction"]) == set(STAGES)


def test_every_watch_event_feeds_enqueue():
    cs = ClusterState()
    _nodes(cs)
    sched = _sched(cs, group=16, obs=ObsConfig(profile=True))
    _pods(cs, 40)  # 40 ADDED events
    for i in range(5):
        cs.delete_pod("default", f"p{i}")  # 5 DELETED events
    prof = sched.telemetry.profiler
    assert prof._events == 45 and prof._enqueue_s > 0.0
    sched.run_pipelined()  # 35 binds, each confirmed by a watch event
    entries = prof.snapshot()["recent"]
    assert sum(e["events"] for e in entries) == 45 + 35
    assert sum(e["stages"]["enqueue"] for e in entries) == pytest.approx(prof._enqueue_s, abs=1e-5)


class _CountingClock(FakeClock):
    def __init__(self):
        super().__init__(100.0)
        self.calls = 0

    def now(self):
        self.calls += 1
        return super().now()

    def perf(self):
        self.calls += 1
        return super().perf()

    def unix_ns(self):
        self.calls += 1
        return super().unix_ns()


@pytest.mark.parametrize("profile", [False, True])
def test_the_event_wrapper_reads_the_clock_only_with_telemetry_on(profile):
    cs = ClusterState()
    _nodes(cs, 4)
    clock = _CountingClock()
    sched = _sched(cs, group=16, obs=ObsConfig(profile=True) if profile else None, clock=clock)
    handled = []
    sched._handle_event = handled.append  # the watch handling itself, whose queue reads the clock
    clock.calls = 0
    # the profiler's collector callback reads this clock too: no collection
    # may land in the counted window
    collecting = gc.isenabled()
    gc.disable()
    try:
        _pods(cs, 3)
    finally:
        if collecting:
            gc.enable()
    assert len(handled) == 3
    assert clock.calls == (2 * 3 if profile else 0)


def test_a_forced_collection_feeds_gc():
    prof = StageProfiler(clock=Clock())
    prof.observe_batch(step=1, pods=0)
    junk = []
    junk.append(junk)  # a cycle for the collector to find
    del junk
    gc.collect()
    e = prof.observe_batch(step=2, pods=0)
    assert e["stages"]["gc"] > 0.0 and e["gc_runs.2"] >= 1
    assert prof.snapshot()["stage_seconds"]["gc"] == pytest.approx(e["stages"]["gc"], abs=1e-6)
    # the callback leaves with its profiler
    cb = prof._gc
    assert cb in gc.callbacks
    del prof, e
    gc.collect()
    assert cb not in gc.callbacks


def test_registry_counters_equal_the_globals_deltas():
    cs = ClusterState()
    _nodes(cs)
    _pods(cs, 40)
    sched = _sched(cs, group=16, obs=ObsConfig(profile=True), batch=16)
    launches = metrics.kernel_launches_total
    before = {
        "reads": metrics.solve_card_reads_total.labels("grouped").value(),
        "read_s": metrics.solve_card_read_seconds_total.labels("grouped").value(),
        "iters": metrics.solve_steps_total.labels("grouped_iterations").value(),
        "dc": launches.labels("domain_counts").value(),
        "tf": launches.labels("threefry_grouped").value(),
        "combines": metrics.mesh_combines_total.value(),
    }
    g0 = (timing.COUNTS["grouped"], timing.SECONDS["grouped"], dc.LAUNCHES, tf.GROUPED_LAUNCHES)
    sched.schedule_batch()
    # the CPU launches no kernel of ours: stand in for the card's launch
    # sites between two batches, so the fold has something to carry
    dc.LAUNCHES += 5
    tf.GROUPED_LAUNCHES += 3
    sched.run_pipelined()
    entries = sched.telemetry.profiler.snapshot()["recent"]
    assert (metrics.solve_card_reads_total.labels("grouped").value() - before["reads"]
            == timing.COUNTS["grouped"] - g0[0]
            == sum(e["card_reads.grouped"] for e in entries) > 0)
    assert (metrics.solve_card_read_seconds_total.labels("grouped").value() - before["read_s"]
            == pytest.approx(timing.SECONDS["grouped"] - g0[1]))
    assert (metrics.solve_steps_total.labels("grouped_iterations").value() - before["iters"]
            == sum(e["grouped_iterations"] for e in entries))
    assert launches.labels("domain_counts").value() - before["dc"] == dc.LAUNCHES - g0[2] == 5
    assert launches.labels("threefry_grouped").value() - before["tf"] == tf.GROUPED_LAUNCHES - g0[3] == 3
    assert metrics.mesh_combines_total.value() == before["combines"]  # one shard combines nothing
    text = metrics.render().decode()
    assert 'scheduler_solve_card_reads_total{site="grouped"}' in text
    assert 'scheduler_profile_stage_seconds_total{stage="issue"}' in text


def _kinds_batch(cs: ClusterState) -> None:
    """18 nodes in 3 zones, then in queue order 32 self-selecting zone-spread
    pods, 16 self-selecting hostname-anti pods, 16 plain pods and 8 plain
    pods mixed with 8 one-off pods: in chunks of 16, two spread chunks,
    one anti, one plain and one slow."""
    for i in range(18):
        cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": "40"})
                       .label("zone", f"z{i % 3}").label("host", f"n{i}").obj())
    pods = [MakePod().name(f"s{i}").label("app", "s").req({"cpu": "100m"})
            .spread_constraint(1, "zone", "DoNotSchedule", {"app": "s"}) for i in range(32)]
    pods += [MakePod().name(f"a{i}").label("app", "a").req({"cpu": "100m"})
             .pod_anti_affinity("host", {"app": "a"}) for i in range(16)]
    pods += [MakePod().name(f"w{i}").label("app", "w").req({"cpu": "100m"}) for i in range(24)]
    pods[-8:-8] = [MakePod().name(f"o{i}").req({"cpu": f"{200 + 50 * i}m"}) for i in range(8)]
    for b in pods:
        cs.create_pod(b.obj())


def test_chunk_counters_by_kind(monkeypatch):
    """The chunks, their valid pods and the grouped loop's iterations by
    chunk kind, as the solver counts them and the profiler folds them:
    the chunks equal the kinds the solver classified (chunks with a valid
    pod), the fast kinds' iterations add up to the grouped iterations, and
    the water-fill is kept in no more iterations than the spread chunks
    ran."""
    from kubernetes_tpu_torch.solver.exact import ExactSolver

    classified = []
    kinds_of = ExactSolver._chunk_kinds

    def recording(pods, *args):
        kinds = kinds_of(pods, *args)
        valid = (pods.valid & pods.feasible_static).reshape(len(kinds), -1).sum(axis=1)
        classified.append((kinds, valid))
        return kinds

    monkeypatch.setattr(ExactSolver, "_chunk_kinds", staticmethod(recording))
    cs = ClusterState()
    _kinds_batch(cs)
    sched = _sched(cs, group=16, obs=ObsConfig(profile=True), batch=80)
    before = {k: (metrics.solve_chunks_total.labels(k).value(),
                  metrics.solve_chunk_pods_total.labels(k).value()) for k in timing.CHUNK_KINDS}
    wf0 = metrics.solve_waterfill_iterations_total.value()
    res = sched.run_pipelined()
    assert sum(len(r.scheduled) for r in res) == 80
    entries = sched.telemetry.profiler.snapshot()["recent"]
    got = {k: sum(e[k] for e in entries) for k in entries[0] if k.startswith("chunk") or "iterations" in k}
    assert all(type(e[k]) is int for e in entries for k in got)
    want_chunks = dict.fromkeys(timing.CHUNK_KINDS, 0)
    want_pods = dict.fromkeys(timing.CHUNK_KINDS, 0)
    for kinds, valid in classified:
        for k, v in zip(kinds.tolist(), valid.tolist()):
            if v:
                want_chunks[timing.CHUNK_KINDS[k]] += 1
                want_pods[timing.CHUNK_KINDS[k]] += v
    assert {k: got[f"chunks.{k}"] for k in timing.CHUNK_KINDS} == want_chunks
    assert {k: got[f"chunk_pods.{k}"] for k in timing.CHUNK_KINDS} == want_pods
    assert want_chunks == {"slow": 1, "plain": 1, "spread": 2, "anti": 1}
    assert sum(want_pods.values()) == 80
    assert (sum(got[f"chunk_iterations.{k}"] for k in timing.FAST_KINDS)
            == got["grouped_iterations"] > 0)
    assert all(got[f"chunk_iterations.{k}"] > 0 for k in timing.FAST_KINDS)
    assert 0 < got["waterfill_iterations"] <= got["chunk_iterations.spread"]
    # the registry advanced by the same deltas
    for k in timing.CHUNK_KINDS:
        assert metrics.solve_chunks_total.labels(k).value() - before[k][0] == want_chunks[k]
        assert metrics.solve_chunk_pods_total.labels(k).value() - before[k][1] == want_pods[k]
    assert metrics.solve_waterfill_iterations_total.value() - wf0 == got["waterfill_iterations"]


@pytest.fixture(scope="module")
def kinds_run():
    """One Scheduler run over ``_kinds_batch`` with its spans and profiler
    on: the ``issue`` spans' attributes and the ledger entries."""
    cs = ClusterState()
    _kinds_batch(cs)
    sched = _sched(cs, group=16, obs=ObsConfig(profile=True, spans=True), batch=80)
    assert sum(len(r.scheduled) for r in sched.run_pipelined()) == 80
    attrs = [s["attrs"] for s in _spans(sched) if s["name"] == "issue"]
    return attrs, sched.telemetry.profiler.snapshot()["recent"]


@pytest.mark.parametrize("key", list(timing.COUNT_SERIES))
def test_each_solve_count_reaches_the_ledger_the_span_and_its_series(kinds_run, key):
    """Each key of the counts table is a ledger key and an attribute of
    every ``issue`` span, the two summing alike, and one ``observe_batch``
    advances the key's registry child, and no other count, by the solve's
    count."""
    attrs, entries = kinds_run
    assert attrs and all(key in a for a in attrs)
    assert entries and all(type(e[key]) is int for e in entries)
    assert sum(a[key] for a in attrs) == sum(e[key] for e in entries)
    series, label = timing.COUNT_SERIES[key]
    assert label in (None, key.rsplit(".", 1)[-1])
    parent = getattr(metrics, series)
    assert any(parent is m for m in metrics.PORT_SERIES)
    child = parent if label is None else parent.labels(label)
    times = timing.SolveTimes()
    times.counts[key] = 7
    prof = StageProfiler()
    before = child.value()
    prof.add_solve(times)
    entry = prof.observe_batch(step=1, pods=1)
    assert entry[key] == 7 and child.value() - before == 7
    assert all(entry[k] == 0 for k in timing.COUNT_SERIES if k != key)


def test_the_auction_times_and_counts_its_reads():
    import numpy as np

    from kubernetes_tpu_torch.solver.single_shot import SingleShotSolver
    from kubernetes_tpu_torch.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch

    nodes = [MakeNode().name(f"n{i}").capacity({"cpu": "2", "memory": "8Gi", "pods": "10"}).obj()
             for i in range(8)]
    pods = [MakePod().name(f"p{i}").req({"cpu": "500m"}).obj() for i in range(24)]
    vocab = ResourceVocab.build(pods, nodes)
    solver = SingleShotSolver(device="cpu")
    n0, s0 = timing.COUNTS["auction"], timing.SECONDS["auction"]
    got = solver.solve(build_node_batch(nodes, vocab=vocab), build_pod_batch(pods, vocab))
    assert np.all(got >= 0)
    assert timing.COUNTS["auction"] - n0 == solver.last_reads > 0
    assert timing.SECONDS["auction"] > s0


def _spans(sched) -> list[dict]:
    return [d for d in map(json.loads, sched.flight.lines()) if d.get("k") == "span"]


def test_span_stamps_nest_and_lie_within_the_call():
    cs = ClusterState()
    _nodes(cs)
    _pods(cs, 48)
    sched = _sched(cs, group=16, obs=ObsConfig(profile=True, spans=True))
    a = time.time_ns()
    sched.run_pipelined()
    b = time.time_ns()
    spans = [s for s in _spans(sched) if s["t0_ns"] >= a]  # this call's, not the start-up's
    by_id = {s["span"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert {"dispatch", "upload", "prepare", "issue", "card_read"} <= names
    for s in spans:
        assert a <= s["t0_ns"] <= s["t1_ns"] <= b
        parent = by_id.get(s["parent"])
        if parent is not None:
            assert parent["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= parent["t1_ns"]
    for s in spans:
        if s["name"] in SUB:
            assert by_id[s["parent"]]["name"] == "dispatch"
        if s["name"] == "card_read":
            assert by_id[s["parent"]]["name"] == "issue" and s["attrs"]["site"] == "grouped"
        if s["name"] == "issue":
            assert {"scan_steps", "grouped_iterations", "card_reads", "launches", "chunks.spread",
                    "chunk_pods.slow", "chunk_iterations.plain",
                    "waterfill_iterations"} <= set(s["attrs"])
    # the stage seconds and the spans time the same intervals
    prof = sched.telemetry.profiler.snapshot()["stage_seconds"]
    issue = sum(s["dur"] for s in spans if s["name"] == "issue")
    assert issue == pytest.approx(prof["issue"], rel=0.05)


def _stamps(seed_pods: int) -> list[tuple]:
    clock = FakeClock(1_000.0)
    cs = ClusterState()
    _nodes(cs)
    _pods(cs, seed_pods, spread=True)
    sched = _sched(cs, group=16, obs=ObsConfig(spans=True, enqueue_span_sample_n=1), clock=clock,
                   batch=16)
    while True:
        r = sched.schedule_batch()
        clock.advance(0.25)
        if not r.progressed:
            break
    return [(s["name"], s["span"], s["parent"], s["t0_ns"], s["t1_ns"]) for s in _spans(sched)]


def test_fake_clock_stamps_repeat_exactly():
    one, two = _stamps(40), _stamps(40)
    assert one == two
    assert {"upload", "prepare", "issue"} <= {s[0] for s in one}
    # the stamps are the virtual clock's, and they move with it
    assert len({s[3] for s in one}) > 1 and min(s[3] for s in one) >= 1_000 * 10**9


def test_tracing_session_has_a_range_per_loop_batch_and_sub_stage(tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "_trace_dir", None)
    monkeypatch.setattr(tracing, "_profiler", None)
    assert tracing.step("run_pipelined", 1) is tracing.stage("issue")  # one shared no-op when off
    cs = ClusterState()
    _nodes(cs)
    _pods(cs, 48)
    sched = _sched(cs, group=16, obs=None)
    tracing.enable(str(tmp_path))
    try:
        sched.run_pipelined()
        _pods(cs, 16, start=48)
        sched.run_streaming()
    finally:
        path = tracing.stop()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("run_pipelined#") for n in names)
    assert any(n.startswith("run_streaming#") for n in names)
    assert {"upload", "prepare", "issue", "card_read"} <= names


def test_top_renders_the_overlapping_stages_apart():
    snap = {"enabled": True, "profile": {
        "batches": 2, "pods": 16,
        "stage_seconds": {s: 0.5 for s in ALL_STAGES},
        "stage_fraction": {s: 1.0 / len(STAGES) for s in STAGES},
        "recent": [],
    }}
    out = render_top(snap).splitlines()
    head = next(i for i, line in enumerate(out) if line.startswith("  overlapping"))
    assert all(any(line.split()[0] == s for line in out[1:head]) for s in STAGES)
    assert [line.split()[0] for line in out[head + 1:]] == list(NESTED_STAGES)
