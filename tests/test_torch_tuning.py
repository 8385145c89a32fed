"""The port's auto-tuning runtime against the JAX package's on the CPU.

The controller, window and runtime cases of ``tests/test_tuning.py`` run
on the port's copies (``kubernetes_tpu_torch/tuning``) with the same
expected values, and each is run on the JAX package's modules too: the
climbers' decision sequences, the windows' estimates and the tuners'
summaries must be equal. The runtime cases drive both Schedulers through
``_torch_sched_pair.Pair`` (``FakeClock``s, ``tie_break="first"``,
float64 balanced scores). The fleet flush knob's cases run on the port's
remote exchange. Left out: the sim invariant's
known-bad fixtures (``sim/invariants.check_tuning``, item 8) and the two
``run_sim("tuning_convergence")`` cases (item 8).
"""

from __future__ import annotations

import random

import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.tuning import controllers as ref_controllers
from kubernetes_tpu.tuning import runtime as ref_runtime
from kubernetes_tpu.tuning import window as ref_window
from kubernetes_tpu.utils.clock import FakeClock as RefFakeClock
from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.api.wrappers import MakePod as PMakePod
from kubernetes_tpu_torch.config import types as config_types
from kubernetes_tpu_torch.tuning import controllers, runtime, window
from kubernetes_tpu_torch.utils.clock import FakeClock

from _torch_sched_pair import PARITY, Pair

PKGS = ((controllers, window, FakeClock), (ref_controllers, ref_window, RefFakeClock))


def decisions(c):
    return [(d.knob, d.action, d.old, d.new) for d in c.history]


def both(case):
    """Run ``case(controllers, window, FakeClock)`` on the port, then on
    the JAX package; the returned observations must be equal."""
    port, ref = (case(*pkg) for pkg in PKGS)
    assert port == ref
    return port


def drive(climber, objective, batches):
    for _ in range(batches):
        climber.observe(objective(climber.value), 1.0)
        if climber.settled:
            break


# -- HillClimber --------------------------------------------------------------


@pytest.mark.parametrize(
    "start,lo,hi,objective,value,min_moves",
    [
        (2, 1, 64, lambda v: 100 - abs(v - 8) * 10, 8, 2),  # climbs to a clean peak
        (32, 1, 64, lambda v: 1000.0 / v, 1, 1),  # descends when down is better
        (4, 1, 16, lambda v: 50.0, 4, 0),  # flat: settles at the start value
        (4, 1, 64, lambda v: 100.0 * (1.03 if v > 4 else 1.0), 4, 0),  # under the margin
    ],
    ids=["climbs_to_peak", "descends", "flat_objective", "strict_hysteresis_margin"],
)
def test_climber_settles(start, lo, hi, objective, value, min_moves):
    def case(ctl, _w, _c):
        c = ctl.HillClimber("k", start, lo, hi, eval_batches=2, hysteresis=0.05, settle_after=1)
        drive(c, objective, 200)
        assert c.settled and c.value == value
        assert c.moves >= min_moves if min_moves else c.moves == 0
        return decisions(c)

    both(case)


def test_never_leaves_bounds_or_alignment():
    def case(ctl, _w, _c):
        c = ctl.HillClimber("k", 64, 32, 512, eval_batches=1, hysteresis=0.05, settle_after=2, align=32)
        seen = []
        for i in range(300):
            c.observe(float((i * 37) % 11), 1.0)
            seen.append(c.value)
            if c.settled:
                break
        assert all(32 <= v <= 512 and v % 32 == 0 for v in seen)
        return seen

    both(case)


def test_guard_rejected_candidate_is_never_applied():
    def case(ctl, _w, _c):
        tried = []

        def guard(v):
            tried.append(v)
            return v <= 8

        c = ctl.HillClimber("k", 8, 1, 64, eval_batches=1, hysteresis=0.05, settle_after=1, guard=guard)
        seen = []
        for i in range(100):
            c.observe(float(i % 7), 1.0)
            seen.append(c.value)
            if c.settled:
                break
        assert max(seen) <= 8
        assert c.guard_rejections >= 1
        assert any(v > 8 for v in tried)
        return seen, tried, c.guard_rejections

    both(case)


def test_probe_budget_bounds_a_noisy_objective():
    def case(ctl, _w, _c):
        c = ctl.HillClimber("k", 4, 1, 4096, eval_batches=1, hysteresis=0.05, settle_after=3, max_probes=6)
        n = [0.0]
        for _ in range(500):
            n[0] += 10.0  # strictly increasing: every probe accepts
            c.observe(n[0], 1.0)
            if c.settled:
                break
        assert c.settled and c.probes <= 6
        return decisions(c)

    both(case)


def test_no_oscillation_past_hysteresis():
    def case(ctl, _w, _c):
        c = ctl.HillClimber("k", 8, 1, 64, eval_batches=2, hysteresis=0.05, settle_after=2)
        for _ in range(400):
            c.observe(100 - abs(c.value - 16) * 2, 1.0)
            if c.settled:
                break
        assert c.settled and c.value == 16
        accepts = [d for d in c.history if d.action == "accept"]
        assert len(accepts) == len({(d.old, d.new) for d in accepts})
        return decisions(c)

    both(case)


def test_unsettle_reopens_and_reconverges():
    def case(ctl, _w, _c):
        c = ctl.HillClimber("k", 2, 1, 64, eval_batches=2, hysteresis=0.05, settle_after=1)
        drive(c, lambda v: 100 - abs(v - 8) * 10, 200)
        assert c.settled and c.value == 8
        c.unsettle({"why": "test"})
        assert not c.settled
        drive(c, lambda v: 100 - abs(v - 32) * 2, 400)
        assert c.settled and c.value == 32
        return decisions(c)

    both(case)


@pytest.mark.parametrize(
    "seed,eval_batches,settle_after",
    [(0, 1, 1), (1, 2, 1), (7, 3, 2), (42, 6, 3), (2**31 - 1, 4, 2), (12345, 1, 3)],
)
def test_always_settles_in_bounds(seed, eval_batches, settle_after):
    """Seeded objective traces (the JAX package's property test, at fixed
    seeds): the climber settles within the structural bound and never
    leaves its bounds or alignment."""

    def case(ctl, _w, _c):
        rng = random.Random(seed)
        c = ctl.HillClimber("k", 8, 2, 256, eval_batches=eval_batches, hysteresis=0.1,
                            settle_after=settle_after, align=2, max_probes=8)
        limit = eval_batches * (2 * c.max_probes + 4) + eval_batches
        steps = 0
        while not c.settled and steps < 10_000:
            c.observe(rng.uniform(0, 100), 1.0)
            steps += 1
            assert 2 <= c.value <= 256 and c.value % 2 == 0
        assert c.settled and steps <= limit
        return steps, decisions(c)

    both(case)


# -- CounterWindow --------------------------------------------------------------


def test_note_read_ewma_matches_the_moved_formula():
    def case(_ctl, win, clock):
        w = win.CounterWindow(clock())
        w.note_read(0.2, 0.1, 10)
        assert w.rtt_ewma == pytest.approx(0.2)
        assert w.pod_solve_ewma == pytest.approx(0.3 / 10)
        w.note_read(0.4, 0.1, 10)
        assert w.rtt_ewma == pytest.approx(0.7 * 0.2 + 0.3 * 0.4)
        before = w.rtt_ewma
        w.note_read(0.0005, 0.1, 10)
        assert w.rtt_ewma == before
        return w.rtt_ewma, w.pod_solve_ewma

    both(case)


def test_split_estimate_rule():
    def case(_ctl, win, clock):
        w = win.CounterWindow(clock())
        assert w.split_estimate(100, 8) == 1
        w.rtt_ewma = 0.125
        w.pod_solve_ewma = 0.0009765625  # 2^-10
        assert w.split_estimate(100, 8) == 1
        assert w.split_estimate(4096, 8) == 8
        assert w.split_estimate(4096, 4) == 4
        w.pod_solve_ewma = 0.0005
        assert w.split_estimate(1000, 8) == 4
        return True

    both(case)


def test_note_batch_samples_counter_deltas():
    clock = FakeClock()
    w = window.CounterWindow(clock)
    metrics.stream_unhidden_reads_total.inc(3)
    clock.advance(2.0)
    s = w.note_batch(pods=5, solve_s=0.1)
    assert s.deltas["unhidden_reads"] == 3
    assert s.pods == 5
    assert s.wall_s == pytest.approx(2.0)
    assert w.note_batch(pods=4).deltas["unhidden_reads"] == 0


def test_rate_is_pop_boundary_robust():
    def case(_ctl, win, clk):
        clock = clk()
        a = win.CounterWindow(clock)
        clock.advance(1.0)
        a.note_batch(pods=15)
        b = win.CounterWindow(clock)
        clock.advance(1.0)
        b.note_batch(pods=8)
        b.note_batch(pods=7)
        assert a.rate(4) == pytest.approx(b.rate(4))
        return a.rate(4)

    both(case)


# -- TuningRuntime on the Schedulers --------------------------------------------


def tuning_pair(tuning=("default",), n_nodes=8, cpu="32", group=64, **cfg):
    cs = ClusterState()
    for i in range(n_nodes):
        cs.create_node(
            MakeNode().name(f"n{i}").capacity({"cpu": cpu, "memory": "128Gi", "pods": "110"}).obj()
        )
    kw = dict(eval_batches=2, settle_after=1, hysteresis=0.5, max_probes=4)
    if tuning == ("default",):
        tuning = kw
    port_t = runtime.TuningConfig(**tuning) if tuning is not None else None
    ref_t = ref_runtime.TuningConfig(**tuning) if tuning is not None else None
    return Pair(cs, solver=dict(PARITY, group_size=group), batch_size=8, tuning=port_t,
                ref_config={"tuning": ref_t}, **cfg)


def add_pods(pair, n, prefix="p"):
    for i in range(n):
        pair.create_pod(MakePod().name(f"{prefix}{i:04}").req({"cpu": "500m", "memory": "1Gi"}).obj())


def cycles(pair, n, loop):
    for c in range(n):
        add_pods(pair, 6, prefix=f"c{c}-")
        pair.run(loop, max_batches=50)
        pair.advance(1.0)


def test_streaming_drive_converges_and_journals():
    pair = tuning_pair()
    cycles(pair, 20, "streaming")
    pair.assert_equal()
    s = pair.port
    summary = s.tuner.summary()
    assert summary == pair.ref.tuner.summary()
    assert summary["probes"] >= 1 and summary["settled"] == 1
    assert summary["guardrail_breaches"] == 0
    assert 1 <= summary["knobs"]["stream_depth"] <= 16
    assert 1 <= summary["knobs"]["pipeline_split"] <= 8
    assert s.config.stream_depth == summary["knobs"]["stream_depth"]
    assert metrics.tuning_knob_value.labels("stream_depth")._value.get() == float(s.config.stream_depth)
    assert len(s.tuner.decisions) == summary["adjustments"]


def test_choose_split_prefers_tuner_then_window():
    pair = tuning_pair()
    for s, _ in pair.sides():
        s.window.rtt_ewma = 0.1
        s.window.pod_solve_ewma = 0.001
        assert s._choose_split(1000) == s.window.split_estimate(1000, 8)
        s.tuner.attach(s)
        assert s._choose_split(1000) == s.tuner.split_override()
        s.config.pipeline_split = 3
        assert s._choose_split(1000) == 3


def test_pipelined_drive_settles_despite_inactive_stream_knob():
    pair = tuning_pair()
    cycles(pair, 20, "pipelined")
    pair.assert_equal()
    summary = pair.port.tuner.summary()
    assert summary == pair.ref.tuner.summary()
    assert summary["settled"] == 1, summary
    depth = pair.port.tuner.controllers["stream_depth"]
    assert depth.ticks == 0 and not depth.settled


def test_first_sample_is_a_warm_batch():
    pair = tuning_pair()
    pair.advance(100.0)  # "construction + compile" gap
    add_pods(pair, 6)
    pair.run("streaming", max_batches=10)
    for s, _ in pair.sides():
        assert all(c.ticks == 0 for c in s.tuner.controllers.values())
        assert len(s.window.samples) >= 1


def test_static_pin_by_dropping_the_knob():
    pair = tuning_pair(dict(eval_batches=2, settle_after=1, knobs=("pipeline_split",)))
    for c in range(8):
        add_pods(pair, 6, prefix=f"c{c}-")
        pair.run("streaming", max_batches=50)
        pair.advance(1.0)
    s = pair.port
    assert "stream_depth" not in s.tuner.controllers
    assert s.config.stream_depth == 4
    assert "pipeline_split" in s.tuner.controllers
    assert s.tuner.summary() == pair.ref.tuner.summary()


def test_drain_guardrail_rejects_over_budget_chunks():
    from kubernetes_tpu_torch.solver import budget as hbm

    pair = tuning_pair(n_nodes=12, cpu="64")
    add_pods(pair, 768)
    budget = hbm.estimate(pair.port.drain_shape(128)).per_device_bytes + 1
    _, report = pair.run("drain", chunk_pods=128, budget_bytes=budget)
    pair.assert_equal()
    assert report.drained == 768
    summary = pair.port.tuner.summary()
    assert summary == pair.ref.tuner.summary()
    assert summary["guardrail_breaches"] == 0
    assert summary["guardrail_rejections"] >= 1
    assert report.final_chunk_pods <= 128


def test_drain_chunk_stays_group_aligned():
    pair = tuning_pair(group=8)
    add_pods(pair, 128)
    pair.run("drain", chunk_pods=16, budget_bytes=8 << 30)
    chunk = pair.port.tuner.knob_values().get("backlog_chunk")
    assert chunk is not None and chunk % 8 == 0
    assert chunk == pair.ref.tuner.knob_values().get("backlog_chunk")


def test_tuned_profile_round_trips_through_standard_config():
    from kubernetes_tpu_torch.tuning.profile import tuned_profile

    pair = tuning_pair()
    cycles(pair, 12, "streaming")
    s = pair.port
    doc = tuned_profile(s)
    sched_cfg = config_types.scheduler_config(config_types.load(doc))
    knobs = s.tuner.knob_values()
    assert sched_cfg.stream_depth == knobs["stream_depth"]
    assert sched_cfg.pipeline_split == knobs["pipeline_split"]
    assert sched_cfg.tuning is None
    assert knobs == pair.ref.tuner.knob_values()


def test_stream_depth_applies_at_ring_drain_boundary():
    pair = tuning_pair(None)
    s = pair.port
    s.config.stream_depth = 2
    add_pods(pair, 32)
    depths = []
    orig = s._dispatch_stream

    def spy(prep, **kw):
        depths.append(s.config.stream_depth)
        return orig(prep, **kw)

    s._dispatch_stream = spy
    s.run_streaming(max_batches=50)
    assert depths and set(depths) == {2}
    s.config.stream_depth = 5
    for i in range(16):
        pair.cluster.create_pod(PMakePod().name(f"q{i:04}").req({"cpu": "500m", "memory": "1Gi"}).obj())
    s.run_streaming(max_batches=50)
    assert s.config.stream_depth == 5
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_tuner_knob_trajectory_equals_reference():
    """A tuner governing ``pipeline_split`` and the backlog chunk: the
    port's knob values after every batch equal the JAX package's, over a
    pipelined drive and then a backlog drain."""
    pair = tuning_pair(dict(eval_batches=2, settle_after=1, hysteresis=0.05, max_probes=4,
                            knobs=("pipeline_split", "backlog_chunk")), group=8)
    trajectories = []
    for s, _ in pair.sides():
        seen = []
        trajectories.append(seen)
        real = s.tuner.observe_batch

        def observe(*a, real=real, seen=seen, tuner=s.tuner, **kw):
            real(*a, **kw)
            seen.append(tuner.knob_values())

        s.tuner.observe_batch = observe
    cycles(pair, 10, "pipelined")
    add_pods(pair, 256, prefix="d")
    pair.advance(1.0)
    pair.run("drain", chunk_pods=32, budget_bytes=8 << 30)
    pair.assert_equal()
    port, ref = trajectories
    assert len(port) >= 12
    assert port == ref
    assert any("backlog_chunk" in k for k in port)
    assert pair.port.tuner.summary() == pair.ref.tuner.summary()


# -- the config surface of the tuning knobs --------------------------------------


def test_empty_knob_list_pins_everything():
    cfg = config_types.load("tuning: {enabled: true, knobs: []}")
    assert cfg.tuning.knobs == []
    assert config_types.scheduler_config(cfg).tuning.knobs == ()
    cfg2 = config_types.load("tuning: {enabled: true}")
    assert set(cfg2.tuning.knobs) == set(config_types.TUNABLE_KNOBS)


def test_max_probes_parses_and_validates():
    cfg = config_types.load("tuning: {enabled: true, maxProbes: 5}")
    assert config_types.scheduler_config(cfg).tuning.max_probes == 5
    with pytest.raises(ValueError):
        config_types.load("tuning: {maxProbes: 0}")
    with pytest.raises(ValueError):
        runtime.TuningConfig(max_probes=0).validate()


def test_config_flush_batch_reaches_the_refused_fleet_section():
    """fleet.flushBatch parses and validates as in the JAX package and
    reaches the replica's FleetConfig. The Scheduler refused fleet mode
    until the fleet was ported; now it constructs, its remote exchange takes
    the configured batch, and the tuner builds the fleet_flush controller
    over it (an in-process hub has no write-behind buffer, so no knob)."""
    from kubernetes_tpu_torch import convert
    from kubernetes_tpu_torch.fleet import OccupancyExchange
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.server.bulk import BulkCore, make_grpc_server

    sc = config_types.scheduler_config(config_types.load("fleet:\n  replica: r0\n  flushBatch: 64\n"))
    assert sc.fleet.flush_batch == 64
    with pytest.raises(ValueError):
        config_types.load("fleet:\n  replica: r0\n  flushBatch: -1\n")
    server, port = make_grpc_server(BulkCore(convert.cluster_state(ClusterState()),
                                             exchange=OccupancyExchange(), device="cpu"))
    server.start()
    try:
        sc = config_types.scheduler_config(config_types.load(
            "fleet:\n  replica: r0\n  replicas: [r0]\n  flushBatch: 64\n"
            f"  hubAddress: 127.0.0.1:{port}\n"
            "tuning:\n  enabled: true\n  knobs: [fleet_flush]\n"))
        sched = Scheduler(convert.cluster_state(ClusterState()), sc, device="cpu")
        assert sched.fleet.flush_batch() == 64
        sched.tuner.attach(sched)
        climber = sched.tuner.controllers[runtime.KNOB_FLUSH]
        assert climber.value == 64
        climber.value = 16  # a probe's candidate, as the climber sets it
        sched.tuner._apply(sched, climber, controllers.Decision(
            runtime.KNOB_FLUSH, "probe", 64, 16, 0.0, 0.0))
        assert sched.fleet.flush_batch() == 16
        sched.fleet.exchange.close()
    finally:
        server.stop(grace=None)


def test_remote_exchange_buffer_cap_retargets():
    """The fleet_flush knob's application surface (tests/test_tuning.py's
    case on both packages): the write-behind cap is an instance setting
    consulted on append, so a retarget at any moment is safe — a shrink
    below the live buffer flushes at the next mutation."""
    from kubernetes_tpu.fleet.occupancy import PodRow as RefPodRow
    from kubernetes_tpu.fleet.runtime import RemoteOccupancyExchange as RefRemote
    from kubernetes_tpu_torch.fleet.occupancy import PodRow
    from kubernetes_tpu_torch.fleet.runtime import RemoteOccupancyExchange

    def drive(remote_cls, row_cls):
        calls = []

        class FakeClient:
            def hub_op(self, op, **meta):
                calls.append((op, meta))
                return {"version": 1}

            def close(self):
                pass

        ex = remote_cls("x:1", "r0", client=FakeClient())
        assert ex._buffer_cap == remote_cls._BUFFER_CAP
        ex.set_buffer_cap(2)

        def row(i):
            return row_cls(pod=f"default/p{i}", node="n0", zone="z0",
                           namespace="default", labels=())

        ex.stage("r0", row(0))
        assert not any(op == "apply_ops" for op, _ in calls)
        ex.stage("r0", row(1))  # cap 2 reached -> one apply_ops flush
        flushes = [m for op, m in calls if op == "apply_ops"]
        assert len(flushes) == 1 and len(flushes[0]["ops"]) == 2
        return [(op, {k: v for k, v in m.items() if k != "flush_client"})
                for op, m in calls]

    assert drive(RemoteOccupancyExchange, PodRow) == drive(RefRemote, RefPodRow)
