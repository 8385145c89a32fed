"""CUDA graphs of the grouped random loop's quota iterations
(solver/graphs.py, solver/grouped.py ``_Loop``) on the CPU.

The CPU keeps the eager loop, so the rule that engages the graphs is
tested as it stands, and the graph path itself with an emulated capture,
as tests/test_torch_step_graphs.py does for the scan step: the "graph"
records the iteration and each replay runs it again, eagerly, on the kept
loop's buffers, which each chunk's prologue rewrites. Each case equals the
eager solve bit for bit: assignments, carried state and the stream's key,
with the replays and the eager iterations adding up to the iterations and
to the grouped card reads. The card's own tests (tests/test_torch_cuda.py)
hold the real graphs the same way."""

from __future__ import annotations

import json

import numpy as np
import pytest

from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.api.wrappers import MakePod
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.parallel import sharding as sh
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver import graphs as sg
from kubernetes_tpu_torch.solver import grouped as gp
from kubernetes_tpu_torch.solver import timing
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors

from _torch_graph_emulation import HOST, ZONE, emulated  # noqa: F401 (a fixture)
from _torch_graph_emulation import inputs as _inputs
from _torch_graph_emulation import nodes as graph_nodes

GROUP = 16


def _nodes(n=48, varied=False):
    """``n`` nodes in 3 zones; ``varied``: capacities that differ, so that
    ties are few and a chunk takes many iterations."""
    return graph_nodes(n, cpu=8, memory="32Gi", pods=40, varied=varied)


def _pods(n, kind, prefix="p", skew=1, bad_every=0, cpu="100m"):
    """``n`` identical pods of ``kind``: "spread" (one hard zone spread at
    maxSkew ``skew``), "anti" (required self-selecting hostname
    anti-affinity), "plain" or "mixed" (one-off requests, chunks the scan
    steps over); every ``bad_every``-th requests a resource no node has."""
    out = []
    for i in range(n):
        req = {"cpu": cpu, "memory": "256Mi"}
        if kind == "mixed":
            req["cpu"] = f"{100 + 10 * i}m"
        if bad_every and i % bad_every == bad_every - 1:
            req["example.com/missing"] = "1"
        b = MakePod().name(f"{prefix}{i:04}").label("app", f"{prefix}-{kind}").req(req)
        if kind == "spread":
            b = b.spread_constraint(skew, ZONE, "DoNotSchedule", {"app": f"{prefix}-{kind}"})
        elif kind == "anti":
            b = b.pod_anti_affinity(HOST, {"app": f"{prefix}-{kind}"})
        out.append(b.obj())
    return out


# each case: the batches one solver solves in turn, and how
CASES = {
    # maxSkew 1 from empty zones: the water-fill is kept
    "spread_skew1": dict(mode="standalone", batches=lambda: [_pods(96, "spread")]),
    "spread_skew5": dict(mode="standalone", batches=lambda: [_pods(96, "spread", skew=5)]),
    # on nodes of differing sizes: few ties, so an iteration places few pods
    "anti": dict(mode="standalone", varied=True, batches=lambda: [_pods(48, "anti")]),
    # a scan chunk's invalid rows owe the stream splits, which the next
    # spread chunk's first draw pays
    "owed_splits": dict(mode="standalone", batches=lambda: [
        _pods(32, "spread", prefix="a") + _pods(16, "mixed", prefix="m", bad_every=4)
        + _pods(48, "spread", prefix="a")]),
    # two session solves under one epoch, each with a new i32 state tensor
    "two_solves": dict(mode="session", batches=lambda: [_pods(64, "spread", prefix="a"),
                                                        _pods(64, "spread", prefix="a")]),
}


def _run(spec, graphs: bool, made, seed=11):
    """The case's solves on one solver: per solve, (assignments, carried
    state, stream key, the solver's counts); and the pass's iteration
    outcomes (True: replayed, False: eager)."""
    nodes = _nodes(varied=spec.get("varied", False))
    solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=seed, group_size=GROUP))
    outcomes = []
    real = sg._Pass.iteration

    def recorded(self, *a):
        out = real(self, *a)
        outcomes.append(out is not None)
        return out

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sg._Pass, "iteration", recorded)
        if not graphs:
            mp.setattr(sg, "engages", lambda *a: False)
        for pods in spec["batches"]():
            inp = _inputs(nodes, pods)
            reads0 = timing.COUNTS["grouped"]
            if spec["mode"] == "standalone":
                got = solver.solve(*inp, device="cpu")
                state = [getattr(inp[0], k).copy() for k in ("used", "nonzero_used", "pod_count")]
            else:
                versions = np.zeros(inp[0].padded, np.int64)
                got = solver.solve(*inp, col_versions=versions, device="cpu")
                p = solver._session.persist
                state = [p["i64"][0].numpy().copy(), p["pod_count"][0].numpy().copy()]
            stream = solver.graphs.stream if graphs else made[-1]
            tm = solver.times
            out.append((got, state, stream.key_words(), dict(
                tm.counts, card_reads=tm.card_reads,
                reads=timing.COUNTS["grouped"] - reads0)))
    return out, outcomes, solver


@pytest.mark.parametrize("case", sorted(CASES))
def test_quota_graphs_equal_the_eager_loop(emulated, case):
    spec = CASES[case]
    want, none, _ = _run(spec, False, emulated)
    got, outcomes, solver = _run(spec, True, emulated)
    assert none == []  # without graphs no pass sees an iteration
    for (a, sa, ka, ca), (b, sb, kb, cb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y)
        assert ka == kb
        quota = sum(ca[f"chunk_iterations.{k}"] for k in timing.QUOTA_KINDS)
        assert quota == sum(cb[f"chunk_iterations.{k}"] for k in timing.QUOTA_KINDS) > 0
        assert ca["grouped_iterations"] == ca["card_reads"] == ca["reads"] == cb["reads"]
        for k in timing.QUOTA_KINDS:
            assert cb[f"grouped_graph_replays.{k}"] == cb[f"grouped_graph_captures.{k}"] == 0
            assert ca[f"grouped_graph_replays.{k}"] <= ca[f"chunk_iterations.{k}"]
    # every quota iteration went through the pass: replayed or eager
    counts = [c for _, _, _, c in got]
    assert len(outcomes) == sum(c[f"chunk_iterations.{k}"] for c in counts
                                for k in timing.QUOTA_KINDS)
    replays = sum(c[f"grouped_graph_replays.{k}"] for c in counts for k in timing.QUOTA_KINDS)
    assert sum(outcomes) == replays > 0
    assert sum(c[f"grouped_graph_captures.{k}"] for c in counts for k in timing.QUOTA_KINDS) > 0
    if case == "spread_skew1":
        assert counts[0]["waterfill_iterations"] > 0
    if case == "anti":
        assert counts[0]["grouped_graph_replays.anti"] > 0
    if case == "two_solves":
        # the same epoch: the second solve captures nothing and replays
        assert counts[1]["grouped_graph_captures.spread"] == 0
        assert counts[1]["grouped_graph_replays.spread"] == counts[1]["chunk_iterations.spread"]


def test_an_iteration_owing_splits_runs_eagerly(emulated, monkeypatch):
    """The first iteration of a spread chunk after a scan chunk's invalid
    rows pays their splits eagerly; no graph bakes the owed count in."""
    owed = []
    real = sg._Pass.iteration

    def watched(self, loop, key, vcnt):
        pending = self.stream.pending
        out = real(self, loop, key, vcnt)
        if pending:
            owed.append(out)
        return out

    monkeypatch.setattr(sg._Pass, "iteration", watched)
    _run(CASES["owed_splits"], True, emulated)
    assert owed and all(o is None for o in owed)


def test_a_signature_is_captured_after_its_eager_iterations(emulated):
    """Each signature (iteration key, valid count, the stream's key slot)
    runs MIN_ITERATIONS eager iterations in an epoch, then is captured once
    and replays."""
    spec = dict(mode="standalone", batches=lambda: [_pods(96, "spread", skew=5)])
    ((_, _, _, c),), outcomes, solver = _run(spec, True, emulated)
    sigs = len(solver.graphs.iterations)
    assert sigs == c["grouped_graph_captures.spread"] >= 1
    assert set(solver.graphs.seen.values()) == {sg.MIN_ITERATIONS}
    assert outcomes.count(False) == sg.MIN_ITERATIONS * len(solver.graphs.seen)
    assert all(len(k) == 5 and k[0] == "spread" for k in solver.graphs.iterations)


def _quota(tm, name) -> dict:
    """The solve's count ``name.<kind>`` by quota kind."""
    return {k: tm.counts[f"{name}.{k}"] for k in timing.QUOTA_KINDS}


def _solve_counts(pods, cfg, **kw):
    solver = ExactSolver(cfg)
    solver.solve(*_inputs(_nodes(), pods), **kw)
    return solver


@pytest.mark.parametrize("case", ["plain", "first"])
def test_plain_chunks_and_first_mode_keep_the_eager_loop(emulated, case):
    """Where graphs engage, plain chunks and "first" mode replay no
    iteration: a plain chunk's loop is not a quota loop, and "first" mode
    reads nothing inside its loop."""
    if case == "plain":
        pods, tie = _pods(64, "plain"), "random"
    else:
        pods, tie = _pods(64, "spread"), "first"
    solver = _solve_counts(pods, ExactSolverConfig(tie_break=tie, seed=2, group_size=GROUP),
                           device="cpu")
    tm = solver.times
    assert tm.counts["grouped_iterations"] > 0
    assert (_quota(tm, "grouped_graph_replays") == _quota(tm, "grouped_graph_captures")
            == {"spread": 0, "anti": 0})
    assert solver.graphs is None or not solver.graphs.iterations


def test_the_cpu_keeps_the_eager_loop():
    solver = _solve_counts(_pods(64, "spread"),
                           ExactSolverConfig(tie_break="random", seed=2, group_size=GROUP),
                           device="cpu")
    assert solver.graphs is None and solver.times.counts["chunk_iterations.spread"] > 0
    assert _quota(solver.times, "grouped_graph_replays") == {"spread": 0, "anti": 0}


def test_a_mesh_keeps_the_eager_loop(emulated):
    solver = _solve_counts(_pods(64, "anti"),
                           ExactSolverConfig(tie_break="random", seed=2, group_size=GROUP),
                           mesh=sh.NodeMesh(("cpu", "cpu")))
    assert solver.graphs is None and solver.times.counts["chunk_iterations.anti"] > 0
    assert _quota(solver.times, "grouped_graph_replays") == {"spread": 0, "anti": 0}


def test_a_nominated_batch_keeps_the_eager_loop(emulated):
    from kubernetes_tpu_torch.tensorize.schema import build_nominated_tensors

    nodes, pods = _nodes(), _pods(64, "spread")
    inputs = list(_inputs(nodes, pods))
    nb, pb = inputs[:2]
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    pairs = [(pods[i], (i * 7) % len(nodes)) for i in range(0, 64, 16)]
    inputs[3] = build_port_tensors(pods, pb, slots, {}, nb.padded, nominated=pairs)
    nom = build_nominated_tensors(pairs, nb.vocab, nb.padded, ports=inputs[3])
    slot_of = {p.key: s for p, s in pairs}
    nslot = np.asarray([slot_of.get(p.key, -1) for p in pods], np.int32)
    solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=4, group_size=GROUP))
    solver.solve(*inputs, nominated=nom, nominated_slot=nslot, device="cpu")
    assert solver.graphs is None
    assert _quota(solver.times, "grouped_graph_replays") == {"spread": 0, "anti": 0}


def test_the_loop_key_holds_what_the_iteration_branches_on():
    """Spread chunks of one class share a key; an anti pod's weight in the
    counts (its in and ex terms) is part of it."""
    nodes = _nodes()
    pods = _pods(16, "spread") + _pods(16, "anti")
    nb, pb, st, ports, spread, interpod = _inputs(nodes, pods)
    from kubernetes_tpu_torch.solver.exact import _pod_inputs

    host = _pod_inputs(pb, st, ports, spread, interpod, None, None, False)
    tables = {"ipa": {"cls_req_anti": np.asarray(interpod.cls_req_anti)}}
    row = {k: v[0] for k, v in host.items()}
    cls = int(row["class_of"])
    assert gp.iteration_key("spread", tables, cls, row) == ("spread", cls, 1)
    arow = {k: v[16] for k, v in host.items()}
    mode, acls, v = gp.iteration_key("anti", tables, int(arow["class_of"]), arow)
    assert (mode, acls) == ("anti", int(arow["class_of"])) and v == 2  # its in and ex terms


def test_registry_series_and_issue_span_count_the_quota_graphs(emulated):
    """The Scheduler hands each solve's quota replays and captures to its
    StageProfiler, which folds them into the two new registry series by
    chunk kind, apart from the scan's series; the ``issue`` span carries
    them."""
    cs = ClusterState()
    cs.create_nodes(_nodes(varied=True))
    for p in _pods(96, "spread", prefix="s") + _pods(32, "anti", prefix="a", cpu="2"):
        cs.create_pod(p)
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=64, obs=ObsConfig(profile=True, spans=True),
        solver=ExactSolverConfig(tie_break="random", seed=5, group_size=GROUP)), device="cpu")
    replays_s, captures_s = (metrics.solve_grouped_graph_replays_total,
                             metrics.solve_grouped_graph_captures_total)
    before = {k: (replays_s.labels(k).value(), captures_s.labels(k).value())
              for k in timing.QUOTA_KINDS}
    scan = metrics.solve_graph_replays_total.value()
    res = sched.run_pipelined()
    assert sum(len(r.scheduled) for r in res) == 128
    entries = sched.telemetry.profiler.snapshot()["recent"]
    spans = [d for d in map(json.loads, sched.flight.lines())
             if d.get("k") == "span" and d.get("name") == "issue"]
    for k in timing.QUOTA_KINDS:
        r = sum(e[f"grouped_graph_replays.{k}"] for e in entries)
        c = sum(e[f"grouped_graph_captures.{k}"] for e in entries)
        assert 0 < r <= sum(e[f"chunk_iterations.{k}"] for e in entries) and c > 0
        assert replays_s.labels(k).value() - before[k][0] == r
        assert captures_s.labels(k).value() - before[k][1] == c
        assert sum(s["attrs"][f"grouped_graph_replays.{k}"] for s in spans) == r
        assert sum(s["attrs"][f"grouped_graph_captures.{k}"] for s in spans) == c
    assert metrics.solve_graph_replays_total.value() == scan  # the scan's series apart
    for series in (replays_s, captures_s):
        assert any(series is m for m in metrics.PORT_SERIES)


def test_the_cpu_counts_no_quota_graph():
    """On the CPU the new counters read 0 in the profiler's ledger, and the
    chunk iterations still add up to the grouped iterations."""
    cs = ClusterState()
    cs.create_nodes(_nodes(24))
    for p in _pods(64, "spread", prefix="s") + _pods(32, "anti", prefix="a"):
        cs.create_pod(p)
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=96, obs=ObsConfig(profile=True),
        solver=ExactSolverConfig(tie_break="random", seed=6, group_size=GROUP)), device="cpu")
    sched.run_pipelined()
    entries = sched.telemetry.profiler.snapshot()["recent"]
    assert all(e[f"grouped_graph_{w}.{k}"] == 0 for e in entries
               for w in ("replays", "captures") for k in timing.QUOTA_KINDS)
    assert (sum(e[f"chunk_iterations.{k}"] for e in entries for k in timing.FAST_KINDS)
            == sum(e["grouped_iterations"] for e in entries) > 0)
