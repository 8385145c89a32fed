"""The scan step's CUDA graphs (solver/graphs.py) on the CPU.

The CPU keeps the eager step, so the rule that engages graphs is tested
as it stands, and the graph path itself with an emulated capture: the
"graph" records the captured step and a replay runs it again, eagerly,
through everything a CUDA graph replays (the step table at the device
cursor, the packed pod row, the owed splits read as data, the static
state, stream key and assignments). Each case equals the eager solve bit
for bit; the card's own tests (tests/test_torch_cuda.py) hold the real
graphs the same way. The registry's two series, the StageProfiler's fold
and the ``issue`` span's attributes are checked here too."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.obs.profile import GRAPH_COUNTS
from kubernetes_tpu_torch.ops import prng
from kubernetes_tpu_torch.ops import threefry as tf
from kubernetes_tpu_torch.parallel import sharding as sh
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver import graphs as sg
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu_torch.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
# interpod5k's four kinds: hostPort, hard zone spread, required hostname
# anti-affinity, preferred zone affinity
MIXED = ("ports", "spread", "anti", "pref")


def _nodes(n=48):
    return [MakeNode().name(f"n{i:03}").capacity({"cpu": "4", "memory": "16Gi", "pods": "20"})
            .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:03}").obj() for i in range(n)]


def _pods(n, kinds=MIXED, prefix="p", bad_every=0):
    """``n`` pods cycling through ``kinds``; every ``bad_every``-th requests
    a resource no node has (an invalid scan row in the middle of the
    batch)."""
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        req = {"cpu": "100m", "memory": "256Mi"}
        if bad_every and i % bad_every == bad_every - 1:
            req["example.com/missing"] = "1"
        b = MakePod().name(f"{prefix}{i:04}").label("app", kind).req(req)
        if kind == "ports":
            b = b.host_port(8000 + i % 4)
        elif kind == "spread":
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
        elif kind == "anti":
            b = b.pod_anti_affinity(HOST, {"app": "anti"})
        elif kind == "pref":
            b = b.preferred_pod_affinity(50, ZONE, {"app": "spread"})
        out.append(b.obj())
    return out


def _inputs(nodes, pods):
    vocab = ResourceVocab.build([], nodes)  # a resource no node has stays unknown
    nb = build_node_batch(nodes, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (nb, pb, st, build_port_tensors(pods, pb, slots, {}, nb.padded),
            build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
            build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad))


@pytest.fixture
def emulated(monkeypatch):
    """Graphs engage on the CPU, and a capture records the step, which each
    replay runs again."""
    monkeypatch.setattr(sg, "engages",
                        lambda device, shards, use_nominated: shards == 1 and not use_nominated)
    monkeypatch.setattr(sg.StepGraphs, "capture", lambda self, fn: SimpleNamespace(replay=fn))
    made = []

    class Recorded(tf.Stream):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tf, "Stream", Recorded)
    return made


def _solve(solver, nodes, pods, mode):
    """One solve in ``mode``: its assignments (the handles' read in order),
    and the written-back node state where the mode writes it."""
    inp = _inputs(nodes, pods)
    if mode == "standalone":
        a = solver.solve(*inp, device="cpu")
        return a, {k: getattr(inp[0], k).copy() for k in ("used", "nonzero_used", "pod_count")}
    versions = np.zeros(inp[0].padded, np.int64)
    split = 4 if mode == "chained" else 1
    out = solver.solve(*inp, col_versions=versions, defer_read=True, split=split, device="cpu")
    handles = out if isinstance(out, list) else [out]
    got = np.full(len(pods), -1, np.int32)
    for h in handles:
        got[h.lo : h.lo + h.count] = h.get()
    return got, {}


CASES = {
    # the per-pod scan over interpod5k's four kinds
    "standalone": dict(mode="standalone", pods=lambda: _pods(96)),
    "session": dict(mode="session", pods=lambda: _pods(96)),
    "chained": dict(mode="chained", pods=lambda: _pods(96, bad_every=11)),
    # invalid rows in the middle owe the stream their splits
    "invalid_rows": dict(mode="standalone", pods=lambda: _pods(96, bad_every=7)),
    # the grouped path: chunks of identical plain pods (kind 1) between
    # mixed ones (KIND_SLOW) with invalid rows
    "grouped_slow": dict(mode="standalone", group=16, pods=lambda: (
        _pods(32, kinds=("plain",)) + _pods(48, kinds=("ports", "anti", "spread"), prefix="q",
                                            bad_every=5)
        + _pods(16, kinds=("plain",), prefix="r") + _pods(32, kinds=("anti", "ports"), prefix="s",
                                                          bad_every=6))),
}


@pytest.mark.parametrize("tie", ["first", "random"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_steps_equal_the_eager_steps(emulated, tie, case):
    spec = CASES[case]
    nodes, pods = _nodes(), spec["pods"]()
    cfg = ExactSolverConfig(tie_break=tie, seed=11, group_size=spec.get("group", 1))

    eager = ExactSolver(cfg)
    eager.graphs = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sg, "engages", lambda *a: False)
        want, want_state = _solve(eager, nodes, pods, spec["mode"])
        want_key = emulated[-1].key_words() if tie == "random" else None
    assert eager.graphs is None

    solver = ExactSolver(cfg)
    got, state = _solve(solver, nodes, pods, spec["mode"])
    np.testing.assert_array_equal(got, want)
    for k, v in want_state.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    tm = solver.times
    assert tm.graph_replays > 0 and tm.graph_captures > 0
    assert tm.graph_replays <= tm.scan_steps
    if tie == "random":
        assert solver.graphs.stream.key_words() == want_key
    if spec["mode"] == "standalone" and spec.get("group", 1) == 1:
        # every row splits the key, the invalid ones too
        key = prng.prng_key(cfg.seed)
        for _ in range(_inputs(nodes, pods)[1].padded):
            key = prng.next_key(key)
        assert want_key in (None, key)


def test_graphs_live_across_session_solves_and_recapture_on_new_tables(emulated):
    """Session solves keep their tables' addresses: the second batch only
    replays. A batch with other pod shapes brings other class tables: a new
    epoch, whose graphs are captured anew, and the result still equals the
    eager one."""
    nodes = _nodes()
    cfg = ExactSolverConfig(tie_break="random", seed=3)
    solver = ExactSolver(cfg)
    versions = np.zeros(_inputs(nodes, _pods(4))[0].padded, np.int64)

    def session(s, pods):
        return s.solve(*_inputs(nodes, pods), col_versions=versions.copy(), device="cpu")

    first = _pods(64, prefix="a")
    session(solver, first)
    captured = solver.times.graph_captures
    assert captured == 4  # one per kind
    epoch = solver.graphs.epoch
    session(solver, first)
    assert solver.times.graph_captures == 0 and solver.times.graph_replays == 64
    assert solver.graphs.epoch == epoch

    other = _pods(64, kinds=("ports", "anti"), prefix="b")
    got = session(solver, other)
    assert solver.graphs.epoch != epoch and solver.times.graph_captures == 2
    eager = ExactSolver(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sg, "engages", lambda *a: False)
        for pods in (first, first, other):
            want = session(eager, pods)
    np.testing.assert_array_equal(got, want)


def test_signature_below_the_threshold_steps_eagerly(emulated):
    """A signature with fewer than MIN_STEPS steps in a call keeps the
    eager step; the others replay (less each one's warm-up step)."""
    nodes = _nodes()
    few = sg.MIN_STEPS - 1
    pods = _pods(40, kinds=("ports", "spread")) + _pods(few, kinds=("anti",), prefix="q")
    solver = ExactSolver(ExactSolverConfig(tie_break="first"))
    solver.solve(*_inputs(nodes, pods), device="cpu")
    tm = solver.times
    assert tm.scan_steps == 40 + few
    assert tm.graph_captures == 2 and tm.graph_replays == 40 - 2


@pytest.mark.parametrize("device,shards,nominated,engaged", [
    ("cpu", 1, False, False),
    ("cuda", 1, False, True),
    ("cuda", 2, False, False),
    ("cuda", 1, True, False),
])
def test_engage_rule(device, shards, nominated, engaged):
    assert sg.engages(device, shards, nominated) is engaged


def test_the_cpu_keeps_the_eager_step():
    solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=1))
    solver.solve(*_inputs(_nodes(), _pods(48)), device="cpu")
    assert solver.graphs is None
    assert solver.times.graph_replays == 0 and solver.times.scan_steps == 48


def test_a_mesh_keeps_the_eager_step(emulated):
    """Even where graphs may engage, a mesh of two shards steps eagerly."""
    solver = ExactSolver(ExactSolverConfig(tie_break="first"))
    solver.solve(*_inputs(_nodes(), _pods(48)), mesh=sh.NodeMesh(("cpu", "cpu")))
    assert solver.graphs is None and solver.times.graph_replays == 0


def test_a_nominated_batch_keeps_the_eager_step(emulated):
    """Where graphs may engage, a batch carrying nominated pods steps
    eagerly: its nomination branches and correction rows stay as written."""
    from kubernetes_tpu_torch.tensorize.schema import build_nominated_tensors

    nodes, pods = _nodes(), _pods(48)
    inputs = list(_inputs(nodes, pods))
    nb, pb = inputs[:2]
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    pairs = [(pods[i], (i * 7) % len(nodes)) for i in range(0, 48, 12)]
    inputs[3] = build_port_tensors(pods, pb, slots, {}, nb.padded, nominated=pairs)
    nom = build_nominated_tensors(pairs, nb.vocab, nb.padded, ports=inputs[3])
    slot_of = {p.key: s for p, s in pairs}
    nslot = np.asarray([slot_of.get(p.key, -1) for p in pods], np.int32)
    solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=4))
    solver.solve(*inputs, nominated=nom, nominated_slot=nslot, device="cpu")
    assert solver.graphs is None and solver.times.graph_replays == 0
    assert solver.times.scan_steps == 48


def test_packed_row_views_are_the_pod_rows():
    """The packed row holds each array's row at its offset; its views read
    back every array the step reads."""
    import torch

    from kubernetes_tpu_torch.solver.exact import _pod_inputs

    nodes, pods = _nodes(), _pods(24, bad_every=5)
    nb, pb, st, ports, spread, interpod = _inputs(nodes, pods)
    host = _pod_inputs(pb, st, ports, spread, interpod, None, None, False)
    layout, width = sg.row_layout(host)
    assert width % 8 == 0 and all(off % 8 == 0 for _, _, _, off, _ in layout)
    rows = torch.from_numpy(sg.pack_rows(host, layout, width))
    k, b = host["req_mask"].shape[1], host["pod_takes"].shape[1]
    for i in range(len(pods)):
        x = sg.row_views(rows[i], layout, k, b)
        for name in sg.ROW_NAMES + ("pod_takes",):
            np.testing.assert_array_equal(x[name].numpy(), host[name][i], err_msg=name)
        np.testing.assert_array_equal(x["req"].numpy(), pb.req[i])


def test_registry_series_and_issue_span_count_the_graphs(emulated):
    """The Scheduler hands each solve's replays and captures to its
    StageProfiler, which folds them into the two registry series and its
    ledger; the ``issue`` span carries them beside ``scan_steps``."""
    cs = ClusterState()
    cs.create_nodes(_nodes(24))
    for p in _pods(64):
        cs.create_pod(p)
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=32, obs=ObsConfig(profile=True, spans=True),
        solver=ExactSolverConfig(tie_break="random", seed=5, group_size=1)), device="cpu")
    before = (metrics.solve_graph_replays_total.value(), metrics.solve_graph_captures_total.value(),
              metrics.solve_steps_total.labels("scan_steps").value())
    res = sched.run_pipelined()
    assert sum(len(r.scheduled) for r in res) == 64
    entries = sched.telemetry.profiler.snapshot()["recent"]
    replays = sum(e["graph_replays"] for e in entries)
    captures = sum(e["graph_captures"] for e in entries)
    steps = sum(e["scan_steps"] for e in entries)
    assert steps == 64 and 0 < replays < steps and captures >= 4
    assert all(type(e[k]) is int for e in entries for k in GRAPH_COUNTS)
    assert metrics.solve_graph_replays_total.value() - before[0] == replays
    assert metrics.solve_graph_captures_total.value() - before[1] == captures
    assert metrics.solve_steps_total.labels("scan_steps").value() - before[2] == steps
    spans = [d for d in map(json.loads, sched.flight.lines())
             if d.get("k") == "span" and d.get("name") == "issue"]
    assert spans
    assert sum(s["attrs"]["graph_replays"] for s in spans) == replays
    assert sum(s["attrs"]["graph_captures"] for s in spans) == captures
    assert all("scan_steps" in s["attrs"] for s in spans)
    for series in (metrics.solve_graph_replays_total, metrics.solve_graph_captures_total):
        assert any(series is m for m in metrics.PORT_SERIES)
