"""The port's device session (solver/session.py) and the solve modes built
on it -- session solves with dirty-column heals, deferred heals, deferred
reads, split sub-batches, the streaming carry -- against standalone solves
and against the JAX package's session, on the CPU; and the port's copy of
solver/budget.py against the JAX package's.

The caller plays the scheduler: it keeps host truth (the pods placed per
node), tensorizes each batch against it, applies each solve's placements,
and bumps the snapshot version of every column it writes, as
state/snapshot.py does, so the session heals those columns. An external
binding between batches dirties columns the session has not seen. In
tie_break="first" every mode equals the standalone solve of the same batch
on the same host truth, and the JAX package's session, bit for bit."""

import dataclasses

import numpy as np
import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.solver import budget as ref_budget
from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
from kubernetes_tpu.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu.tensorize.spread import build_spread_tensors
from kubernetes_tpu_torch import convert, metrics
from kubernetes_tpu_torch.solver import budget
from kubernetes_tpu_torch.solver.exact import ExactSolver
from kubernetes_tpu_torch.solver.session import (
    CLASS_CACHE_SIZE,
    DeferredAssignments,
    SessionDrainRequired,
)

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
GROUP = 16


def _pods(batch, n, kinds=("spread", "plain", "anti")):
    """``n`` pods in runs of GROUP identical pods, the kinds cycling."""
    out = []
    for i in range(n):
        kind = kinds[(i // GROUP) % len(kinds)]
        b = MakePod().name(f"b{batch}-{i:03}").label("app", kind).req(
            {"cpu": "500m", "memory": "1Gi"})
        if kind == "spread":
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
        elif kind == "anti":
            b = b.pod_anti_affinity(HOST, {"app": "anti"})
        out.append(b.obj())
    return out


class Cluster:
    """Host truth: nodes, the pods placed on each, the column versions."""

    def __init__(self, n_nodes=48):
        self.nodes = [
            MakeNode().name(f"n-{i:03}").capacity({"cpu": "4", "memory": "16Gi", "pods": "20"})
            .label(ZONE, f"z{i % 3}").label(HOST, f"n-{i:03}").obj()
            for i in range(n_nodes)
        ]
        self.placed: dict[str, list] = {}
        self.versions = np.zeros(256, np.int64)

    def tensorize(self, pods):
        """The JAX package's tensorize of a batch against host truth."""
        nodes = self.nodes
        vocab = ResourceVocab.build(pods, nodes)
        nb = build_node_batch(nodes, self.placed, vocab=vocab)
        pb = build_pod_batch(pods, vocab, pad=-(-len(pods) // GROUP) * GROUP)
        slots = list(nodes) + [None] * (nb.padded - len(nodes))
        by_slot = {i: self.placed[n.name] for i, n in enumerate(nodes) if n.name in self.placed}
        st = build_static_tensors(pods, pb, slots, nb.padded)
        return (nb, pb, st, build_port_tensors(pods, pb, slots, by_slot, nb.padded),
                build_spread_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad),
                build_interpod_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad))

    def apply(self, pods, assignments):
        for p, a in zip(pods, assignments):
            if a >= 0:
                self.placed.setdefault(self.nodes[a].name, []).append(p)
                self.versions[a] += 1

    def external(self, slot, name):
        """A pod bound by someone else: host truth moves under the session."""
        pod = MakePod().name(name).req({"cpu": "1500m", "memory": "2Gi"}).node(
            self.nodes[slot].name).obj()
        self.placed.setdefault(self.nodes[slot].name, []).append(pod)
        self.versions[slot] += 1


def _cfg(group=GROUP):
    return RefConfig(tie_break="first", balanced_fdtype="float64", group_size=group)


def standalone(cluster, pods, group=GROUP):
    inputs = convert.solve_inputs(*cluster.tensorize(pods))
    return ExactSolver(convert.solver_config(_cfg(group))).solve(*inputs, device="cpu")


def _gather(handles):
    out = np.full(sum(h.count for h in handles), -1, np.int32)
    for h in handles:
        out[h.lo : h.lo + h.count] = h.get()
    return out


@pytest.mark.parametrize("group", [GROUP, 0], ids=["grouped", "scan"])
def test_session_batches_with_dirty_columns(group):
    """Three batches through one session, with heals of the columns the
    caller applied and of columns an external binding dirtied: each equals
    the standalone solve and the JAX package's session."""
    cluster = Cluster()
    port = ExactSolver(convert.solver_config(_cfg(group)))
    ref = RefSolver(_cfg(group))
    h2d = []
    for b in range(3):
        pods = _pods(b, 64)
        want = standalone(cluster, pods, group)
        h2d0 = metrics.h2d_bytes_total.value()
        got = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)),
                         col_versions=cluster.versions.copy(), device="cpu")
        h2d.append(metrics.h2d_bytes_total.value() - h2d0)
        ref_got = ref.solve(*cluster.tensorize(pods), col_versions=cluster.versions.copy())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref_got)
        cluster.apply(pods, got)
        cluster.external(3 * b + 1, f"ext-{b}")
    assert dict(port.dispatch_counts) == dict(ref.dispatch_counts)
    # only the dirty columns and the per-batch rows went up after the first
    assert 0 < h2d[1] < h2d[0] and 0 < h2d[2] < h2d[0], h2d


def test_deferred_heal_and_drain_required():
    """allow_heal=False leaves dirty columns for a later sync (the JAX
    package's semantics, compared solve for solve), and a shape change in
    that mode raises SessionDrainRequired before touching the session."""
    cluster = Cluster()
    port = ExactSolver(convert.solver_config(_cfg()))
    ref = RefSolver(_cfg())
    pods = _pods(0, 48)
    got = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)),
                     col_versions=cluster.versions.copy(), device="cpu")
    ref.solve(*cluster.tensorize(pods), col_versions=cluster.versions.copy())
    cluster.apply(pods, got)
    cluster.external(5, "ext")
    seen = port._session.seen_versions.copy()
    pods = _pods(1, 48)
    got = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)),
                     col_versions=cluster.versions.copy(), allow_heal=False, device="cpu")
    want = ref.solve(*cluster.tensorize(pods), col_versions=cluster.versions.copy(),
                     allow_heal=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port._session.seen_versions, seen)

    bigger = Cluster(160)  # a node padding of 256 instead of 128
    inputs = convert.solve_inputs(*bigger.tensorize(_pods(2, 16)))
    persist = port._session.persist
    with pytest.raises(SessionDrainRequired):
        port.solve(*inputs, col_versions=bigger.versions.copy(), allow_heal=False,
                   device="cpu")
    assert port._session.persist is persist
    got = port.solve(*inputs, col_versions=bigger.versions.copy(), device="cpu")
    np.testing.assert_array_equal(got, standalone(bigger, _pods(2, 16)))


def test_defer_read_handle():
    cluster = Cluster()
    pods = _pods(0, 40)
    want = standalone(cluster, pods)
    port = ExactSolver(convert.solver_config(_cfg()))
    handle = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)),
                        col_versions=cluster.versions.copy(), defer_read=True, device="cpu")
    assert isinstance(handle, DeferredAssignments)
    assert (handle.lo, handle.count) == (0, 40)
    handle.wait()
    got = handle.get()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # standalone mode reads at once, as the JAX package does
    got = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)), defer_read=True,
                     device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group,n_pods,split,handles", [
    (GROUP, 64, 4, 4), (GROUP, 40, 4, 3), (0, 64, 3, 2), (GROUP, 64, 1, 1)],
    ids=["grouped4", "padded_tail", "scan_clamped", "unsplit_list"])
def test_split_equals_unsplit(group, n_pods, split, handles):
    """Sub-batches placed on the state the previous ones left equal the
    unsplit solve; the dispatch counts equal the JAX package's."""
    cluster = Cluster()
    pods = _pods(0, n_pods)
    want = standalone(cluster, pods, group)
    port = ExactSolver(convert.solver_config(_cfg(group)))
    ref = RefSolver(_cfg(group))
    kw = dict(col_versions=cluster.versions.copy(), defer_read=True, split=split)
    got = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)), device="cpu", **kw)
    ref_got = ref.solve(*cluster.tensorize(pods), **kw)
    want_list = split > 1
    assert isinstance(got, list) == want_list
    got = got if want_list else [got]
    assert len(got) == handles == (len(ref_got) if want_list else 1)
    np.testing.assert_array_equal(_gather(got), want)
    if want_list:
        assert [(h.lo, h.count) for h in got] == [(h.lo, h.count) for h in ref_got]
    assert dict(port.dispatch_counts) == dict(ref.dispatch_counts)
    # the session carried the split solve's placements: the next batch
    # equals its standalone solve on the applied host truth
    cluster.apply(pods, want)
    nxt = _pods(1, 32)
    np.testing.assert_array_equal(
        port.solve(*convert.solve_inputs(*cluster.tensorize(nxt)),
                   col_versions=cluster.versions.copy(), device="cpu"),
        standalone(cluster, nxt, group))


def _stream_batch(cluster, port, ref, pods, **kw):
    p_in = convert.solve_inputs(*cluster.tensorize(pods))
    r_in = cluster.tensorize(pods)
    key = port.stream_chain_key(*p_in[:6])
    r_key = ref.stream_chain_key(*r_in[:6])
    got = port.solve(*p_in, col_versions=cluster.versions.copy(), defer_read=True,
                     chain_key=key, device="cpu", **kw)
    r_got = ref.solve(*r_in, col_versions=cluster.versions.copy(), defer_read=True,
                      chain_key=r_key, **kw)
    return _gather(got), _gather(r_got), key


def test_stream_chain_across_batches():
    """A batch keeps its carried state on the card (stream_carry_out); the
    next batch, with the same key, starts from it (chain_occupancy) and
    equals its standalone solve on the applied host truth, as the JAX
    package's chain does. The first batch runs as two chained sub-batches."""
    cluster = Cluster()
    port = ExactSolver(convert.solver_config(_cfg()))
    ref = RefSolver(_cfg())
    kinds = ("spread", "plain")
    pods = _pods(0, 64, kinds)
    want = standalone(cluster, pods)
    got, r_got, key = _stream_batch(cluster, port, ref, pods, stream_carry_out=True, split=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, r_got)
    cluster.apply(pods, got)
    port.note_stream_applied(cluster.versions.copy())
    ref.note_stream_applied(cluster.versions.copy())
    nxt = _pods(1, 64, kinds)
    p_key = port.stream_chain_key(*convert.solve_inputs(*cluster.tensorize(nxt))[:6])
    assert p_key == key and port.can_chain(p_key, cluster.versions.copy())
    want = standalone(cluster, nxt)
    # the streaming dispatcher defers heals while a solve is in flight: the
    # applied columns are already in the carry
    got, r_got, _ = _stream_batch(cluster, port, ref, nxt, chain_occupancy=True,
                                  stream_carry_out=True, allow_heal=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, r_got)
    assert dict(port.dispatch_counts) == dict(ref.dispatch_counts)
    assert port.dispatch_counts["stream_chained"] == 1


def test_heal_drops_the_stream_carry():
    """The carry shares the session's fit tensors: a heal writes them in
    place, so it must drop the carry, and a chain on it is refused."""
    cluster = Cluster()
    port = ExactSolver(convert.solver_config(_cfg()))
    kinds = ("spread", "plain")
    pods = _pods(0, 32, kinds)
    handles = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)),
                         col_versions=cluster.versions.copy(), defer_read=True,
                         stream_carry_out=True, chain_key=("k",), device="cpu")
    got = _gather(handles)
    carry = port._session.stream_carry
    assert carry is not None and carry["i64"] is port._session.persist["i64"]
    cluster.apply(pods, got)
    port.note_stream_applied(cluster.versions.copy())
    assert port.can_chain(("k",), cluster.versions.copy())
    cluster.external(7, "ext")
    assert not port.can_chain(("k",), cluster.versions.copy())
    nxt = _pods(1, 32, kinds)
    with pytest.raises(ValueError, match="chain_occupancy"):
        port.solve(*convert.solve_inputs(*cluster.tensorize(nxt)),
                   col_versions=cluster.versions.copy(), defer_read=True,
                   chain_occupancy=True, chain_key=("k",), device="cpu")
    # a stream solve that heals: the carry is gone before the heal writes
    # the shared tensors, and the result is the standalone one
    cluster2 = Cluster()
    port2 = ExactSolver(convert.solver_config(_cfg()))
    port2.solve(*convert.solve_inputs(*cluster2.tensorize(pods)),
                col_versions=cluster2.versions.copy(), defer_read=True,
                stream_carry_out=True, chain_key=("k",), device="cpu")
    cluster2.apply(pods, got)
    cluster2.external(7, "ext")
    want = standalone(cluster2, nxt)
    got = port2.solve(*convert.solve_inputs(*cluster2.tensorize(nxt)),
                      col_versions=cluster2.versions.copy(), device="cpu")
    assert port2._session.stream_carry is None
    np.testing.assert_array_equal(got, want)


def test_class_table_cache_and_reset():
    """Class tables dedupe by content (a hit uploads nothing), hold
    CLASS_CACHE_SIZE entries, and survive reset_session."""
    cluster = Cluster()
    port = ExactSolver(convert.solver_config(_cfg()))
    inputs = convert.solve_inputs(*cluster.tensorize(_pods(0, 16)))
    port.solve(*inputs, col_versions=cluster.versions.copy(), device="cpu")
    s = port._session
    assert len(s.class_cache) == 1
    static, spread, interpod = inputs[2], inputs[4], inputs[5]
    assert s.class_tables(static, spread, interpod)[1] == 0
    for i in range(CLASS_CACHE_SIZE):
        other = dataclasses.replace(static, image_score=static.image_score + i + 1)
        assert s.class_tables(other, spread, interpod)[1] > 0
    assert len(s.class_cache) == CLASS_CACHE_SIZE
    assert s.class_tables(static, spread, interpod)[1] > 0  # the first entry was evicted
    port.reset_session()
    assert port._session.persist is None and len(port._session.class_cache) == CLASS_CACHE_SIZE


def test_solve_audits_index_width():
    cluster = Cluster()
    inputs = list(convert.solve_inputs(*cluster.tensorize(_pods(0, 16))))
    inputs[4] = dataclasses.replace(inputs[4], d_pad=1 << 31)
    with pytest.raises(budget.IndexWidthError):
        ExactSolver(convert.solver_config(_cfg())).solve(*inputs, device="cpu")


# -- solver/budget.py ----------------------------------------------------------

SHAPES = [
    budget.DrainShape(nodes=300, chunk_pods=256, group=64),
    budget.DrainShape(nodes=1000, chunk_pods=1024, group=64),
    budget.DrainShape(nodes=10_000, chunk_pods=4096, group=64),
    budget.DrainShape(nodes=10_000, chunk_pods=4096, group=64, mesh_devices=8),
    budget.DrainShape(nodes=10_000, chunk_pods=512, group=64, spread=True, interpod=True),
    budget.DrainShape(nodes=1000, chunk_pods=200, group=64),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s.nodes}x{s.chunk_pods}")
def test_budget_estimates_equal_reference(shape):
    ref_shape = ref_budget.DrainShape(**dataclasses.asdict(shape))
    assert dataclasses.asdict(budget.estimate(shape)) == dataclasses.asdict(
        ref_budget.estimate(ref_shape))
    full = budget.estimate(shape)
    for b in (full.per_device_bytes, full.per_device_bytes - 1, full.per_device_bytes // 3):
        try:
            want = ref_budget.plan_chunk(ref_shape, b)
        except ref_budget.BudgetExceeded:
            with pytest.raises(budget.BudgetExceeded):
                budget.plan_chunk(shape, b)
            continue
        got = budget.plan_chunk(shape, b)
        assert (dataclasses.asdict(got[0]), got[1]) == (dataclasses.asdict(want[0]), want[1])
    with pytest.raises(budget.BudgetExceeded):
        budget.plan_chunk(shape, 1000)


def test_budget_paddings_and_headroom_equal_reference():
    for n, mult in ((1, 1), (300, 1), (100_003, 8), (130, 6)):
        assert budget.node_padding(n, mult) == ref_budget.node_padding(n, mult)
    for p, g in ((256, 64), (200, 64), (0, 64)):
        assert budget.pod_padding(p, g) == ref_budget.pod_padding(p, g)
    cases = [
        dict(pod_pad=524_288, node_pad=131_072, d_pad=131_072, group=1024),
        dict(pod_pad=524_288, node_pad=131_072),
        dict(pod_pad=1 << 31, node_pad=1024),
        dict(pod_pad=1024, node_pad=1 << 31),
        dict(pod_pad=1024, node_pad=1024, d_pad=1 << 21, group=1 << 11),
        dict(pod_pad=1024, node_pad=1024, rc_pad=1 << 31),
    ]
    for kw in cases:
        try:
            ref_budget.assert_index_headroom(**kw)
        except ref_budget.IndexWidthError:
            with pytest.raises(budget.IndexWidthError):
                budget.assert_index_headroom(**kw)
        else:
            budget.assert_index_headroom(**kw)
    assert budget.split_fleet_budget(10, 3, replica_index=1) == ref_budget.split_fleet_budget(
        10, 3, replica_index=1)
    assert budget.WORKSPACE_FACTOR == ref_budget.WORKSPACE_FACTOR
    assert budget.device_budget_bytes(12345) == 12345
    # no card here: the conservative floor, as the JAX package on the CPU
    assert budget.device_budget_bytes() == budget.DEFAULT_DEVICE_BUDGET_BYTES
