"""The port's convex-relaxation planner against the JAX package's, on the
CPU: every property of tests/test_relax.py, held on the port, and on the
paired fixtures its agreement with the JAX planner.

The iterations are float32 matmuls, softmaxes and ``exp`` whose
summation order differs between torch and XLA, so the two are gated, not
bit for bit (ROADMAP parity rules). The tolerance, stated after measuring
the paired fixtures here: the dual-ascent iteration count and the pods
the rounded relaxation seats are equal, the per-node dual prices agree
within ``PRICE_RTOL`` / ``PRICE_ATOL`` (measured: identical on every
fixture), the residual within ``RES_RTOL`` (measured: at most one float32
ulp apart) and at least ``MIN_EQUAL_SHARE`` of the assignments are equal
(measured: all of them).
"""

import numpy as np
import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.ops.oracle.profile import FullOracle, make_oracle_nodes
from kubernetes_tpu.solver.relax import RelaxConfig as RefRelaxConfig
from kubernetes_tpu.solver.relax import RelaxSolver as RefRelaxSolver
from kubernetes_tpu.solver.single_shot import SingleShotConfig as RefSingleShotConfig
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.tensorize.plugins import build_static_tensors
from kubernetes_tpu.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api.wrappers import MakePod as PortMakePod
from kubernetes_tpu_torch.solver.budget import (
    IndexWidthError,
    assert_index_headroom,
    relax_estimate,
)
from kubernetes_tpu_torch.solver.relax import RelaxConfig, RelaxSolver, group_prices
from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig
from kubernetes_tpu_torch.state.queue import PriorityQueue
from kubernetes_tpu_torch.utils.clock import FakeClock

from _torch_sched_pair import PARITY, Pair

ZONE = "topology.kubernetes.io/zone"
PRICE_RTOL, PRICE_ATOL = 1e-5, 1e-3
RES_RTOL = 1e-5
MIN_EQUAL_SHARE = 0.99


def solve_relax(nodes, pods, repair=True, **cfg):
    """The port's plan on the JAX package's tensors, held to the JAX
    planner's within the stated tolerance: (assignments, stats, batch)."""
    vocab = ResourceVocab.build(pods, nodes)
    nbatch = build_node_batch(nodes, vocab=vocab)
    pbatch = build_pod_batch(pods, vocab)
    slot_nodes = list(nodes) + [None] * (nbatch.padded - len(nodes))
    static = build_static_tensors(pods, pbatch, slot_nodes, nbatch.padded)
    port_in = (convert.node_batch(nbatch), convert.pod_batch(pbatch),
               convert.static_tensors(static))
    ref = RefRelaxSolver(RefRelaxConfig(**cfg),
                         repair=RefSingleShotConfig() if repair else None)
    want = np.asarray(ref.solve(nbatch, pbatch, static))
    solver = RelaxSolver(RelaxConfig(**cfg), repair=SingleShotConfig() if repair else None,
                         device="cpu")
    got = solver.solve(*port_in)
    stats, rst = solver.last, ref.last
    assert stats.iterations == rst.iterations
    assert stats.placed_relaxed == rst.placed_relaxed
    assert stats.repaired_pods == rst.repaired_pods
    np.testing.assert_allclose(stats.residual, rst.residual, rtol=RES_RTOL)
    np.testing.assert_allclose(stats.node_prices, rst.node_prices, rtol=PRICE_RTOL,
                               atol=PRICE_ATOL)
    assert stats.node_prices.dtype == np.float32
    assert np.mean(got == want) >= MIN_EQUAL_SHARE, np.mean(got == want)
    assert got.dtype == np.int32
    return got, stats, port_in[0]


def check_feasible(nodes, pods, assignments):
    """Every placement respects allocatable + pod-count + schedulability."""
    used = {n.name: {} for n in nodes}
    count = {n.name: 0 for n in nodes}
    for pod, a in zip(pods, assignments):
        if a < 0:
            continue
        node = nodes[a]
        assert not node.unschedulable
        count[node.name] += 1
        for k, v in pod.resource_request().items():
            used[node.name][k] = used[node.name].get(k, 0) + v
    for n in nodes:
        assert count[n.name] <= n.allowed_pod_number, n.name
        for k, v in used[n.name].items():
            assert v <= n.allocatable.get(k, 0), (n.name, k)


def mk_nodes(n, cpu="8", mem="32Gi", pods="20", zone_count=3):
    return [MakeNode().name(f"n{i:03}").capacity({"cpu": cpu, "memory": mem, "pods": pods})
            .label(ZONE, f"z{i % zone_count}").obj() for i in range(n)]


def mk_pods(n, cpu="500m", mem="1Gi", prio=None):
    out = []
    for i in range(n):
        b = MakePod().name(f"p{i:04}").req({"cpu": cpu, "memory": mem})
        if prio is not None:
            b = b.priority(prio[i % len(prio)])
        out.append(b.obj())
    return out


# -- 1. feasibility ------------------------------------------------------


def test_all_place_when_capacity_suffices():
    nodes, pods = mk_nodes(8), mk_pods(64)
    a, stats, _ = solve_relax(nodes, pods)
    assert all(x >= 0 for x in a)
    check_feasible(nodes, pods, a)
    assert stats.placed_total == 64
    assert stats.iterations >= 1


def test_no_overcommit_under_structural_overload():
    nodes, pods = mk_nodes(4, pods="10"), mk_pods(160, cpu="1")
    a, _, _ = solve_relax(nodes, pods)
    check_feasible(nodes, pods, a)
    placed = int((a >= 0).sum())
    assert 28 <= placed < 160


def test_rounding_clamp_without_repair_still_feasible():
    nodes, pods = mk_nodes(4, pods="10"), mk_pods(120, cpu="1")
    a, stats, _ = solve_relax(nodes, pods, repair=False)
    check_feasible(nodes, pods, a)
    assert stats.repaired_pods == 0


def test_static_mask_honored():
    nodes = mk_nodes(4) + [
        MakeNode().name("tainted").capacity({"cpu": "64", "memory": "256Gi", "pods": "110"})
        .taint("dedicated", "gpu", "NoSchedule").obj()
    ]
    pods = mk_pods(40)
    a, _, _ = solve_relax(nodes, pods)
    check_feasible(nodes, pods, a)
    assert not any(x == len(nodes) - 1 for x in a)


# -- 2. rounding-repair parity vs the oracle -----------------------------


def _oracle_replay(nodes, pods, assigned, nbatch):
    names = [nbatch.names[a] if 0 <= a < nbatch.num_nodes else None for a in assigned]
    return FullOracle(make_oracle_nodes(nodes)).validate_feasible(
        pods, [int(a) for a in assigned], names=names)


def test_scarce_plan_passes_oracle_feasibility_replay():
    rng = np.random.default_rng(7)
    nodes = mk_nodes(12, pods="12")
    pods = [MakePod().name(f"p{i:04}").req({"cpu": f"{int(rng.integers(2, 9)) * 250}m",
                                            "memory": "1Gi"})
            .priority(int(rng.integers(0, 8))).obj() for i in range(180)]
    a, _, nbatch = solve_relax(nodes, pods)
    errors = _oracle_replay(nodes, pods, a, nbatch)
    assert not errors, "\n".join(errors[:5])


def test_fragmented_plan_passes_oracle_feasibility_replay():
    nodes = [MakeNode().name(f"small{i:02}").capacity({"cpu": "2", "memory": "4Gi", "pods": "8"})
             .label(ZONE, f"z{i % 3}").obj() for i in range(10)] + [
        MakeNode().name(f"big{i}").capacity({"cpu": "32", "memory": "128Gi", "pods": "60"})
        .label(ZONE, f"z{i}").obj() for i in range(2)]
    pods = mk_pods(24, cpu="3", mem="12Gi") + [
        MakePod().name(f"filler{i:03}").req({"cpu": "250m", "memory": "512Mi"}).obj()
        for i in range(40)]
    a, _, nbatch = solve_relax(nodes, pods)
    check_feasible(nodes, pods, a)
    errors = _oracle_replay(nodes, pods, a, nbatch)
    assert not errors, "\n".join(errors[:5])
    for x in a[:24]:
        if x >= 0:
            assert nodes[x].name.startswith("big"), nodes[x].name


def test_objective_ratio_vs_greedy_anchor():
    rng = np.random.default_rng(11)
    nodes = mk_nodes(16, pods="16")
    pods = [MakePod().name(f"p{i:04}").req({"cpu": f"{int(rng.integers(1, 7)) * 250}m",
                                            "memory": "1Gi"})
            .priority(int(rng.integers(0, 5))).obj() for i in range(200)]
    a, _, _ = solve_relax(nodes, pods)
    anchor, _ = FullOracle(make_oracle_nodes(nodes)).schedule(pods)
    assert int((a >= 0).sum()) >= 0.95 * sum(1 for x in anchor if x >= 0)


# -- 3. dual prices ------------------------------------------------------


def test_dual_prices_zero_when_uncontended():
    _, stats, nbatch = solve_relax(mk_nodes(6), mk_pods(6))
    groups = [f"z{i % 3}" for i in range(nbatch.padded)]
    prices = group_prices(stats, groups, valid=nbatch.valid)
    assert set(prices) == {"z0", "z1", "z2"}
    assert all(v < 1e-3 for v in prices.values()), prices


def test_dual_prices_positive_under_contention_and_sorted():
    _, stats, nbatch = solve_relax(mk_nodes(6, pods="8"), mk_pods(120, cpu="1"))
    groups = [f"z{i % 3}" for i in range(nbatch.padded)]
    prices = group_prices(stats, groups, valid=nbatch.valid)
    assert list(prices) == sorted(prices)
    assert all(v > 0.0 for v in prices.values()), prices


# -- 4. planner routing --------------------------------------------------


def test_plan_engine_routing():
    from kubernetes_tpu_torch.rebalance.planner import RELAX_PLAN_CELLS, plan_engine

    assert plan_engine(1000, 128) == "auction"
    assert plan_engine(RELAX_PLAN_CELLS // 1024, 1024) == "relax"
    assert plan_engine(10, 8, engine="relax") == "relax"
    assert plan_engine(10**9, 10**6, engine="auction") == "auction"
    with pytest.raises(ValueError):
        plan_engine(10, 8, engine="simplex")


# -- 5. warm-start plumbing ----------------------------------------------


def _queued(q):
    return [i.pod.name for i in q.pop_batch(100)]


def _qpod(name, prio=None):
    b = PortMakePod().name(name).req({"cpu": "100m"})
    if prio is not None:
        b = b.priority(prio)
    return b.obj()


def test_reorder_active_permutes_only_within_priority_band():
    clock = FakeClock()
    q = PriorityQueue(clock)
    for name, prio in [("a", 1), ("b", 1), ("c", 1), ("hi", 9)]:
        q.add(_qpod(name, prio))
        clock.advance(1)
    assert q.reorder_active({"default/c": 0, "default/a": 1, "default/hi": 2}) == 3
    assert _queued(q) == ["hi", "c", "a", "b"]


def test_reorder_active_refuses_custom_less():
    q = PriorityQueue(FakeClock(), less=lambda x, y: x.pod.name < y.pod.name)
    q.add(_qpod("a"))
    assert q.reorder_active({"default/a": 0}) == 0


def test_reorder_active_drops_stale_entries():
    clock = FakeClock()
    q = PriorityQueue(clock)
    for name in ("a", "b", "c"):
        q.add(_qpod(name, 1))
        clock.advance(1)
    (popped,) = q.pop_batch(1)
    assert popped.pod.name == "a"
    assert q.reorder_active({"default/c": 0, "default/b": 1}) == 2
    assert _queued(q) == ["c", "b"]


def _drain_pair(warm):
    cs = ClusterState()
    for i in range(12):
        cs.create_node(MakeNode().name(f"n{i:03}").capacity(
            {"cpu": "16", "memory": "64Gi", "pods": "110"}).label(ZONE, f"z{i % 3}").obj())
    for i in range(96):
        cs.create_pod(MakePod().name(f"pod-{i:04}").req({"cpu": "100m", "memory": "256Mi"})
                      .priority((0, 3, 7)[i % 3]).obj())
    return Pair(cs, solver=dict(PARITY, group_size=8), batch_size=16,
                backlog_warm_start=warm)


WARM_KEYS = ("warm_start_ranked", "relax_iterations", "drained", "chunks", "chain_fraction")


def test_drain_warm_start_ranks_and_does_not_regress():
    """Both packages' drains, cold and warm: the warm start ranks the same
    pods in the same iterations, binds every pod as the JAX package does,
    and does not regress completeness or the chain fraction."""
    cold = _drain_pair(False)
    rep_cold, port_cold = cold.run("drain", chunk_pods=16, budget_bytes=8 << 30)
    warm = _drain_pair(True)
    rep_warm, port_warm = warm.run("drain", chunk_pods=16, budget_bytes=8 << 30)
    for rep, port in ((rep_cold, port_cold), (rep_warm, port_warm)):
        assert {k: getattr(port, k) for k in WARM_KEYS} == {k: getattr(rep, k) for k in WARM_KEYS}
        np.testing.assert_allclose(port.relax_residual, rep.relax_residual, rtol=RES_RTOL)
    assert port_cold.warm_start_ranked == 0
    assert port_warm.warm_start_ranked >= 1 and port_warm.relax_iterations >= 1
    assert port_warm.drained == port_cold.drained == 96
    assert port_warm.chain_fraction >= port_cold.chain_fraction
    ref_b, port_b = warm.bindings()
    assert port_b == ref_b and all(port_b.values())


def test_drain_warm_start_explicit_flag_overrides_config():
    pair = _drain_pair(False)
    rep, port = pair.run("drain", chunk_pods=16, budget_bytes=8 << 30, warm_start=True)
    assert port.warm_start_ranked == rep.warm_start_ranked >= 1


def test_relax_plan_backlog_matches_jax():
    pair = _drain_pair(False)
    ref_plan = pair.ref.relax_plan_backlog()
    plan = pair.port.relax_plan_backlog()
    assert set(plan) == set(ref_plan)
    same = sum(plan[k] == ref_plan[k] for k in plan)
    assert same >= MIN_EQUAL_SHARE * len(plan)
    assert all(v is not None for v in plan.values())


# -- 6. index-headroom audit at the mega-plan shape ----------------------


def test_relax_estimate_2m_shape_has_headroom():
    est = relax_estimate(200_000, 2_000_000, rc=8)
    assert_index_headroom(est.pod_pad, est.node_pad, rc_pad=est.rc_pad)
    assert est.rc_pad * est.node_pad < 2**31
    assert est.pod_pad * est.node_pad < 2**63
    assert (est.rc_pad - 1) * (1 << 32) + est.pod_pad < 1 << 62
    assert est.per_device_bytes >= est.sharded_bytes + est.replicated_bytes


@pytest.mark.parametrize("nodes,pods,rc", [
    (1_000, 50_000, 8), (102_400, 512_000, 64), (200_000, 2_000_000, 8)])
def test_headroom_property_flattened_products_fit(nodes, pods, rc):
    est = relax_estimate(nodes, pods, rc=rc)
    assert_index_headroom(est.pod_pad, est.node_pad, rc_pad=est.rc_pad)
    assert est.rc_pad * est.node_pad < 2**31
    assert (est.rc_pad - 1) * (1 << 32) + est.pod_pad < 1 << 62


def test_headroom_rejects_overflowing_rc_axis():
    with pytest.raises(IndexWidthError):
        assert_index_headroom(1_000, 2**30, rc_pad=2**33)


def test_headroom_rejects_sort_key_collision_with_sentinel():
    with pytest.raises(IndexWidthError):
        assert_index_headroom(1_000, 1_000, rc_pad=1 << 31)


# -- the port's own contract ---------------------------------------------


def test_mesh_raises_naming_item_11():
    """A mesh solve runs: on a 2-shard CPU mesh the plan seats what the
    unsharded one seats (this small shape converges alike; the float32
    tolerance is tests/test_torch_sharding.py's), and a padding that does
    not divide over the shards raises ValueError."""
    from kubernetes_tpu_torch.parallel.sharding import NodeMesh

    nodes, pods = mk_nodes(2), mk_pods(2)
    vocab = ResourceVocab.build(pods, nodes)
    nb, pb = build_node_batch(nodes, vocab=vocab), build_pod_batch(pods, vocab)
    want = RelaxSolver(device="cpu").solve(convert.node_batch(nb), convert.pod_batch(pb))
    got = RelaxSolver(device="cpu").solve(convert.node_batch(nb), convert.pod_batch(pb),
                                          mesh=NodeMesh(("cpu", "cpu")))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not a multiple of the mesh size"):
        RelaxSolver(device="cpu").solve(convert.node_batch(nb), convert.pod_batch(pb),
                                        mesh=NodeMesh(("cpu",) * 3))
