"""The port's single-shot auction against the JAX package's, on the CPU.

Every fixture of tests/test_single_shot.py, tensorized once by the JAX
package and carried across with ``convert``: the port's
``SingleShotSolver`` (``device="cpu"``) must give the JAX auction's
assignments, written-back ``used`` / ``pod_count`` and round count (main +
repair) bit for bit. The auction is integer arithmetic over stable sorts
with one correctly rounded float32 division, so there is no tolerance.
Each fixture also keeps the file's own property asserts on the port's
result. ``dense_ties`` builds headroom ties on every node, which pins the
top-T tie order (lower node index first, as ``lax.top_k``).
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.server.bulk import columnar_pod_batch
from kubernetes_tpu.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu.solver.single_shot import SingleShotConfig as RefConfig
from kubernetes_tpu.solver.single_shot import SingleShotSolver as RefSolver
from kubernetes_tpu.solver.single_shot import _single_shot_jit
from kubernetes_tpu.solver.single_shot import request_classes as ref_request_classes
from kubernetes_tpu.tensorize.plugins import build_static_tensors, trivial_static_tensors
from kubernetes_tpu.tensorize.schema import (
    NodeBatch,
    ResourceVocab,
    build_node_batch,
    build_pod_batch,
    pad_to,
)
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig, SingleShotSolver


def ref_inputs(nodes, pods):
    vocab = ResourceVocab.build(pods, nodes)
    nbatch = build_node_batch(nodes, vocab=vocab)
    pbatch = build_pod_batch(pods, vocab)
    slot_nodes = list(nodes) + [None] * (nbatch.padded - len(nodes))
    static = build_static_tensors(pods, pbatch, slot_nodes, nbatch.padded)
    return nbatch, pbatch, static


def ref_run(nb, pb, static, **cfg):
    """The JAX auction on the solver's own inputs: (assignments, used,
    pod_count, rounds). Its ``solve`` gives the same assignments and node
    state (checked here) but not the round count, which the jitted
    function returns."""
    c = RefConfig(**cfg)
    if static is None:
        static = trivial_static_tensors(pb, nb.padded, nb.schedulable)
    rc_req, rc_static, rc_of = ref_request_classes(pb, static)
    args = [nb.allocatable, nb.used, nb.pod_count, nb.max_pods, nb.valid, static.mask,
            rc_req, rc_static, rc_of, pb.priority, pb.valid & pb.feasible_static]
    a, used, cnt, _, rounds = _single_shot_jit(
        *[np.array(x) for x in args], max_rounds=c.max_rounds, price_step=c.price_step,
        top_t=c.top_t, repair_rounds=c.repair_rounds, pack=c.objective == "pack",
    )
    nb2 = convert.node_batch(nb)  # a copy: the reference's solve replaces its arrays
    got = RefSolver(c).solve(nb2, pb, static)
    np.testing.assert_array_equal(got, np.asarray(a)[: pb.num_pods])
    np.testing.assert_array_equal(nb2.used, np.asarray(used))
    return np.asarray(a)[: pb.num_pods], np.asarray(used), np.asarray(cnt), int(rounds)


def port_run(nb, pb, static, **cfg):
    pnb = convert.node_batch(nb)
    ppb = convert.pod_batch(pb)
    pst = None if static is None else convert.static_tensors(static)
    used_in = pnb.used
    solver = SingleShotSolver(SingleShotConfig(**cfg), device="cpu")
    before = dc.LAUNCHES
    a = solver.solve(pnb, ppb, pst)
    assert dc.LAUNCHES == before
    assert pnb.used is not used_in  # replaced, as the JAX solve does
    return a, pnb.used, pnb.pod_count, solver.last_rounds, solver


def check_parity(nb, pb, static=None, **cfg):
    """Port == JAX bit for bit; returns the port's assignments."""
    ref = ref_run(nb, pb, static, **cfg)
    a, used, cnt, rounds, solver = port_run(nb, pb, static, **cfg)
    np.testing.assert_array_equal(a, ref[0])
    assert a.dtype == np.int32
    np.testing.assert_array_equal(used, ref[1])
    assert used.dtype == ref[1].dtype
    np.testing.assert_array_equal(cnt, ref[2])
    assert cnt.dtype == ref[2].dtype
    assert rounds == ref[3]
    assert solver.last_reads <= rounds + 1
    return a


def solve(nodes, pods, **cfg):
    return check_parity(*ref_inputs(nodes, pods), **cfg)


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


def test_all_place_when_capacity_suffices():
    nodes = [MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj()
             for i in range(8)]
    pods = [MakePod().name(f"p{i}").req({"cpu": "500m", "memory": "1Gi"}).obj() for i in range(64)]
    a = solve(nodes, pods)
    assert all(x >= 0 for x in a)
    check_feasible(nodes, pods, a)


def test_work_conservation_overload():
    nodes = [MakeNode().name(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": "100"}).obj()
             for i in range(2)]
    pods = [MakePod().name(f"p{i}").req({"cpu": "1"}).obj() for i in range(12)]
    a = solve(nodes, pods)
    assert int((a >= 0).sum()) == 8
    check_feasible(nodes, pods, a)


def test_priority_dominance_under_scarcity():
    nodes = [MakeNode().name("n0").capacity({"cpu": "2", "memory": "8Gi", "pods": "10"}).obj()]
    pods = [MakePod().name(f"lo{i}").req({"cpu": "1"}).priority(1).obj() for i in range(4)] + [
        MakePod().name(f"hi{i}").req({"cpu": "1"}).priority(100).obj() for i in range(2)]
    a = solve(nodes, pods)
    assert {pods[i].name for i in range(6) if a[i] >= 0} == {"hi0", "hi1"}
    check_feasible(nodes, pods, a)


def test_static_mask_respected():
    nodes = [
        MakeNode().name("tainted").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"})
        .taint("k", "v", "NoSchedule").obj(),
        MakeNode().name("open").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj(),
    ]
    pods = [MakePod().name(f"p{i}").req({"cpu": "1"}).obj() for i in range(4)]
    assert all(x == 1 for x in solve(nodes, pods))


def test_mixed_request_classes():
    rng = np.random.default_rng(5)
    nodes = [MakeNode().name(f"n{i:03}").capacity({"cpu": "16", "memory": "64Gi", "pods": "50"})
             .label("zone", f"z{i % 3}").obj() for i in range(32)]
    pods = []
    for i in range(400):
        cpu = int(rng.integers(1, 8)) * 250
        b = MakePod().name(f"p{i:04}").req(
            {"cpu": f"{cpu}m", "memory": f"{int(rng.integers(1, 4))}Gi"}
        ).priority(int(rng.integers(0, 3)))
        if i % 5 == 0:
            b = b.node_selector({"zone": f"z{i % 3}"})
        pods.append(b.obj())
    a = solve(nodes, pods)
    check_feasible(nodes, pods, a)
    assert int((a >= 0).sum()) == 400
    for i in range(0, 400, 5):
        assert int(a[i]) % 3 == i % 3


def test_quality_vs_exact():
    """The auction against the exact scan on one contended workload:
    placed count and priority mass within 3 %, fill balance within 2x."""
    rng = np.random.default_rng(11)

    def mk_nodes():
        return [MakeNode().name(f"n{i:03}").capacity({"cpu": "8", "memory": "32Gi", "pods": "30"})
                .obj() for i in range(64)]

    pods = []
    for i in range(900):
        cpu = int(rng.integers(1, 5)) * 250
        pods.append(MakePod().name(f"p{i:04}")
                    .req({"cpu": f"{cpu}m", "memory": f"{int(rng.integers(1, 3))}Gi"})
                    .priority(int(rng.integers(0, 8))).obj())
    pods.sort(key=lambda p: -p.effective_priority)
    nb, pb, static = ref_inputs(mk_nodes(), pods)
    a_exact = ExactSolver(ExactSolverConfig(tie_break="first", group_size=0)).solve(
        *ref_inputs(mk_nodes(), pods), None, None, None)
    a_ss = check_parity(nb, pb, static)
    check_feasible(mk_nodes(), pods, a_ss)
    prios = np.asarray([p.effective_priority for p in pods])
    placed_e, placed_s = int((a_exact >= 0).sum()), int((a_ss >= 0).sum())
    assert placed_s >= 0.97 * placed_e, (placed_s, placed_e)
    assert int(prios[a_ss >= 0].sum()) >= 0.97 * int(prios[np.asarray(a_exact) >= 0].sum())
    score = []
    for a in (a_exact, a_ss):
        fill_cpu, fill_mem = np.zeros(64), np.zeros(64)
        for i in np.flatnonzero(np.asarray(a) >= 0):
            r = pods[i].resource_request()
            fill_cpu[int(a[i])] += r.get("cpu", 0)
            fill_mem[int(a[i])] += r.get("memory", 0)
        score.append(float(((fill_cpu / 8000.0 + fill_mem / (32 * 1024**3)) / 2.0).var()))
    assert score[1] <= max(2.0 * score[0], 1e-4), score


def _preloaded_scarce(seed=3, n_nodes=256, n_pods=1200, rc=8):
    """tests/test_single_shot.py's scarce_rc8 miniature: unevenly preloaded
    nodes, big request classes, demand > capacity."""
    rng = np.random.default_rng(seed)
    vocab = ResourceVocab(("cpu", "memory", "ephemeral-storage"))
    npad = pad_to(n_nodes)
    live = np.arange(npad) < n_nodes
    alloc = np.zeros((3, npad), np.int64)
    alloc[0, :n_nodes] = 16_000
    alloc[1, :n_nodes] = 64 << 30
    load = rng.integers(0, 9, n_nodes)
    used = np.zeros((3, npad), np.int64)
    used[0, :n_nodes] = load * 1_000
    used[1, :n_nodes] = load * (2 << 30)
    cnt = np.zeros(npad, np.int32)
    cnt[:n_nodes] = load
    rc_cpu = rng.integers(24, 33, rc) * 125
    rc_mem = rng.choice([8 << 30], rc)
    rc_of = np.sort(rng.integers(0, rc, n_pods))
    prio = rng.integers(0, 10, n_pods).astype(np.int32)
    order = np.lexsort((rc_of, -prio))
    rc_of, prio = rc_of[order], prio[order]
    nb = NodeBatch(
        vocab=vocab, names=[f"n{i}" for i in range(n_nodes)], num_nodes=n_nodes, padded=npad,
        allocatable=alloc, used=used, nonzero_used=used[:2].copy(), pod_count=cnt,
        max_pods=np.where(live, 110, 0).astype(np.int32), valid=live.copy(),
        schedulable=live.copy(),
    )
    pb = columnar_pod_batch(rc_cpu[rc_of], np.asarray(rc_mem)[rc_of], prio, vocab)
    base = (100.0 * ((alloc[0] - used[0]) / np.maximum(alloc[0], 1)
                     + (alloc[1] - used[1]) / np.maximum(alloc[1], 1)) / 2.0).astype(np.int64)
    return nb, pb, base


@pytest.mark.parametrize("repair_rounds", [16, 0])
def test_scarcity_repair_closes_the_gap(repair_rounds):
    """The full-width repair phase places >= 0.995 of the exact anchor's
    pods at >= 0.99 of its objective; without it the narrow window strands
    capacity. Both settings bit for bit with the JAX package."""
    nb, pb, base = _preloaded_scarce()
    a = check_parity(nb, pb, None, top_t=16, max_rounds=8, repair_rounds=repair_rounds)
    placed = a >= 0
    a_exact = ExactSolver(ExactSolverConfig(tie_break="first", group_size=256)).solve(
        convert.node_batch(nb), pb)
    placed_e = np.asarray(a_exact) >= 0
    if repair_rounds:
        assert placed.sum() >= 0.995 * placed_e.sum()
        assert base[a[placed]].sum() >= 0.99 * base[np.asarray(a_exact)[placed_e]].sum()
    else:
        assert placed.sum() < 0.995 * placed_e.sum()  # the gap the repair closes


def test_pack_objective_consolidates():
    nodes = [
        MakeNode().name("full").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj(),
        MakeNode().name("empty").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj(),
    ]
    vocab = ResourceVocab.build([], nodes)
    nbatch = build_node_batch(nodes, vocab=vocab)
    nbatch.used[0, 0] = 4000
    pods = [MakePod().name(f"p{i}").req({"cpu": "1"}).obj() for i in range(2)]
    pbatch = build_pod_batch(pods, vocab)
    static = build_static_tensors(pods, pbatch, list(nodes) + [None] * (nbatch.padded - 2),
                                  nbatch.padded)
    a = check_parity(nbatch, pbatch, static, objective="pack", top_t=1)
    assert all(int(x) == 0 for x in a)


def test_moderate_scale_host():
    nodes = [MakeNode().name(f"n{i:04}").capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
             .obj() for i in range(512)]
    pods = [MakePod().name(f"p{i:05}").req({"cpu": "250m", "memory": "512Mi"}).obj()
            for i in range(2000)]
    a = solve(nodes, pods)
    assert int((a >= 0).sum()) == 2000
    check_feasible(nodes, pods, a)
    assert np.bincount(a, minlength=512).max() <= 64


def dense_ties(seed=0, n_nodes=2000, n_pods=6000, classes=4, top_t=64):
    """Every node at one of four fill levels, so each headroom score is
    shared by ~500 nodes, and four request classes: the top-T window cuts
    through long runs of equal scores in every round."""
    rng = np.random.default_rng(seed)
    vocab = ResourceVocab(("cpu", "memory"))
    npad = pad_to(n_nodes)
    live = np.arange(npad) < n_nodes
    alloc = np.zeros((2, npad), np.int64)
    alloc[0, :n_nodes] = 8_000
    alloc[1, :n_nodes] = 32 << 30
    level = rng.integers(0, 4, n_nodes)
    used = np.zeros((2, npad), np.int64)
    used[0, :n_nodes] = level * 1_000
    used[1, :n_nodes] = level * (4 << 30)
    cnt = np.zeros(npad, np.int32)
    cnt[:n_nodes] = level
    nb = NodeBatch(
        vocab=vocab, names=[f"n{i}" for i in range(n_nodes)], num_nodes=n_nodes, padded=npad,
        allocatable=alloc, used=used, nonzero_used=used.copy(), pod_count=cnt,
        max_pods=np.where(live, 110, 0).astype(np.int32), valid=live.copy(),
        schedulable=live.copy(),
    )
    cls = rng.integers(0, classes, n_pods)
    cpu = (np.array([250, 500, 750, 1000])[cls]).astype(np.int64)
    pb = columnar_pod_batch(cpu, cpu * (1 << 20), rng.integers(0, 3, n_pods).astype(np.int32),
                            vocab)
    return nb, pb, top_t


@pytest.mark.parametrize("objective", ["spread", "pack"])
def test_dense_headroom_ties(objective):
    """Headroom ties on every node: the port's stable descending sort picks
    the JAX package's top-T window (lower node index first), so the bids,
    admissions and prices stay equal round after round."""
    nb, pb, top_t = dense_ties()
    free = (nb.allocatable[0] - nb.used[0])[: nb.num_nodes]
    assert len(np.unique(free)) == 4  # four headroom values over 2,000 nodes
    a = check_parity(nb, pb, None, top_t=top_t, objective=objective)
    assert (a >= 0).sum() == pb.num_pods


def test_caller_arrays_are_not_written():
    nb, pb, top_t = dense_ties(n_nodes=64, n_pods=200)
    pnb, ppb = convert.node_batch(nb), convert.pod_batch(pb)
    used, cnt = pnb.used, pnb.pod_count
    used0, cnt0 = used.copy(), cnt.copy()
    SingleShotSolver(device="cpu").solve(pnb, ppb)
    np.testing.assert_array_equal(used, used0)
    np.testing.assert_array_equal(cnt, cnt0)
    assert (pnb.pod_count.sum() - cnt0.sum()) == 200


def test_mesh_raises_naming_item_11():
    """A mesh solve runs and equals the unsharded one bit for bit on dense
    ties (the merge of the shards' top-T keeps the lower global index
    first); a padding that does not divide over the shards raises
    ValueError."""
    from kubernetes_tpu_torch.parallel.sharding import NodeMesh

    nb, pb, _ = dense_ties(n_nodes=8, n_pods=4)
    want_nb = convert.node_batch(nb)
    want = SingleShotSolver(device="cpu").solve(want_nb, convert.pod_batch(pb))
    got_nb = convert.node_batch(nb)
    got = SingleShotSolver(device="cpu").solve(got_nb, convert.pod_batch(pb),
                                               mesh=NodeMesh(("cpu",) * 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_nb.used, want_nb.used)
    with pytest.raises(ValueError, match="not a multiple of the mesh size"):
        SingleShotSolver(device="cpu").solve(convert.node_batch(nb), convert.pod_batch(pb),
                                             mesh=NodeMesh(("cpu",) * 3))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SingleShotSolver()
