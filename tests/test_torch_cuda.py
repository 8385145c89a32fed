"""The port on the card. Every test here needs an NVIDIA GPU and skips
without one. The file imports no JAX (the machine with the card has none),
so it runs there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu_torch.tensorize.schema import (
    ResourceVocab,
    build_node_batch,
    build_pod_batch,
)
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors

pytestmark = pytest.mark.cuda
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU; a skip here is not a pass "
            "(run this file on the card, or chip_smoke.py)"
        )
    return torch.device("cuda")


def assert_exact(got, want, case: str) -> None:
    """Kernel output == plain version, exactly; a mismatch names the case
    (its seed), the shape, the first differing index, both values and
    how many elements differ."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        f"{case}: kernel {tuple(got.shape)} {got.dtype}, plain {tuple(want.shape)} {want.dtype}")
    if torch.equal(got, want):
        return
    bad = (got != want).nonzero()
    first = tuple(int(i) for i in bad[0])
    raise AssertionError(
        f"{case}: kernel != plain at {first} of shape {tuple(got.shape)}: "
        f"kernel {int(got[first])}, plain {int(want[first])} ({len(bad)} elements differ)")


def _inputs(seed, t, n, d_pad, dev):
    rng = np.random.default_rng(seed)
    dom = torch.from_numpy(rng.integers(-1, d_pad, (t, n)).astype(np.int32)).to(dev)
    cnt = torch.from_numpy(rng.integers(0, 5, (t, n)).astype(np.int32)).to(dev)
    return dom, cnt


@pytest.mark.parametrize(
    "t,n,d_pad",
    [(8, 5120, 8192), (1, 5001, 8), (16, 5120, 8), (3, 777, 65536), (2, 100_000, 16384),
     (2, 5120, 2**19)],
)
def test_kernel_equals_plain(cuda_device, t, n, d_pad):
    dom, cnt = _inputs(t + n, t, n, d_pad, cuda_device)
    before = dc.LAUNCHES
    got = dc.domain_counts(dom, cnt, d_pad)
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + 1
    assert_exact(got, dc.domain_counts_plain(dom, cnt, d_pad),
                 f"seed {t + n}, T {t}, N {n}, d_pad {d_pad}")


def test_both_paths_are_taken(cuda_device):
    """8,192 and 65,536 bins fit a cluster's shared memory; 2^19 do not and
    take the global path."""
    for t, n, d_pad, want in [(16, 5120, 8192, (8, False)), (8, 5120, 65536, (8, False)),
                              (8, 600, 65536, (2, False)), (8, 5120, 2**19, (8, True))]:
        dom, cnt = _inputs(t, t, n, d_pad, cuda_device)
        agg = dc.Aggregation([(dom, cnt, None)], d_pad)
        assert (agg.cluster, agg.is_global) == want


def _check_sets(sets, d_pad, case="", **kw):
    want = dc.aggregate_plain(sets, d_pad)
    before = dc.LAUNCHES
    got = dc.aggregate(sets, d_pad, **kw)
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + 1
    for i, ((g_out, g_tot), (w_out, w_tot)) in enumerate(zip(got, want)):
        assert_exact(g_out, w_out, f"{case} d_pad {d_pad} {kw} set {i} totals")
        assert_exact(g_tot, w_tot, f"{case} d_pad {d_pad} {kw} set {i} per-node")


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("d_pad", [8192, 2**19], ids=["shared", "global"])
def test_each_cluster_size_and_path(cuda_device, cluster, d_pad):
    """Every cluster size on both paths: the two-set form with its
    gathered totals, and a separate gather row."""
    rng = np.random.default_rng(cluster)
    dev = cuda_device
    zone = torch.from_numpy(rng.integers(-1, 3, (8, 5120)).astype(np.int32)).to(dev)
    host = torch.from_numpy(
        np.where(rng.random((8, 5120)) < 0.1, -1, np.arange(5120) % d_pad).astype(np.int32)
    ).to(dev)
    cnt = [torch.from_numpy(rng.integers(0, 4, (8, 5120)).astype(np.int32)).to(dev)
           for _ in range(2)]
    case = f"seed {cluster}"
    _check_sets([(zone, cnt[0], None), (host, cnt[1], None)], d_pad, case, cluster=cluster)
    _check_sets([(zone, cnt[0], host)], d_pad, case, cluster=cluster)


@pytest.mark.parametrize("seed", range(12))
def test_random_shapes(cuda_device, seed):
    """A sweep of shapes: d_pad in {8, 8192, 16384, 65536}, N not a
    multiple of the vector width, all -1 rows, misaligned rows (the scalar
    path), one or two sets."""
    rng = np.random.default_rng(1000 + seed)
    d_pad = int(rng.choice([8, 8192, 16384, 65536]))
    n = int(rng.integers(1, 12_000))
    if seed % 3 == 0:
        n += -n % 4  # the vector path
    sets = []
    for _ in range(1 + seed % 2):
        t = int(rng.integers(1, 20))
        dom = rng.integers(-1, min(d_pad, int(rng.integers(2, 20_000))), (t, n)).astype(np.int32)
        dom[rng.random(t) < 0.3] = -1
        cnt = rng.integers(-3, 9, (t, n)).astype(np.int32)
        if seed % 4 == 1:  # a row view 4 bytes off alignment
            flat = torch.empty(t * n + 1, dtype=torch.int32, device=cuda_device)
            cnt_d = flat[1:].view(t, n)
            cnt_d.copy_(torch.from_numpy(cnt))
        else:
            cnt_d = torch.from_numpy(cnt).to(cuda_device)
        gdom = None
        if seed % 5 == 2:
            gdom = torch.from_numpy(
                rng.integers(-1, d_pad, (t, n)).astype(np.int32)
            ).to(cuda_device)
        sets.append((torch.from_numpy(dom).to(cuda_device), cnt_d, gdom))
    shapes = [tuple(d.shape) for d, _, _ in sets]
    _check_sets(sets, d_pad, f"seed {1000 + seed}, shapes {shapes}")


def test_prepared_aggregation_follows_in_place_updates(cuda_device):
    """The scan's prepared launch reads the counts' current contents and
    rewrites its outputs on every call."""
    dom, cnt = _inputs(11, 8, 5120, 8192, cuda_device)
    ex_dom, ex_cnt = _inputs(12, 8, 5120, 8192, cuda_device)
    sets = [(dom, cnt, None), (ex_dom, ex_cnt, None)]
    agg = dc.Aggregation(sets, 8192, counts=False)
    for step in range(3):
        got = agg()
        want = dc.aggregate_plain(sets, 8192, counts=False)
        torch.cuda.synchronize()
        for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
            assert_exact(g, w, f"seeds 11/12, T 8 + 8, N 5120, step {step}, set {i}")
        cnt[:, step::7] += step + 1
        ex_cnt.index_add_(1, torch.tensor([step], device=cuda_device),
                          torch.ones((8, 1), dtype=torch.int32, device=cuda_device))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_repeated_launches_stay_exact(cuda_device, cluster):
    """One prepared aggregation launched 50 times over the same inputs
    gives the plain result every time: the scan's two-set shape (T 8 + 8,
    N 5,120, d_pad 8,192, gathered) and a scalar-path shape with a
    separate gather row (T 15, N 4,570, d_pad 16,384)."""
    dom, cnt = _inputs(21, 8, 5120, 8192, cuda_device)
    ex_dom, ex_cnt = _inputs(22, 8, 5120, 8192, cuda_device)
    rng = np.random.default_rng(23)
    r_dom, r_cnt = _inputs(24, 15, 4570, 16384, cuda_device)
    r_gdom = torch.from_numpy(rng.integers(-1, 16384, (15, 4570)).astype(np.int32)).to(cuda_device)
    for sets, d_pad in (([(dom, cnt, None), (ex_dom, ex_cnt, None)], 8192),
                        ([(r_dom, r_cnt, r_gdom)], 16384)):
        want = dc.aggregate_plain(sets, d_pad)
        agg = dc.Aggregation(sets, d_pad, cluster=cluster)
        for call in range(50):
            got = agg()
            torch.cuda.synchronize()
            for i, ((g_out, g_tot), (w_out, w_tot)) in enumerate(zip(got, want)):
                case = f"seeds 21-24, cluster {cluster}, d_pad {d_pad}, call {call}, set {i}"
                assert_exact(g_out, w_out, case + " totals")
                assert_exact(g_tot, w_tot, case + " per-node")


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    dom, cnt = _inputs(0, 4, 256, 8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dc.domain_counts(dom.t().contiguous().t(), cnt, 8)
    with pytest.raises(ValueError):
        dc.domain_counts(dom, cnt.cpu(), 8)
    with pytest.raises(ValueError):
        dc.aggregate([(dom, cnt, None), (dom.cpu(), cnt.cpu(), None)], 8)
    with pytest.raises(ValueError, match="cluster"):
        dc.aggregate([(dom, cnt, None)], 65536, cluster=1)


def _cluster(n_nodes, n_pods):
    nodes = [
        MakeNode().name(f"n{i:04}").capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
        .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:04}").obj()
        for i in range(n_nodes)
    ]
    pods = []
    for i in range(n_pods):
        b = MakePod().name(f"p{i:04}").label("app", f"k{i % 4}").req(
            {"cpu": "250m", "memory": "512Mi"}
        )
        if i % 4 == 0:
            b = b.host_port(8000 + i % 8)
        elif i % 4 == 1:
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "k1"})
        elif i % 4 == 2:
            b = b.pod_anti_affinity(HOST, {"app": "k2"})
        else:
            b = b.preferred_pod_affinity(50, ZONE, {"app": "k1"}).spread_constraint(
                2, ZONE, "ScheduleAnyway", {"app": "k3"}
            )
        pods.append(b.obj())
    return nodes, pods


def _tensorize(nodes, pods):
    vocab = ResourceVocab.build(pods, nodes)
    nb = build_node_batch(nodes, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (
        nb, pb, st, build_port_tensors(pods, pb, slots, {}, nb.padded),
        build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
        build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
    )


@pytest.mark.parametrize("fdtype", ["float64", "float32"])
def test_card_equals_cpu(cuda_device, fdtype):
    nodes, pods = _cluster(300, 200)
    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype=fdtype)
    card = _tensorize(nodes, pods)
    cpu = _tensorize(nodes, pods)
    before = dc.LAUNCHES
    a = ExactSolver(cfg).solve(*card, device=cuda_device)
    assert dc.LAUNCHES > before
    b = ExactSolver(cfg).solve(*cpu, device="cpu")
    np.testing.assert_array_equal(a, b)
    for k in ("used", "nonzero_used", "pod_count"):
        np.testing.assert_array_equal(getattr(card[0], k), getattr(cpu[0], k))


def test_random_tie_break_on_the_card(cuda_device):
    """Random mode draws from a CUDA generator: the same seed repeats, and
    every pod is placed with the anti-affinity and port rules held."""
    nodes, pods = _cluster(64, 120)
    cfg = ExactSolverConfig(tie_break="random", seed=5)
    a = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    b = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all()
    anti = a[2::4]
    assert len(set(anti.tolist())) == len(anti)
    for port in range(8000, 8008):
        on = [a[i] for i in range(0, len(pods), 4) if 8000 + i % 8 == port]
        assert len(set(on)) == len(on)


# -- the grouped path, nominated pods and the session on the card ---------------


def _kind_pods(kind, n, prefix="g"):
    out = []
    for i in range(n):
        b = MakePod().name(f"{prefix}{kind}-{i:04}").label("app", f"g-{kind}").req(
            {"cpu": "250m", "memory": "512Mi"})
        if kind == "spread":
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "g-spread"})
        elif kind == "anti":
            b = b.pod_anti_affinity(HOST, {"app": "g-anti"})
        out.append(b.obj())
    return out


@pytest.mark.parametrize("kind,want", [("plain", "kind1"), ("spread", "kind2"),
                                       ("anti", "kind3")])
def test_grouped_first_equals_scan_on_the_card(cuda_device, kind, want):
    nodes, _ = _cluster(300, 0)
    pods = _kind_pods(kind, 256)
    grouped = ExactSolver(ExactSolverConfig(tie_break="first"))
    before = dc.LAUNCHES
    a = grouped.solve(*_tensorize(nodes, pods), device=cuda_device)
    if kind != "plain":
        assert dc.LAUNCHES > before
    assert grouped.dispatch_counts[want] == 4
    b = ExactSolver(ExactSolverConfig(tie_break="first", group_size=0)).solve(
        *_tensorize(nodes, pods), device=cuda_device)
    np.testing.assert_array_equal(a, b)
    c = ExactSolver(ExactSolverConfig(tie_break="first")).solve(*_tensorize(nodes, pods),
                                                                device="cpu")
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("kind", ["plain", "spread", "anti"])
def test_grouped_random_on_the_card(cuda_device, kind):
    """Random mode places every pod with the workload's invariants held,
    and one seed repeats on the card."""
    nodes, _ = _cluster(300, 0)
    pods = _kind_pods(kind, 256)
    cfg = ExactSolverConfig(tie_break="random", seed=3)
    a = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    b = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all()
    if kind == "spread":
        zones = np.bincount(a % 3, minlength=3)
        assert zones.max() - zones.min() <= 1
    if kind == "anti":
        assert len(set(a.tolist())) == len(a)


def test_nominated_card_equals_cpu(cuda_device):
    from kubernetes_tpu_torch.tensorize.schema import build_nominated_tensors

    nodes, pods = _cluster(300, 200)
    foreign = [
        MakePod().name(f"nom-{i}").req({"cpu": "2", "memory": "4Gi"}).priority(10 * (i % 3))
        .host_port(8000 + i % 8).scheduler_name("other").obj()
        for i in range(12)
    ]
    pairs = [(p, (i * 23) % 300) for i, p in enumerate(foreign)]
    pairs += [(pods[i], (i * 7) % 300) for i in range(0, 200, 25)]
    out = []
    for dev in (cuda_device, "cpu"):
        inputs = list(_tensorize(nodes, pods))
        nb, pb, st = inputs[:3]
        slots = list(nodes) + [None] * (nb.padded - len(nodes))
        inputs[3] = build_port_tensors(pods, pb, slots, {}, nb.padded, nominated=pairs)
        nom = build_nominated_tensors(pairs, nb.vocab, nb.padded, ports=inputs[3])
        assert nom.port_takes is not None
        slot_of = {p.key: s for p, s in pairs}
        nslot = np.asarray([slot_of.get(p.key, -1) for p in pods], np.int32)
        cfg = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
        out.append((ExactSolver(cfg).solve(*inputs, nominated=nom, nominated_slot=nslot,
                                           device=dev), nb))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for k in ("used", "nonzero_used", "pod_count"):
        np.testing.assert_array_equal(getattr(out[0][1], k), getattr(out[1][1], k))


def test_session_equals_standalone_on_the_card(cuda_device):
    """Two batches through one session on the card, the caller applying the
    first batch's placements (and bumping their columns) before the second:
    each equals its standalone solve, and the deferred handle reads from
    pinned host memory."""
    from kubernetes_tpu_torch.solver.session import DeferredAssignments

    nodes, _ = _cluster(300, 0)
    cfg = ExactSolverConfig(tie_break="first")
    solver = ExactSolver(cfg)
    placed = {}
    versions = np.zeros(512, np.int64)
    for b in range(2):
        pods = _kind_pods("spread", 128, prefix=f"b{b}")
        vocab = ResourceVocab.build(pods, nodes)
        nb = build_node_batch(nodes, placed, vocab=vocab)
        pb = build_pod_batch(pods, vocab)
        slots = list(nodes) + [None] * (nb.padded - len(nodes))
        by_slot = {i: placed[n.name] for i, n in enumerate(nodes) if n.name in placed}
        st = build_static_tensors(pods, pb, slots, nb.padded)

        def inputs():
            return (build_node_batch(nodes, placed, vocab=vocab), pb, st,
                    build_port_tensors(pods, pb, slots, by_slot, nb.padded),
                    build_spread_tensors(pods, st.reps, pb, slots, by_slot, nb.padded,
                                         st.c_pad),
                    build_interpod_tensors(pods, st.reps, pb, slots, by_slot, nb.padded,
                                           st.c_pad))

        want = ExactSolver(cfg).solve(*inputs(), device=cuda_device)
        handle = solver.solve(*inputs(), col_versions=versions.copy(), defer_read=True,
                              device=cuda_device)
        assert isinstance(handle, DeferredAssignments) and handle._host.is_pinned()
        got = handle.get()
        np.testing.assert_array_equal(got, want)
        for p, a in zip(pods, got):
            placed.setdefault(nodes[a].name, []).append(p)
            versions[a] += 1


# -- the Scheduler and the preemption dry-run on the card --------------------


def _sched_cluster(n_nodes, pods):
    from kubernetes_tpu_torch.state.cluster import ClusterState

    cs = ClusterState()
    cs.create_nodes(
        MakeNode().name(f"node-{i:04}").capacity({"cpu": "4", "memory": "8Gi", "pods": "20"})
        .label(ZONE, f"z{i % 3}").label(HOST, f"node-{i:04}").obj()
        for i in range(n_nodes)
    )
    cs.create_pods(pods)
    return cs


def _sched_pod(i):
    b = MakePod().name(f"m{i:03}").req({"cpu": f"{150 + 50 * (i % 4)}m", "memory": "256Mi"})
    kind = i % 5
    if kind == 0:
        b = b.label("app", "lb").host_port(8080)
    elif kind == 1:
        b = b.label("app", "spread").spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
    elif kind == 2:
        b = b.label("app", "anti").pod_anti_affinity(HOST, match_labels={"app": "anti"})
    elif kind == 3:
        b = b.label("app", "web").preferred_pod_affinity(50, ZONE, {"app": "spread"})
    return b.obj()


def _drive(dev, build, script):
    """Run ``script`` (a list of callables on the cluster, between
    batches) through a Scheduler on ``dev``; returns the batch results,
    bindings and nominations."""
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.utils.clock import FakeClock

    cs = build()
    clock = FakeClock()
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=16,
        solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64")),
        clock=clock, device=dev)
    views = []
    for change in script + [None] * 8:
        r = sched.schedule_batch()
        views.append((r.scheduled, r.unschedulable, r.preemptions))
        assert not r.quarantined and set(sched._tier_last.values()) <= {"single"}
        if change is not None:
            change(cs)
        clock.advance(2.0)
    assert sched.resilience.trips == 0 and sched.resilience.rebuilds == 0
    pods = cs.list_pods()
    return views, {p.key: p.node_name for p in pods}, {p.key: p.nominated_node_name for p in pods}


def test_scheduler_card_equals_cpu_mixed(cuda_device):
    def add_node(cs):
        cs.create_node(MakeNode().name("node-0099").capacity({"cpu": "4", "memory": "8Gi",
                       "pods": "20"}).label(ZONE, "z0").label(HOST, "node-0099").obj())
        cs.create_pods(_sched_pod(i) for i in range(40, 52))

    def delete_one(cs):
        cs.delete_pod(*sorted(p.key for p in cs.list_pods() if p.node_name)[0].split("/"))
        cs.create_pods(_sched_pod(i) for i in range(52, 64))

    def build():
        nominee = (MakePod().name("nominee").req({"cpu": "1"}).priority(10)
                   .nominated_node_name("node-0003").obj())
        return _sched_cluster(12, [nominee] + [_sched_pod(i) for i in range(40)])

    card = _drive(cuda_device, build, [add_node, delete_one])
    cpu = _drive(torch.device("cpu"), build, [add_node, delete_one])
    assert card == cpu
    assert sum(1 for v in card[1].values() if v) >= 50


def test_scheduler_card_equals_cpu_preemption(cuda_device):
    def build():
        low = [
            MakePod().name(f"low-{i}-{j}").node(f"node-{i:04}").req({"cpu": "2"})
            .priority(1 + (i + j) % 3).start_time(float(j)).obj()
            for i in range(6) for j in range(2)
        ]
        vips = [MakePod().name(f"vip-{k}").req({"cpu": "2"}).priority(100).obj()
                for k in range(4)]
        return _sched_cluster(6, low + vips)

    card = _drive(cuda_device, build, [])
    cpu = _drive(torch.device("cpu"), build, [])
    assert card == cpu
    assert sum(len(v[2]) for v in card[0]) == 4
    assert all(card[1][f"default/vip-{k}"] for k in range(4))


@pytest.mark.parametrize("seed", range(4))
def test_preempt_scan_card_equals_cpu(cuda_device, seed):
    from kubernetes_tpu_torch.solver.preemption import _preempt_scan

    rng = np.random.default_rng(seed)
    s, k, n = 16, 3, 5120
    alloc = rng.integers(2_000, 8_000, (k, n)).astype(np.int64)
    xs = (
        alloc, rng.integers(2, 6, n).astype(np.int32),
        (alloc * rng.random((k, n)) * 0.8).astype(np.int64),
        rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.15,
        rng.integers(200, 2_500, k).astype(np.int64),
        rng.integers(0, 2_000, (s, k, n)).astype(np.int64),
        rng.random((s, n)) > 0.3, rng.random((s, n)) > 0.7,
        rng.integers(-3, 4, (s, n)).astype(np.int32),
        rng.choice(np.float32([0.0, 0.5, 1.25, 2.0]), (s, n)),
    )
    cpu = _preempt_scan(*(torch.from_numpy(x) for x in xs))
    card = _preempt_scan(*(torch.from_numpy(x).to(cuda_device) for x in xs))
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


# -- the pipelined and streaming loops and the backlog drain on the card -----


def _loop_bindings(dev, loop, **kw):
    """The mixed scenario through one of the Scheduler's loops on ``dev``:
    a backlog, then a node added with more pods, then a bound pod deleted
    with more pods, each followed by one call of ``loop``."""
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.solver import budget as hbm
    from kubernetes_tpu_torch.utils.clock import FakeClock

    nominee = (MakePod().name("nominee").req({"cpu": "1"}).priority(10)
               .nominated_node_name("node-0003").obj())
    cs = _sched_cluster(12, [nominee] + [_sched_pod(i) for i in range(40)])
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=16,
        solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64", group_size=8)),
        clock=FakeClock(), device=dev)
    splits = []

    def run():
        if loop == "settled":
            return sched.run_until_settled()
        if loop == "pipelined":
            return sched.run_pipelined()
        if loop == "streaming":
            return sched.run_streaming()
        budget = kw.get("budget_bytes") or 8 << 30
        if budget == "tight":
            budget = hbm.estimate(sched.drain_shape(16)).per_device_bytes - 1
        rep = sched.drain_backlog(chunk_pods=16, budget_bytes=budget)
        splits.append(rep.budget_splits)
        return rep.results

    results = list(run())
    cs.create_node(MakeNode().name("node-0099").capacity({"cpu": "4", "memory": "8Gi",
                   "pods": "20"}).label(ZONE, "z0").label(HOST, "node-0099").obj())
    cs.create_pods(_sched_pod(i) for i in range(40, 52))
    results += run()
    cs.delete_pod(*sorted(p.key for p in cs.list_pods() if p.node_name)[0].split("/"))
    cs.create_pods(_sched_pod(i) for i in range(52, 64))
    results += run()
    assert not any(r.quarantined for r in results)
    assert set(sched._tier_last.values()) <= {"single"}
    assert sched.resilience.trips == 0 and sched.resilience.rebuilds == 0
    return {p.key: p.node_name for p in cs.list_pods()}, splits


@pytest.mark.parametrize("loop", ["pipelined", "streaming", "drain"])
def test_loops_equal_run_until_settled_on_the_card(cuda_device, loop):
    want, _ = _loop_bindings(torch.device("cpu"), "settled")
    got, _ = _loop_bindings(cuda_device, loop)
    assert got == want
    assert sum(1 for v in got.values() if v) >= 50


def test_forced_auto_split_drain_binds_as_unsplit_on_the_card(cuda_device):
    wide, wide_splits = _loop_bindings(cuda_device, "drain")
    tight, splits = _loop_bindings(cuda_device, "drain", budget_bytes="tight")
    assert wide_splits == [0, 0, 0] and min(splits) >= 1
    assert tight == wide


def test_completion_wait_releases_the_gil(cuda_device):
    """The completion thread parks in DeferredAssignments.wait on a CUDA
    event; the driver thread must keep running Python meanwhile."""
    import threading
    import time

    from kubernetes_tpu_torch.solver.session import DeferredAssignments

    a = torch.randn(4096, 4096, device=cuda_device)
    stop = threading.Event()
    ticks = []

    def driver():
        while not stop.is_set():
            ticks.append(time.perf_counter())

    x = a
    for _ in range(40):  # well over 100 ms of queued device work
        x = x @ a
        x = x / x.norm()
    handle = DeferredAssignments(x.flatten()[:16].to(torch.int32), 16)
    t = threading.Thread(target=driver)
    t.start()
    t0 = time.perf_counter()
    handle.wait()  # this thread parks on the event
    waited = time.perf_counter() - t0
    during = sum(1 for v in ticks if t0 <= v <= t0 + waited)
    stop.set()
    t.join()
    assert waited > 0.02, "the queued work finished before the wait began"
    # a GIL-holding wait would starve the driver for the whole wait
    assert during > 1000, (during, waited)


# -- the extender's evaluator, restarts, bundles and the drain budget --------


def _eval_view(n_nodes=48, n_placed=96):
    """A cluster with placed pods of the mixed kinds (hostPorts, spread
    and anti-affinity owners, preferred affinity) and its evaluator view."""
    from kubernetes_tpu_torch.state.cluster import ClusterState

    cs = ClusterState()
    cs.create_nodes(
        MakeNode().name(f"e{i:03}").capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
        .label(ZONE, f"z{i % 3}").label(HOST, f"e{i:03}").obj()
        for i in range(n_nodes)
    )
    for i in range(n_placed):
        pod = _sched_pod(i)
        pod.node_name = f"e{(i * 7) % n_nodes:03}"
        cs.create_pod(pod)
    by_node = {}
    for p in cs.list_pods():
        by_node.setdefault(p.node_name, []).append(p)
    return cs.list_nodes(), by_node


def _requests(n):
    out = []
    for i in range(n):
        b = MakePod().name(f"r{i:03}").req({"cpu": "300m", "memory": "256Mi"})
        kind = i % 6
        if kind == 0:
            b = b.host_port(8080)
        elif kind == 1:
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
        elif kind == 2:
            b = b.spread_constraint(2, HOST, "ScheduleAnyway", {"app": "web"})
        elif kind == 3:
            b = b.pod_anti_affinity(HOST, {"app": "anti"})
        elif kind == 4:
            b = b.pod_affinity(ZONE, {"app": "spread"}).preferred_pod_affinity(
                20, HOST, {"app": "lb"}, anti=True)
        else:
            b = b.label("app", "anti")  # the placed anti terms select it
        out.append(b.obj())
    return out


def test_evaluator_card_equals_cpu(cuda_device):
    from kubernetes_tpu_torch.solver.evaluate import BatchEvaluator

    nodes, by_node = _eval_view()
    cfg = ExactSolverConfig(balanced_fdtype="float64")
    launches = []
    for p in (12, 48):
        pods = _requests(p)
        before = dc.LAUNCHES
        card = BatchEvaluator(cfg, device=cuda_device).evaluate(pods, nodes, by_node)
        launches.append(dc.LAUNCHES - before)
        cpu = BatchEvaluator(cfg, device="cpu").evaluate(pods, nodes, by_node)
        np.testing.assert_array_equal(card, cpu)
        assert card.shape == (p, len(nodes)) and (card >= 0).any(axis=1).all()
    # the interpod in + ex rows and the spread rows: one launch each, for any P
    assert launches == [2, 2]


def _crash_then_restart(dev, tmp_path):
    """The mixed scenario: incarnation 1 runs ``run_pipelined`` until the
    commit seam raises on its second batch; incarnation 2 on the same
    cluster settles it. Returns the bindings before and after and the
    journal's recovered records."""
    import json

    from kubernetes_tpu_torch.obs import ObsConfig
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.utils.clock import FakeClock

    class Crash(Exception):
        pass

    cs = _sched_cluster(12, [_sched_pod(i) for i in range(60)])
    clock = FakeClock()
    solver = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    s1 = Scheduler(cs, SchedulerConfig(batch_size=16, solver=solver), clock=clock, device=dev)
    calls = []

    def die(pending):
        calls.append(len(pending))
        if len(calls) == 2:
            raise Crash()

    s1._pre_commit_hook = die
    with pytest.raises(Crash):
        s1.run_pipelined()
    cs.unsubscribe(s1._on_event)
    before = {p.key: p.node_name for p in cs.list_pods()}
    s2 = Scheduler(cs, SchedulerConfig(batch_size=16, solver=solver, incarnation=2,
                                       obs=ObsConfig(journal=True)), clock=clock, device=dev)
    recovered = [json.loads(x) for x in s2.journal.lines]
    s2.run_until_settled()
    assert set(s2._tier_last.values()) <= {"single"}
    return before, recovered, {p.key: p.node_name for p in cs.list_pods()}


def test_restart_card_equals_cpu(cuda_device, tmp_path):
    card = _crash_then_restart(cuda_device, tmp_path)
    cpu = _crash_then_restart(torch.device("cpu"), tmp_path)
    assert card == cpu
    before, recovered, after = card
    assert {r["outcome"] for r in recovered} == {"recovered"}
    assert sorted(r["pod"] for r in recovered) == sorted(k for k, v in before.items() if not v)
    assert sum(1 for v in after.values() if v) >= 50


def test_card_bundle_replays_on_the_cpu(cuda_device, tmp_path):
    from kubernetes_tpu_torch.obs import ObsConfig
    from kubernetes_tpu_torch.obs.bundle import replay_bundle
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.utils.clock import FakeClock

    cs = _sched_cluster(12, [_sched_pod(i) for i in range(40)])
    solver = ExactSolverConfig(tie_break="first", balanced_fdtype="float64")
    sched = Scheduler(cs, SchedulerConfig(batch_size=16, solver=solver,
                                          obs=ObsConfig(bundle_dir=str(tmp_path))),
                      clock=FakeClock(), device=cuda_device)
    sched.schedule_batch()
    sched.schedule_batch()
    path = sched.telemetry.capture("manual")
    for dev in ("cpu", cuda_device):
        rep = replay_bundle(path, device=dev)
        assert rep["ok"] and rep["detail"] == "assignments bit-identical", (dev, rep)


def test_drain_budget_excludes_memory_held_outside(cuda_device):
    """With all but a few MiB of the card held by a block outside the
    drain, the default budget sees only what is left: the drain raises
    BudgetExceeded (or splits) before dispatch, never an out-of-memory."""
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.solver import budget as hbm
    from kubernetes_tpu_torch.state.cluster import ClusterState

    cs = ClusterState()
    cs.create_nodes(
        MakeNode().name(f"b{i:05}").capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
        .label(ZONE, f"z{i % 3}").obj() for i in range(20_000))
    cs.create_pods(
        MakePod().name(f"q{i:05}").req({"cpu": "250m", "memory": "512Mi"}).label("app", "s")
        .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "s"}).obj() for i in range(4096))
    sched = Scheduler(cs, SchedulerConfig(batch_size=1024), device=cuda_device)
    est_min = hbm.estimate(sched.drain_shape(64)).per_device_bytes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    idle = hbm.device_budget_bytes(device=cuda_device)
    keep = 8 << 20
    free = torch.cuda.mem_get_info(cuda_device)[0]
    block = torch.empty(free - keep, dtype=torch.uint8, device=cuda_device)
    try:
        budget = hbm.device_budget_bytes(device=cuda_device)
        assert budget <= keep + (2 << 20), (budget, keep)
        assert idle - budget >= block.numel() - (2 << 20)
        assert budget < est_min  # so no chunk size fits
        with pytest.raises(hbm.BudgetExceeded):
            sched.drain_backlog(chunk_pods=1024)
        assert sched.pending == 4096  # nothing popped or dispatched
    finally:
        del block
        torch.cuda.empty_cache()
    # with the block gone the same drain plans its chunk unsplit and binds
    rep = sched.drain_backlog(chunk_pods=1024)
    assert rep.budget_splits == 0 and rep.drained == 4096
