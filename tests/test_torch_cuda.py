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
from kubernetes_tpu_torch.ops import prng
from kubernetes_tpu_torch.ops import threefry as tf
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


def _random_sets(seed, cuda_device):
    """One random case: d_pad in {8, 8192, 16384, 65536}, N not a multiple
    of the vector width, all -1 rows, misaligned rows (the scalar path),
    one or two sets. Returns (sets, d_pad, case label)."""
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
    return sets, d_pad, f"seed {1000 + seed}, shapes {shapes}"


@pytest.mark.parametrize("seed", range(12))
def test_random_shapes(cuda_device, seed):
    """A sweep of shapes (``_random_sets``), each held exactly to plain."""
    sets, d_pad, case = _random_sets(seed, cuda_device)
    _check_sets(sets, d_pad, case)


def test_random_shapes_stress(cuda_device):
    """ROADMAP queue 3 entry 1, the stress step: the random-shape
    generator over 500 seeds, each case launched twice (a fresh
    aggregation each time), every launch held exactly to plain. Prints
    the launches checked."""
    checked = 0
    for seed in range(500):
        sets, d_pad, case = _random_sets(seed, cuda_device)
        for launch in range(2):
            _check_sets(sets, d_pad, f"{case}, launch {launch}")
            checked += 1
    print(f"\nrandom-shape stress: {checked} launches checked, all exact")
    assert checked == 1000


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


def test_prepared_aggregation_stress(cuda_device):
    """ROADMAP queue 3 entry 1, the stress step: the prepared two-set
    aggregation of ``test_prepared_aggregation_follows_in_place_updates``
    for 200 steps of in-place count updates, every launch held exactly to
    plain. Prints the launches checked."""
    dom, cnt = _inputs(11, 8, 5120, 8192, cuda_device)
    ex_dom, ex_cnt = _inputs(12, 8, 5120, 8192, cuda_device)
    sets = [(dom, cnt, None), (ex_dom, ex_cnt, None)]
    agg = dc.Aggregation(sets, 8192, counts=False)
    before = dc.LAUNCHES
    for step in range(200):
        got = agg()
        want = dc.aggregate_plain(sets, 8192, counts=False)
        torch.cuda.synchronize()
        for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
            assert_exact(g, w, f"seeds 11/12, T 8 + 8, N 5120, step {step}, set {i}")
        cnt[:, step % 7::7] += step % 5 + 1
        ex_cnt.index_add_(1, torch.tensor([step % 5120], device=cuda_device),
                          torch.ones((8, 1), dtype=torch.int32, device=cuda_device))
    checked = dc.LAUNCHES - before
    print(f"\nprepared-aggregation stress: {checked} launches checked, all exact")
    assert checked == 200


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
    """Random mode draws the threefry stream through the kernel, one scan
    draw per valid pod: the card equals the CPU port bit for bit, and
    every pod is placed with the anti-affinity and port rules held."""
    nodes, pods = _cluster(64, 120)
    cfg = ExactSolverConfig(tie_break="random", seed=5)
    before = tf.SCAN_LAUNCHES
    a = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    assert tf.SCAN_LAUNCHES - before == len(pods)
    b = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device="cpu")
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all()
    anti = a[2::4]
    assert len(set(anti.tolist())) == len(anti)
    for port in range(8000, 8008):
        on = [a[i] for i in range(0, len(pods), 4) if 8000 + i % 8 == port]
        assert len(set(on)) == len(on)


# -- the threefry kernel ------------------------------------------------------

# JAX 0.9.0 (x64, partitionable threefry), PRNGKey(2026): the scan step's
# chain (split, then randint(sub, (), 0, max(span, 1)) in int64) over
# GOLDEN_SPANS, the key after it, then one grouped split's float64 uniform
# and its randint(0, 1 << 20, int32) * 10240 + iota at GOLDEN_COLUMNS
GOLDEN_SPANS = (1, 2, 3, 7, 100, 5120, 10240, 0, 9999, 64)
GOLDEN_RANKS = (0, 0, 0, 0, 34, 3135, 8137, 0, 6960, 21)
GOLDEN_KEY_AFTER = (277385298, 1201959585)
GOLDEN_COLUMNS = (0, 1, 5119, 10239)
GOLDEN_UNIFORM = (0.39642325656630373, 0.8948193735018288, 0.008306621072576181,
                  0.9273055868316546)
GOLDEN_NODE_KEYS = (5671362560, 626257921, 8299893759, 7370495999)
GOLDEN_KEY_END = (2414729977, 3878860213)


def _n_ties(v, dev):
    return torch.tensor(int(v), dtype=torch.int64, device=dev)


def test_threefry_known_answer_on_the_card(cuda_device):
    """The Random123 known answer through the uniform entry point: the
    subkey slot holds the key (0x13198a2e, 0x03707344) and the column is
    the counter (0x243f6a88, 0x85a308d3), whose hash (0xc4923a9c,
    0x483df7a0) becomes the float64 below."""
    stream = tf.Stream((0, 0), cuda_device)
    stream.state[4:6] = torch.tensor([0x13198A2E, 0x03707344], device=cuda_device)
    stream.has_sub = True
    got = stream.uniform(0x243F6A8885A308D3, 1, split=False)
    assert got.item() == 0.767856276659806


def test_threefry_golden_jax_draws_on_the_card(cuda_device):
    stream = tf.Stream(prng.prng_key(2026), cuda_device)
    ranks = torch.stack([stream.rank(_n_ties(s, cuda_device)) for s in GOLDEN_SPANS])
    assert tuple(ranks.cpu().tolist()) == GOLDEN_RANKS
    assert stream.key_words() == GOLDEN_KEY_AFTER
    u = stream.uniform(0, 10240)
    keys = stream.node_keys(0, 10240, 10240, split=False)
    cols = list(GOLDEN_COLUMNS)
    assert tuple(u[cols].cpu().tolist()) == GOLDEN_UNIFORM
    assert tuple(keys[cols].cpu().tolist()) == GOLDEN_NODE_KEYS
    assert stream.key_words() == GOLDEN_KEY_END


@pytest.mark.parametrize("n", [5120, 10240])
def test_threefry_kernel_equals_plain(cuda_device, n):
    """Both entry points against the plain versions on seeded keys, at the
    main path's widths: scan draws over tie counts up to n with skipped
    rows between them, grouped splits with the uniform and the node keys,
    redraws from the same subkey and draws of a column range; every
    output and the key after each step equal, exactly."""
    rng = np.random.default_rng(n)
    for trial in range(4):
        key = tuple(int(w) for w in rng.integers(0, 1 << 32, 2))
        card, cpu = tf.Stream(key, cuda_device), tf.Stream(key, "cpu")
        for step in range(24):
            for _ in range(int(rng.integers(0, 3))):
                card.skip()
                cpu.skip()
            what = step % 4
            case = f"n {n}, trial {trial}, step {step}"
            if what == 0:
                t = int(rng.integers(0, n + 1))
                assert_exact(card.rank(_n_ties(t, cuda_device)).cpu(),
                             cpu.rank(_n_ties(t, "cpu")), case)
            elif what == 1:
                assert_exact(card.uniform(0, n).cpu().view(torch.int64),
                             cpu.uniform(0, n).view(torch.int64), case)
                assert_exact(card.node_keys(0, n, n, split=False).cpu(),
                             cpu.node_keys(0, n, n, split=False), case)
            elif what == 2:
                assert_exact(card.node_keys(0, n, n).cpu(), cpu.node_keys(0, n, n), case)
                assert_exact(card.uniform(0, n, split=False).cpu().view(torch.int64),
                             cpu.uniform(0, n, split=False).view(torch.int64), case)
            else:
                lo = int(rng.integers(0, n))
                assert_exact(card.node_keys(lo, n - lo, n).cpu(), cpu.node_keys(lo, n - lo, n),
                             case)
            assert card.key_words() == cpu.key_words(), case


def test_threefry_scan_chain_stress(cuda_device):
    """1,000 scan-step draws with skipped rows between them, the ranks kept
    on the card and read once: the chain equals the plain chain."""
    rng = np.random.default_rng(7)
    spans = rng.integers(0, 10_241, 1000)
    skips = rng.integers(0, 2, 1000)
    card, cpu = tf.Stream(prng.prng_key(99), cuda_device), tf.Stream(prng.prng_key(99), "cpu")
    before = tf.SCAN_LAUNCHES
    got, want = [], []
    for t, k in zip(spans, skips):
        for _ in range(int(k)):
            card.skip()
            cpu.skip()
        got.append(card.rank(_n_ties(t, cuda_device)))
        want.append(cpu.rank(_n_ties(t, "cpu")))
    assert tf.SCAN_LAUNCHES - before == 1000
    assert_exact(torch.stack(got).cpu(), torch.stack(want), "scan chain stress")
    assert card.key_words() == cpu.key_words()


def test_threefry_wrapper_raises_instead_of_falling_back(cuda_device):
    stream = tf.Stream(prng.prng_key(0), cuda_device)
    with pytest.raises(ValueError, match="int64"):
        stream.rank(torch.tensor(3, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="stream on"):
        stream.rank(torch.tensor(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="subkey"):
        stream.uniform(0, 8, split=False)


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
    one grouped draw launch per loop iteration or more (a spread chunk:
    one launch of the fused loop, ops/grouped_spread.py), and the card
    equals the CPU port bit for bit."""
    from kubernetes_tpu_torch.ops import grouped_spread as gs

    nodes, _ = _cluster(300, 0)
    pods = _kind_pods(kind, 256)
    cfg = ExactSolverConfig(tie_break="random", seed=3)
    before = tf.GROUPED_LAUNCHES, gs.LAUNCHES
    a = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    if kind == "spread":
        assert gs.LAUNCHES - before[1] == 4 and tf.GROUPED_LAUNCHES == before[0]
    else:
        assert tf.GROUPED_LAUNCHES > before[0]
    b = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device="cpu")
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


# -- the simulator and the perf runner ----------------------------------------


def test_sim_profile_card_equals_cpu(cuda_device):
    """churn_heavy (hard zone spread, hostname anti-affinity and hostPort
    arrivals under churn and injected faults) on the card and on the CPU:
    the same trace, byte for byte, every invariant OK, and the kernel
    launched on the card."""
    from kubernetes_tpu_torch.sim import run_sim

    cpu = run_sim("churn_heavy", seed=0, cycles=8, device="cpu")
    before = dc.LAUNCHES
    card = run_sim("churn_heavy", seed=0, cycles=8, device=cuda_device)
    assert dc.LAUNCHES > before
    assert card.ok, [v.as_dict() for v in card.violations]
    assert card.trace.lines == cpu.trace.lines
    assert card.journal_lines == cpu.journal_lines


def test_perf_workload_card_equals_cpu(cuda_device):
    """The shipped SchedulingPodAntiAffinity workload in "first" mode on
    the card and on the CPU: the same counts and the same bindings."""
    import pathlib

    import yaml

    import kubernetes_tpu_torch.perf.runner as runner_mod
    from kubernetes_tpu_torch.scheduler import SchedulerConfig

    path = pathlib.Path(runner_mod.__file__).parent / "performance-config.yaml"
    case = next(c for c in yaml.safe_load(path.read_text())
                if c["name"] == "SchedulingPodAntiAffinity")
    made, base = [], runner_mod.ClusterState

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    runner_mod.ClusterState = Recording
    try:
        results = [
            runner_mod.PerfRunner(
                SchedulerConfig(batch_size=256, solver=ExactSolverConfig(tie_break="first")),
                device=dev,
            ).run_workload(case["name"], "500Nodes", case["workloadTemplate"],
                           case["workloads"][0]["params"], path.parent)
            for dev in (cuda_device, "cpu")
        ]
    finally:
        runner_mod.ClusterState = base
    card, cpu = results
    assert card.scheduled == cpu.scheduled == 400
    assert card.unschedulable == cpu.unschedulable
    bindings = [{p.key: p.node_name for p in cs.list_pods()} for cs in made]
    assert bindings[0] == bindings[1]


# -- the auction, the relax planner, the bulk path, the rebalancer -----------


def _dense_tie_batches(n_nodes=2000, n_pods=6000, seed=0):
    """Four fill levels over the nodes (each headroom score shared by ~500
    nodes) and four request classes: the top-T window cuts through long
    runs of equal scores in every round."""
    from kubernetes_tpu_torch.server.bulk import columnar_pod_batch
    from kubernetes_tpu_torch.tensorize.schema import NodeBatch, pad_to

    rng = np.random.default_rng(seed)
    vocab = ResourceVocab(("cpu", "memory"))
    npad = pad_to(n_nodes)
    live = np.arange(npad) < n_nodes
    alloc = np.zeros((2, npad), np.int64)
    alloc[0, :n_nodes], alloc[1, :n_nodes] = 8_000, 32 << 30
    level = rng.integers(0, 4, n_nodes)
    used = np.zeros((2, npad), np.int64)
    used[0, :n_nodes], used[1, :n_nodes] = level * 1_000, level * (4 << 30)
    cnt = np.zeros(npad, np.int32)
    cnt[:n_nodes] = level

    def nodes():
        return NodeBatch(
            vocab=vocab, names=[f"n{i}" for i in range(n_nodes)], num_nodes=n_nodes,
            padded=npad, allocatable=alloc.copy(), used=used.copy(), nonzero_used=used.copy(),
            pod_count=cnt.copy(), max_pods=np.where(live, 110, 0).astype(np.int32),
            valid=live.copy(), schedulable=live.copy())

    cpu = np.array([250, 500, 750, 1000])[rng.integers(0, 4, n_pods)].astype(np.int64)
    pods = columnar_pod_batch(cpu, cpu * (1 << 20),
                              rng.integers(0, 3, n_pods).astype(np.int32), vocab)
    return nodes, pods


@pytest.mark.parametrize("objective", ["spread", "pack"])
def test_auction_card_equals_cpu_on_dense_ties(cuda_device, objective):
    """The auction's assignments, node state and round count on the card
    equal the CPU's bit for bit, with headroom ties on every node."""
    from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig, SingleShotSolver

    nodes, pods = _dense_tie_batches()
    out = []
    for dev in (cuda_device, "cpu"):
        nb = nodes()
        s = SingleShotSolver(SingleShotConfig(top_t=64, objective=objective), device=dev)
        out.append((s.solve(nb, pods), nb.used, nb.pod_count, s.last_rounds, s.last_reads))
    (a, u, c, r, reads), (a2, u2, c2, r2, reads2) = out
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(c, c2)
    assert (r, reads) == (r2, reads2)
    assert (a >= 0).sum() == pods.num_pods


def test_relax_plan_is_feasible_on_the_card(cuda_device):
    """The relax plan (with the auction repairing its tail) on the card
    overcommits no node, and places as many pods as the CPU's plan within
    1 % (float32 work whose order differs between the two)."""
    from kubernetes_tpu_torch.solver.relax import RelaxConfig, RelaxSolver
    from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig

    nodes, pods = _dense_tie_batches(n_nodes=1500, n_pods=20_000, seed=3)
    placed = []
    for dev in (cuda_device, "cpu"):
        nb = nodes()
        s = RelaxSolver(RelaxConfig(objective="pack"), repair=SingleShotConfig(), device=dev)
        a = s.solve(nb, pods)
        assert s.last.iterations >= 1
        assert (nb.used <= nb.allocatable).all()
        assert (nb.pod_count <= nb.max_pods).all()
        # the written-back state is the assignments' load, pod by pod
        load = np.zeros_like(nb.used)
        np.add.at(load.T, a[a >= 0], pods.req[: pods.num_pods][a >= 0])
        np.testing.assert_array_equal(load, nb.used - nodes().used)
        placed.append(int((a >= 0).sum()))
    assert abs(placed[0] - placed[1]) <= 0.01 * placed[1]


def test_bulk_single_shot_card_equals_cpu(cuda_device):
    """A BulkCore single-shot Solve on the card answers the CPU's reply."""
    from kubernetes_tpu_torch.server import tensorcodec
    from kubernetes_tpu_torch.server.bulk import BulkCore
    from kubernetes_tpu_torch.state.cluster import ClusterState

    rng = np.random.default_rng(5)
    req = tensorcodec.encode({"mode": "single_shot"}, {
        "cpu_milli": rng.integers(1, 9, 3000).astype(np.int64) * 250,
        "mem_bytes": rng.integers(1, 5, 3000).astype(np.int64) << 30,
        "priority": rng.integers(0, 5, 3000).astype(np.int32)})
    replies = []
    for dev in (cuda_device, "cpu"):
        cs = ClusterState()
        for i in range(600):
            cs.create_node(MakeNode().name(f"n{i:04}").capacity(
                {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())
        replies.append(tensorcodec.decode(BulkCore(cs, device=dev).solve(req)))
    (m1, a1), (m2, a2) = replies
    assert m1 == m2
    np.testing.assert_array_equal(a1["assignments"], a2["assignments"])
    assert (a1["assignments"] >= 0).sum() > 2000


def test_rebalancer_card_equals_cpu(cuda_device):
    """A fragmented cluster settled with the rebalancer on: the card's
    passes, evictions and final bindings equal the CPU's."""
    from kubernetes_tpu_torch.rebalance.runtime import RebalanceConfig
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState
    from kubernetes_tpu_torch.utils.clock import FakeClock

    runs = []
    for dev in (cuda_device, "cpu"):
        cs, rng = ClusterState(), np.random.default_rng(2)
        for i in range(64):
            cs.create_node(MakeNode().name(f"n{i:02}").capacity(
                {"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
        k = 0
        for i in range(64):
            for _ in range(int(rng.integers(1, 4))):
                cs.create_pod(MakePod().name(f"p{k:04}").req(
                    {"cpu": ("500m", "1")[k % 2], "memory": "1Gi"}).obj())
                cs.bind("default", f"p{k:04}", f"n{i:02}")
                k += 1
        clock = FakeClock()
        s = Scheduler(cs, SchedulerConfig(
            solver=ExactSolverConfig(tie_break="first"),
            rebalance=RebalanceConfig(interval_s=1.0, max_moves_per_cycle=32,
                                      min_packing=0.6)), clock=clock, device=dev)
        for _ in range(6):
            clock.advance(1.5)
            s.run_until_settled()
        s.rebalancer.reconcile(cs)
        runs.append(([(r.planned, r.selected, r.evicted) for r in s.rebalancer.history],
                     s.rebalancer.stats(), sorted((p.key, p.node_name) for p in cs.list_pods())))
    assert runs[0] == runs[1]
    assert runs[0][1]["evicted"] >= 1 and all(n for _, n in runs[0][2])


# -- the fleet: replicas in one process share the one card -------------------


def _fleet_bindings(dev, n_nodes=24, n_pods=48, seed=0):
    """A 2-replica fleet over one cluster and one in-process hub, "first"
    mode on a virtual clock, driven round-robin until nothing moves."""
    import random

    from kubernetes_tpu_torch.fleet import FleetConfig, OccupancyExchange
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.sim.generators import ZONE_KEY, make_node, make_pod
    from kubernetes_tpu_torch.state.cluster import ClusterState
    from kubernetes_tpu_torch.utils.clock import FakeClock

    rng = random.Random(seed)
    clock, cs = FakeClock(), ClusterState()
    for i in range(n_nodes):
        cs.create_node(make_node(f"n{i:02d}", "8", "16Gi", labels={ZONE_KEY: f"z{i % 3}"}))
    hub = OccupancyExchange(clock)
    universe = ("r0", "r1")
    scheds = [Scheduler(cs, SchedulerConfig(
        batch_size=16, solver=ExactSolverConfig(tie_break="first", balanced_fdtype="float64"),
        fleet=FleetConfig(replica=rid, replicas=universe, exchange=hub)),
        clock=clock, device=dev) for rid in universe]
    for i in range(n_pods):
        cs.create_pod(make_pod(f"p{i:03d}", "500m", shape=rng.choice(("plain", "spread", "anti"))))
    for _ in range(8):
        for s in scheds:
            s.run_until_settled()
        clock.advance(11.0)
        for s in scheds:
            with cs.lock:
                s.queue.move_all_to_active_or_backoff()
    return {p.key: p.node_name for p in cs.list_pods()}, cs


def test_fleet_card_equals_cpu(cuda_device):
    dc.LAUNCHES = 0
    card, _ = _fleet_bindings(cuda_device)
    assert dc.LAUNCHES > 0  # the replicas' spread and anti rows ran the kernel
    cpu, _ = _fleet_bindings(torch.device("cpu"))
    assert card == cpu
    assert sum(1 for n in card.values() if n) >= 40


def test_fleet_drain_backlog_loses_nothing_on_the_card(cuda_device):
    """The fleet backlog drain on the card: one relax plan, the ledger at
    an in-process hub, 2 replicas loop ``fleet_drain_backlog``; every pod
    bound exactly once, the ledger complete."""
    from kubernetes_tpu_torch.fleet import FleetConfig, OccupancyExchange
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.sim.generators import ZONE_KEY, make_node, make_pod
    from kubernetes_tpu_torch.sim.invariants import BindTransitionTracker
    from kubernetes_tpu_torch.state.cluster import ClusterState
    from kubernetes_tpu_torch.utils.clock import FakeClock

    clock, cs = FakeClock(), ClusterState()
    for i in range(32):
        cs.create_node(make_node(f"n{i:02d}", "8", "16Gi", labels={ZONE_KEY: f"z{i % 3}"}))
    tracker = BindTransitionTracker(cs)
    hub = OccupancyExchange(clock)
    cfg = dict(batch_size=64, solver=ExactSolverConfig(tie_break="first"))
    scheds = [Scheduler(cs, SchedulerConfig(**cfg, fleet=FleetConfig(
        replica=rid, replicas=("r0", "r1"), exchange=hub)), clock=clock, device=cuda_device)
        for rid in ("r0", "r1")]
    planner = Scheduler(cs, SchedulerConfig(**cfg), clock=clock, device=cuda_device)
    for i in range(256):
        cs.create_pod(make_pod(f"d{i:04d}", "250m"))
    plan = planner.relax_plan_backlog()
    cs.unsubscribe(planner._on_event)
    keys = list(plan)
    scheds[0].fleet.drain_init_from_plan(plan, keys)
    drained = 0
    for _ in range(4):
        for s in scheds:
            out = s.fleet_drain_backlog(chunk_pods=64, plan_keys=set(keys))
            drained += out["drained"]
            tracker.record_results([kn for r in out["results"] for kn in r.scheduled])
    violations = []
    tracker.drain(0, violations)
    assert not violations
    assert drained == 256 == sum(1 for p in cs.list_pods() if p.node_name)
    assert hub.drain_status()["complete"]


def _race_worker(addr, rid, barrier, out_q):
    """One replica process with a CUDA context of its own on the card."""
    import torch

    from kubernetes_tpu_torch.fleet import AdmitConflict, PodRow, RemoteOccupancyExchange

    torch.zeros(1, device="cuda")  # hold a CUDA context while racing
    remote = RemoteOccupancyExchange(addr, rid)
    try:
        view = remote.peers_view(rid)
        barrier.wait(timeout=60)
        row = PodRow(pod=f"default/{rid}", node=f"{rid}-node", zone="z0",
                     namespace="default", labels=(("app", "spread"),))
        try:
            remote.compare_and_stage(rid, row, view.version)
            out_q.put((rid, "won", None))
        except AdmitConflict as e:
            out_q.put((rid, "conflict", bool(e.fenced)))
    finally:
        remote.close()


def test_two_process_race_exactly_one_winner_on_the_card(cuda_device):
    """Two spawned replica processes, each holding a CUDA context on the one
    card, race a hard-spread admission through the port's gRPC hub at the
    same view version: the fenced compare-and-stage lands exactly one."""
    import multiprocessing

    from kubernetes_tpu_torch.fleet import OccupancyExchange
    from kubernetes_tpu_torch.server.bulk import BulkCore, make_grpc_server
    from kubernetes_tpu_torch.state.cluster import ClusterState

    hub = OccupancyExchange()
    server, port = make_grpc_server(BulkCore(ClusterState(), exchange=hub, device=cuda_device))
    server.start()
    ctx = multiprocessing.get_context("spawn")
    barrier, out_q = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=_race_worker, args=(f"127.0.0.1:{port}", rid, barrier, out_q))
             for rid in ("r0", "r1")]
    try:
        for p in procs:
            p.start()
        results = [out_q.get(timeout=120) for _ in procs]
        assert sorted(o for _r, o, _f in results) == ["conflict", "won"], results
        assert [f for _r, o, f in results if o == "conflict"] == [False]
        winner = [r for r, o, _f in results if o == "won"][0]
        assert [r.pod for r in hub.peers_view("observer").pod_rows] == [f"default/{winner}"]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
        server.stop(grace=None)


# -- the kernel build cache (utils/compile_cache.py) ------------------------

# one child process: domain_counts at 6b's in + ex shape, built and loaded
# through $KUBERNETES_TPU_COMPILE_CACHE, held exactly to its plain version;
# "prebuilt" takes the compiler away
_CACHE_CHILD = r"""
import json, sys
import numpy as np
import torch
from kubernetes_tpu_torch import build
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.ops import prng
from kubernetes_tpu_torch.ops import threefry as tf

builds = []
build.BUILD_LISTENERS.append(lambda name, s: builds.append(name))
if sys.argv[1] == "prebuilt":
    def no_compiler():
        raise build.KernelError("a prebuilt directory needs no compiler")
    build.nvcc = no_compiler
rng = np.random.default_rng(3)
sets = [(torch.from_numpy(rng.integers(-1, 8192, (8, 5120)).astype(np.int32)).cuda(),
         torch.from_numpy(rng.integers(0, 5, (8, 5120)).astype(np.int32)).cuda(), None)
        for _ in range(2)]
try:
    got = dc.aggregate(sets, 8192)
except build.KernelError as e:
    print(json.dumps({"error": str(e), "builds": len(builds)}))
    sys.exit(0)
want = dc.aggregate_plain(sets, 8192)
torch.cuda.synchronize()
exact = all(torch.equal(g, w) for gp, wp in zip(got, want) for g, w in zip(gp, wp))
print(json.dumps({"builds": len(builds), "launches": dc.LAUNCHES, "exact": exact,
                  "library": str(build.library_path("domain_counts"))}))
"""


def _cache_child(mode, cache_dir):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "KUBERNETES_TPU_COMPILE_CACHE": str(cache_dir)}
    proc = subprocess.run([sys.executable, "-c", _CACHE_CHILD, mode], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_build_cache_cold_warm_prebuilt_on_the_card(cuda_device, tmp_path):
    """A cold directory builds once, the same directory in a new process
    builds nothing, a read-only copy with no compiler builds nothing; each
    launch is exact. A directory that cannot be created raises KernelError
    naming it."""
    import shutil

    cold = tmp_path / "cache"
    got = _cache_child("cold", cold)
    assert got == {**got, "builds": 1, "launches": 1, "exact": True}
    assert got["library"].startswith(str(cold))
    got = _cache_child("warm", cold)
    assert got == {**got, "builds": 0, "launches": 1, "exact": True}
    pre = tmp_path / "prebuilt"
    shutil.copytree(cold, pre)
    pre.chmod(0o555)
    try:
        got = _cache_child("prebuilt", pre)
    finally:
        pre.chmod(0o755)
    assert got == {**got, "builds": 0, "launches": 1, "exact": True}
    assert got["library"].startswith(str(pre))
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    got = _cache_child("unwritable", blocker / "cache")
    assert str(blocker / "cache") in got["error"] and got["builds"] == 0


# -- the node-axis mesh: k shards on cuda:0 ---------------------------------


def _card_mesh(k):
    from kubernetes_tpu_torch.parallel.sharding import NodeMesh

    return NodeMesh(("cuda:0",) * k)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_counts_only_launch_per_shard(cuda_device, k):
    """A sharded aggregation: one counts-only launch per shard over its
    node block, each exact against plain, and the shards' sums equal the
    unsharded kernel's counts."""
    dom, cnt = _inputs(k, 16, 5120, 8192, cuda_device)
    w = 5120 // k
    before = dc.LAUNCHES
    parts = [dc.aggregate([(dom[:, s * w:(s + 1) * w].contiguous(),
                            cnt[:, s * w:(s + 1) * w].contiguous(), None)], 8192,
                          gather=False)[0][0] for s in range(k)]
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + k
    for s, p in enumerate(parts):
        assert_exact(p, dc.domain_counts_plain(dom[:, s * w:(s + 1) * w],
                                               cnt[:, s * w:(s + 1) * w], 8192),
                     f"seed {k}, shard {s} of {k}")
    assert_exact(sum(parts[1:], parts[0]), dc.domain_counts(dom, cnt, 8192),
                 f"seed {k}, the sum over {k} shards")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("tie", ["first", "random"])
def test_sharded_solve_equals_unsharded_on_the_card(cuda_device, k, tie):
    """The scan (spread, interpod, hostPorts) and the grouped kinds on k
    shards of the card equal the unsharded card solve bit for bit, in both
    tie-break modes, and launch k counts-only kernels per aggregation."""
    nodes, pods = _cluster(256, 96)
    cfg = ExactSolverConfig(tie_break=tie, group_size=1)
    flat = _tensorize(nodes, pods)
    before = dc.LAUNCHES
    want = ExactSolver(cfg).solve(*flat, device=cuda_device)
    flat_launches = dc.LAUNCHES - before
    sharded = _tensorize(nodes, pods)
    before = dc.LAUNCHES
    got = ExactSolver(cfg).solve(*sharded, mesh=_card_mesh(k))
    assert dc.LAUNCHES - before == k * flat_launches
    np.testing.assert_array_equal(got, want)
    for key in ("used", "nonzero_used", "pod_count"):
        np.testing.assert_array_equal(getattr(sharded[0], key), getattr(flat[0], key))
    for kind in ("spread", "anti", "plain"):
        kp = [MakePod().name(f"{kind}{i}").label("app", kind).req({"cpu": "250m"})
              for i in range(128)]
        if kind == "spread":
            kp = [b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": kind}) for b in kp]
        elif kind == "anti":
            kp = [b.pod_anti_affinity(HOST, {"app": kind}) for b in kp]
        kp = [b.obj() for b in kp]
        gcfg = ExactSolverConfig(tie_break=tie, group_size=64)
        want = ExactSolver(gcfg).solve(*_tensorize(nodes, kp), device=cuda_device)
        got = ExactSolver(gcfg).solve(*_tensorize(nodes, kp), mesh=_card_mesh(k))
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_sharded_scheduler_on_the_card(cuda_device):
    """The Scheduler with 4 shards of the card (mesh_devices 4 over four
    visible entries of cuda:0) binds the mixed cluster as the unsharded
    Scheduler does, every batch at the mesh rung."""
    from kubernetes_tpu_torch.parallel import sharding
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState

    def drive(k):
        nodes, pods = _cluster(120, 160)
        cs = ClusterState()
        cs.create_nodes(nodes)
        cs.create_pods(pods)
        saved = sharding.forced_device_count()
        sharding.force_device_count(k, cuda_device)
        try:
            s = Scheduler(cs, SchedulerConfig(
                batch_size=64, mesh_devices=k,
                solver=ExactSolverConfig(tie_break="first")), device=cuda_device)
        finally:
            sharding.force_device_count(*saved)
        assert (s.mesh.size if s.mesh else 1) == k
        s.run_until_settled()
        return {p.key: p.node_name for p in cs.list_pods()}, s

    want, _ = drive(1)
    got, s = drive(4)
    assert got == want and s.resilience.ladder[0] == "mesh"
    assert set(s._tier_last.values()) == {"mesh"}


# -- the scan step's CUDA graphs (solver/graphs.py) ----------------------------


def _graph_pods(n, kinds=("ports", "spread", "anti", "pref"), prefix="s", bad_every=0):
    """interpod5k's four kinds (hostPort, hard zone spread, required hostname
    anti-affinity, preferred zone affinity) in turn; every ``bad_every``-th
    pod requests a resource no node has, an invalid scan row."""
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        req = {"cpu": "100m", "memory": "500Mi"}
        if bad_every and i % bad_every == bad_every - 1:
            req["example.com/missing"] = "1"
        b = MakePod().name(f"{prefix}{i:04}").label("app", kind).req(req)
        if kind == "ports":
            b = b.host_port(8000 + i % 8)
        elif kind == "spread":
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
        elif kind == "anti":
            b = b.pod_anti_affinity(HOST, {"app": "anti"})
        elif kind == "pref":
            b = b.preferred_pod_affinity(50, ZONE, {"app": "spread"})
        out.append(b.obj())
    return out


def _graph_inputs(nodes, pods):
    vocab = ResourceVocab.build([], nodes)  # a resource no node has stays unknown
    nb = build_node_batch(nodes, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (nb, pb, st, build_port_tensors(pods, pb, slots, {}, nb.padded),
            build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
            build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad))


GRAPH_CASES = {
    "standalone": dict(mode="standalone", pods=lambda: _graph_pods(512)),
    "session": dict(mode="session", pods=lambda: _graph_pods(512)),
    "chained": dict(mode="chained", pods=lambda: _graph_pods(512, bad_every=37)),
    "invalid_rows": dict(mode="standalone", pods=lambda: _graph_pods(512, bad_every=7)),
    # chunks of identical plain pods (kind 1) between mixed ones (KIND_SLOW)
    "grouped_slow": dict(mode="standalone", group=64, pods=lambda: (
        _graph_pods(128, kinds=("plain",)) + _graph_pods(192, kinds=("ports", "anti", "spread"),
                                                         prefix="q", bad_every=5)
        + _graph_pods(64, kinds=("plain",), prefix="r")
        + _graph_pods(128, kinds=("anti", "ports"), prefix="t", bad_every=6))),
}


def _graph_solve(monkeypatch, dev, spec, tie, graphs: bool):
    """One solve of ``spec`` with the step graphs on or off: assignments,
    carried state, the stream's key words, launch deltas and the solver."""
    from kubernetes_tpu_torch.solver import graphs as sg

    made = []

    class Recorded(tf.Stream):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    with monkeypatch.context() as mp:
        mp.setattr(tf, "Stream", Recorded)
        if not graphs:
            mp.setattr(sg, "engages", lambda *a: False)
        nodes, _ = _cluster(1024, 0)
        inp = _graph_inputs(nodes, spec["pods"]())
        solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=2026, balanced_fdtype="float64",
                                               group_size=spec.get("group", 1)))
        l0 = (dc.LAUNCHES, tf.SCAN_LAUNCHES, tf.GROUPED_LAUNCHES)
        if spec["mode"] == "standalone":
            got = solver.solve(*inp, device=dev)
            state = [getattr(inp[0], k).copy() for k in ("used", "nonzero_used", "pod_count")]
        else:
            versions = np.zeros(inp[0].padded, np.int64)
            out = solver.solve(*inp, col_versions=versions, defer_read=True,
                               split=4 if spec["mode"] == "chained" else 1, device=dev)
            handles = out if isinstance(out, list) else [out]
            got = np.concatenate([h.get() for h in handles])
            p = solver._session.persist
            state = [p["i64"][0].cpu().numpy(), p["pod_count"][0].cpu().numpy()]
        torch.cuda.synchronize()
        launches = tuple(b - a for a, b in zip(l0, (dc.LAUNCHES, tf.SCAN_LAUNCHES,
                                                     tf.GROUPED_LAUNCHES)))
        stream = (solver.graphs.stream if graphs else made[-1]) if tie == "random" else None
        key = stream.key_words() if stream is not None else None
    return got, state, key, launches, solver


@pytest.mark.parametrize("tie", ["first", "random"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_step_graphs_equal_the_eager_steps_on_the_card(cuda_device, monkeypatch, tie, case):
    """An interpod5k-shaped batch solved with the step graphs equals the
    eager solve bit for bit: assignments, carried state and the stream's
    key; the launch counters advance by the same counts, so the
    hand-written kernels are seen launching inside the graphs."""
    spec = GRAPH_CASES[case]
    want, want_state, want_key, want_l, _ = _graph_solve(monkeypatch, cuda_device, spec, tie, False)
    got, state, key, launches, solver = _graph_solve(monkeypatch, cuda_device, spec, tie, True)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(state, want_state):
        np.testing.assert_array_equal(a, b)
    assert key == want_key
    assert launches == want_l and launches[0] > 0
    if tie == "random":
        assert launches[1] > 0
    counts = solver.times.counts
    assert counts["graph_captures"] > 0 and counts["graph_replays"] > 0.9 * counts["scan_steps"]


def test_step_graphs_recapture_when_the_class_tables_change_on_the_card(cuda_device, monkeypatch):
    """Session solves on one solver: the same batch again replays the
    graphs it has; a batch of other kinds brings other class tables, so
    every graph is dropped and captured anew, and each solve equals the
    eager solver's on the same sequence."""
    from kubernetes_tpu_torch.solver import graphs as sg

    nodes, _ = _cluster(1024, 0)
    batches = [_graph_pods(256, prefix="a"), _graph_pods(256, prefix="a"),
               _graph_pods(256, kinds=("ports", "anti"), prefix="b")]
    cfg = ExactSolverConfig(tie_break="random", seed=7, balanced_fdtype="float64")
    versions = np.zeros(_graph_inputs(nodes, batches[0])[0].padded, np.int64)
    out = {}
    for graphs in (True, False):
        solver = ExactSolver(cfg)
        with monkeypatch.context() as mp:
            if not graphs:
                mp.setattr(sg, "engages", lambda *a: False)
            seen = []
            for pods in batches:
                a = solver.solve(*_graph_inputs(nodes, pods), col_versions=versions.copy(),
                                 device=cuda_device)
                counts = solver.times.counts
                seen.append((a, counts["graph_captures"], counts["graph_replays"],
                             solver.graphs.epoch if graphs else None))
        out[graphs] = seen
    for (a, *_), (b, *_) in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    (_, c0, _, e0), (_, c1, r1, e1), (_, c2, _, e2) = out[True]
    assert c0 == 4 and c1 == 0 and r1 == 256 and e1 == e0
    assert c2 == 2 and e2 != e0


# -- the quota iterations' CUDA graphs (solver/graphs.py) ----------------------


def _quota_nodes(n, varied=False):
    """``n`` nodes in 3 zones; ``varied``: CPU capacities at which a 2-CPU
    pod's LeastAllocated score takes 50 values, one each 50th node, so
    that ties are few and an anti chunk takes many iterations."""
    return [MakeNode().name(f"n{i:04}").capacity(
        {"cpu": f"{-(-200_000 // (50 - i % 50))}m" if varied else "16", "memory": "64Gi",
         "pods": "110"})
        .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:04}").obj() for i in range(n)]


def _quota_pods(n, kind, prefix, skew=1, bad_every=0, cpu="250m"):
    """``n`` identical pods of ``kind`` ("spread": one hard zone spread at
    maxSkew ``skew``; "anti": required self-selecting hostname
    anti-affinity; "mixed": one-off requests, a chunk the scan steps over);
    every ``bad_every``-th requests a resource no node has."""
    out = []
    for i in range(n):
        req = {"cpu": f"{250 + 10 * i}m" if kind == "mixed" else cpu, "memory": "512Mi"}
        if bad_every and i % bad_every == bad_every - 1:
            req["example.com/missing"] = "1"
        b = MakePod().name(f"{prefix}{i:04}").label("app", f"{prefix}-{kind}").req(req)
        if kind == "spread":
            b = b.spread_constraint(skew, ZONE, "DoNotSchedule", {"app": f"{prefix}-{kind}"})
        elif kind == "anti":
            b = b.pod_anti_affinity(HOST, {"app": f"{prefix}-{kind}"})
        out.append(b.obj())
    return out


QUOTA_GRAPH_CASES = {
    # maxSkew 1 from empty zones: the water-fill is kept, in replays too
    "spread_skew1": dict(mode="standalone", batches=lambda: [_quota_pods(512, "spread", "a")]),
    "spread_skew5": dict(mode="standalone",
                         batches=lambda: [_quota_pods(512, "spread", "a", skew=5)]),
    # nodes of differing sizes and pods of 2 CPUs: few ties, many iterations
    "anti": dict(mode="standalone", varied=True,
                 batches=lambda: [_quota_pods(256, "anti", "a", cpu="2")]),
    # a scan chunk whose last rows are invalid owes the stream splits, which
    # the next spread chunk's first iteration pays
    "owed_splits": dict(mode="standalone", batches=lambda: [
        _quota_pods(256, "spread", "a") + _quota_pods(64, "mixed", "m", bad_every=4)
        + _quota_pods(256, "spread", "a")]),
    # two session solves under one epoch, each with a new i32 state tensor
    "two_solves": dict(mode="session", batches=lambda: [_quota_pods(256, "spread", "a"),
                                                        _quota_pods(256, "spread", "a")]),
}


def _quota_graph_run(monkeypatch, dev, spec, graphs: bool):
    """The case's solves on one solver with the graphs on or off: per solve
    (assignments, carried state, the stream's key, the solver's counts,
    the launch deltas); the stream's key after every fast chunk; and each
    quota iteration's (replayed, exit row read)."""
    from kubernetes_tpu_torch.solver import graphs as sg
    from kubernetes_tpu_torch.solver import grouped as gp

    made, keys, outcomes, reads = [], [], [], []

    class Recorded(tf.Stream):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    real_chunk, real_iter, real_read = gp.fast_chunk, sg._Pass.iteration, gp._read_placed

    def chunk(*a, **k):
        out = yield from real_chunk(*a, **k)
        keys.append(k["stream"].key_words())
        return out

    def iteration(self, *a):
        out = real_iter(self, *a)
        outcomes.append(out is not None)
        return out

    def read(parts):
        got = real_read(parts)
        reads.append(got[0])
        return got

    out = []
    with monkeypatch.context() as mp:
        mp.setattr(tf, "Stream", Recorded)
        mp.setattr(gp, "fast_chunk", chunk)
        mp.setattr(gp, "_read_placed", read)
        mp.setattr(sg._Pass, "iteration", iteration)
        if not graphs:
            mp.setattr(sg, "engages", lambda *a: False)
        nodes = _quota_nodes(600, spec.get("varied", False))
        solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=2026,
                                               balanced_fdtype="float64"))
        for pods in spec["batches"]():
            inp = _graph_inputs(nodes, pods)
            l0 = (dc.LAUNCHES, tf.SCAN_LAUNCHES, tf.GROUPED_LAUNCHES)
            if spec["mode"] == "standalone":
                got = solver.solve(*inp, device=dev)
                state = [getattr(inp[0], k).copy() for k in ("used", "nonzero_used", "pod_count")]
            else:
                versions = np.zeros(inp[0].padded, np.int64)
                got = solver.solve(*inp, col_versions=versions, device=dev)
                p = solver._session.persist
                state = [p["i64"][0].cpu().numpy(), p["pod_count"][0].cpu().numpy()]
            torch.cuda.synchronize()
            launches = tuple(b - a for a, b in zip(l0, (dc.LAUNCHES, tf.SCAN_LAUNCHES,
                                                         tf.GROUPED_LAUNCHES)))
            stream = solver.graphs.stream if graphs else made[-1]
            tm = solver.times
            out.append((got, state, stream.key_words(), dict(
                tm.counts, card_reads=tm.card_reads), launches))
    return out, keys, outcomes, reads


@pytest.mark.parametrize("case", sorted(QUOTA_GRAPH_CASES))
def test_quota_graphs_equal_the_eager_loop_on_the_card(cuda_device, monkeypatch, case):
    """Spread and anti chunks solved with the quota iterations' graphs equal
    the eager loop bit for bit: assignments, carried state, the stream's
    key after every chunk; the hand-written kernels' launch counts are the
    eager run's; the replays and the eager iterations add up to the
    iterations, which equal the grouped card reads. The spread chunks'
    fused loop is off here (ops/grouped_spread.py), so that they iterate
    through the graphs as a chunk it does not take does."""
    from kubernetes_tpu_torch.ops import grouped_spread as gs

    monkeypatch.setattr(gs, "engages", lambda *a: False)
    spec = QUOTA_GRAPH_CASES[case]
    want, want_keys, none, want_reads = _quota_graph_run(monkeypatch, cuda_device, spec, False)
    got, keys, outcomes, reads = _quota_graph_run(monkeypatch, cuda_device, spec, True)
    assert none == [] and keys == want_keys and reads == want_reads
    quota = ("spread", "anti")
    for (a, sa, ka, ca, la), (b, sb, kb, cb, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y)
        assert ka == kb
        assert la == lb and la[0] > 0 and la[2] > 0
        assert ca["grouped_iterations"] == ca["card_reads"] == cb["card_reads"]
        for k in quota:
            assert ca[f"chunk_iterations.{k}"] == cb[f"chunk_iterations.{k}"]
            assert cb[f"grouped_graph_replays.{k}"] == cb[f"grouped_graph_captures.{k}"] == 0
    counts = [c for _, _, _, c, _ in got]
    replays = sum(c[f"grouped_graph_replays.{k}"] for c in counts for k in quota)
    iterations = sum(c[f"chunk_iterations.{k}"] for c in counts for k in quota)
    # every quota iteration went through the pass: replayed or eager
    assert len(outcomes) == iterations and sum(outcomes) == replays > 0.5 * iterations
    if case == "spread_skew1":
        # a replayed iteration kept the water-fill (the flag of its exit row)
        assert any(r and row[1] for r, row in zip(outcomes, reads))
    if case == "anti":
        assert counts[0]["grouped_graph_replays.anti"] > 0
    if case == "two_solves":
        assert counts[1]["grouped_graph_captures.spread"] == 0
        assert counts[1]["grouped_graph_replays.spread"] == counts[1]["chunk_iterations.spread"]


@pytest.mark.parametrize("shape", ["scan", "anti"])
def test_graph_captures_feed_the_capture_stage_on_the_card(cuda_device, shape):
    """The card captures real CUDA graphs, of the scan's steps (one-off
    pods, group 1) or of the anti chunks' iterations (hostname-anti pods,
    group 16): each capture is the solve's ``capture`` sub-stage, whose
    seconds the StageProfiler folds inside ``issue``, and a span, a child of
    ``issue``, that carries its kind, one a capture the counts record."""
    import json

    from kubernetes_tpu_torch.obs import ObsConfig
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState

    cs = ClusterState()
    cs.create_nodes(MakeNode().name(f"n{i:03}").capacity({"cpu": "8", "memory": "32Gi", "pods": "40"})
                    .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:03}").obj() for i in range(128))
    for i in range(96):
        b = MakePod().name(f"p{i:03}").label("app", shape).req({"cpu": "100m", "memory": "256Mi"})
        cs.create_pod((b.pod_anti_affinity(HOST, {"app": shape}) if shape == "anti" else b).obj())
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=96, obs=ObsConfig(profile=True, spans=True),
        solver=ExactSolverConfig(tie_break="random", seed=5, group_size=1 if shape == "scan" else 16)),
        device=cuda_device)
    assert sum(len(r.scheduled) for r in sched.run_pipelined()) == 96
    entries = sched.telemetry.profiler.snapshot()["recent"]
    spans = [d for d in map(json.loads, sched.flight.lines()) if d.get("k") == "span"]
    by_id = {s["span"]: s for s in spans}
    captures = [s for s in spans if s["name"] == "capture"]
    key = "graph_captures" if shape == "scan" else "grouped_graph_captures.anti"
    want = sum(e[key] for e in entries)
    assert want > 0 and len(captures) == want
    assert all(s["attrs"]["kind"] == shape and by_id[s["parent"]]["name"] == "issue" for s in captures)
    assert all(0.0 <= e["stages"]["capture"] <= e["stages"]["issue"] for e in entries)
    assert sum(e["stages"]["capture"] for e in entries) > 0.0
