"""The port's node-axis sharding (``kubernetes_tpu_torch/parallel/sharding.py``)
on the CPU: k shards of one device, k in {1, 2, 3, 8}, against the port
unsharded and against the JAX package on its 8-device CPU mesh
(``tests/conftest.py``), on the same numpy inputs. The cases are
``tests/test_sharding.py``'s, carried over.

Bit for bit everywhere but the relax planner, whose float32 softmax sums
change order with the shard count: it is held to ``tests/test_torch_relax.py``'s
stated tolerance (the same iterations and seated pods, prices within
``PRICE_RTOL`` / ``PRICE_ATOL``, at least ``MIN_EQUAL_SHARE`` of the
assignments equal) and to no overcommit. A 384-column padding
(``lcm(LANE, 3)``) serves k = 3 and the JAX package's 8-way mesh alike.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_relax import MIN_EQUAL_SHARE, PRICE_ATOL, PRICE_RTOL, check_feasible
from test_torch_tensorize import mixed_cluster

import kubernetes_tpu.api.wrappers as ref_wrappers
from kubernetes_tpu.parallel import sharding as ref_sharding
from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
from kubernetes_tpu.solver.single_shot import SingleShotConfig as RefSSConfig
from kubernetes_tpu.solver.single_shot import SingleShotSolver as RefSSSolver
from kubernetes_tpu.tensorize import schema as ref_schema
from kubernetes_tpu.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu.tensorize.spread import build_spread_tensors
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.parallel import sharding as sh
from kubernetes_tpu_torch.solver.exact import ExactSolver
from kubernetes_tpu_torch.solver.relax import RelaxConfig, RelaxSolver
from kubernetes_tpu_torch.solver.single_shot import SingleShotConfig, SingleShotSolver

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
PAD = 384  # lcm(LANE, 3), a multiple of 8
KS = (1, 2, 3, 8)
STATE = ("used", "nonzero_used", "pod_count")


@pytest.fixture(autouse=True)
def _visible_list():
    """Every test leaves the visible device list as it found it."""
    saved = sh.forced_device_count()
    yield
    sh.force_device_count(*saved)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices tests/conftest.py forces")
    return Mesh(np.array(jax.devices()[:8]), axis_names=("nodes",))


def cpu_mesh(k: int):
    return sh.NodeMesh(("cpu",) * k)


# -- inputs ----------------------------------------------------------------


def _shape_pod(w, i: int, kind: str):
    b = w.MakePod().name(f"{kind}{i:03}").req({"cpu": "100m", "memory": "256Mi"})
    if kind == "spread":
        b = b.label("app", "spread").spread_constraint(1, ZONE, "DoNotSchedule",
                                                       {"app": "spread"})
    elif kind == "anti":
        b = b.label("app", "anti").pod_anti_affinity(HOST, {"app": "anti"})
    elif kind == "ports":
        b = b.host_port(8000 + i % 3)
    return b.obj()


def _shape_nodes(w, n):
    return [w.MakeNode().name(f"n-{i:04}").capacity({"cpu": "8", "memory": "32Gi", "pods": "40"})
            .label(ZONE, f"z{i % 3}").label(HOST, f"n-{i:04}").obj() for i in range(n)]


def ref_inputs(nodes, pods, placed_by_node=None, pad=PAD):
    """The JAX package's tensorizers over ``pad`` node columns."""
    placed_by_node = placed_by_node or {}
    all_pods = pods + [p for ps in placed_by_node.values() for p in ps]
    vocab = ref_schema.ResourceVocab.build(all_pods, nodes)
    nb = ref_schema.build_node_batch(nodes, placed_by_node, vocab=vocab, pad=pad)
    pb = ref_schema.build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    by_slot = {i: placed_by_node[n.name] for i, n in enumerate(nodes) if n.name in placed_by_node}
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (nb, pb, st, build_port_tensors(pods, pb, slots, by_slot, nb.padded),
            build_spread_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad),
            build_interpod_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad))


def mixed_inputs(n_pods=64):
    return ref_inputs(*mixed_cluster(ref_wrappers, 256, n_pods, placed_every=5))


def shape_inputs(kind, n_nodes=256, n_pods=48):
    return ref_inputs(_shape_nodes(ref_wrappers, n_nodes),
                      [_shape_pod(ref_wrappers, i, kind) for i in range(n_pods)])


def ref_solve(inputs, mesh=None, tie="first", **cfg):
    inputs = copy.deepcopy(inputs)
    solver = RefSolver(RefConfig(tie_break=tie, balanced_fdtype="float64", seed=5, **cfg))
    got = np.asarray(solver.solve(*inputs, mesh=mesh))
    return got, {k: np.asarray(getattr(inputs[0], k)) for k in STATE}


def port_solve(inputs, k=None, tie="first", **cfg):
    """The port's solve on fresh copies of the JAX package's inputs; k None
    is the unsharded path, k an int a k-shard CPU mesh."""
    p_in = convert.solve_inputs(*copy.deepcopy(inputs))
    solver = ExactSolver(convert.solver_config(
        RefConfig(tie_break=tie, balanced_fdtype="float64", seed=5, **cfg)))
    mesh = cpu_mesh(k) if k else None
    got = solver.solve(*p_in, mesh=mesh, device="cpu")
    return np.asarray(got), {s: getattr(p_in[0], s) for s in STATE}


def same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for s in STATE:
        np.testing.assert_array_equal(a[1][s], b[1][s], err_msg=s)


# -- 0. resolve_mesh against the reference (the repaired refusal) ----------


@pytest.mark.parametrize("visible", [1, 2, 8])
def test_resolve_mesh_matches_the_reference(visible, monkeypatch):
    """The JAX package's resolve_mesh at ``visible`` devices and the port's
    at ``visible`` entries of the CPU: None alike, the same size, the same
    positions in the visible list, the same exception type and wording."""
    real = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: real[:visible])
    sh.force_device_count(visible, "cpu")
    for md in (0, 1, 2, 8):
        for sl in (None, (0, 1), (0, 2), (1, 2)):
            try:
                want = ref_sharding.resolve_mesh(md, sl)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    sh.resolve_mesh(md, sl)
                assert str(got.value) == str(e)
                continue
            got = sh.resolve_mesh(md, sl)
            if want is None:
                assert got is None, (md, sl)
                continue
            assert got.size == want.size, (md, sl)
            ids = [real.index(d) for d in want.devices.flat]
            assert sh.resolve_indices(md, sl, visible) == ids, (md, sl)


def test_node_mesh_and_placers():
    """NodeMesh checks its devices; a sharded table is a tuple of its own
    allocations (even on one device); replicated tables share one copy per
    distinct device; the placers and the tree placement follow the
    reference's node-axis-last rule."""
    with pytest.raises(ValueError, match="CUDA"):
        sh.NodeMesh(("cuda:0",))
    with pytest.raises(ValueError):
        sh.NodeMesh(())
    m = cpu_mesh(4)
    assert m.size == 4 and m.distinct == (torch.device("cpu"),) and m.shards_per_device() == 4
    a = np.arange(3 * 512, dtype=np.int64).reshape(3, 512)
    parts = sh.put_node_table(m, a, 512)
    assert len(parts) == 4 and len({p.data_ptr() for p in parts}) == 4
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), a)
    rep = sh.put_node_table(m, np.ones(8, np.int32), 512)  # no node axis: replicated
    assert all(r is rep[0] for r in rep)
    dev, dev_n = sh.placers(m, 512)
    r = dev(np.zeros(2))
    assert len(r) == 4 and all(x is r[0] for x in r)
    assert dev_n(a)[1].shape == (3, 128)
    tree = sh.shard_node_tree(m, {"alloc": a, "spr": {"max_skew": np.ones(8, np.int32)}},
                              replicate_names=sh.REPLICATED_TABLE_NAMES)
    assert tree["alloc"][2].shape == (3, 128) and tree["spr"]["max_skew"][0].shape == (8,)
    assert sh.mesh_fingerprint(None) is None
    assert sh.mesh_fingerprint(m) != sh.mesh_fingerprint(cpu_mesh(2))
    with pytest.raises(ValueError, match="not a multiple"):
        cpu_mesh(3).width(512)


# -- 1. the scan ----------------------------------------------------------


@pytest.fixture(scope="module")
def scan_reference(jmesh):
    inputs = mixed_inputs()
    want = ref_solve(inputs, jmesh, group_size=1)
    same(want, ref_solve(inputs, None, group_size=1))
    return inputs, want


@pytest.mark.parametrize("k", KS)
def test_exact_scan_sharded_equals_unsharded(k, scan_reference, monkeypatch):
    """The per-pod scan with spread (hard and soft), interpod, hostPorts and
    preferences: the port on k shards == the port unsharded == the JAX
    package's 8-way mesh, assignments and written-back node state. On
    more than one shard every aggregation is counts-only per shard (the
    per-node totals are gathered after the cross-shard sum)."""
    inputs, want = scan_reference
    calls = []
    plain = dc.aggregate_plain

    def counting(sets, d_pad, *, counts=True, gather=True):
        calls.append(gather)
        return plain(sets, d_pad, counts=counts, gather=gather)

    monkeypatch.setattr(dc, "aggregate_plain", counting)
    got = port_solve(inputs, k, group_size=1)
    same(got, want)
    if k == 1:
        same(port_solve(inputs, None, group_size=1), want)
    assert calls and all(g == (k == 1) for g in calls)
    assert (got[0] >= 0).sum() > 40


@pytest.mark.parametrize("k", [2, 3, 8])
def test_random_mode_sharded_equals_unsharded(k, jmesh):
    """tie_break="random": one draw per step or loop iteration from the
    lead's one threefry stream, whatever the shard count, so k shards ==
    unsharded bit for bit, the scan (mixed) and the grouped kinds alike;
    at k = 2 the scan and the spread kind (the water-fill's second draw)
    equal the JAX package's 8-way mesh (its draws, bit for bit)."""
    scan = mixed_inputs(48)
    got = port_solve(scan, k, tie="random", group_size=1)
    same(got, port_solve(scan, None, tie="random", group_size=1))
    if k == 2:
        same(got, ref_solve(scan, jmesh, tie="random", group_size=1))
    for kind in ("plain", "spread", "anti"):
        inputs = shape_inputs(kind, n_pods=64)
        got = port_solve(inputs, k, tie="random", group_size=16)
        same(got, port_solve(inputs, None, tie="random", group_size=16))
        if k == 2 and kind == "spread":
            same(got, ref_solve(inputs, jmesh, tie="random", group_size=16))


# -- 2. the grouped kinds and the hard shapes ------------------------------


@pytest.mark.parametrize("kind", ["plain", "ports", "spread", "anti"])
def test_exact_solver_sharded_equals_unsharded(kind, jmesh):
    """ExactSolver.solve through the production tensorizers for each hard
    shape (grouped kinds 1-3 and the ports scan): the port at k in {2, 3,
    8} == unsharded == the JAX package's 8-way mesh."""
    inputs = shape_inputs(kind)
    want = ref_solve(inputs, jmesh, group_size=16)
    for k in (None, 2, 3, 8):
        same(port_solve(inputs, k, group_size=16), want)
    assert (want[0] >= 0).sum() > 0


def test_argmax_tie_across_the_shard_boundary(jmesh):
    """Two feasible columns left: the last of shard 0 and the first of
    shard 1 (k = 2), equal scores. The lowest global index wins the first
    pod and the second lands on the next shard; only the owning shard's
    assume scatter adds."""
    w = PAD // 2
    nodes = []
    for i in range(PAD):
        b = ref_wrappers.MakeNode().name(f"n-{i:04}").capacity(
            {"cpu": "1", "memory": "4Gi", "pods": "1"}).label(ZONE, f"z{i % 3}")
        if i not in (w - 1, w):
            b = b.unschedulable(True)
        nodes.append(b.obj())
    pods = [ref_wrappers.MakePod().name(f"p{i}").req({"cpu": "500m"}).obj() for i in range(3)]
    inputs = ref_inputs(nodes, pods)
    want = ref_solve(inputs, jmesh, group_size=1)
    assert list(want[0]) == [w - 1, w, -1]
    for k in (2, 8):
        same(port_solve(inputs, k, group_size=1), want)
        got = port_solve(inputs, k, tie="random", group_size=1)
        assert sorted(got[0][:2]) == [w - 1, w] and got[0][2] == -1
        if k == 2:
            same(got, ref_solve(inputs, jmesh, tie="random", group_size=1))


def test_nominated_override_on_another_shard():
    """Nominated pods (the scan with the nominator's load) whose nominated
    slots lie on shards other than the pick's: k shards == unsharded in
    both tie-break modes."""
    import chip_smoke as cs

    nodes = cs.make_nodes(256)
    pods = [cs.make_pod(i) for i in range(48)]
    from kubernetes_tpu_torch.tensorize.schema import ResourceVocab

    def run(k, tie):
        inputs, extra = cs.tensorize(nodes, pods, {}, ResourceVocab.build(pods, nodes),
                                     nominated=cs.nominated_set(nodes, pods))
        solver = ExactSolver(convert.solver_config(RefConfig(tie_break=tie, seed=1)))
        a = solver.solve(*inputs, mesh=cpu_mesh(k) if k else None, device="cpu", **extra)
        return np.asarray(a), {s: getattr(inputs[0], s) for s in STATE}

    for tie in ("first", "random"):
        want = run(None, tie)
        for k in (2, 8):
            same(run(k, tie), want)


# -- 3. the session, the compact wire, the chained split -------------------


def _session_pods(start, n, kind="plain"):
    return [_shape_pod(ref_wrappers, start + i, kind) for i in range(n)]


def test_session_heal_touches_one_shard(jmesh):
    """Session mode on 4 shards: a dirty column heals into its owning shard
    only (every other shard's storage untouched), and the two batches
    equal the unsharded session's and the JAX package's 8-way session's.
    The same session object then moves from 4 shards to 1 and 2: each
    mesh change is a full re-upload and solves as a fresh session does."""
    nodes = _shape_nodes(ref_wrappers, 200)
    versions = np.zeros(PAD, np.int64)
    b1 = ref_inputs(nodes, _session_pods(0, 32, "spread"))
    placed = {}

    def run(solver, inputs, vers, mesh=None, ref=False):
        inputs = copy.deepcopy(inputs)
        if ref:
            return np.asarray(solver.solve(*inputs, col_versions=vers.copy(), mesh=mesh))
        return np.asarray(solver.solve(*convert.solve_inputs(*inputs), col_versions=vers.copy(),
                                       mesh=mesh, device="cpu"))

    cfg = RefConfig(tie_break="first", balanced_fdtype="float64", group_size=16)
    port = ExactSolver(convert.solver_config(cfg))
    flat = ExactSolver(convert.solver_config(cfg))
    ref = RefSolver(cfg)
    m4 = cpu_mesh(4)
    first = run(port, b1, versions, m4)
    np.testing.assert_array_equal(first, run(flat, b1, versions))
    np.testing.assert_array_equal(first, run(ref, b1, versions, jmesh, ref=True))
    # an external pod lands on column 250 (shard 2 of 4): host truth moves
    for p, a in zip(_session_pods(0, 32, "spread"), first):
        placed.setdefault(nodes[a].name, []).append(p)
        versions[a] += 1
    ext = ref_wrappers.MakePod().name("ext").req({"cpu": "7", "memory": "2Gi"}).node(
        nodes[150].name).obj()
    placed.setdefault(nodes[150].name, []).append(ext)
    b2 = ref_inputs(nodes, _session_pods(100, 32, "spread"), placed)
    sess = port._session
    before = [[t.clone() for t in sess.persist["i64"]], [t.data_ptr() for t in sess.persist["i64"]]]
    # heal only column 150 (the solver's own placements are already on the card)
    seen = sess.seen_versions.copy()
    vers2 = seen.copy()
    vers2[150] += 1
    sess.sync(convert.node_batch(copy.deepcopy(b2[0])), vers2, "cpu", mesh=m4)
    after = sess.persist["i64"]
    for s in range(4):
        assert after[s].data_ptr() == before[1][s]
        if s != 150 // (PAD // 4):
            assert torch.equal(after[s], before[0][s]), s
    assert not torch.equal(after[1], before[0][1])
    second = run(port, b2, vers2, m4)
    np.testing.assert_array_equal(second, run(flat, b2, vers2))
    np.testing.assert_array_equal(second, run(ref, b2, vers2, jmesh, ref=True))
    # one session object across mesh changes
    for mesh in (None, cpu_mesh(2)):
        fresh = ExactSolver(convert.solver_config(cfg))
        np.testing.assert_array_equal(run(port, b2, vers2, mesh), run(fresh, b2, vers2, mesh))


def test_compact_wire_and_chained_split(jmesh):
    """Session + deferred reads + split 4 on the compact wire (uniform
    chunks): the chained sub-batches on 8 shards == unsharded == the
    JAX package's 8-way mesh."""
    inputs = ref_inputs(_shape_nodes(ref_wrappers, 256), _session_pods(0, 128, "spread"))
    vers = np.zeros(PAD, np.int64)
    cfg = RefConfig(tie_break="first", balanced_fdtype="float64", group_size=16)

    def gather(handles, n):
        out = np.full(n, -1, np.int32)
        for h in handles:
            out[h.lo : h.lo + h.count] = h.get()
        return out

    ref = RefSolver(cfg)
    want = gather(ref.solve(*copy.deepcopy(inputs), col_versions=vers, defer_read=True,
                            split=4, mesh=jmesh), 128)
    for k in (None, 8):
        port = ExactSolver(convert.solver_config(cfg))
        handles = port.solve(*convert.solve_inputs(*copy.deepcopy(inputs)), col_versions=vers,
                             defer_read=True, split=4, mesh=cpu_mesh(k) if k else None,
                             device="cpu")
        np.testing.assert_array_equal(gather(handles, 128), want)
        assert port.dispatch_counts["compact_batches"] == 1
        assert port.dispatch_counts["chained_subbatches"] == 4
    key = port.stream_chain_key(*convert.solve_inputs(*copy.deepcopy(inputs)), mesh=cpu_mesh(8))
    assert key[2] == sh.mesh_fingerprint(cpu_mesh(8))


# -- 4. the Scheduler, padding, the sim ------------------------------------


def _mk_cluster(pkg_cluster, w, n_nodes=6):
    cs = pkg_cluster()
    for i in range(n_nodes):
        cs.create_node(w.MakeNode().name(f"n{i}").capacity(
            {"cpu": "8", "memory": "32Gi", "pods": "110"})
            .label(ZONE, f"z{i % 3}").label(HOST, f"n{i}").obj())
    return cs


def _drive_port(kind, mesh_devices):
    import kubernetes_tpu_torch.api.wrappers as pw
    from kubernetes_tpu_torch.obs import ObsConfig
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState

    sh.force_device_count(8, "cpu")
    cs = _mk_cluster(ClusterState, pw)
    s = Scheduler(cs, SchedulerConfig(
        batch_size=16, mesh_devices=mesh_devices,
        solver=ExactSolverConfig(tie_break="first", group_size=8),
        obs=ObsConfig(journal=True)), device="cpu")
    assert (s.mesh.size if s.mesh else 1) == mesh_devices
    for i in range(20):
        cs.create_pod(_shape_pod(pw, i, kind))
    s.run_pipelined()
    return sorted((p.name, p.node_name) for p in cs.list_pods())


@pytest.mark.parametrize("kind", ["plain", "ports", "spread", "anti"])
def test_scheduler_mesh_end_to_end_equivalence(kind, jmesh):
    """Through the Scheduler (session mode, heals, the pipelined loop):
    mesh_devices 8 binds as mesh_devices 1, and as the JAX package's
    Scheduler on its 8-device mesh."""
    from kubernetes_tpu.scheduler import Scheduler as RefScheduler
    from kubernetes_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
    from kubernetes_tpu.state.cluster import ClusterState as RefClusterState

    cs = _mk_cluster(RefClusterState, ref_wrappers)
    s = RefScheduler(cs, RefSchedulerConfig(
        batch_size=16, mesh_devices=8, solver=RefConfig(tie_break="first", group_size=8)))
    for i in range(20):
        cs.create_pod(_shape_pod(ref_wrappers, i, kind))
    s.run_pipelined()
    want = sorted((p.name, p.node_name) for p in cs.list_pods())
    assert _drive_port(kind, 8) == want
    assert _drive_port(kind, 1) == want
    assert any(n for _, n in want)


def test_padding_rows_never_bound():
    """5 nodes on an 8-shard mesh (most shards hold only padding), with a
    node deleted mid-run: no pod ever binds to a padding or deleted slot,
    and a standalone sharded solve never names one."""
    import kubernetes_tpu_torch.api.wrappers as pw
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState

    sh.force_device_count(8, "cpu")
    cs = _mk_cluster(ClusterState, pw, n_nodes=5)
    s = Scheduler(cs, SchedulerConfig(batch_size=16, mesh_devices=8,
                                      solver=ExactSolverConfig(tie_break="first", group_size=8)),
                  device="cpu")
    assert s.mesh.size == 8
    for i in range(12):
        cs.create_pod(_shape_pod(pw, i, "spread"))
    s.run_pipelined()
    live = {f"n{i}" for i in range(5)}
    for p in [p for p in cs.list_pods() if p.node_name == "n4"]:
        cs.delete_pod(p.namespace, p.name)
    cs.delete_node("n4")
    live.discard("n4")
    for i in range(12, 20):
        cs.create_pod(_shape_pod(pw, i, "anti"))
    s.run_pipelined()
    bound = [p.node_name for p in cs.list_pods() if p.node_name]
    assert bound and set(bound) <= live
    got = port_solve(ref_inputs(_shape_nodes(ref_wrappers, 5), _session_pods(0, 8), pad=128), 8,
                     group_size=8)
    assert int(got[0].max()) < 5 and int((got[0] >= 0).sum()) == 8


def test_pad_multiple_at_100k_nodes_mesh8():
    """Snapshot.pad_multiple 8 at >= 100k node counts: the padding honors
    lcm(LANE, 8) and stays masked across delete churn (host side, swept),
    and one sharded session solve at the largest binds no padding row."""
    import math

    from kubernetes_tpu_torch.api.objects import Node
    from kubernetes_tpu_torch.server.bulk import columnar_pod_batch
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.snapshot import Snapshot
    from kubernetes_tpu_torch.tensorize.schema import LANE

    q = math.lcm(LANE, 8)

    def build(n):
        cache = SchedulerCache()
        for i in range(n):
            cache.add_node(Node(name=f"n{i:06}",
                                allocatable={"cpu": 16_000, "memory": 64 << 30, "pods": 110}))
        snap = Snapshot()
        snap.pad_multiple = 8
        return cache, snap, snap.update(cache)

    from kubernetes_tpu_torch.solver.budget import node_padding

    for n in (100_003, 100_608 - 1, 100_608 + 1, 102_400 + 7):
        assert node_padding(n, 8) % q == 0 and node_padding(n, 8) >= n
    n = 102_407
    cache, snap, b = build(n)
    assert b.padded % q == 0 and b.padded == node_padding(n, 8) and int(b.valid.sum()) == n
    assert not b.schedulable[~b.valid].any()
    for i in range(0, 512, 2):
        cache.remove_node(f"n{i:06}")
    b = snap.update(cache)
    assert int(b.valid.sum()) == n - 256 and not b.schedulable[~b.valid].any()
    pb = columnar_pod_batch(np.full(16, 250, np.int64), np.full(16, 512 << 20, np.int64),
                            None, b.vocab)
    solver = ExactSolver(convert.solver_config(RefConfig(tie_break="first", group_size=16)))
    asg = solver.solve(b, pb, col_versions=snap.col_versions, mesh=cpu_mesh(8))
    assert int((asg >= 0).sum()) == 16 and all(b.valid[a] for a in asg)


def test_sim_trace_device_count_invariant():
    """churn_heavy, seed 0, 3 cycles: the trace and the decision journal at
    mesh_devices 8 are byte-identical to mesh_devices 1 and to the JAX
    package's run at 8."""
    from kubernetes_tpu.sim.harness import run_sim as ref_run_sim
    from kubernetes_tpu_torch.sim.harness import run_sim

    r1 = run_sim("churn_heavy", seed=0, cycles=3, mesh_devices=1, device="cpu")
    sh.force_device_count(8, "cpu")
    r8 = run_sim("churn_heavy", seed=0, cycles=3, mesh_devices=8, device="cpu")
    ref = ref_run_sim("churn_heavy", seed=0, cycles=3, mesh_devices=8)
    assert r1.ok and r8.ok and ref.ok
    assert r8.journal_lines == r1.journal_lines == ref.journal_lines
    assert r8.trace.lines == r1.trace.lines == ref.trace.lines


# -- 5. the auction and the relax planner ----------------------------------


def _ss_workload(w, n_nodes=256, n_pods=512, tight=False):
    rng = np.random.default_rng(42)
    nodes = [w.MakeNode().name(f"n-{i:04}").capacity(
        {"cpu": "2" if tight else "8", "memory": "32Gi", "pods": "40"}).obj()
        for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        cpu = int(rng.integers(1, 8)) * 250
        mem = int(rng.integers(1, 5)) << 29
        pods.append(w.MakePod().name(f"p-{i:04}").req({"cpu": f"{cpu}m", "memory": mem})
                    .priority(int(rng.integers(0, 5))).obj())
    vocab = ref_schema.ResourceVocab.build(pods, nodes)
    return (ref_schema.build_node_batch(nodes, vocab=vocab, pad=PAD),
            ref_schema.build_pod_batch(pods, vocab))


@pytest.mark.parametrize("tight", [False, True])
def test_single_shot_sharded_equals_unsharded(tight, jmesh):
    """The auction (top-T 16, so the shards' candidate merge decides) on k
    in {1, 2, 3, 8} shards == unsharded == the JAX package's 8-way mesh:
    assignments, node state and rounds."""
    nb, pb = _ss_workload(ref_wrappers, tight=tight)
    ref_nb = copy.deepcopy(nb)
    ref = RefSSSolver(RefSSConfig(top_t=16))
    want = np.asarray(ref.solve(ref_nb, pb, mesh=jmesh))
    for k in (None,) + KS:
        p_nb = convert.node_batch(copy.deepcopy(nb))
        solver = SingleShotSolver(SingleShotConfig(top_t=16), device="cpu")
        got = solver.solve(p_nb, convert.pod_batch(pb), mesh=cpu_mesh(k) if k else None)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(p_nb.used, np.asarray(ref_nb.used))
        np.testing.assert_array_equal(p_nb.pod_count, np.asarray(ref_nb.pod_count))
    assert (want >= 0).sum() > 0


def test_relax_sharded_within_tolerance():
    """The relax planner on k in {2, 3, 8} shards against unsharded within
    the stated tolerance, and no overcommit, on a contended shape."""
    import kubernetes_tpu_torch.api.wrappers as pw

    nodes = [pw.MakeNode().name(f"n{i:03}").capacity({"cpu": "4", "memory": "32Gi", "pods": "10"})
             .label(ZONE, f"z{i % 3}").obj() for i in range(200)]
    pods = [pw.MakePod().name(f"p{i:04}").req({"cpu": ("500m", "1", "250m")[i % 3],
                                                "memory": "1Gi"}).obj() for i in range(512)]
    from kubernetes_tpu_torch.tensorize.schema import (
        ResourceVocab,
        build_node_batch,
        build_pod_batch,
    )

    vocab = ResourceVocab.build(pods, nodes)
    pb = build_pod_batch(pods, vocab)

    def plan(k):
        nb = build_node_batch(nodes, vocab=vocab, pad=PAD)
        solver = RelaxSolver(RelaxConfig(), repair=SingleShotConfig(), device="cpu")
        return solver.solve(nb, pb, mesh=cpu_mesh(k) if k else None), solver.last

    want, wst = plan(None)
    check_feasible(nodes, pods, want)
    for k in (2, 3, 8):
        got, st = plan(k)
        check_feasible(nodes, pods, got)
        assert st.iterations == wst.iterations and st.placed_relaxed == wst.placed_relaxed
        np.testing.assert_allclose(st.node_prices, wst.node_prices, rtol=PRICE_RTOL,
                                   atol=PRICE_ATOL)
        assert np.mean(got == want) >= MIN_EQUAL_SHARE


# -- 6. the budget ----------------------------------------------------------


def test_budget_split_by_shards_per_device():
    """The drain's chunk plan follows the JAX package's at equal
    mesh_devices (the sharded tables divided by the shard count), and with
    k shards on one device the budget each shard plans against is the
    device's divided by k."""
    from kubernetes_tpu.solver import budget as ref_budget
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.solver import budget
    from kubernetes_tpu_torch.state.cluster import ClusterState

    assert budget.device_budget_bytes(1000, shards_per_device=4) == 250
    assert budget.device_budget_bytes(1000) == 1000
    sh.force_device_count(4, "cpu")
    s = Scheduler(ClusterState(), SchedulerConfig(mesh_devices=4), device="cpu")
    assert s._shards_per_device() == 4
    shape = s.drain_shape(512)
    assert shape.mesh_devices == 4 and shape.pad_multiple == 4
    ref_shape = ref_budget.DrainShape(**{f: getattr(shape, f) for f in
                                         shape.__dataclass_fields__})
    est = budget.estimate(shape)
    assert est.per_device_bytes == ref_budget.estimate(ref_shape).per_device_bytes
    # one card holding all 4 shards: 4 shares fit its budget exactly, so
    # each shard plans against a quarter, and one byte less splits
    card = 4 * est.per_device_bytes
    assert budget.device_budget_bytes(card, shards_per_device=4) == est.per_device_bytes
    assert budget.plan_chunk(shape, budget.device_budget_bytes(card, shards_per_device=4))[1] == 0
    assert budget.plan_chunk(
        shape, budget.device_budget_bytes(card - 4, shards_per_device=4))[1] >= 1
    assert budget.relax_estimate(10_240, 51_200, 8, mesh_devices=4).per_device_bytes == \
        ref_budget.relax_estimate(10_240, 51_200, 8, mesh_devices=4).per_device_bytes
