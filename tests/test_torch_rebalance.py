"""The port's continuous rebalancer against the JAX package's, on the CPU.

Every case of tests/test_rebalance.py: the detector's reports, the plan's
raw moves, the bounded ``Move`` lists and, through the real Scheduler, each
pass's ``RunRecord`` (all but its wall-clock ``plan_solve_s``), the
rebalancer's stats, the journal's eviction records and the final bindings
equal the JAX package's. The plan is the pack-objective auction, integer
work over stable sorts, so nothing here has a tolerance. Each case also
keeps the file's own property asserts on the port's side.
"""

import dataclasses
import json

import numpy as np
import pytest

from kubernetes_tpu.api.labels import Selector, requirements_from_match_labels
from kubernetes_tpu.api.objects import PodDisruptionBudget
from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.obs import ObsConfig as RefObsConfig
from kubernetes_tpu.rebalance.detector import detect as ref_detect
from kubernetes_tpu.rebalance.planner import plan_moves as ref_plan_moves
from kubernetes_tpu.rebalance.planner import select_moves as ref_select_moves
from kubernetes_tpu.rebalance.runtime import RebalanceConfig as RefRebalanceConfig
from kubernetes_tpu.scheduler import BatchResult as RefBatchResult
from kubernetes_tpu.state.cache import SchedulerCache
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.state.snapshot import Snapshot
from kubernetes_tpu.utils.clock import FakeClock
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api import objects as port_objects
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.rebalance.detector import detect, packing_score
from kubernetes_tpu_torch.rebalance.planner import plan_moves, select_moves
from kubernetes_tpu_torch.rebalance.runtime import RebalanceConfig, Rebalancer
from kubernetes_tpu_torch.scheduler import BatchResult

from _torch_sched_pair import Pair


def node(name, cpu="8", mem="16Gi", pods="110"):
    return MakeNode().name(name).capacity({"cpu": cpu, "memory": mem, "pods": pods}).obj()


def pod(name, cpu="1", mem="1Gi", prio=0, labels=None):
    mp = MakePod().name(name).req({"cpu": cpu, "memory": mem})
    if prio:
        mp = mp.priority(prio)
    for k, v in (labels or {}).items():
        mp = mp.label(k, v)
    return mp.obj()


def port_pod(p):
    return convert.api_object(p, port_objects.Pod)


def batch_of(placements, node_cpu="8", node_mem="16Gi"):
    """The JAX package's NodeBatch via its cache + snapshot path, and the
    port's copy of it: (ref batch, port batch, snapshot)."""
    c = SchedulerCache(FakeClock())
    for name in placements:
        c.add_node(node(name, cpu=node_cpu, mem=node_mem))
    for name, pods_here in placements.items():
        for pname, cpu in pods_here:
            p = pod(pname, cpu=cpu)
            p.node_name = name
            c.add_pod(p)
    snap = Snapshot()
    b = snap.update(c)
    return b, convert.node_batch(b), snap


def both_detect(placements, **kw):
    b, pb, _ = batch_of(placements)
    r = detect(pb, **kw)
    assert dataclasses.asdict(r) == dataclasses.asdict(ref_detect(b, **kw))
    return r


def move_view(plan):
    return ([(m.pod.key, m.source, m.target, m.source_slot, m.target_slot, m.gain)
             for m in plan.moves], plan.planned, plan.pdb_blocked)


def both_select(placements, specs, pdbs=(), **kw):
    """select_moves on both packages for (pod, src, dst) specs; the plans
    must be equal. Returns the port's plan."""
    b, pb, snap = batch_of(placements)
    raw = [(p, snap.slot_of(s), snap.slot_of(d)) for p, s, d in specs]
    port_raw = [(port_pod(p), s, d) for p, s, d in raw]
    port_pdbs = [convert.api_object(x, port_objects.PodDisruptionBudget) for x in pdbs]
    plan = select_moves(pb, list(snap.names), port_raw, port_pdbs, **kw)
    ref = ref_select_moves(b, list(snap.names), raw, list(pdbs), **kw)
    assert move_view(plan) == move_view(ref)
    return plan


# -- detector ---------------------------------------------------------------


def test_detect_flags_sparse_scatter_as_fragmented():
    r = both_detect({f"n{i}": [(f"p{i}a", "1"), (f"p{i}b", "1")] for i in range(6)},
                    min_packing=0.7)
    assert r.nodes_in_use == 6 and r.ideal_nodes == 2
    assert r.packed_utilization == pytest.approx(12 / 48)
    assert r.fragmented


def test_detect_unconsolidatable_sparse_cluster_exempt():
    r = both_detect({f"n{i}": [(f"p{i}", "5")] for i in range(2)}, min_packing=0.7)
    assert r.packed_utilization == pytest.approx(10 / 16)
    assert r.nodes_in_use == 2 and r.ideal_nodes == 2
    assert not r.fragmented


def test_detect_well_packed_cluster_not_fragmented():
    r = both_detect({"n0": [(f"p{i}", "1") for i in range(7)],
                     "n1": [(f"q{i}", "1") for i in range(7)], "n2": [], "n3": []},
                    min_packing=0.7)
    assert r.packed_utilization == pytest.approx(14 / 16)
    assert not r.fragmented


def test_detect_empty_cluster_is_trivially_packed():
    r = both_detect({"n0": [], "n1": []})
    assert r.nodes_in_use == 0 and r.packed_utilization == 1.0
    assert not r.fragmented


def test_packing_score_dominant_resource_and_extra_used():
    _, b, snap = batch_of({"n0": [("p0", "4")], "n1": []})
    s0 = snap.slot_of("n0")
    assert packing_score(b, s0) == 50
    assert packing_score(b, snap.slot_of("n1")) == 0
    req = np.asarray(b.vocab.vectorize(port_pod(pod("x", cpu="4")).resource_request()),
                     dtype=np.int64)
    assert packing_score(b, s0, extra_used=-req) < 50


# -- planner ----------------------------------------------------------------


def test_plan_moves_consolidates_off_drained_sources():
    b, pb, snap = batch_of({"n0": [("p0", "1")], "n1": [("p1", "2")],
                            "n2": [(f"q{i}", "1") for i in range(5)], "n3": []})
    slot_names = list(snap.names)
    movable, fixed_used, fixed_cnt, drain = [], b.used.copy(), b.pod_count.copy(), set()
    for pname, cpu, nname in (("p0", "1", "n0"), ("p1", "2", "n1")):
        slot = snap.slot_of(nname)
        p = pod(pname, cpu=cpu)
        movable.append((p, slot))
        req = np.asarray(b.vocab.vectorize(p.resource_request()), dtype=np.int64)
        fixed_used[:, slot] -= req
        fixed_cnt[slot] -= 1
        drain.add(slot)
    ref = ref_plan_moves(b, movable, fixed_used, fixed_cnt, frozenset(drain))
    raw = plan_moves(pb, [(port_pod(p), s) for p, s in movable], fixed_used.copy(),
                     fixed_cnt.copy(), frozenset(drain), device="cpu")
    assert [(p.key, s, d) for p, s, d in raw] == [(p.key, s, d) for p, s, d in ref]
    assert len(raw) == 2
    for _p, _src, dst in raw:
        assert dst not in drain and slot_names[dst] == "n2"


def test_plan_moves_relax_engine_matches_jax():
    """The mega-plan engine (relax + the plan auction on its tail) on the
    same candidates: the same raw moves as the JAX package's."""
    placements = {f"n{i}": [(f"p{i}{j}", "1") for j in range(1 + i % 3)] for i in range(8)}
    b, pb, snap = batch_of(placements)
    movable, fixed_used, fixed_cnt, drain = [], b.used.copy(), b.pod_count.copy(), set()
    for i in range(4):
        slot = snap.slot_of(f"n{i}")
        for pname, cpu in placements[f"n{i}"]:
            p = pod(pname, cpu=cpu)
            movable.append((p, slot))
            fixed_used[:, slot] -= np.asarray(b.vocab.vectorize(p.resource_request()))
            fixed_cnt[slot] -= 1
        drain.add(slot)
    ref = ref_plan_moves(b, movable, fixed_used, fixed_cnt, frozenset(drain), engine="relax")
    raw = plan_moves(pb, [(port_pod(p), s) for p, s in movable], fixed_used.copy(),
                     fixed_cnt.copy(), frozenset(drain), engine="relax", device="cpu")
    assert [(p.key, s, d) for p, s, d in raw] == [(p.key, s, d) for p, s, d in ref]
    assert raw and all(d not in drain for _, _, d in raw)


def test_select_moves_respects_budget():
    plan = both_select({"n0": [(f"p{i}", "1") for i in range(4)],
                        "n1": [(f"q{i}", "1") for i in range(6)]},
                       [(pod(f"p{i}"), "n0", "n1") for i in range(4)], budget=2, min_gain=1)
    assert plan.planned == 4 and len(plan.moves) == 2


def test_select_moves_priority_order_least_important_first():
    plan = both_select({"n0": [("lo", "1"), ("hi", "1")], "n1": [(f"q{i}", "1") for i in range(6)]},
                       [(pod("hi", prio=100), "n0", "n1"), (pod("lo", prio=1), "n0", "n1")],
                       budget=1, min_gain=1)
    assert [m.pod.name for m in plan.moves] == ["lo"]


def test_select_moves_gain_first_within_a_priority():
    lo = pod("lowgain")
    lo.start_time = 100.0
    hi = pod("highgain")
    hi.start_time = 1.0
    plan = both_select({"n0": [("lowgain", "1"), ("highgain", "1")],
                        "n1": [("q0", "1"), ("q1", "1")], "n2": [(f"r{i}", "1") for i in range(6)]},
                       [(lo, "n0", "n1"), (hi, "n0", "n2")], budget=1, min_gain=1)
    assert [m.pod.name for m in plan.moves] == ["highgain"]


def test_select_moves_drops_non_strict_gains():
    plan = both_select({"n0": [(f"p{i}", "1") for i in range(4)], "n1": [("q0", "1")]},
                       [(pod("p0"), "n0", "n1")], budget=8, min_gain=1)
    assert plan.planned == 1 and plan.moves == []


def test_select_moves_skips_targets_without_live_capacity():
    plan = both_select({"n0": [("p0", "2")], "n1": [(f"q{i}", "1") for i in range(7)]},
                       [(pod("p0", cpu="2"), "n0", "n1")], budget=8, min_gain=1)
    assert plan.moves == []


def _guard(allowed):
    return PodDisruptionBudget(
        name="guard",
        selector=Selector(requirements=requirements_from_match_labels({"app": "db"})),
        disruptions_allowed=allowed,
    )


def test_select_moves_pdb_gate_blocks_exhausted_cohort():
    plan = both_select({"n0": [("guarded", "1"), ("free", "1")],
                        "n1": [(f"q{i}", "1") for i in range(6)]},
                       [(pod("guarded", labels={"app": "db"}), "n0", "n1"),
                        (pod("free"), "n0", "n1")], pdbs=[_guard(0)], budget=8, min_gain=1)
    assert plan.pdb_blocked == 1
    assert [m.pod.name for m in plan.moves] == ["free"]


def test_select_moves_pdb_allowance_decrements_across_plan():
    plan = both_select({"n0": [("a", "1"), ("b", "1")], "n1": [(f"q{i}", "1") for i in range(6)]},
                       [(pod("a", labels={"app": "db"}), "n0", "n1"),
                        (pod("b", labels={"app": "db"}), "n0", "n1")],
                       pdbs=[_guard(1)], budget=8, min_gain=1)
    assert plan.pdb_blocked == 1 and len(plan.moves) == 1


# -- runtime: the loop through the real Scheduler ---------------------------


RECORD = ("t", "packing_before", "stranded_before", "planned", "selected", "evicted",
          "pdb_blocked")


def _rebalance(interval_s=1.0, max_moves_per_cycle=4, min_packing=0.7):
    kw = dict(interval_s=interval_s, max_moves_per_cycle=max_moves_per_cycle,
              min_packing=min_packing)
    return dict(rebalance=RebalanceConfig(**kw), obs=ObsConfig(journal=True),
                ref_config={"rebalance": RefRebalanceConfig(**kw),
                            "obs": RefObsConfig(journal=True)})


def _pair(cs, fence_role=None, **rebalance):
    return Pair(cs, fence_role=fence_role, **_rebalance(**rebalance))


def _fragmented(n_nodes=6, per_node=2, labels=None, fence_role=None):
    """6 nodes x 2 small pods each, bound through the state service:
    packed utilization 0.25 against the 0.7 bar."""
    cs = ClusterState()
    for i in range(n_nodes):
        cs.create_node(node(f"n{i}"))
    for i in range(n_nodes):
        for j in range(per_node):
            cs.create_pod(pod(f"p{i}{j}", labels=labels))
            cs.bind("default", f"p{i}{j}", f"n{i}")
    return _pair(cs, fence_role=fence_role)


def assert_same_passes(pair):
    """Run records (but the wall time), stats, pending migrations, the
    journal's eviction records and the bindings equal."""
    ref, port = pair.ref.rebalancer, pair.port.rebalancer
    view = lambda h: [{k: getattr(r, k) for k in RECORD} for r in h]  # noqa: E731
    assert view(port.history) == view(ref.history)
    assert port.stats() == ref.stats()
    assert port.pending_migrations == ref.pending_migrations
    evictions = lambda s: [  # noqa: E731
        (r["pod"], r["node"], r["nominated"]) for r in map(json.loads, s.journal.lines)
        if r.get("outcome") == "evicted_for_rebalance"]
    assert evictions(pair.port) == evictions(pair.ref)
    ref_b, port_b = pair.bindings()
    assert port_b == ref_b


def _packing(sched):
    return detect(sched.snapshot.update(sched.cache),
                  min_packing=sched.rebalancer.config.min_packing)


def settle_both(pair, rounds=1, advance=1.5):
    for _ in range(rounds):
        pair.advance(advance)
        pair.run("settled")


def test_rebalancer_consolidates_within_budget_every_cycle():
    pair = _fragmented()
    before = _packing(pair.port)
    assert before.fragmented
    for _ in range(12):
        settle_both(pair)
        if not _packing(pair.port).fragmented:
            break
    after = _packing(pair.port)
    assert not after.fragmented
    assert after.packed_utilization > before.packed_utilization
    assert after.nodes_in_use < before.nodes_in_use
    for s, cs in pair.sides():
        s.rebalancer.reconcile(cs)
    assert_same_passes(pair)
    stats = pair.port.rebalancer.stats()
    assert stats["runs"] >= 1 and stats["evicted"] >= 1
    assert stats["max_cycle_evictions"] <= 4 and stats["over_budget"] == 0
    assert stats["migrations_completed"] >= 1
    assert pair.port.rebalancer.pending_migrations == {}
    assert all(p.node_name for p in pair.cluster.list_pods())
    assert pair.port.pending == 0


def test_rebalancer_journals_evictions_with_nominated_target():
    pair = _fragmented()
    settle_both(pair)
    assert_same_passes(pair)
    recs = [r for r in map(json.loads, pair.port.journal.lines)
            if r.get("outcome") == "evicted_for_rebalance"]
    assert recs
    for r in recs:
        assert r["node"] and r["nominated"] and r["nominated"] != r["node"]


def test_rebalancer_interval_gates_passes():
    pair = _fragmented()
    settle_both(pair)
    runs = len(pair.port.rebalancer.history)
    assert runs >= 1
    settle_both(pair, advance=0.2)
    assert len(pair.port.rebalancer.history) == runs
    assert_same_passes(pair)


def test_rebalancer_waits_for_idle_queues():
    pair = _fragmented()
    pair.create_pod(pod("newcomer"))
    pair.advance(1.5)
    res, ref_res = BatchResult(), RefBatchResult()
    assert pair.port.rebalancer.maybe_run(pair.port, res) == 0
    assert pair.ref.rebalancer.maybe_run(pair.ref, ref_res) == 0
    assert pair.port.rebalancer.history == [] and res.rebalance_evictions == []


def test_rebalancer_fenced_zombie_moves_nothing():
    pair = _fragmented(fence_role="leader")
    placement = {p.key: p.node_name for p in pair.cluster.list_pods()}
    for _, cs in pair.sides():
        cs.grant_fence("leader")
    pair.advance(1.5)
    assert pair.port.rebalancer.maybe_run(pair.port, BatchResult()) == 0
    assert pair.ref.rebalancer.maybe_run(pair.ref, RefBatchResult()) == 0
    assert pair.port.rebalancer.history == []
    assert {p.key: p.node_name for p in pair.cluster.list_pods()} == placement


def test_rebalancer_refenced_incarnation_resumes():
    pair = _fragmented(fence_role="leader")
    for _, cs in pair.sides():
        cs.grant_fence("leader")
    pair.advance(1.5)
    assert pair.port.rebalancer.maybe_run(pair.port, BatchResult()) == 0
    assert pair.ref.rebalancer.maybe_run(pair.ref, RefBatchResult()) == 0
    pair.port.reacquire_fence()
    pair.ref.reacquire_fence()
    settle_both(pair)
    assert pair.port.rebalancer.stats()["evicted"] >= 1
    assert_same_passes(pair)


def test_rebalancer_never_moves_pdb_guarded_pods():
    pair = _fragmented(labels={"app": "db"})
    pdb = _guard(0)
    pair.ref_cluster.create_pdb(pdb)
    pair.cluster.create_pdb(convert.api_object(pdb, port_objects.PodDisruptionBudget))
    placement = {p.key: p.node_name for p in pair.cluster.list_pods()}
    settle_both(pair, rounds=4)
    stats = pair.port.rebalancer.stats()
    assert stats["pdb_blocked"] >= 1 and stats["evicted"] == 0
    assert {p.key: p.node_name for p in pair.cluster.list_pods()} == placement
    assert_same_passes(pair)


def test_rebalancer_respects_node_selectors():
    cs = ClusterState()
    for i in range(2):
        cs.create_node(MakeNode().name(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "110"}).label("pool", "gold").obj())
    for i in range(2, 6):
        cs.create_node(node(f"n{i}"))
    cs.create_pod(MakePod().name("sel").req({"cpu": "1", "memory": "1Gi"})
                  .node_selector({"pool": "gold"}).obj())
    cs.bind("default", "sel", "n0")
    for j in range(4):
        cs.create_pod(pod(f"t{j}"))
        cs.bind("default", f"t{j}", "n1")
    for i in range(2, 6):
        for j in range(3):
            cs.create_pod(pod(f"f{i}{j}"))
            cs.bind("default", f"f{i}{j}", f"n{i}")
    pair = _pair(cs, max_moves_per_cycle=8)
    settle_both(pair, rounds=8)
    assert pair.cluster.get_pod("default", "sel").node_name in ("n0", "n1")
    assert pair.port.pending == 0
    assert_same_passes(pair)


def test_rebalancer_skips_hard_shaped_pods():
    pair = _fragmented()
    hard = [
        MakePod().name("ports").req({"cpu": "1"}).host_port(8080).obj(),
        MakePod().name("spread").req({"cpu": "1"}).label("app", "s")
        .spread_constraint(1, "zone", "DoNotSchedule", {"app": "s"}).obj(),
        MakePod().name("anti").req({"cpu": "1"})
        .pod_anti_affinity("kubernetes.io/hostname", {"app": "s"}).obj(),
        MakePod().name("pvc").req({"cpu": "1"}).pvc("claim0").obj(),
    ]
    for p in hard:
        assert not Rebalancer._movable(pair.port, port_pod(p)), p.name
    assert Rebalancer._movable(pair.port, pair.cluster.get_pod("default", "p00"))


def test_rebalancer_not_fragmented_cluster_untouched():
    cs = ClusterState()
    for i in range(2):
        cs.create_node(node(f"n{i}"))
    for i in range(7):
        cs.create_pod(pod(f"p{i}"))
        cs.bind("default", f"p{i}", "n0")
    pair = Pair(cs, **{**_rebalance(), "rebalance": RebalanceConfig(interval_s=1.0),
                       "ref_config": {"rebalance": RefRebalanceConfig(interval_s=1.0),
                                      "obs": RefObsConfig(journal=True)}})
    placement = {p.key: p.node_name for p in pair.cluster.list_pods()}
    settle_both(pair)
    assert pair.port.rebalancer.stats()["evicted"] == 0
    assert {p.key: p.node_name for p in pair.cluster.list_pods()} == placement
    assert_same_passes(pair)


@pytest.mark.parametrize("loop", ["pipelined", "streaming"])
def test_rebalancer_runs_in_the_other_loops(loop):
    """run_pipelined and run_streaming tick the rebalancer when idle, as the
    JAX package's do: the same passes, evictions and re-bindings."""
    pair = _fragmented()
    for _ in range(4):
        pair.advance(1.5)
        pair.run(loop)
    assert pair.port.rebalancer.stats()["evicted"] >= 1
    for s, cs in pair.sides():
        s.rebalancer.reconcile(cs)
    assert_same_passes(pair)
    assert pair.port.pending == 0


def test_config_layer_builds_rebalance_section():
    from kubernetes_tpu_torch.config.types import load, scheduler_config

    sc = scheduler_config(load({
        "apiVersion": "kubescheduler.config.k8s.io/v1",
        "kind": "KubeSchedulerConfiguration",
        "rebalance": {"enabled": True, "intervalSeconds": 30, "maxMovesPerCycle": 16,
                      "minPackingUtilization": 0.6, "minGainPoints": 2, "nominate": False},
    }))
    assert isinstance(sc.rebalance, RebalanceConfig)
    assert dataclasses.asdict(sc.rebalance) == dict(
        interval_s=30.0, max_moves_per_cycle=16, min_packing=0.6, min_gain=2,
        nominate=False, plan_engine="auto")
    off = load({"apiVersion": "kubescheduler.config.k8s.io/v1",
                "kind": "KubeSchedulerConfiguration"})
    assert scheduler_config(off).rebalance is None


def test_config_rejects_bad_rebalance_values():
    from kubernetes_tpu_torch.config.types import load

    for bad in ({"maxMovesPerCycle": -1}, {"minPackingUtilization": 0.0},
                {"intervalSeconds": 0}, {"intervalSeconds": -5}, {"minGainPoints": 0}):
        with pytest.raises(ValueError):
            load({"apiVersion": "kubescheduler.config.k8s.io/v1",
                  "kind": "KubeSchedulerConfiguration", "rebalance": bad})


def test_config_explicit_nulls_default():
    from kubernetes_tpu_torch.config.types import load

    cfg = load({
        "apiVersion": "kubescheduler.config.k8s.io/v1",
        "kind": "KubeSchedulerConfiguration",
        "tpuSolver": {"singleShot": {"repairRounds": None}},
        "rebalance": {"enabled": True, "intervalSeconds": None, "maxMovesPerCycle": None,
                      "minPackingUtilization": None, "minGainPoints": None,
                      "nominate": None},
    })
    assert cfg.tpu_solver.single_shot.repair_rounds == 16
    assert cfg.rebalance.interval_seconds == 60.0
    assert cfg.rebalance.max_moves_per_cycle == 512
    assert cfg.rebalance.min_packing_utilization == 0.7
    assert cfg.rebalance.min_gain_points == 1
    assert cfg.rebalance.nominate is True
