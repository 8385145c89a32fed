"""The port's copy of tests/test_sim_invariants.py, on
``kubernetes_tpu_torch.sim.invariants`` (schedulers on ``device="cpu"``),
the ``check_rebalance`` cases on the port's ``rebalance.runtime.RunRecord``.

Known-bad fixtures for the sim's invariant checkers — the
fixture-per-rule pattern of tests/test_static_analysis.py: a checker
that never fires gates nothing, so each one is fed a crafted violation
it MUST flag (and a clean state it must not)."""

from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.sim.invariants import (
    BindTransitionTracker,
    MonotonicCounters,
    check_capacity,
    check_constraints,
    check_lost_pods,
)
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.utils.clock import FakeClock


def _cluster(n_nodes=2, cpu="4"):
    cs = ClusterState(clock=FakeClock())
    for i in range(n_nodes):
        cs.create_node(
            MakeNode()
            .name(f"n{i}")
            .capacity({"cpu": cpu, "memory": "8Gi", "pods": "10"})
            .obj()
        )
    return cs


def _pod(name, cpu="1"):
    return MakePod().name(name).req({"cpu": cpu, "memory": "1Gi"}).obj()


# -- double_bind ------------------------------------------------------------


def test_double_bind_flags_node_transition():
    cs = _cluster()
    tracker = BindTransitionTracker(cs)
    cs.create_pod(_pod("a"))
    cs.bind("default", "a", "n0")
    violations = []
    tracker.drain(0, violations)
    assert violations == []  # a first bind is fine
    # the state service's binding subresource refuses rebinds, so forge
    # the A->B transition the way a buggy writer would: update_pod
    pod = cs.get_pod("default", "a")
    pod.node_name = "n1"
    cs.update_pod(pod)
    tracker.drain(1, violations)
    assert len(violations) == 1
    assert violations[0].invariant == "double_bind"
    assert "rebound n0 -> n1" in violations[0].detail


def test_double_bind_flags_duplicate_scheduler_result():
    cs = _cluster()
    tracker = BindTransitionTracker(cs)
    tracker.record_results([("default/a", "n0")])
    tracker.record_results([("default/a", "n1")])
    violations = []
    tracker.drain(0, violations)
    assert [v.invariant for v in violations] == ["double_bind"]


def test_double_bind_allows_delete_then_recreate():
    cs = _cluster()
    tracker = BindTransitionTracker(cs)
    cs.create_pod(_pod("a"))
    cs.bind("default", "a", "n0")
    cs.delete_pod("default", "a")
    cs.create_pod(_pod("a"))
    cs.bind("default", "a", "n1")
    violations = []
    tracker.drain(0, violations)
    assert violations == []


# -- capacity ---------------------------------------------------------------


def test_capacity_flags_overflow():
    cs = _cluster(n_nodes=1, cpu="2")
    # the binding subresource doesn't check capacity (neither does the
    # apiserver) — overflowing it is exactly the scheduler bug class
    # this checker exists to catch
    for i in range(3):
        cs.create_pod(_pod(f"p{i}", cpu="1"))
        cs.bind("default", f"p{i}", "n0")
    violations = []
    check_capacity(cs, 0, violations)
    assert [v.invariant for v in violations] == ["capacity"]
    assert "cpu used 3000 > allocatable 2000" in violations[0].detail


def test_capacity_clean_at_exact_fit():
    cs = _cluster(n_nodes=1, cpu="2")
    for i in range(2):
        cs.create_pod(_pod(f"p{i}", cpu="1"))
        cs.bind("default", f"p{i}", "n0")
    violations = []
    check_capacity(cs, 0, violations)
    assert violations == []


def test_capacity_flags_pod_count_overflow():
    cs = _cluster(n_nodes=1, cpu="64")
    # pods allocatable is 10; bind 11 near-free pods
    for i in range(11):
        cs.create_pod(_pod(f"p{i}", cpu="100m"))
        cs.bind("default", f"p{i}", "n0")
    violations = []
    check_capacity(cs, 0, violations)
    assert any("pods > allowed" in v.detail for v in violations)


# -- constraint (hard-shape placements) -------------------------------------


def test_constraint_flags_hostport_clash():
    cs = _cluster(n_nodes=1, cpu="8")
    for i in range(2):
        cs.create_pod(
            MakePod()
            .name(f"p{i}")
            .req({"cpu": "1"})
            .host_port(8080)
            .obj()
        )
        cs.bind("default", f"p{i}", "n0")
    violations = []
    check_constraints(cs, 0, violations)
    assert [v.invariant for v in violations] == ["constraint"]
    assert "hostPort" in violations[0].detail


def test_constraint_flags_anti_affinity_coresidence():
    cs = _cluster(n_nodes=1, cpu="8")
    for i in range(2):
        cs.create_pod(
            MakePod()
            .name(f"a{i}")
            .label("app", "anti")
            .req({"cpu": "1"})
            .pod_anti_affinity("kubernetes.io/hostname", {"app": "anti"})
            .obj()
        )
        cs.bind("default", f"a{i}", "n0")
    violations = []
    check_constraints(cs, 0, violations)
    assert violations and all(
        v.invariant == "constraint" for v in violations
    )
    assert "anti-affinity" in violations[0].detail


def test_constraint_clean_on_separate_nodes():
    cs = _cluster(n_nodes=2, cpu="8")
    for i in range(2):
        cs.create_pod(
            MakePod()
            .name(f"a{i}")
            .label("app", "anti")
            .req({"cpu": "1"})
            .pod_anti_affinity("kubernetes.io/hostname", {"app": "anti"})
            .host_port(8080)
            .obj()
        )
        cs.bind("default", f"a{i}", f"n{i}")
    violations = []
    check_constraints(cs, 0, violations)
    assert violations == []


# -- lost_pod ---------------------------------------------------------------


def _sched(cs):
    return Scheduler(
        cs,
        SchedulerConfig(
            batch_size=8,
            solver=ExactSolverConfig(tie_break="first", group_size=4),
        ),
        clock=FakeClock(),
        device="cpu",
    )


def test_lost_pod_flags_dropped_bookkeeping():
    cs = _cluster()
    s = _sched(cs)
    cs.create_pod(_pod("a"))
    violations = []
    check_lost_pods(cs, s, 0, violations)
    assert violations == []  # queued: accounted for
    # simulate the bug class: the pod falls out of every structure
    s.queue.delete("default/a")
    check_lost_pods(cs, s, 1, violations)
    assert [v.invariant for v in violations] == ["lost_pod"]
    assert "default/a" in violations[0].detail


def test_lost_pod_accepts_undelivered_watch_add():
    cs = _cluster()
    s = _sched(cs)
    cs.unsubscribe(s._on_event)  # the delayed-bus interposition shape
    cs.create_pod(_pod("a"))  # scheduler never saw the ADDED event
    violations = []
    check_lost_pods(
        cs, s, 0, violations, undelivered=lambda: {"default/a"}
    )
    assert violations == []
    check_lost_pods(cs, s, 1, violations)  # no undelivered claim -> lost
    assert [v.invariant for v in violations] == ["lost_pod"]


def test_lost_pod_ignores_foreign_scheduler_pods():
    cs = _cluster()
    s = _sched(cs)
    pod = MakePod().name("x").scheduler_name("other").req({"cpu": "1"}).obj()
    cs.create_pod(pod)
    violations = []
    check_lost_pods(cs, s, 0, violations)
    assert violations == []


# -- monotonic --------------------------------------------------------------


def test_monotonic_flags_regressing_counter():
    series = {"scheduler_schedule_attempts_total": 5.0}
    mono = MonotonicCounters(sample=lambda: dict(series))
    violations = []
    mono.observe(0, violations)
    assert violations == []
    series["scheduler_schedule_attempts_total"] = 3.0  # regression
    mono.observe(1, violations)
    assert [v.invariant for v in violations] == ["monotonic"]
    assert "went backwards" in violations[0].detail


def test_monotonic_clean_on_growth():
    series = {"scheduler_schedule_attempts_total": 5.0}
    mono = MonotonicCounters(sample=lambda: dict(series))
    violations = []
    mono.observe(0, violations)
    series["scheduler_schedule_attempts_total"] = 9.0
    mono.observe(1, violations)
    assert violations == []


# -- progress (the settle loop's violation) ---------------------------------


def test_progress_violation_on_unsettled_harness():
    """A harness whose scheduler never drains must emit a progress
    violation instead of looping forever — pin it with a queue-stuffed
    settle check rather than a real livelock (the real one is what the
    pipelined backstop prevents, test_pipelined covers it)."""
    from kubernetes_tpu_torch.sim.harness import SimHarness

    h = SimHarness(
        "node_flaps", seed=0, cycles=0, max_settle_rounds=3, device="cpu"
    )
    # park a pod the scheduler will never see an event for, then gut the
    # drive so nothing ever drains it
    cs = h.cluster
    cs.create_pod(_pod("stuck"))
    h.bus.pump_all()
    h.scheduler.run_until_settled = lambda max_batches=0: []
    h.scheduler.run_pipelined = lambda max_batches=0: []
    res = h.run()
    assert not res.settled
    assert any(v.invariant == "progress" for v in res.violations)


# -- recovery (crash_restart) -----------------------------------------------


def test_recovery_flags_crash_that_never_fired():
    from kubernetes_tpu_torch.sim.invariants import check_recovery

    violations = []
    check_recovery(
        0, violations, crash_expected=True, crashes=0, incarnations=1,
        orphans_at_restart=0, recovered_records=0,
    )
    assert [v.invariant for v in violations] == ["recovery"]
    assert "never engaged" in violations[0].detail


def test_recovery_flags_missing_restart():
    from kubernetes_tpu_torch.sim.invariants import check_recovery

    violations = []
    check_recovery(
        0, violations, crash_expected=True, crashes=1, incarnations=1,
        orphans_at_restart=0, recovered_records=0,
    )
    assert [v.invariant for v in violations] == ["recovery"]
    assert "restart never happened" in violations[0].detail


def test_recovery_flags_unjournaled_orphans():
    from kubernetes_tpu_torch.sim.invariants import check_recovery

    violations = []
    check_recovery(
        0, violations, crash_expected=True, crashes=1, incarnations=2,
        orphans_at_restart=3, recovered_records=0,
    )
    assert [v.invariant for v in violations] == ["recovery"]
    assert "recovered" in violations[0].detail


def test_recovery_clean_on_good_run():
    from kubernetes_tpu_torch.sim.invariants import check_recovery

    violations = []
    check_recovery(
        0, violations, crash_expected=True, crashes=1, incarnations=2,
        orphans_at_restart=3, recovered_records=3,
    )
    assert violations == []


# -- fencing (hub_partition / zombie) ---------------------------------------


def test_fencing_flags_vacuous_zombie():
    from kubernetes_tpu_torch.sim.invariants import check_hub_partition

    violations = []
    check_hub_partition(
        0, violations, fenced_commits=0, zombie_binds_while_fenced=0,
        stale_rejections=2,
    )
    assert [v.invariant for v in violations] == ["fencing"]
    assert "never engaged" in violations[0].detail


def test_fencing_flags_leaked_zombie_bind():
    from kubernetes_tpu_torch.sim.invariants import check_hub_partition

    violations = []
    check_hub_partition(
        0, violations, fenced_commits=2, zombie_binds_while_fenced=1,
        stale_rejections=2,
    )
    assert [v.invariant for v in violations] == ["fencing"]
    assert "LANDED" in violations[0].detail


def test_fencing_flags_missing_conservative_admission():
    from kubernetes_tpu_torch.sim.invariants import check_hub_partition

    violations = []
    check_hub_partition(
        0, violations, fenced_commits=2, zombie_binds_while_fenced=0,
        stale_rejections=0,
    )
    assert [v.invariant for v in violations] == ["fencing"]
    assert "conservative" in violations[0].detail


def test_fencing_clean_on_good_partition_run():
    from kubernetes_tpu_torch.sim.invariants import check_hub_partition

    violations = []
    check_hub_partition(
        0, violations, fenced_commits=2, zombie_binds_while_fenced=0,
        stale_rejections=3,
    )
    assert violations == []


# -- rebalance (fragmentation profile) --------------------------------------


def _run_record(t=10.0, packing=0.4, evicted=2, **kw):
    from kubernetes_tpu_torch.rebalance.runtime import RunRecord

    return RunRecord(
        t=t, packing_before=packing, stranded_before=0.5,
        planned=kw.get("planned", evicted),
        selected=kw.get("selected", evicted),
        evicted=evicted, pdb_blocked=kw.get("pdb_blocked", 0),
        plan_solve_s=0.01,
    )


def _check_rebalance(violations, history, **kw):
    from kubernetes_tpu_torch.sim.invariants import check_rebalance

    defaults = dict(
        budget=4, pdb_overruns=0, migrations_completed=1,
        churn_end_t=9.0, final_packing=0.5,
    )
    defaults.update(kw)
    check_rebalance(0, violations, history=history, **defaults)


def test_rebalance_flags_budget_exceeded_plan():
    violations = []
    _check_rebalance(violations, [_run_record(evicted=9)], budget=4)
    assert [v.invariant for v in violations] == ["rebalance"]
    assert "churn budget" in violations[0].detail


def test_rebalance_flags_pdb_violating_eviction():
    violations = []
    _check_rebalance(violations, [_run_record()], pdb_overruns=1)
    assert [v.invariant for v in violations] == ["rebalance"]
    assert "PDB" in violations[0].detail


def test_rebalance_flags_utilization_regression():
    violations = []
    _check_rebalance(
        violations,
        [
            _run_record(t=10.0, packing=0.5),
            _run_record(t=21.0, packing=0.3),  # settle-phase regression
        ],
    )
    assert any(
        v.invariant == "rebalance" and "regressed" in v.detail
        for v in violations
    )


def test_rebalance_flags_final_packing_regression():
    violations = []
    _check_rebalance(
        violations, [_run_record(t=10.0, packing=0.5)], final_packing=0.2,
    )
    assert [v.invariant for v in violations] == ["rebalance"]
    assert "final packed utilization" in violations[0].detail


def test_rebalance_flags_stranded_evictions():
    violations = []
    _check_rebalance(
        violations, [_run_record(evicted=3)], migrations_completed=0,
    )
    assert [v.invariant for v in violations] == ["rebalance"]
    assert "strands" in violations[0].detail


def test_rebalance_flags_never_engaged():
    violations = []
    _check_rebalance(violations, [])
    assert [v.invariant for v in violations] == ["rebalance"]
    assert "never engaged" in violations[0].detail


def test_rebalance_churn_phase_regression_exempt():
    # packing moving both ways DURING churn is legitimate: only
    # settle-phase passes are held to monotonicity
    violations = []
    _check_rebalance(
        violations,
        [
            _run_record(t=3.0, packing=0.6),  # churn phase
            _run_record(t=5.0, packing=0.3),  # churn phase
            _run_record(t=10.0, packing=0.4),
            _run_record(t=21.0, packing=0.45),
        ],
    )
    assert violations == []




def test_rebalance_tracker_counts_evictions_and_pdb_overruns():
    """The tracker's independent allowance mirror must flag an eviction
    that the enforcement code (hypothetically buggy) let through."""
    from kubernetes_tpu_torch.api.labels import (
        Selector,
        requirements_from_match_labels,
    )
    from kubernetes_tpu_torch.api.objects import PodDisruptionBudget
    from kubernetes_tpu_torch.sim.invariants import RebalanceTracker

    cs = _cluster()
    cs.create_pdb(
        PodDisruptionBudget(
            name="guard", namespace="default",
            selector=Selector(
                requirements=requirements_from_match_labels({"app": "g"})
            ),
            disruptions_allowed=1,
        )
    )
    tracker = RebalanceTracker(cs)
    for name in ("a", "b"):
        pod = MakePod().name(name).label("app", "g").req(
            {"cpu": "1", "memory": "1Gi"}
        ).obj()
        cs.create_pod(pod)
        cs.bind("default", name, "n0")
    # first eviction consumes the allowance; force the second past the
    # subresource's own gate by resetting the LIVE allowance — the
    # tracker's mirror (seeded at construction) must still flag it
    cs.evict("default", "a")
    assert tracker.evictions == 1 and tracker.pdb_overruns == 0
    cs.list_pdbs()[0].disruptions_allowed = 1
    cs.evict("default", "b")
    assert tracker.evictions == 2
    assert tracker.pdb_overruns == 1
    assert tracker.evicted_keys == ["default/a", "default/b"]


def test_double_bind_evict_then_rebind_is_legitimate():
    """An evict-and-rebind inside one drive delivers its DELETED before
    the bind report drains: the banked bound-delete credit keeps the
    tracker from misreading the migration as a double-bind — while a
    genuine double-report still flags."""
    cs = _cluster()
    tracker = BindTransitionTracker(cs)
    cs.create_pod(_pod("a"))
    cs.bind("default", "a", "n0")
    cs.evict("default", "a")
    cs.bind("default", "a", "n1")
    violations = []
    # both binds report at drive end, after the eviction's DELETED
    tracker.record_results([("default/a", "n0"), ("default/a", "n1")])
    tracker.drain(0, violations)
    assert violations == []
    # a THIRD report with no delete in between is still a double-bind
    tracker.record_results([("default/a", "n1")])
    tracker.drain(1, violations)
    assert [v.invariant for v in violations] == ["double_bind"]


def test_double_bind_plain_delete_banks_no_credit():
    """Only EVICTIONS bank re-bind credits (keyed on the subresource's
    Evicted event): a plain bound-pod delete racing the bind report
    must NOT absorb a masked double-report of the dead pod's key —
    that is exactly the scheduler bug the check exists to catch."""
    cs = _cluster()
    tracker = BindTransitionTracker(cs)
    cs.create_pod(_pod("a"))
    cs.bind("default", "a", "n0")
    cs.delete_pod("default", "a")  # churn delete, no Evicted record
    violations = []
    tracker.record_results([("default/a", "n0"), ("default/a", "n0")])
    tracker.drain(0, violations)
    assert [v.invariant for v in violations] == ["double_bind"]


# -- cross-incarnation journal merge ----------------------------------------


def test_merged_last_outcomes_last_incarnation_wins():
    from kubernetes_tpu_torch.sim.invariants import merged_last_outcomes

    inc1 = [
        '{"outcome":"permit_wait","pod":"default/a","step":1,"t":1.0}',
        '{"outcome":"bound","pod":"default/b","step":1,"t":1.0}',
    ]
    inc2 = [
        '{"outcome":"recovered","pod":"default/a","step":0,"t":4.0}',
    ]
    merged = merged_last_outcomes([inc1, inc2])
    assert merged["default/a"]["outcome"] == "recovered"
    assert merged["default/b"]["outcome"] == "bound"


# -- gang (no partial binds) -------------------------------------------------


def _gang_pod(name, group="train", min_member=3):
    from kubernetes_tpu_torch.gang import GANG_LABEL, MIN_MEMBER_ANNOTATION

    return (
        MakePod()
        .name(name)
        .req({"cpu": "1", "memory": "1Gi"})
        .label(GANG_LABEL, group)
        .annotation(MIN_MEMBER_ANNOTATION, str(min_member))
        .obj()
    )


def test_gang_flags_partially_bound_group():
    from kubernetes_tpu_torch.sim.invariants import check_no_partial_gangs

    cs = _cluster()
    for n in ("m0", "m1", "m2"):
        cs.create_pod(_gang_pod(n))
    # forge the wreck a non-atomic commit would leave: 1/3 bound
    cs.bind("default", "m0", "n0")
    violations = []
    check_no_partial_gangs(cs, 3, violations)
    assert [v.invariant for v in violations] == ["gang"]
    assert "default/train" in violations[0].detail
    assert "default/m0" in violations[0].detail  # names the bound side
    assert "default/m1" in violations[0].detail  # and the pending side


def test_gang_clean_when_fully_bound_or_fully_pending():
    from kubernetes_tpu_torch.sim.invariants import check_no_partial_gangs

    cs = _cluster()
    violations = []
    # all pending: fine (mid-assembly)
    for n in ("m0", "m1", "m2"):
        cs.create_pod(_gang_pod(n))
    check_no_partial_gangs(cs, 0, violations)
    assert violations == []
    # all bound: fine (the atomic commit landed)
    for i, n in enumerate(("m0", "m1", "m2")):
        cs.bind("default", n, f"n{i % 2}")
    check_no_partial_gangs(cs, 1, violations)
    assert violations == []
    # two independent gangs, each internally consistent: still clean
    for n in ("x0", "x1"):
        cs.create_pod(_gang_pod(n, group="other", min_member=2))
    check_no_partial_gangs(cs, 2, violations)
    assert violations == []


def test_gang_delete_churn_cannot_fake_violation():
    from kubernetes_tpu_torch.sim.invariants import check_no_partial_gangs

    cs = _cluster()
    for n in ("m0", "m1"):
        cs.create_pod(_gang_pod(n, min_member=2))
    cs.bind("default", "m0", "n0")
    cs.bind("default", "m1", "n1")
    # delete churn removes one bound member: the survivor is all-bound,
    # not a partial gang
    cs.delete_pod("default", "m0")
    violations = []
    check_no_partial_gangs(cs, 5, violations)
    assert violations == []


# -- telemetry --------------------------------------------------------------


def _tel_summary(anomalies=1, captures=1):
    return {"anomalies": anomalies, "bundles_captured": captures}


def test_telemetry_flags_silent_sentinel():
    from kubernetes_tpu_torch.sim.invariants import check_telemetry

    v = []
    check_telemetry(5, v, summary=_tel_summary(anomalies=0))
    assert [x.invariant for x in v] == ["telemetry"]
    assert "sentinel never fired" in v[0].detail


def test_telemetry_flags_disconnected_capture_seam():
    from kubernetes_tpu_torch.sim.invariants import check_telemetry

    v = []
    check_telemetry(5, v, summary=_tel_summary(captures=0))
    assert [x.invariant for x in v] == ["telemetry"]
    assert "capture seam is disconnected" in v[0].detail


def test_telemetry_flags_configured_dir_with_no_bundles(tmp_path):
    from kubernetes_tpu_torch.sim.invariants import check_telemetry

    v = []
    check_telemetry(
        5, v, summary=_tel_summary(), bundle_dir=str(tmp_path)
    )
    assert [x.invariant for x in v] == ["telemetry"]
    assert "no bundle was written" in v[0].detail


def test_telemetry_flags_unloadable_bundle(tmp_path):
    from kubernetes_tpu_torch.sim.invariants import check_telemetry

    # a bundle directory with no manifest: load must fail and the
    # checker must surface it (a truncated capture is itself a finding)
    (tmp_path / "bundle-00000-sentinel").mkdir()
    v = []
    check_telemetry(
        5, v, summary=_tel_summary(), bundle_dir=str(tmp_path),
        device="cpu",
    )
    details = [x.detail for x in v]
    assert any("failed to load/replay" in d for d in details)
    # ... and with every bundle broken, the loop never closed
    assert any("none replayed bit-identical" in d for d in details)


def test_telemetry_clean_without_bundle_dir():
    from kubernetes_tpu_torch.sim.invariants import check_telemetry

    v = []
    check_telemetry(5, v, summary=_tel_summary())
    assert v == []


# -- megaplan ---------------------------------------------------------------


def _mp_summary(**kw):
    base = {
        "pods": 120,
        "ranked": 90,
        "iterations": 64,
        "plan_valid": True,
        "plan_errors": 0,
        "objective_ratio": 1.02,
        "relax_placed": 95,
        "exact_placed": 93,
    }
    base.update(kw)
    return base


def test_megaplan_flags_missing_probe():
    from kubernetes_tpu_torch.sim.invariants import check_megaplan

    v = []
    check_megaplan(5, v, summary=None)
    assert [x.invariant for x in v] == ["megaplan"]


def test_megaplan_flags_never_iterated():
    from kubernetes_tpu_torch.sim.invariants import check_megaplan

    v = []
    check_megaplan(5, v, summary=_mp_summary(iterations=0))
    assert [x.invariant for x in v] == ["megaplan"]
    assert "never iterated" in v[0].detail


def test_megaplan_flags_disconnected_reorder_seam():
    from kubernetes_tpu_torch.sim.invariants import check_megaplan

    v = []
    check_megaplan(5, v, summary=_mp_summary(ranked=0))
    assert [x.invariant for x in v] == ["megaplan"]
    assert "re-ranked zero" in v[0].detail


def test_megaplan_flags_infeasible_plan():
    from kubernetes_tpu_torch.sim.invariants import check_megaplan

    v = []
    check_megaplan(
        5, v, summary=_mp_summary(plan_valid=False, plan_errors=3)
    )
    assert [x.invariant for x in v] == ["megaplan"]
    assert "feasibility replay" in v[0].detail


def test_megaplan_flags_ratio_below_floor():
    from kubernetes_tpu_torch.sim.invariants import check_megaplan

    v = []
    check_megaplan(5, v, summary=_mp_summary(objective_ratio=0.5))
    assert [x.invariant for x in v] == ["megaplan"]
    assert "floor" in v[0].detail


def test_megaplan_clean_on_good_summary():
    from kubernetes_tpu_torch.sim.invariants import check_megaplan

    v = []
    check_megaplan(5, v, summary=_mp_summary())
    assert v == []


# -- fleet backlog drain -----------------------------------------------------


def _fd_kwargs(**kw):
    base = {
        "backlog": 120,
        "drained": 118,
        "double_binds": 0,
        "lost": 0,
        "leases_reassigned": 1,
        "expect_reassign": True,
    }
    base.update(kw)
    return base


def test_fleet_drain_clean_on_good_summary():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(5, v, **_fd_kwargs())
    assert v == []


def test_fleet_drain_flags_empty_backlog_as_vacuous():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(5, v, **_fd_kwargs(backlog=0))
    assert [x.invariant for x in v] == ["fleet_drain"]
    assert "vacuous" in v[0].detail


def test_fleet_drain_flags_disengaged_ledger():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(5, v, **_fd_kwargs(drained=0))
    assert [x.invariant for x in v] == ["fleet_drain"]
    assert "never engaged" in v[0].detail


def test_fleet_drain_flags_lost_pods():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(5, v, **_fd_kwargs(lost=3))
    assert [x.invariant for x in v] == ["fleet_drain"]
    assert "lost work" in v[0].detail


def test_fleet_drain_flags_double_binds():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(5, v, **_fd_kwargs(double_binds=2))
    assert [x.invariant for x in v] == ["fleet_drain"]
    assert "two drain leases" in v[0].detail


def test_fleet_drain_flags_disconnected_reassignment_seam():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(5, v, **_fd_kwargs(leases_reassigned=0))
    assert [x.invariant for x in v] == ["fleet_drain"]
    assert "return-on-retire" in v[0].detail


def test_fleet_drain_reassign_clause_scoped_to_kill_profiles():
    from kubernetes_tpu_torch.sim.invariants import check_fleet_drain

    v = []
    check_fleet_drain(
        5, v,
        **_fd_kwargs(leases_reassigned=0, expect_reassign=False),
    )
    assert v == []
