"""Fleet sim drive (sim/fleet.py): determinism, fleet-vs-single
binding equivalence, replica loss, and known-bad fixtures for the new
no-global-overcommit and fleet journal-completeness invariants."""

from kubernetes_tpu_torch.sim.fleet import FleetSimHarness, run_fleet_sim
from kubernetes_tpu_torch.sim.invariants import (
    check_fleet_journal_completeness,
    check_no_global_overcommit,
)
from kubernetes_tpu_torch.sim.generators import make_node, make_pod
from kubernetes_tpu_torch.state.cluster import ClusterState


def test_fleet_drive_clean_and_deterministic():
    a = run_fleet_sim("fleet_mixed", seed=0, cycles=6, device="cpu")
    assert a.ok, [v.as_dict() for v in a.violations]
    assert a.replicas == 2
    assert a.summary["unbound"] == 0
    b = run_fleet_sim("fleet_mixed", seed=0, cycles=6, device="cpu")
    assert a.journal_digests == b.journal_digests
    assert a.bindings == b.bindings
    # a different seed takes a different path (the digests actually
    # carry information)
    c = run_fleet_sim("fleet_mixed", seed=1, cycles=6, device="cpu")
    assert c.journal_digests != a.journal_digests


def test_fleet_bindings_equivalent_to_single_modulo_ownership():
    """the fleet-of-2 drive binds exactly the pod
    set the single-scheduler drive binds (nodes may differ — that IS
    the shard ownership). Holds because fleet profiles generate an
    identical event stream either way (no external binds / shrinks)."""
    from kubernetes_tpu_torch.sim.harness import run_sim

    fleet = run_fleet_sim("fleet_mixed", seed=1, cycles=8, device="cpu")
    single = run_sim("fleet_mixed", seed=1, cycles=8, device="cpu")
    assert fleet.ok, [v.as_dict() for v in fleet.violations]
    assert single.ok
    assert set(fleet.bindings) == set(single.bindings)


def test_replica_loss_reowns_shard_and_completes_journals():
    res = run_fleet_sim("replica_loss", seed=0, cycles=8, device="cpu")
    assert res.ok, [v.as_dict() for v in res.violations]
    assert res.summary["lost_replica"] == "r1"
    assert res.summary["alive"] == 1
    # the survivor owns the whole cluster after the loss
    h = FleetSimHarness("replica_loss", seed=0, cycles=8, device="cpu")
    res2 = h.run()
    assert res2.ok
    survivor = h.schedulers["r0"]
    with h.cluster.lock:
        assert all(
            r == "r0" for r in survivor.fleet._assignment.values()
        )
    # every node in the cluster is in the survivor's cache
    live = {n.name for n in h.cluster.list_nodes()}
    cached = {
        n
        for n, info in survivor.cache.nodes.items()
        if info.node is not None
    }
    assert live == cached
    # both replicas actually bound work before/after the loss
    assert all(v > 0 for v in res.summary["binds_by_replica"].values())


def test_fleet_drive_exercises_cross_shard_machinery():
    """The fleet_mixed profile must actually drive the exchange (rows
    staged/committed) — otherwise the reconcile path is dead code in
    the smoke."""
    from kubernetes_tpu_torch import metrics

    def rows(op):
        return metrics.fleet_occupancy_rows_total.labels(op)._value.get()

    staged0, committed0 = rows("staged"), rows("committed")
    res = run_fleet_sim("fleet_mixed", seed=2, cycles=6, device="cpu")
    assert res.ok
    assert rows("staged") > staged0
    assert rows("committed") > committed0


# -- known-bad fixtures --


def _tiny_cluster():
    cs = ClusterState()
    cs.create_node(make_node("n0", "2", "4Gi"))
    cs.create_node(make_node("n1", "2", "4Gi"))
    return cs


def test_no_global_overcommit_flags_foreign_bind():
    """Ownership fixture: a bind reported by a replica that does NOT
    own the node must violate, even with capacity intact."""
    cs = _tiny_cluster()
    cs.create_pod(make_pod("p0", "1"))
    cs.bind("default", "p0", "n0")
    violations: list = []
    check_no_global_overcommit(
        cs, 0, violations,
        binds=[("r1", "default/p0", "n0")],
        owners={"n0": "r0", "n1": "r1"},
    )
    assert any(
        v.invariant == "global_overcommit" and "r1" in v.detail
        for v in violations
    )


def test_no_global_overcommit_flags_capacity_breach():
    """Capacity fixture: two replicas double-booking one node trips
    the global capacity half regardless of ownership claims."""
    cs = _tiny_cluster()
    for i in range(3):
        cs.create_pod(make_pod(f"p{i}", "1"))
        cs.bind("default", f"p{i}", "n0")  # 3 cpu onto a 2-cpu node
    violations: list = []
    check_no_global_overcommit(
        cs, 0, violations,
        binds=[
            ("r0", "default/p0", "n0"),
            ("r0", "default/p1", "n0"),
            ("r1", "default/p2", "n0"),
        ],
        owners={"n0": "r0", "n1": "r1"},
    )
    kinds = {v.invariant for v in violations}
    assert "capacity" in kinds  # the overcommit itself
    assert "global_overcommit" in kinds  # r1's foreign bind


def test_no_global_overcommit_clean_case_passes():
    cs = _tiny_cluster()
    cs.create_pod(make_pod("p0", "1"))
    cs.bind("default", "p0", "n0")
    violations: list = []
    check_no_global_overcommit(
        cs, 0, violations,
        binds=[("r0", "default/p0", "n0")],
        owners={"n0": "r0", "n1": "r1"},
    )
    assert violations == []


class _JournalStub:
    def __init__(self, lines):
        self.lines = lines


class _SchedStub:
    def __init__(self, lines, solvers=("default-scheduler",)):
        self.journal = _JournalStub(lines)
        self.solvers = {name: None for name in solvers}

        class _Q:
            @staticmethod
            def entries():
                return {}

        self.queue = _Q()


def _dec(pod, outcome, t, step=1, replica="r0"):
    import json

    return json.dumps(
        {
            "k": "dec", "v": 1, "step": step, "cycle": 1, "pod": pod,
            "uid": "", "outcome": outcome, "t": t, "replica": replica,
        },
        sort_keys=True,
    )


def test_fleet_journal_completeness_merges_across_replicas():
    """A pod handed off (non-terminal 'discarded' on r0) and then
    bound by r1 is COMPLETE fleet-wide; the single-replica view alone
    would flag it."""
    cs = _tiny_cluster()
    cs.create_pod(make_pod("p0", "1"))
    cs.bind("default", "p0", "n1")
    r0 = _SchedStub([_dec("default/p0", "discarded", 1.0, replica="r0")])
    r1 = _SchedStub([_dec("default/p0", "bound", 2.0, replica="r1")])
    violations: list = []
    check_fleet_journal_completeness(
        cs, [r0, r1], 0, violations, {"default/p0"}
    )
    assert violations == []


def test_fleet_journal_completeness_flags_orphaned_pod():
    """Known-bad: an unbound pod whose merged history ends
    non-terminal (the replica-loss blind spot this invariant exists
    to close)."""
    cs = _tiny_cluster()
    cs.create_pod(make_pod("p0", "1"))  # never bound
    r0 = _SchedStub([_dec("default/p0", "discarded", 1.0)])
    r1 = _SchedStub([])
    violations: list = []
    check_fleet_journal_completeness(cs, [r0, r1], 0, violations, set())
    assert any(
        v.invariant == "journal" and "non-terminal" in v.detail
        for v in violations
    )
    # ...and one that never journaled anywhere
    cs.create_pod(make_pod("p1", "1"))
    violations2: list = []
    check_fleet_journal_completeness(cs, [r0, r1], 0, violations2, set())
    assert any(
        "never appeared" in v.detail for v in violations2
    )


def test_fleet_journal_completeness_flags_unjournaled_bind():
    cs = _tiny_cluster()
    cs.create_pod(make_pod("p0", "1"))
    cs.bind("default", "p0", "n0")
    r0 = _SchedStub([])
    violations: list = []
    check_fleet_journal_completeness(
        cs, [r0], 0, violations, {"default/p0"}
    )
    assert any(
        v.invariant == "journal" and "bound" in v.detail
        for v in violations
    )


def test_fleet_harness_rejects_unsound_profiles():
    import pytest

    with pytest.raises(ValueError, match="prompt delivery"):
        FleetSimHarness("churn_heavy", seed=0, cycles=2, device="cpu")


def test_hub_partition_zombie_fenced_and_conservative():
    """The partition scenario: the last replica is cut off
    from the occupancy hub with its lease observed stale. 100% of its
    bind attempts while fenced must reject with Conflict (the
    commit-fence invariant), conservative admission must reject
    cross-shard-risky placements while rows are aged out, and after
    the heal the fleet settles clean."""
    res = run_fleet_sim("hub_partition", seed=0, cycles=8, device="cpu")
    assert res.violations == []
    assert res.settled
    s = res.summary
    assert s["zombie"] == "r1"
    assert s["fenced_commits"]["r1"] >= 1  # the zombie really tried
    assert s["zombie_binds_while_fenced"] == 0  # ...and never landed one
    assert s["stale_rejections"] >= 1  # conservative admission engaged
    # determinism across the partition/heal boundary
    res2 = run_fleet_sim("hub_partition", seed=0, cycles=8, device="cpu")
    assert res.journal_digests == res2.journal_digests
