"""Restart incarnations on the port, paired against the JAX package.

Every case of ``tests/test_restart_recovery.py`` runs as one scenario
written once and driven on each package through its own wrappers,
``ClusterState``, ``FakeClock`` and ``Scheduler`` (the port on the CPU,
both in "first" mode with float64 balanced scores). The scenario returns
what it observed -- bindings, nominations, batch results, the journal's
records (``recovered`` ones with their incarnation tag), claim
reservations -- and the two packages' observations must be equal. Two
cases go beyond the reference's file: a crash at the commit seam
(``_pre_commit_hook``) in the middle of ``run_pipelined`` settled by a
second incarnation, and a pod group left partly bound that the second
incarnation evicts and binds whole.
"""

import importlib
import json
import types

import pytest

SIDES = ("jax", "port")


def side(name: str):
    """The modules a scenario needs, from one package."""
    root = "kubernetes_tpu" if name == "jax" else "kubernetes_tpu_torch"

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    ns = types.SimpleNamespace(name=name)
    wrappers, sched, obs = m("api.wrappers"), m("scheduler"), m("obs")
    ns.MakeNode, ns.MakePod = wrappers.MakeNode, wrappers.MakePod
    ns.ClusterState = m("state.cluster").ClusterState
    ns.FakeClock = m("utils.clock").FakeClock
    ns.ObsConfig = obs.ObsConfig
    ns.dra = m("api.dra")
    ns.FeatureGates = m("utils.featuregate").FeatureGates
    ns.interface = m("framework.interface")
    ns.SolverFaultError = m("resilience").SolverFaultError
    ns.metrics = m("metrics")
    ns.tracing = m("utils.tracing")
    ns.GangConfig = m("gang").GangConfig
    solver_cfg = m("solver.exact").ExactSolverConfig

    def scheduler(cs, clock, **kw):
        kw.setdefault("solver", solver_cfg(tie_break="first", balanced_fdtype="float64"))
        if name == "jax":
            return sched.Scheduler(cs, sched.SchedulerConfig(mesh_devices=1, **kw), clock=clock)
        return sched.Scheduler(cs, sched.SchedulerConfig(**kw), clock=clock, device="cpu")

    ns.scheduler = scheduler
    return ns


def paired(scenario):
    """Run ``scenario`` on both packages; their observations must agree.
    Returns the port's."""
    got = {s: scenario(side(s)) for s in SIDES}
    assert got["port"] == got["jax"]
    return got["port"]


def node(k, name="n", cpu="4", mem="8Gi", pods="10"):
    return k.MakeNode().name(name).capacity({"cpu": cpu, "memory": mem, "pods": pods}).obj()


def records(sched) -> list[dict]:
    return [json.loads(line) for line in sched.journal.lines]


def bindings(cs) -> dict:
    return {p.key: p.node_name for p in cs.list_pods()}


def batch(res) -> dict:
    return {"scheduled": list(res.scheduled), "unschedulable": list(res.unschedulable),
            "preemptions": [(p, n, list(v)) for p, n, v in res.preemptions]}


# -- tests/test_restart_recovery.py ------------------------------------------


def test_restart_resumes_pending_and_nominations():
    def scenario(k):
        clock = k.FakeClock()
        cs = k.ClusterState()
        cs.create_node(node(k, cpu="2", mem="4Gi"))
        s1 = k.scheduler(cs, clock)
        cs.create_pod(k.MakePod().name("victim").priority(0).req({"cpu": "2"}).obj())
        cs.bind("default", "victim", "n")
        cs.create_pod(k.MakePod().name("preemptor").priority(10).req({"cpu": "2"}).obj())
        r1 = s1.schedule_batch()
        assert r1.preemptions
        assert cs.get_pod("default", "preemptor").nominated_node_name == "n"
        cs.create_pod(k.MakePod().name("thief").priority(1).req({"cpu": "2"}).obj())
        clock.advance(30.0)
        s2 = k.scheduler(cs, clock)
        assert "default/preemptor" in s2.nominated_pods
        r2 = s2.schedule_batch()
        assert dict(r2.scheduled).get("default/preemptor") == "n"
        assert "default/thief" in r2.unschedulable
        return batch(r1), batch(r2), bindings(cs)

    paired(scenario)


def test_restart_reconstructs_bound_state():
    def scenario(k):
        clock = k.FakeClock()
        cs = k.ClusterState()
        cs.create_node(node(k, cpu="2", mem="4Gi"))
        s1 = k.scheduler(cs, clock)
        cs.create_pod(k.MakePod().name("a").req({"cpu": "2"}).obj())
        r1 = s1.schedule_batch()
        assert dict(r1.scheduled).get("default/a") == "n"
        s2 = k.scheduler(cs, clock)
        cs.create_pod(k.MakePod().name("b").req({"cpu": "2"}).obj())
        r2 = s2.schedule_batch()
        assert "default/b" in r2.unschedulable or r2.preemptions == []
        return batch(r1), batch(r2), bindings(cs)

    paired(scenario)


def test_restart_journals_recovered_for_orphans():
    def scenario(k):
        cs = k.ClusterState()
        cs.create_node(node(k))
        cs.create_pod(k.MakePod().name("a").req({"cpu": "1"}).obj())
        cs.create_pod(k.MakePod().name("b").req({"cpu": "1"}).obj())
        s2 = k.scheduler(cs, k.FakeClock(), incarnation=2, obs=k.ObsConfig(journal=True))
        recs = records(s2)
        assert [r["outcome"] for r in recs] == ["recovered", "recovered"]
        assert all(r["incarnation"] == 2 for r in recs)
        r = s2.schedule_batch()
        assert len(r.scheduled) == 2
        after = records(s2)
        assert [x["outcome"] for x in after[-2:]] == ["bound", "bound"]
        assert all(x["incarnation"] == 2 for x in after)
        return recs, batch(r), [(x["pod"], x["outcome"], x.get("node")) for x in after]

    paired(scenario)


def test_first_start_journals_no_recovered():
    def scenario(k):
        cs = k.ClusterState()
        cs.create_node(node(k))
        cs.create_pod(k.MakePod().name("a").req({"cpu": "1"}).obj())
        s1 = k.scheduler(cs, k.FakeClock(), obs=k.ObsConfig(journal=True))
        assert s1.journal.lines == []
        assert "incarnation" not in s1.journal.tags
        s1.schedule_batch()
        recs = records(s1)
        assert all("incarnation" not in r for r in recs)
        return recs

    paired(scenario)


def _claim(k, pod, bound=False, scheduler_name=None):
    """A node and a pod holding a claim reserved for it, the pod bound
    or not, owned by ``scheduler_name`` or the default scheduler."""
    cs = k.ClusterState()
    cs.create_node(node(k))
    b = k.MakePod().name(pod).req({"cpu": "1"}).resource_claim("c")
    if scheduler_name:
        b = b.scheduler_name(scheduler_name)
    cs.create_pod(b.obj())
    if bound:
        cs.bind("default", pod, "n")
    cs.create_resource_claim(k.dra.ResourceClaim(
        name="c",
        requests=(k.dra.DeviceRequest(name="r", device_class_name="tpu"),),
        allocated_node="n",
        results=(k.dra.DeviceResult(request="r", driver="d", pool="p", device="0"),),
        reserved_for=(f"default/{pod}",),
    ))
    s = k.scheduler(cs, k.FakeClock(), incarnation=2, obs=k.ObsConfig(journal=True),
                    feature_gates=k.FeatureGates.parse("DynamicResourceAllocation=true"))
    c = cs.get_resource_claim("default", "c")
    return c.reserved_for, c.allocated_node, [r["outcome"] for r in records(s)]


def test_restart_rolls_back_half_committed_claim():
    def scenario(k):
        got = _claim(k, "orphan")
        assert got[:2] == ((), "")  # reservation and devices freed
        return got

    assert paired(scenario)[2] == ["recovered"]


def test_restart_leaves_bound_pod_claims_alone():
    def scenario(k):
        got = _claim(k, "ok", bound=True)
        assert got[:2] == (("default/ok",), "n")
        return got

    paired(scenario)


def test_restart_leaves_foreign_scheduler_claims_alone():
    def scenario(k):
        got = _claim(k, "theirs", scheduler_name="other-scheduler")
        assert got[:2] == (("default/theirs",), "n")
        return got

    paired(scenario)


def test_restart_recovers_permit_parked_orphan():
    def scenario(k):
        class HoldAtPermit(k.interface.PermitPlugin):
            def permit(self, state, pod, node_name):
                return k.interface.Status(k.interface.StatusCode.WAIT), 30.0

        clock = k.FakeClock()
        cs = k.ClusterState()
        cs.create_node(node(k))
        s1 = k.scheduler(cs, clock, out_of_tree_plugins=(HoldAtPermit(),))
        cs.create_pod(k.MakePod().name("p").req({"cpu": "1"}).obj())
        s1.schedule_batch()
        assert list(s1.waiting_pods()) == ["default/p"]
        cs.unsubscribe(s1._on_event)
        s2 = k.scheduler(cs, clock, incarnation=2, obs=k.ObsConfig(journal=True))
        recs = records(s2)
        assert [r["outcome"] for r in recs] == ["recovered"]
        r = s2.schedule_batch()
        assert dict(r.scheduled).get("default/p") == "n"
        return recs, batch(r), bindings(cs)

    paired(scenario)


def test_restart_requarantines_poison_pod():
    def scenario(k):
        clock = k.FakeClock()
        cs = k.ClusterState()
        cs.create_node(node(k, cpu="8", mem="16Gi"))
        cs.create_pod(k.MakePod().name("poison").label("poison", "1").req({"cpu": "1"}).obj())
        cs.create_pod(k.MakePod().name("fine").req({"cpu": "1"}).obj())

        def poison_fault(pods, tier):
            if any(p.labels.get("poison") for p in pods):
                raise k.SolverFaultError("data poison breaks every tier")

        s1 = k.scheduler(cs, clock)
        s1._solve_fault = poison_fault
        s1.run_until_settled()
        assert "default/poison" in s1._quarantine
        cs.unsubscribe(s1._on_event)
        s2 = k.scheduler(cs, clock, incarnation=2, obs=k.ObsConfig(journal=True))
        assert s2._quarantine == {}  # reset, not carried over
        assert s2.resilience.summary()["trips"] == 0  # the breaker too
        s2._solve_fault = poison_fault
        s2.run_until_settled()
        assert "default/poison" in s2._quarantine
        outcomes = [r["outcome"] for r in records(s2)]
        assert "quarantined" in outcomes
        assert cs.get_pod("default", "fine").node_name == "n"
        return outcomes, bindings(cs), sorted(s2._quarantine)

    paired(scenario)


def _recoveries(k) -> float:
    if k.name == "port":
        return k.metrics.restart_recovery_seconds.count()
    for metric in k.metrics.restart_recovery_seconds.collect():
        for s in metric.samples:
            if s.name.endswith("_count"):
                return s.value
    raise AssertionError("histogram has no _count sample")


def test_recovery_metric_and_span_observed():
    def scenario(k):
        before = _recoveries(k)
        cs = k.ClusterState()
        cs.create_node(node(k))
        cs.create_pod(k.MakePod().name("a").req({"cpu": "1"}).obj())
        clock = k.FakeClock()
        clock.advance(1.0)
        s2 = k.scheduler(cs, clock, incarnation=2, obs=k.ObsConfig(journal=True, spans=True))
        assert _recoveries(k) == before + 1
        assert s2.journal.lines
        spans = [json.loads(line) for line in s2.flight.lines()]
        rec = [x for x in spans if x.get("name") == "recover"]
        assert len(rec) == 1
        attrs = rec[0]["attrs"]
        return (attrs["restart"], attrs["incarnation"], attrs["adopted"], attrs["recovered"],
                attrs["claims_rolled_back"], attrs["gangs_rolled_back"])

    assert paired(scenario) == (True, 2, 1, 1, 0, 0)


def test_tracing_wraps_schedule_batch(tmp_path):
    def scenario(k):
        trace = tmp_path / k.name
        k.tracing.enable(str(trace))
        try:
            cs = k.ClusterState()
            cs.create_node(node(k))
            sched = k.scheduler(cs, k.FakeClock())
            cs.create_pod(k.MakePod().name("p").req({"cpu": "1"}).obj())
            r = sched.schedule_batch()
            assert dict(r.scheduled).get("default/p") == "n"
        finally:
            k.tracing.stop()
            k.tracing._trace_dir = None
        assert any(trace.iterdir())  # the profiler wrote its trace
        return batch(r)

    paired(scenario)


# -- beyond the reference's file ---------------------------------------------


class Crash(Exception):
    """The scheduler process died at the commit seam."""


def _crash_cluster(k):
    cs = k.ClusterState()
    for i in range(8):
        cs.create_node(k.MakeNode().name(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": "10"})
                       .label("zone", f"z{i % 3}").label("kubernetes.io/hostname", f"n{i}").obj())
    for i in range(24):
        b = k.MakePod().name(f"p{i:02}").req({"cpu": "500m"}).label("app", ("s", "a", "w")[i % 3])
        if i % 3 == 0:
            b = b.spread_constraint(1, "zone", "DoNotSchedule", {"app": "s"})
        elif i % 3 == 1:
            b = b.pod_anti_affinity("kubernetes.io/hostname", {"app": "a"})
        cs.create_pod(b.obj())
    return cs


@pytest.mark.parametrize("loop", ["pipelined", "settled"])
def test_crash_at_commit_seam_then_restart_settles(loop):
    """Incarnation 1 dies at ``_pre_commit_hook`` on its second batch
    (pods assumed and approved, nothing bound); incarnation 2 on the same
    cluster re-adopts and journals every unbound pod and settles it."""

    def scenario(k):
        clock = k.FakeClock()
        cs = _crash_cluster(k)
        s1 = k.scheduler(cs, clock, batch_size=8, obs=k.ObsConfig(journal=True))
        calls = []

        def die(pending):
            calls.append(len(pending))
            if len(calls) == 2:
                raise Crash()

        s1._pre_commit_hook = die
        with pytest.raises(Crash):
            (s1.run_pipelined if loop == "pipelined" else s1.run_until_settled)()
        cs.unsubscribe(s1._on_event)
        bound1 = bindings(cs)
        orphans = sorted(key for key, n in bound1.items() if not n)
        assert len(orphans) == 16
        s2 = k.scheduler(cs, clock, batch_size=8, incarnation=2, obs=k.ObsConfig(journal=True))
        recs = records(s2)
        assert sorted(r["pod"] for r in recs) == orphans
        assert {(r["outcome"], r["incarnation"]) for r in recs} == {("recovered", 2)}
        s2.run_until_settled()
        assert all(bindings(cs).values())
        return calls, bound1, recs, bindings(cs), [(r["pod"], r["outcome"]) for r in records(s2)]

    paired(scenario)


def test_restart_rolls_back_a_partial_gang():
    """Two of a three-member pod group bound when the predecessor died:
    the successor evicts them back to Pending and binds the group whole."""

    def scenario(k):
        cs = k.ClusterState()
        for i in range(3):
            cs.create_node(node(k, name=f"n{i}"))
        for i in range(3):
            cs.create_pod(
                k.MakePod().name(f"g{i}").req({"cpu": "1"})
                .label("scheduling.x-k8s.io/pod-group", "grp")
                .annotation("scheduling.x-k8s.io/pod-group-min-member", "3").obj()
            )
        cs.bind("default", "g0", "n0")
        cs.bind("default", "g1", "n1")
        s2 = k.scheduler(cs, k.FakeClock(), incarnation=2, gang=k.GangConfig(),
                         obs=k.ObsConfig(journal=True, spans=True))
        assert not any(bindings(cs).values())  # the stranded members evicted
        spans = [json.loads(line) for line in s2.flight.lines()]
        rolled = [x["attrs"]["gangs_rolled_back"] for x in spans if x.get("name") == "recover"]
        assert rolled == [1]
        res = s2.run_until_settled()
        assert all(bindings(cs).values())
        return ([r["outcome"] for r in records(s2)], bindings(cs),
                [batch(r) for r in res if r.scheduled])

    paired(scenario)
