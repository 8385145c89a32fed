"""The port's Scheduler against the JAX package's on the CPU.

Each scenario is built once with the JAX package's ``MakeNode`` /
``MakePod`` / ``ClusterState`` and carried across with
``convert.cluster_state``. Both schedulers run on a ``FakeClock`` with
``tie_break="first"`` and ``balanced_fdtype="float64"`` (the JAX one with
``mesh_devices=1``; its results are device-count invariant), and must give
the same batch results in order, the same bindings, nominations and
``scheduler_schedule_attempts_total`` deltas (``_torch_sched_pair.Pair``).
Random mode, the production default, draws the JAX package's threefry
stream: with the default config the port binds every pod where the JAX
package's does, and its picks are held by invariants and by the oracle's
tie set too.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.config.types import Extender as RefExtender
from kubernetes_tpu.framework.interface import FilterPlugin as RefFilterPlugin
from kubernetes_tpu.framework.interface import ScorePlugin as RefScorePlugin
from kubernetes_tpu.framework.interface import Status as RefStatus
from kubernetes_tpu.ops.oracle import scheduler as osched
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.config.types import Extender
from kubernetes_tpu_torch.framework.interface import FilterPlugin, ScorePlugin, Status
from kubernetes_tpu_torch.api import objects as port_objects
from kubernetes_tpu_torch.metrics import prom
from kubernetes_tpu_torch.ops.oracle import scheduler as port_osched
from kubernetes_tpu_torch.ops.oracle.profile import FullOracle, make_oracle_nodes
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.utils.clock import FakeClock

from _torch_sched_pair import Pair

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def mk_cluster(n_nodes, cpu="4", mem="8Gi", pods="110", zones=0):
    cs = ClusterState()
    for i in range(n_nodes):
        b = (
            MakeNode().name(f"node-{i:04}")
            .capacity({"cpu": cpu, "memory": mem, "pods": pods})
            .label(HOST, f"node-{i:04}")
        )
        if zones:
            b = b.label(ZONE, f"z{i % zones}")
        cs.create_node(b.obj())
    return cs


# -- the scenarios of tests/test_scheduler_e2e.py --------------------------


def test_all_pods_bound():
    cs = mk_cluster(8)
    for i in range(40):
        cs.create_pod(MakePod().name(f"p{i:03}").req({"cpu": "200m", "memory": "256Mi"}).obj())
    pair = Pair(cs, batch_size=16)
    pair.settle()
    pair.assert_equal()
    assert all(p.node_name for p in pair.cluster.list_pods())
    assert pair.port.pending == 0
    assert sum(len(p["scheduled"]) for _, p in pair.batches) == 40


def test_bindings_match_sequential_oracle():
    cs = mk_cluster(5)
    node_objs = cs.list_nodes()
    pods = [
        MakePod().name(f"p{i:03}")
        .req({"cpu": f"{100 + 70 * (i % 7)}m", "memory": f"{256 + 128 * (i % 3)}Mi"}).obj()
        for i in range(30)
    ]
    pair = Pair(cs)
    for p in pods:
        pair.create_pod(p)
    pair.settle()
    pair.assert_equal()
    oracle = osched.schedule(pods, osched.make_node_states(node_objs))
    names = [n.name for n in node_objs]
    want = {p.key: (names[a] if a >= 0 else "") for p, a in zip(pods, oracle.assignments)}
    assert pair.bindings()[1] == want
    # and the port's own oracle, on the port's objects
    port_nodes = [convert.api_object(n, port_objects.Node) for n in node_objs]
    port_pods = [convert.api_object(p, port_objects.Pod) for p in pods]
    port_oracle = port_osched.schedule(port_pods, port_osched.make_node_states(port_nodes))
    assert port_oracle.assignments == oracle.assignments
    assert pair.bindings()[1] == {
        p.key: (names[a] if a >= 0 else "") for p, a in zip(port_pods, port_oracle.assignments)
    }


def test_infeasible_pod_parked_then_rescued_by_node_add():
    cs = mk_cluster(1, cpu="1")
    pair = Pair(cs)
    pair.create_pod(MakePod().name("big").req({"cpu": "3"}).obj())
    r, p = pair.step()
    assert p.unschedulable == ["default/big"]
    pair.create_node(
        MakeNode().name("big-node").capacity({"cpu": "8", "memory": "8Gi", "pods": "10"}).obj()
    )
    pair.requeue()
    r, p = pair.step()
    assert p.scheduled == [("default/big", "big-node")]
    pair.assert_equal()


def test_bind_conflict_forgets_and_requeues():
    from kubernetes_tpu.state.cluster import ApiError as RefApiError
    from kubernetes_tpu_torch.state.cluster import ApiError

    cs = mk_cluster(2)
    pair = Pair(cs)
    left = {"ref": 1, "port": 1}

    def fault(side, exc):
        def f(pod, node_name):
            if left[side]:
                left[side] -= 1
                raise exc("Conflict", "injected bind conflict")
        return f

    pair.ref_cluster.bind_fault = fault("ref", RefApiError)
    pair.cluster.bind_fault = fault("port", ApiError)
    pair.create_pod(MakePod().name("p").req({"cpu": "100m"}).obj())
    r, p = pair.step()
    assert p.bind_failures and not p.scheduled
    assert pair.port.cache.nodes["node-0000"].used.get("cpu", 0) == 0
    pair.requeue()
    pair.settle()
    pair.assert_equal()
    assert pair.cluster.get_pod("default", "p").node_name


def test_priority_order_across_batches():
    cs = mk_cluster(1, cpu="1", pods="2")
    pair = Pair(cs, batch_size=16)
    pair.create_pod(MakePod().name("low-a").priority(1).req({"cpu": "400m"}).obj())
    pair.create_pod(MakePod().name("low-b").priority(1).req({"cpu": "400m"}).obj())
    pair.create_pod(MakePod().name("high").priority(100).req({"cpu": "800m"}).obj())
    pair.settle()
    pair.assert_equal()
    assert pair.cluster.get_pod("default", "high").node_name


class TestEventsRecorder:
    @staticmethod
    def _events(cluster, name):
        return [
            (e.reason, e.type, e.note, e.count)
            for e in cluster.list_events(regarding_name=name)
        ]

    def test_scheduled_event_for_bound_pod(self):
        pair = Pair(mk_cluster(3))
        pair.create_pod(MakePod().name("ok").req({"cpu": "1"}).obj())
        pair.settle()
        pair.assert_equal()
        evs = self._events(pair.cluster, "ok")
        assert [e[0] for e in evs] == ["Scheduled"]
        assert evs == self._events(pair.ref_cluster, "ok")

    def test_failed_scheduling_event_dedups_with_fit_error(self):
        pair = Pair(mk_cluster(2))
        pair.create_pod(MakePod().name("big").req({"cpu": "64"}).obj())
        pair.step()
        pair.advance(301.0)  # forced leftover flush -> second attempt
        pair.step()
        evs = self._events(pair.cluster, "big")
        assert [e[0] for e in evs] == ["FailedScheduling"]
        assert evs[0][3] == 2
        # the reference-shaped fit error, equal to the JAX package's
        assert "0/2 nodes are available" in evs[0][2]
        assert "Insufficient cpu" in evs[0][2]
        assert evs == self._events(pair.ref_cluster, "big")
        pair.assert_equal()

    def test_preemption_emits_victim_and_nominee_events(self):
        cs = mk_cluster(1, cpu="2")
        cs.create_pod(MakePod().name("victim").node("node-0000").priority(0).req({"cpu": "2"}).obj())
        pair = Pair(cs)
        pair.create_pod(MakePod().name("vip").priority(100).req({"cpu": "2"}).obj())
        r, p = pair.step()
        assert p.preemptions
        for name in ("victim", "vip"):
            assert self._events(pair.cluster, name) == self._events(pair.ref_cluster, name)
        assert "Nominated" in [e[0] for e in self._events(pair.cluster, "vip")]
        pair.assert_equal()


# -- the mixed multi-batch scenario -----------------------------------------


def _mixed_pod(i: int):
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


def test_mixed_multi_batch_with_heal():
    """hostPorts, hard zone spread, hostname anti-affinity, preferred
    affinity and a nominated pod over several batches; a node added and a
    bound pod deleted between batches, so the device session heals dirty
    columns under the Scheduler."""
    cs = mk_cluster(12, zones=3, pods="20")
    # a pending pod already nominated onto node-0003 (a preemptor's
    # nomination from an earlier cycle)
    cs.create_pod(
        MakePod().name("nominee").req({"cpu": "1"}).priority(10)
        .nominated_node_name("node-0003").obj()
    )
    for i in range(40):
        cs.create_pod(_mixed_pod(i))
    pair = Pair(cs, batch_size=16)
    pair.step()
    pair.create_node(
        MakeNode().name("node-0012").capacity({"cpu": "4", "memory": "8Gi", "pods": "20"})
        .label(HOST, "node-0012").label(ZONE, "z0").obj()
    )
    for i in range(40, 52):
        pair.create_pod(_mixed_pod(i))
    pair.step()
    bound = sorted(k for k, v in pair.bindings()[1].items() if v)
    pair.delete_pod(*bound[0].split("/"))
    for i in range(52, 64):
        pair.create_pod(_mixed_pod(i))
    n = pair.settle()
    assert len(pair.batches) >= 3 and n >= 1
    pair.assert_equal()
    # the session healed (a node add and a delete between batches) rather
    # than resetting: one tier throughout
    assert pair.port._tier_last == {"default-scheduler": "single"}
    assert pair.cluster.get_pod("default", "nominee").node_name == "node-0003"


# -- the production default config: the JAX package's bindings, invariants
# -- and the oracle's tie set -----------------------------------------------


def _check_invariants(cluster):
    nodes = {n.name: n for n in cluster.list_nodes()}
    pods = [p for p in cluster.list_pods() if p.node_name]
    used: dict = {}
    ports: dict = {}
    for p in pods:
        for r, v in p.resource_request().items():
            used[(p.node_name, r)] = used.get((p.node_name, r), 0) + v
        for hp in p.host_ports():
            key = (p.node_name, hp)
            assert key not in ports, f"hostPort conflict {key}"
            ports[key] = p.key
    for (node, r), v in used.items():
        if r == "pods":
            continue
        assert v <= nodes[node].allocatable.get(r, 0), f"overcommit {node} {r}"
    per_node: dict = {}
    for p in pods:
        per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    for node, c in per_node.items():
        assert c <= nodes[node].allowed_pod_number
    anti = [p.node_name for p in pods if p.labels.get("app") == "anti"]
    assert len(anti) == len(set(anti)), "anti-affinity violated"
    zones = {n.name: n.labels.get(ZONE) for n in nodes.values()}
    counts: dict = {z: 0 for z in set(zones.values())}
    for p in pods:
        if p.labels.get("app") == "spread":
            counts[zones[p.node_name]] += 1
    assert max(counts.values()) - min(counts.values()) <= 1, f"skew {counts}"


@pytest.mark.parametrize("seed", [0, 1])
def test_default_random_config_invariants_and_tie_set(seed):
    cs = mk_cluster(16, zones=3)
    for i in range(120):
        cs.create_pod(_mixed_pod(i) if i % 3 else
                      MakePod().name(f"m{i:03}").req({"cpu": "250m", "memory": "512Mi"}).obj())
    # the production defaults, with the seed of the random tie-break drawn;
    # the JAX package's Scheduler on the same cluster binds alike
    pair = Pair(cs, solver=dict(seed=seed), batch_size=64)
    cfg = pair.port.config
    assert cfg.solver.tie_break == "random" and cfg.solver.group_size == 64
    assert cfg.solver == ExactSolverConfig(seed=seed)
    port_cs = pair.cluster
    nodes = port_cs.list_nodes()
    pods = {p.key: p for p in port_cs.list_pods()}
    _, results = pair.run("settled")
    pair.assert_equal()
    order = []
    for r in results:
        order += r.scheduled
    # every feasible pod bound: hostPort pods beyond one per node cannot be
    lb = [p for p in pods.values() if p.labels.get("app") == "lb"]
    want = len(pods) - max(len(lb) - len(nodes), 0)
    assert len(order) == want
    _check_invariants(port_cs)
    oracle = FullOracle(make_oracle_nodes(nodes))
    errors = oracle.validate_assignments(
        [pods[k] for k, _ in order], [0] * len(order), names=[n for _, n in order]
    )
    assert not errors, "\n".join(errors[:5])


# -- an out-of-tree Filter/Score plugin and an extender, equal to JAX -------


def _plugins(filter_base, score_base, status):
    class NoOdd(filter_base):
        def name(self):
            return "NoOdd"

        def filter(self, state, pod, node, placed=()):
            if int(node.name[-1]) % 2:
                return status.unschedulable("odd node")
            return status.success()

    class PreferHigh(score_base):
        def name(self):
            return "PreferHigh"

        def score(self, state, pod, node):
            return int(node.name[-1]) * 10

        def weight(self):
            return 3

    return (NoOdd(), PreferHigh())


def test_out_of_tree_filter_score_plugins_equal_reference():
    cs = mk_cluster(6)
    for i in range(12):
        cs.create_pod(MakePod().name(f"p{i:02}").req({"cpu": "500m"}).obj())
    pair = Pair(
        cs,
        out_of_tree_plugins=_plugins(FilterPlugin, ScorePlugin, Status),
        # the JAX package gets plugin objects of its own classes
        ref_config={"out_of_tree_plugins": _plugins(RefFilterPlugin, RefScorePlugin, RefStatus)},
    )
    pair.settle()
    pair.assert_equal()
    assert {n for n in pair.bindings()[1].values()} <= {"node-0000", "node-0002", "node-0004"}


class _ExtenderHandler(BaseHTTPRequestHandler):
    """Fixed verdicts in the extender/v1 wire shapes: filter keeps the
    nodes whose index is below 4 and fails the rest; prioritize gives
    node-000k the score k."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        names = [n["metadata"]["name"] for n in body["nodes"]["items"]]
        if self.path.endswith("/filter"):
            keep = [n for n in names if int(n[-1]) < 4]
            out = {
                "nodes": {"items": [i for i in body["nodes"]["items"]
                                    if i["metadata"]["name"] in keep]},
                "failedNodes": {n: "extender says no" for n in names if n not in keep},
            }
        else:
            out = [{"host": n, "score": int(n[-1])} for n in names]
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def test_extender_equal_reference():
    server = HTTPServer(("127.0.0.1", 0), _ExtenderHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        kw = dict(url_prefix=url, filter_verb="filter", prioritize_verb="prioritize", weight=2)
        cs = mk_cluster(6)
        for i in range(10):
            cs.create_pod(MakePod().name(f"p{i:02}").req({"cpu": "1"}).obj())
        pair = Pair(
            cs, extenders=(Extender(**kw),),
            ref_config={"extenders": (RefExtender(**kw),)},
        )
        pair.settle()
        pair.assert_equal()
        assert set(pair.bindings()[1].values()) <= {f"node-000{k}" for k in range(4)}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


# -- device resolution and the config features not ported -----------------


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = convert.cluster_state(mk_cluster(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(cs, SchedulerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(cs, SchedulerConfig(device="cuda"))


def _one_replica_fleet():
    from kubernetes_tpu_torch.fleet import FleetConfig, OccupancyExchange

    return FleetConfig(replica="r0", replicas=("r0",), exchange=OccupancyExchange())


@pytest.mark.parametrize(
    "field,value,item",
    [
        ("fleet", _one_replica_fleet, "item 8"),
        ("mesh_devices", 2, "item 11"),
        ("mesh_slice", (0, 2), "item 11"),
    ],
)
def test_unported_config_features_raise(field, value, item):
    """The features once refused here now construct. Fleet mode: a
    one-replica fleet owns every node, publishes its inventory to the hub
    and binds as a fleetless Scheduler does. A mesh resolves as the JAX
    package resolves it over the visible devices: with one visible
    device, mesh_devices 2 is the unsharded path, and a 0/2 mesh slice
    raises the JAX package's ValueError (no disjoint share)."""
    cs = convert.cluster_state(mk_cluster(1))
    if field == "fleet":
        cfg = value()
        sched = Scheduler(cs, SchedulerConfig(fleet=cfg), device="cpu")
        assert sched.fleet is not None and sched.fleet.replica == "r0"
        assert sorted(sched.cache.nodes) == sorted(n.name for n in cs.list_nodes())
        assert cfg.exchange.replica_rows("r0")[0]
        return
    if field == "mesh_devices":
        sched = Scheduler(cs, SchedulerConfig(**{field: value}), device="cpu")
        assert sched.mesh is None and sched.resilience.ladder[0] == "single"
        return
    with pytest.raises(ValueError, match="needs at least 2 visible devices"):
        Scheduler(cs, SchedulerConfig(**{field: value}), device="cpu")


@pytest.mark.parametrize("feature", ["incarnation", "bundle_dir", "sentinel"])
def test_ported_config_features_construct_and_run(feature, tmp_path):
    """Restart incarnations, replay bundles and the anomaly sentinel were
    refused until the port had the recovery pass and the solver's capture
    hook; now each constructs and binds every pod."""
    from kubernetes_tpu_torch.obs import ObsConfig, SentinelConfig

    kw = {
        "incarnation": dict(incarnation=2, obs=ObsConfig(journal=True)),
        "bundle_dir": dict(obs=ObsConfig(bundle_dir=str(tmp_path))),
        "sentinel": dict(obs=ObsConfig(sentinel=SentinelConfig())),
    }[feature]
    ref = mk_cluster(3)
    for i in range(6):
        ref.create_pod(MakePod().name(f"p{i}").req({"cpu": "500m"}).obj())
    cs = convert.cluster_state(ref)
    sched = Scheduler(cs, SchedulerConfig(**kw), clock=FakeClock(), device="cpu")
    sched.run_until_settled()
    assert all(p.node_name for p in cs.list_pods())
    if feature == "incarnation":
        outcomes = [json.loads(line)["outcome"] for line in sched.journal.lines]
        assert outcomes.count("recovered") == len(cs.list_pods())
    else:
        path = sched.telemetry.capture("manual")
        assert (path is not None) == (feature == "bundle_dir")
        assert sched.telemetry.bundles.snapshot()["captures"] == 1


@pytest.mark.parametrize("feature", ["rebalance", "backlog_warm_start"])
def test_rebalance_and_warm_start_construct_and_run(feature):
    """The rebalancer and the backlog warm start were refused until the
    port had the auction and the relax planner; now each constructs, and
    its loop binds every pod (the warm start ranking the backlog first)."""
    from kubernetes_tpu_torch.rebalance.runtime import RebalanceConfig

    ref = mk_cluster(3)
    for i in range(6):
        ref.create_pod(MakePod().name(f"p{i}").req({"cpu": "500m"}).obj())
    cs = convert.cluster_state(ref)
    if feature == "rebalance":
        sched = Scheduler(cs, SchedulerConfig(rebalance=RebalanceConfig(interval_s=1.0)),
                          clock=FakeClock(), device="cpu")
        assert sched.rebalancer is not None and sched.rebalancer.config.interval_s == 1.0
        sched.run_until_settled()
    else:
        sched = Scheduler(cs, SchedulerConfig(backlog_warm_start=True), clock=FakeClock(),
                          device="cpu")
        report = sched.drain_backlog(chunk_pods=8, budget_bytes=8 << 30)
        assert report.warm_start_ranked == 6 and report.relax_iterations >= 1
    assert all(p.node_name for p in cs.list_pods())


def test_obs_journal_and_slo_run():
    """The ported observability layer (spans, journal, SLO engine, stage
    profiler) runs under the port's Scheduler."""
    from kubernetes_tpu_torch.obs import ObsConfig, SloConfig

    cs = convert.cluster_state(mk_cluster(3))
    sched = Scheduler(
        cs,
        SchedulerConfig(obs=ObsConfig(spans=True, journal=True, slo=SloConfig(), profile=True)),
        clock=FakeClock(), device="cpu",
    )
    from kubernetes_tpu_torch.api.wrappers import MakePod as PortMakePod

    for i in range(5):
        cs.create_pod(PortMakePod().name(f"p{i}").req({"cpu": "100m"}).obj())
    sched.run_until_settled()
    outcomes = [json.loads(line)["outcome"] for line in sched.journal.lines]
    assert outcomes.count("bound") == 5
    assert sched.slo.snapshot()["window_events"] == 5


# -- convert.cluster_state --------------------------------------------------


def test_cluster_state_carries_every_object():
    from kubernetes_tpu.api.dra import DeviceClass, ResourceClaim, ResourceSlice
    from kubernetes_tpu.api.labels import selector_from_match_labels
    from kubernetes_tpu.api.objects import (
        PersistentVolume,
        PersistentVolumeClaim,
        PodDisruptionBudget,
        Service,
    )

    cs = mk_cluster(3, zones=2)
    cs.create_pod(MakePod().name("a").req({"cpu": "1"}).priority(5).start_time(7.5)
                  .label("app", "x").node("node-0001").obj())
    cs.create_pod(_mixed_pod(2))
    cs.create_pod(MakePod().name("n").req({"cpu": "1"}).nominated_node_name("node-0002").obj())
    cs.create_pdb(PodDisruptionBudget(name="pdb", selector=selector_from_match_labels({"app": "x"}),
                                      disruptions_allowed=1))
    cs.create_service(Service(name="svc", selector={"app": "x"}))
    cs.create_pv(PersistentVolume(name="pv0", capacity_bytes=1 << 30, storage_class="fast"))
    cs.create_pvc(PersistentVolumeClaim(name="pvc0", storage_class="fast", request_bytes=1 << 20))
    cs.create_resource_slice(ResourceSlice.from_dict({
        "metadata": {"name": "s0"},
        "spec": {"driver": "gpu.x", "nodeName": "node-0000", "pool": {"name": "p"},
                 "devices": [{"name": "d0"}]},
    }))
    cs.create_device_class(DeviceClass.from_dict({"metadata": {"name": "gpu"}}))
    cs.create_resource_claim(ResourceClaim.from_dict({
        "metadata": {"name": "c0", "namespace": "default"},
        "spec": {"devices": {"requests": [{"name": "r", "deviceClassName": "gpu"}]}},
    }))
    port = convert.cluster_state(cs)
    for lister in ("list_nodes", "list_pods", "list_pdbs", "list_services", "list_pvs",
                   "list_pvcs", "list_resource_slices", "list_device_classes",
                   "list_resource_claims"):
        src, dst = getattr(cs, lister)(), getattr(port, lister)()
        assert len(src) == len(dst) >= 1, lister
        assert [o.to_dict() for o in dst] == [o.to_dict() for o in src], lister
    assert [p.start_time for p in port.list_pods()] == [p.start_time for p in cs.list_pods()]
    assert port.resource_version == cs.resource_version
    # the copies share nothing with the source
    assert all(a is not b for a, b in zip(port.list_pods(), cs.list_pods()))


# -- the metrics registry ---------------------------------------------------


def test_metrics_registry_names_and_labels_equal_reference():
    from kubernetes_tpu import metrics as ref_metrics
    from kubernetes_tpu_torch import metrics

    def port_series():
        return {
            m._name + ("_total" if m._type == "counter" else ""): tuple(m._labelnames)
            for m in metrics.REGISTRY.collect()
        }

    def ref_series():
        out = {}
        for name in dir(ref_metrics):
            m = getattr(ref_metrics, name)
            if hasattr(m, "_labelnames") and hasattr(m, "_name"):
                full = m._name + ("_total" if m._type == "counter" else "")
                out[full] = tuple(m._labelnames)
        return out

    assert port_series() == ref_series()
    assert len(port_series()) == 103


def test_metrics_render_exposition_format():
    reg = prom.CollectorRegistry()
    c = prom.Counter("x_total", "a counter", ["kind"], registry=reg)
    g = prom.Gauge("y", "a gauge", registry=reg)
    h = prom.Histogram("z_seconds", "a histogram", buckets=(0.1, 1.0), registry=reg)
    c.labels("a").inc(2)
    g.set(3)
    g.dec()
    h.observe(0.5)
    h.observe(5.0)
    assert c.labels("a").value() == 2 and g.value() == 2
    assert h.count() == 2 and h.sum() == 5.5
    text = prom.generate_latest(reg).decode().splitlines()
    assert 'x_total{kind="a"} 2.0' in text
    assert "y 2.0" in text
    assert 'z_seconds_bucket{le="0.1"} 0.0' in text
    assert 'z_seconds_bucket{le="1.0"} 1.0' in text
    assert 'z_seconds_bucket{le="+Inf"} 2.0' in text
    assert "z_seconds_count 2.0" in text and "z_seconds_sum 5.5" in text
    # prometheus_client names a counter's family by its sample name
    assert "# TYPE x_total counter" in text and "# TYPE z_seconds histogram" in text
    with pytest.raises(ValueError):
        c.labels("a").inc(-1)
    with pytest.raises(ValueError):
        c.inc()  # labelled: a child is needed


def test_attempt_metrics_read_from_each_registry():
    """The pair's metric comparison reads real deltas: a batch with one
    unschedulable pod moves the unschedulable count in both registries."""
    cs = mk_cluster(1, cpu="1")
    pair = Pair(cs)
    pair.create_pod(MakePod().name("big").req({"cpu": "4"}).obj())
    pair.create_pod(MakePod().name("ok").req({"cpu": "500m"}).obj())
    pair.step()
    ref, port = pair.attempt_deltas()
    assert port == ref == {"scheduled": 1, "unschedulable": 1, "error": 0}
    assert np.isclose(sum(port.values()), 2)


def test_transfer_bytes_reach_the_registry():
    from kubernetes_tpu_torch import metrics

    cs = convert.cluster_state(mk_cluster(4, zones=2))
    sched = Scheduler(cs, SchedulerConfig(batch_size=16), clock=FakeClock(), device="cpu")
    from kubernetes_tpu_torch.api.wrappers import MakePod as PortMakePod

    for i in range(20):
        cs.create_pod(PortMakePod().name(f"p{i}").req({"cpu": "100m"}).obj())
    h2d0, d2h0 = metrics.h2d_bytes_total.value(), metrics.d2h_bytes_total.value()
    sched.run_until_settled()
    h2d1, d2h1 = metrics.h2d_bytes_total.value(), metrics.d2h_bytes_total.value()
    assert h2d1 > h2d0 and d2h1 > d2h0
    # with nothing left to schedule no solve runs, and nothing is counted
    sched.run_until_settled()
    assert (metrics.h2d_bytes_total.value(), metrics.d2h_bytes_total.value()) == (h2d1, d2h1)
