"""The port's Scheduler against the JAX package's on the host paths around
the solve: gangs, Permit / Reserve / PostFilter plugins, volume binding and
dynamic resource allocation (with its device-driven preemption). Each
scenario runs both schedulers side by side (``_torch_sched_pair.Pair``):
the same batch results in order, bindings, nominations and attempt-metric
deltas, in ``tie_break="first"`` with float64 balanced scores.
"""

import pytest

from kubernetes_tpu.api.dra import Device, DeviceClass, DeviceRequest, ResourceClaim, ResourceSlice
from kubernetes_tpu.api.objects import PersistentVolume, PersistentVolumeClaim
from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.framework import interface as ref_fw
from kubernetes_tpu.gang import GangConfig as RefGangConfig
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.utils.featuregate import FeatureGates as RefFeatureGates
from kubernetes_tpu_torch.framework import interface as port_fw
from kubernetes_tpu_torch.gang import (
    ACCEL_CLASS_LABEL,
    GANG_LABEL,
    MIN_MEMBER_ANNOTATION,
    WORKLOAD_CLASS_LABEL,
    GangConfig,
)
from kubernetes_tpu_torch.utils.featuregate import FeatureGates

from _torch_sched_pair import Pair

ZONE = "topology.kubernetes.io/zone"
GB = 1 << 30


def _nodes(n, cpu="4", labels=None):
    cs = ClusterState()
    for i in range(n):
        b = MakeNode().name(f"n{i}").capacity({"cpu": cpu, "memory": "8Gi", "pods": "20"})
        for k, v in (labels(i) if labels else {}).items():
            b = b.label(k, v)
        cs.create_node(b.obj())
    return cs


def _member(name, group="train", min_member=3, cpu="1", wc=""):
    b = (MakePod().name(name).req({"cpu": cpu, "memory": "256Mi"})
         .label(GANG_LABEL, group).annotation(MIN_MEMBER_ANNOTATION, str(min_member)))
    if wc:
        b = b.label(WORKLOAD_CLASS_LABEL, wc)
    return b.obj()


def _gang_pair(cs, **gang):
    return Pair(cs, batch_size=64, gang=GangConfig(**gang),
                ref_config={"gang": RefGangConfig(**gang)})


# -- gangs -------------------------------------------------------------------


def test_gang_parks_short_then_binds_atomically():
    pair = _gang_pair(_nodes(4), min_member_timeout=600.0)
    pair.create_pod(_member("m0"))
    pair.create_pod(_member("m1"))
    pair.settle()
    assert not any(pair.bindings()[1].values())
    pair.create_pod(_member("m2"))
    pair.settle()
    pair.assert_equal()
    assert all(pair.bindings()[1].values())


def test_gang_shortfall_releases_all_then_quarantines():
    pair = _gang_pair(_nodes(1, cpu="2"), quarantine_after=1, min_member_timeout=600.0)
    for n in ("m0", "m1", "m2"):
        pair.create_pod(_member(n))
    pair.settle()
    assert sum(len(p["gang_released"]) for _, p in pair.batches) == 2
    pair.advance(301.0)
    pair.settle()
    pair.assert_equal()
    assert sorted(pair.port._quarantine) == sorted(pair.ref._quarantine) == [
        "default/m0", "default/m1", "default/m2"]


def test_gang_throughput_objective_steers():
    accel = ("gpu-a100", "tpu-v4")
    cs = _nodes(2, cpu="8", labels=lambda i: {ACCEL_CLASS_LABEL: accel[i]})
    table = {"transformer": {"tpu-v4": 1.0, "gpu-a100": 0.25}}
    pair = _gang_pair(cs, throughput_weight=100, class_throughput=table)
    for n in ("m0", "m1"):
        pair.create_pod(_member(n, min_member=2, wc="transformer"))
    pair.settle()
    pair.assert_equal()
    assert set(pair.bindings()[1].values()) == {"n1"}


# -- Permit, Reserve and PostFilter plugins ----------------------------------


def _plugins(fw):
    class Gate(fw.PermitPlugin):
        def name(self):
            return "Gate"

        def permit(self, state, pod, node_name):
            if pod.name.startswith("wait"):
                return fw.Status(fw.StatusCode.WAIT), 30.0
            if pod.name.startswith("deny"):
                return fw.Status.unschedulable("denied"), 0.0
            return fw.Status.success(), 0.0

    class Budget(fw.ReservePlugin):
        def name(self):
            return "Budget"

        def reserve(self, state, pod, node_name):
            if pod.name == "greedy":
                return fw.Status.unschedulable("over budget")
            return fw.Status.success()

    class Nominate(fw.PostFilterPlugin):
        def name(self):
            return "Nominate"

        def post_filter(self, state, pod, filtered):
            return sorted(filtered)[0], fw.Status.success()

    return (Gate(), Budget(), Nominate())


def test_permit_reserve_postfilter_plugins_equal_reference():
    cs = _nodes(3)
    pair = Pair(cs, batch_size=16, out_of_tree_plugins=_plugins(port_fw),
                ref_config={"out_of_tree_plugins": _plugins(ref_fw)})
    for name, cpu in (("ok", "1"), ("wait-a", "1"), ("wait-b", "1"), ("deny", "1"),
                      ("greedy", "1"), ("huge", "64")):
        pair.create_pod(MakePod().name(name).req({"cpu": cpu}).obj())
    r, p = pair.step()
    assert sorted(pair.port.waiting_pods()) == ["default/wait-a", "default/wait-b"]
    for s in (pair.ref, pair.port):
        s.waiting_pods()["default/wait-a"].allow("Gate")
        s.waiting_pods()["default/wait-b"].reject("Gate", "not today")
    pair.step()
    pair.advance(40.0)
    pair.settle()
    pair.assert_equal()
    bound = pair.bindings()[1]
    assert bound["default/ok"] and bound["default/wait-a"] and not bound["default/deny"]
    assert pair.nominations()[1]["default/huge"] == "n0"


# -- volume binding ----------------------------------------------------------


def test_wait_for_first_consumer_volumes_equal_reference():
    cs = _nodes(3, labels=lambda i: {ZONE: ("east", "east", "west")[i]})
    for name, zone, size in (("pv-small", "east", 5 * GB), ("pv-big", "east", 50 * GB),
                             ("pv-west", "west", 20 * GB)):
        cs.create_pv(PersistentVolume(name=name, labels={ZONE: zone}, capacity_bytes=size,
                                      storage_class="standard"))
    for i, size in enumerate((2 * GB, 10 * GB, 30 * GB)):
        cs.create_pvc(PersistentVolumeClaim(name=f"data-{i}", storage_class="standard",
                                            request_bytes=size, wait_for_first_consumer=True))
    pair = Pair(cs)
    for i in range(3):
        pair.create_pod(MakePod().name(f"p{i}").req({"cpu": "1"}).pvc(f"data-{i}").obj())
    pair.settle()
    pair.assert_equal()
    ref = {c.key: c.volume_name for c in pair.ref_cluster.list_pvcs()}
    port = {c.key: c.volume_name for c in pair.cluster.list_pvcs()}
    assert port == ref and port["default/data-0"] == "pv-small"


# -- dynamic resource allocation --------------------------------------------


def _dra_cluster(n_nodes, gpus):
    cs = _nodes(n_nodes, cpu="8")
    for i in range(n_nodes):
        cs.create_resource_slice(ResourceSlice(
            name=f"slice-n{i}", node_name=f"n{i}", driver="gpu.example.com",
            devices=tuple(Device(name=f"gpu-{j}", attributes={"model": "a100"})
                          for j in range(gpus))))
    cs.create_device_class(DeviceClass(name="gpu", driver="gpu.example.com"))
    return cs


def _dra_pair(cs):
    return Pair(cs, batch_size=64,
                feature_gates=FeatureGates.parse("DynamicResourceAllocation=true"),
                ref_config={"feature_gates": RefFeatureGates.parse(
                    "DynamicResourceAllocation=true")})


def _claims(pair):
    def view(cs):
        return {c.key: (c.allocated_node, tuple(r.device for r in c.results), c.reserved_for)
                for c in cs.list_resource_claims()}
    return view(pair.ref_cluster), view(pair.cluster)


def test_dra_allocation_and_exhaustion_equal_reference():
    cs = _dra_cluster(2, 2)
    for i in range(3):
        cs.create_resource_claim(ResourceClaim(
            name=f"c{i}", requests=(DeviceRequest(name="g", device_class_name="gpu", count=2),)))
    pair = _dra_pair(cs)
    for i in range(3):
        pair.create_pod(MakePod().name(f"p{i}").req({"cpu": "1", "memory": "1Gi"})
                        .resource_claim(f"c{i}").obj())
    pair.settle()
    pair.advance(301.0)
    pair.step()
    pair.assert_equal()
    ref, port = _claims(pair)
    assert port == ref
    assert sum(1 for v in pair.bindings()[1].values() if v) == 2


@pytest.mark.parametrize("shared", [False, True])
def test_dra_preemption_frees_devices_equal_reference(shared):
    cs = _dra_cluster(1, 1)
    names = ("low", "high") if not shared else ("low", "low")
    for name in sorted(set(names)):
        cs.create_resource_claim(ResourceClaim(
            name=f"c-{name}", requests=(DeviceRequest(name="g", device_class_name="gpu", count=1),)))
    pair = _dra_pair(cs)
    pair.create_pod(MakePod().name("low").priority(1).req({"cpu": "1", "memory": "1Gi"})
                    .resource_claim("c-low").obj())
    pair.settle()
    pair.create_pod(MakePod().name("high").priority(100).req({"cpu": "1", "memory": "1Gi"})
                    .resource_claim(f"c-{names[1]}").obj())
    for _ in range(4):
        pair.step()
        pair.advance(11.0)
    pair.assert_equal()
    ref, port = _claims(pair)
    assert port == ref
    if not shared:
        # the low pod's claim held the only device: it was preempted
        assert any(p["preemptions"] for _, p in pair.batches)
        assert pair.bindings()[1]["default/high"] == "n0"
