"""The port's batched evaluator (``kubernetes_tpu_torch/solver/evaluate.py``)
against the JAX package's ``BatchEvaluator`` on the same clusters.

Every fixture is built once in the JAX package's ``ClusterState`` and
carried across with ``convert.cluster_state``. In a
``balanced_fdtype="float64"`` config the ``[P, N]`` score matrices must be
equal; in float32 the feasible sets must be equal and the scores equal
except on pods whose soft-spread ``log`` may round differently (ROADMAP's
parity rules). The number of ``domain_counts`` launches per evaluation is
pinned at two batch sizes: it must not depend on the number of pods.
"""

import numpy as np
import pytest

from kubernetes_tpu.api.objects import (
    PersistentVolume,
    PersistentVolumeClaim,
    Service,
)
from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.solver.evaluate import BatchEvaluator as RefEvaluator
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolverConfig
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu.tensorize.schema import build_node_batch, build_pod_batch
from kubernetes_tpu.tensorize.spread import build_spread_tensors
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api import objects as port_objects
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.solver.evaluate import BatchEvaluator
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
GB = 1024**3
F64 = dict(balanced_fdtype="float64")


# -- fixtures ----------------------------------------------------------------


def serve_cluster():
    """tests/test_serve_tpu.py's cluster: 6 nodes in 2 zones, one busy."""
    cs = ClusterState()
    for i in range(6):
        cs.create_node(
            MakeNode().name(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"})
            .label("zone", f"z{i % 2}").label(HOST, f"node-{i}").obj()
        )
    cs.create_pod(MakePod().name("existing").node("node-0").req({"cpu": "7"}).obj())
    return cs


def serve_pods():
    return [
        MakePod().name("p").req({"cpu": "4"}).obj(),
        MakePod().name("z").obj(),
        MakePod().name("a").req({"cpu": "1"}).node_affinity_in("zone", ["z1"]).obj(),
        MakePod().name("q").req({"cpu": "2", "memory": "4Gi"}).obj(),
    ]


def extender_cluster():
    """tests/test_extender.py's cluster: 4 nodes, node-3 tainted."""
    cs = ClusterState()
    for i in range(4):
        b = (MakeNode().name(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"})
             .label("zone", f"z{i % 2}"))
        if i == 3:
            b = b.taint("dedicated", "gpu", "NoSchedule")
        cs.create_node(b.obj())
    cs.create_pod(MakePod().name("existing").node("node-0").req({"cpu": "7"}).obj())
    return cs


def extender_pods():
    return [
        MakePod().name("p").req({"cpu": "4"}).obj(),
        MakePod().name("t").req({"cpu": "1"}).toleration("dedicated", "gpu", "Equal",
                                                          "NoSchedule").obj(),
    ]


def mixed_cluster(n_nodes=24, seed=3):
    """Nodes in 3 zones with hostnames, taints, images and an extended
    resource; placed pods holding hostPorts, labels the requests select,
    required anti-affinity (the symmetry side) and a bound volume."""
    rng = np.random.default_rng(seed)
    cs = ClusterState()
    for i in range(n_nodes):
        b = (MakeNode().name(f"n{i:02}").capacity({"cpu": "8", "memory": "16Gi", "pods": "12"})
             .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:02}"))
        if i % 5 == 4:
            b = b.taint("dedicated", "batch", "NoSchedule")
        if i % 4 == 0:
            b = b.image("registry/app:v1", 300 * 1024 * 1024)
        if i % 6 == 1:
            b = b.capacity({"cpu": "8", "memory": "16Gi", "pods": "12", "example.com/gpu": "2"})
        cs.create_node(b.obj())
    apps = ("web", "db", "cache")
    for k in range(2 * n_nodes):
        node = f"n{int(rng.integers(n_nodes)):02}"
        b = (MakePod().name(f"placed-{k:03}").node(node).label("app", apps[k % 3])
             .req({"cpu": f"{int(rng.integers(1, 8)) * 100}m", "memory": "512Mi"}))
        if k % 7 == 0:
            b = b.host_port(8080)
        if k % 11 == 0:
            b = b.pod_anti_affinity(HOST, {"app": "solo"})
        if k % 13 == 0:
            b = b.preferred_pod_affinity(30, ZONE, {"app": "web"}, anti=True)
        cs.create_pod(b.obj())
    cs.create_pv(PersistentVolume(
        name="pv-z1", labels={ZONE: "z1"}, capacity_bytes=10 * GB,
        access_modes=("ReadWriteOnce",)))
    cs.create_pvc(PersistentVolumeClaim(name="data", volume_name="pv-z1", request_bytes=5 * GB))
    cs.create_service(Service(name="web", selector={"app": "web"}))
    return cs


def mixed_pods(copies=1):
    """Requests of every kind the evaluator scores; ``copies`` of each
    template (one class per template)."""
    templates = [
        lambda b: b.host_port(8080),
        lambda b: b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "web"}),
        lambda b: b.spread_constraint(2, HOST, "ScheduleAnyway", {"app": "web"}),
        lambda b: b.spread_constraint(1, ZONE, "ScheduleAnyway", {"app": "db"}),
        lambda b: b.pod_affinity(ZONE, {"app": "db"}),
        lambda b: b.pod_anti_affinity(HOST, {"app": "cache"}),
        lambda b: b.preferred_pod_affinity(40, ZONE, {"app": "web"}),
        lambda b: b.preferred_pod_affinity(20, HOST, {"app": "db"}, anti=True),
        lambda b: b.toleration("dedicated", "batch", "Equal", "NoSchedule"),
        lambda b: b.preferred_node_affinity(10, ZONE, ["z2"]),
        lambda b: b.container_image("registry/app:v1"),
        lambda b: b.pvc("data"),
        lambda b: b.req({"cpu": "500m", "example.com/gpu": "1"}),
        lambda b: b.req({"cpu": "500m", "example.com/fpga": "1"}),  # no node has it
        lambda b: b.label("app", "solo"),  # the placed anti terms select it
        lambda b: b.label("app", "web"),  # no constraint: the Service's default spread
    ]
    pods = []
    for c in range(copies):
        for t, make in enumerate(templates):
            b = MakePod().name(f"r{t:02}-{c}").req({"cpu": "300m", "memory": "256Mi"})
            pods.append(make(b).obj())
    return pods


# -- the pairing -----------------------------------------------------------


def _view(cs):
    pods_by_node = {}
    for p in cs.list_pods():
        if p.node_name:
            pods_by_node.setdefault(p.node_name, []).append(p)
    return (cs.list_nodes(), pods_by_node, cs.list_services(), cs.list_pvs(), cs.list_pvcs())


def evaluate_both(ref_cs, pods, **cfg):
    """(JAX matrix, port matrix) for ``pods`` against ``ref_cs``."""
    port_cs = convert.cluster_state(ref_cs)
    nodes, by_node, services, pvs, pvcs = _view(ref_cs)
    want = RefEvaluator(RefSolverConfig(**cfg)).evaluate(
        pods, nodes, by_node, services=services, pvs=pvs, pvcs=pvcs)
    nodes, by_node, services, pvs, pvcs = _view(port_cs)
    port_pods = [convert.api_object(p, port_objects.Pod) for p in pods]
    got = BatchEvaluator(ExactSolverConfig(**cfg), device="cpu").evaluate(
        port_pods, nodes, by_node, services=services, pvs=pvs, pvcs=pvcs)
    return want, got


def assert_equal(want, got):
    assert got.dtype == np.int32 and got.shape == want.shape
    bad = np.argwhere(got != want)
    assert bad.size == 0, (
        f"{len(bad)} cells differ; first at {tuple(bad[0])}: "
        f"port {got[tuple(bad[0])]} JAX {want[tuple(bad[0])]}"
    )


@pytest.mark.parametrize("fixture", ["serve", "extender", "mixed", "mixed_repeated"])
def test_float64_matrix_equals_reference(fixture):
    cs, pods = {
        "serve": (serve_cluster, serve_pods),
        "extender": (extender_cluster, extender_pods),
        "mixed": (mixed_cluster, mixed_pods),
        "mixed_repeated": (mixed_cluster, lambda: mixed_pods(copies=3)),
    }[fixture]
    want, got = evaluate_both(cs(), pods(), **F64)
    assert_equal(want, got)
    assert (got >= 0).any(axis=1).sum() >= 1


def test_mixed_fixture_exercises_every_tier():
    """The mixed fixture's rows differ in what filtered them: a pod with an
    unknown resource is -1 everywhere, the hostPort pod loses the port
    holders, the tainted nodes pass only the tolerating pod."""
    pods = mixed_pods()
    want, got = evaluate_both(mixed_cluster(), pods, **F64)
    assert_equal(want, got)
    names = [p.name for p in pods]
    assert (got[names.index("r13-0")] == -1).all()  # example.com/fpga
    tainted = [i for i in range(24) if i % 5 == 4]
    assert (got[names.index("r08-0")][tainted] >= 0).any()
    assert (got[names.index("r00-0")][tainted] == -1).all()
    gpu = [i for i in range(24) if i % 6 == 1 and i % 5 != 4]
    row = got[names.index("r12-0")]
    assert set(np.nonzero(row >= 0)[0]) <= set(gpu)


def test_float32_matrix_under_the_log_rule():
    pods = mixed_pods(copies=2)
    want, got = evaluate_both(mixed_cluster(), pods)
    assert ((got >= 0) == (want >= 0)).all()
    soft = [bool(p.topology_spread_constraints) or p.labels.get("app") == "web" for p in pods]
    for i, has_soft in enumerate(soft):
        if not has_soft:
            np.testing.assert_array_equal(got[i], want[i])


def test_evaluate_tensors_directly():
    """The low-level entry on converted tensors: the bulk path's shape."""
    cs = mixed_cluster()
    nodes, by_node, services, _, _ = _view(cs)
    pods = mixed_pods(copies=2)
    pods = [p for p in pods if not p.pvc_names]
    nb = build_node_batch(nodes, by_node)
    pb = build_pod_batch(pods, nb.vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    placed = {i: by_node[n.name] for i, n in enumerate(nodes) if n.name in by_node}
    static = build_static_tensors(pods, pb, slots, nb.padded)
    ports = build_port_tensors(pods, pb, slots, placed, nb.padded)
    spread = build_spread_tensors(pods, static.reps, pb, slots, placed, nb.padded,
                                  static.c_pad, services=services)
    interpod = build_interpod_tensors(pods, static.reps, pb, slots, placed, nb.padded,
                                      static.c_pad)
    want = RefEvaluator(RefSolverConfig(**F64)).evaluate_tensors(
        nb, pb, static, ports, spread, interpod)
    got = BatchEvaluator(ExactSolverConfig(**F64), device="cpu").evaluate_tensors(
        *convert.solve_inputs(nb, pb, static, ports, spread, interpod))
    assert got.shape == (len(pods), nb.padded)
    assert_equal(want, got)


@pytest.fixture
def launches(monkeypatch):
    """Counts the aggregations an evaluation makes (on the CPU each one is
    the kernel's plain version, called where the card launches the
    kernel)."""
    count = [0]
    plain = dc.aggregate_plain

    def counted(*a, **kw):
        count[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(dc, "aggregate_plain", counted)
    return count


@pytest.mark.parametrize("copies", [1, 4])
def test_launches_per_evaluation_do_not_depend_on_pods(launches, copies):
    cs = convert.cluster_state(mixed_cluster())
    nodes, by_node, services, pvs, pvcs = _view(cs)
    pods = [convert.api_object(p, port_objects.Pod) for p in mixed_pods(copies)]
    ev = BatchEvaluator(ExactSolverConfig(**F64), device="cpu")
    ev.evaluate(pods, nodes, by_node, services=services, pvs=pvs, pvcs=pvcs)
    # one for the InterPodAffinity in + ex rows, one for every spread row
    assert launches[0] == 2


def test_no_interpod_and_no_spread_launch_nothing(launches):
    cs = convert.cluster_state(serve_cluster())
    nodes, by_node, *_ = _view(cs)
    pods = [convert.api_object(p, port_objects.Pod) for p in serve_pods()]
    out = BatchEvaluator(device="cpu").evaluate(pods, nodes, by_node)
    assert launches[0] == 0 and out.shape == (4, 6)


def test_empty_batch_and_device_default():
    ev = BatchEvaluator(device="cpu")
    cs = convert.cluster_state(serve_cluster())
    nodes, by_node, *_ = _view(cs)
    assert ev.evaluate([], nodes, by_node).shape == (0, 6)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchEvaluator()
