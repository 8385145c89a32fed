"""Drive the JAX package's Scheduler and the port's side by side.

A scenario is built once in the JAX package's ``ClusterState`` (with its
``MakeNode`` / ``MakePod``) and carried across with
``kubernetes_tpu_torch.convert.cluster_state``. Both schedulers run on
their own ``FakeClock``; every later change (a node added, a pod created or
deleted, the clock advanced) is applied to both clusters. ``step`` runs one
``schedule_batch`` on each and checks that the batch results agree; the
final check compares bindings, nominations and the attempt-metric deltas
read from each package's own registry.
"""

from __future__ import annotations

from kubernetes_tpu import metrics as ref_metrics
from kubernetes_tpu.scheduler import Scheduler as RefScheduler
from kubernetes_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolverConfig
from kubernetes_tpu.utils.clock import FakeClock as RefFakeClock
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch import metrics as port_metrics
from kubernetes_tpu_torch.api import objects as port_objects
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.utils.clock import FakeClock

PARITY = dict(tie_break="first", balanced_fdtype="float64")
RESULTS = ("scheduled", "unschedulable", "error")


def attempts(metrics_mod, profile="default-scheduler") -> dict:
    c = metrics_mod.schedule_attempts_total
    return {r: c.labels(r, profile)._value.get() for r in RESULTS}


def batch_view(res) -> dict:
    """What must agree between the two packages for one batch."""
    return {
        "scheduled": list(res.scheduled),
        "unschedulable": list(res.unschedulable),
        "bind_failures": list(res.bind_failures),
        "preemptions": [(p, n, list(v)) for p, n, v in res.preemptions],
        "quarantined": list(res.quarantined),
        "gang_released": list(res.gang_released),
    }


class Pair:
    """The two schedulers over two copies of one cluster."""

    def __init__(
        self,
        ref_cluster,
        solver: dict | None = None,
        device="cpu",
        ref_config: dict | None = None,
        **config,
    ):
        solver = dict(PARITY if solver is None else solver)
        self.ref_cluster = ref_cluster
        self.cluster = convert.cluster_state(ref_cluster)
        self.ref_clock = RefFakeClock()
        self.clock = FakeClock()
        self._attempts0 = (attempts(ref_metrics), attempts(port_metrics))
        # ``ref_config`` overrides ``config`` for the JAX side (its own
        # plugin and extender objects)
        self.ref = RefScheduler(
            ref_cluster,
            RefSchedulerConfig(
                solver=RefSolverConfig(**solver), mesh_devices=1,
                **{**config, **(ref_config or {})},
            ),
            clock=self.ref_clock,
        )
        self.port = Scheduler(
            self.cluster,
            SchedulerConfig(solver=ExactSolverConfig(**solver), **config),
            clock=self.clock,
            device=device,
        )
        self.batches: list[tuple[dict, dict]] = []

    # -- changes applied to both clusters --

    def create_pod(self, pod) -> None:
        port_pod = convert.api_object(pod, port_objects.Pod)
        self.ref_cluster.create_pod(pod)
        self.cluster.create_pod(port_pod)

    def create_node(self, node) -> None:
        port_node = convert.api_object(node, port_objects.Node)
        self.ref_cluster.create_node(node)
        self.cluster.create_node(port_node)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.ref_cluster.delete_pod(namespace, name)
        self.cluster.delete_pod(namespace, name)

    def advance(self, seconds: float) -> None:
        self.ref_clock.advance(seconds)
        self.clock.advance(seconds)

    def requeue(self, seconds: float = 2.0) -> None:
        """Wake parked pods on both (a cluster event), let their backoff
        run out, and flush them to the active queue."""
        for s in (self.ref, self.port):
            s.queue.move_all_to_active_or_backoff("test")
        self.advance(seconds)
        for s in (self.ref, self.port):
            s.queue.flush_backoff_completed()

    # -- driving --

    def step(self):
        """One schedule_batch on each; the batch results must agree."""
        r = self.ref.schedule_batch()
        p = self.port.schedule_batch()
        rv, pv = batch_view(r), batch_view(p)
        assert pv == rv, f"batch {len(self.batches)} differs:\n{pv}\n{rv}"
        self.batches.append((rv, pv))
        return r, p

    def settle(self, max_batches: int = 50) -> int:
        """schedule_batch on both until neither progresses."""
        n = 0
        for _ in range(max_batches):
            r, p = self.step()
            if not (r.progressed or p.progressed):
                break
            n += 1
        return n

    # -- the final comparison --

    def bindings(self) -> tuple[dict, dict]:
        ref = {p.key: p.node_name for p in self.ref_cluster.list_pods()}
        port = {p.key: p.node_name for p in self.cluster.list_pods()}
        return ref, port

    def nominations(self) -> tuple[dict, dict]:
        ref = {p.key: p.nominated_node_name for p in self.ref_cluster.list_pods()}
        port = {p.key: p.nominated_node_name for p in self.cluster.list_pods()}
        return ref, port

    def attempt_deltas(self) -> tuple[dict, dict]:
        r0, p0 = self._attempts0
        r1, p1 = attempts(ref_metrics), attempts(port_metrics)
        return (
            {k: r1[k] - r0[k] for k in RESULTS},
            {k: p1[k] - p0[k] for k in RESULTS},
        )

    def assert_equal(self) -> None:
        ref, port = self.bindings()
        assert port == ref
        ref, port = self.nominations()
        assert port == ref
        ref, port = self.attempt_deltas()
        assert port == ref
