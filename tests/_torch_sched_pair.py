"""Drive the JAX package's Scheduler and the port's side by side.

A scenario is built once in the JAX package's ``ClusterState`` (with its
``MakeNode`` / ``MakePod``) and carried across with
``kubernetes_tpu_torch.convert.cluster_state``. Both schedulers run on
their own ``FakeClock``; every later change (a node added, a pod created or
deleted, the clock advanced) is applied to both clusters. ``step`` runs one
``schedule_batch`` on each and checks that the batch results agree;
``run(loop)`` drives both through one of the four loops
(``run_until_settled``, ``run_pipelined``, ``run_streaming``,
``drain_backlog``) and checks that the result lists agree in order. The
final check compares bindings, nominations and the deltas, read from each
package's own registry, of the attempt counter and the loops' counters
(``scheduler_pipeline_mode_total`` by mode,
``scheduler_stream_slot_discard_total``,
``scheduler_pipeline_fallback_total``).
"""

from __future__ import annotations

import dataclasses
import time

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
MODES = ("overlap", "carry", "sync", "stream")
LOOPS = ("settled", "pipelined", "streaming", "drain")


def attempts(metrics_mod, profile="default-scheduler") -> dict:
    c = metrics_mod.schedule_attempts_total
    out = {r: c.labels(r, profile)._value.get() for r in RESULTS}
    for m in MODES:
        out[f"mode_{m}"] = metrics_mod.pipeline_mode_total.labels(m)._value.get()
    out["slot_discards"] = metrics_mod.stream_slot_discard_total._value.get()
    out["fallbacks"] = metrics_mod.pipeline_fallback_total._value.get()
    out["discarded"] = metrics_mod.solves_discarded_total._value.get()
    out["subbatches"] = metrics_mod.pipeline_subbatches_total._value.get()
    return out


def manual_flight(s, profile=None, fold=False, **dispatch):
    """Pop one batch, tensorize it (and fold it) and dispatch it deferred
    (``_dispatch_group(prep, defer=True, allow_heal=True, **dispatch)``)."""
    t0 = time.perf_counter()
    with s.cluster.lock:
        infos = s.queue.pop_batch(s.config.batch_size)
        base = s.queue.scheduling_cycle - len(infos)
        for i in infos:
            s._in_flight[i.key] = i
    prep = s._tensorize_group(
        profile or next(iter(s.solvers)), infos, list(range(len(infos))), base, t0
    )
    if fold:
        s._fold_group(prep)
    got = s._dispatch_group(prep, defer=True, allow_heal=True, **dispatch)
    for f in got if isinstance(got, list) else [got]:
        settle_flight(f)
    return got


def settle_flight(flight) -> None:
    """Wait until a dispatched solve has computed (its handle's ``wait``;
    the flight stays unapplied). The JAX package's CPU backend dispatches
    asynchronously and may read host buffers after the call returns, so
    an event applied while its solve still computes can leak into that
    solve; the tests land their events after this wait, on both sides."""
    wait = getattr(flight.handle, "wait", None)
    if wait is not None:
        wait()


def drive(sched, loop: str, **kw):
    """One call of ``loop`` on ``sched``: its BatchResult list (a drain's
    report's ``results``) and the drain report or None."""
    if loop == "settled":
        return sched.run_until_settled(**kw), None
    if loop == "pipelined":
        return sched.run_pipelined(**kw), None
    if loop == "streaming":
        return sched.run_streaming(**kw), None
    if loop == "drain":
        rep = sched.drain_backlog(**kw)
        return rep.results, rep
    raise ValueError(loop)


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

    def update_node(self, node) -> None:
        """Replace a node (a JAX-package object) on both clusters, each at
        its own resourceVersion."""
        port_node = convert.api_object(node, port_objects.Node)
        node.resource_version = self.ref_cluster.get_node(node.name).resource_version
        port_node.resource_version = self.cluster.get_node(node.name).resource_version
        self.ref_cluster.update_node(node)
        self.cluster.update_node(port_node)

    def bind(self, namespace: str, name: str, node_name: str) -> None:
        self.ref_cluster.bind(namespace, name, node_name)
        self.cluster.bind(namespace, name, node_name)

    def relabel_pod(self, namespace: str, name: str, labels: dict) -> None:
        for cs in (self.ref_cluster, self.cluster):
            cs.update_pod(dataclasses.replace(cs.get_pod(namespace, name), labels=labels))

    def sides(self):
        """(scheduler, cluster) for the JAX package, then the port."""
        return ((self.ref, self.ref_cluster), (self.port, self.cluster))

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

    def flights(self, profile=None, fold=False, **dispatch):
        """Pop, tensorize (and fold) one batch on each and dispatch it
        deferred, the way run_pipelined does: (ref, port) in-flight solves."""
        return tuple(manual_flight(s, profile, fold, **dispatch) for s, _ in self.sides())

    def apply(self, ref_flight, port_flight):
        """_apply_flight on each; the batch results must agree."""
        r = self.ref._apply_flight(ref_flight)
        p = self.port._apply_flight(port_flight)
        rv, pv = batch_view(r), batch_view(p)
        assert pv == rv, f"apply differs:\n{pv}\n{rv}"
        return r, p

    def step(self):
        """One schedule_batch on each; the batch results must agree."""
        r = self.ref.schedule_batch()
        p = self.port.schedule_batch()
        rv, pv = batch_view(r), batch_view(p)
        assert pv == rv, f"batch {len(self.batches)} differs:\n{pv}\n{rv}"
        self.batches.append((rv, pv))
        return r, p

    def run(self, loop: str, **kw):
        """Drive both schedulers through ``loop``; the result lists must
        agree in order. Returns (ref, port) results, or drain reports."""
        r, rrep = drive(self.ref, loop, **kw)
        p, prep = drive(self.port, loop, **kw)
        rv = [batch_view(x) for x in r]
        pv = [batch_view(x) for x in p]
        assert pv == rv, f"{loop} results differ:\n{pv}\n{rv}"
        self.batches.extend(zip(rv, pv))
        if rrep is not None:
            keys = ("pods", "drained", "unschedulable", "chunks", "chunk_pods",
                    "budget_splits", "stream_chained_batches",
                    "estimated_per_device_bytes", "final_chunk_pods")
            assert {k: getattr(prep, k) for k in keys} == {
                k: getattr(rrep, k) for k in keys
            }
            return rrep, prep
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

    def counter_deltas(self) -> tuple[dict, dict]:
        """The attempt deltas and the loops' counter deltas."""
        r0, p0 = self._attempts0
        r1, p1 = attempts(ref_metrics), attempts(port_metrics)
        return (
            {k: r1[k] - r0[k] for k in r1},
            {k: p1[k] - p0[k] for k in p1},
        )

    def assert_equal(self) -> None:
        ref, port = self.bindings()
        assert port == ref
        ref, port = self.nominations()
        assert port == ref
        ref, port = self.counter_deltas()
        assert port == ref
