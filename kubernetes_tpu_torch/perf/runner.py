"""scheduler_perf-compatible YAML workload runner (SURVEY.md §4.5, §8.6).

Parses the same testCase/workload shape as
test/integration/scheduler_perf/config/performance-config.yaml:

    - name: SchedulingBasic
      workloadTemplate:
        - opcode: createNodes
          countParam: $initNodes
          nodeTemplatePath: config/node-default.yaml   # or nodeTemplate: {}
        - opcode: createPods
          countParam: $initPods
        - opcode: barrier
        - opcode: createPods
          countParam: $measurePods
          collectMetrics: true
        - opcode: barrier
      workloads:
        - name: 500Nodes
          params: {initNodes: 500, initPods: 500, measurePods: 1000}

Supported opcodes: createNodes, createPods, createNamespaces, barrier,
sleep, churn (create/delete pods at a rate between scheduling batches),
createPodsSteady (open-loop: pods arrive at a fixed rate while the
scheduler drains concurrently — the arrival-driven sustained workload).
Templates load from nodeTemplatePath/podTemplatePath (YAML manifests parsed
through the same wire decoders the extender uses) or inline
nodeTemplate/podTemplate maps; absent both, a default 32-core node /
1-core pod is used. $param indirection and {{.Index}}-style name suffixes
are handled ({{.Index}} is replaced; other template actions are not).

Measurement mirrors scheduler_perf's SchedulingThroughput collector:
pods/s sampled per scheduling batch over the collectMetrics phases, with
avg/p50/p90/p99 summary, per-pod e2e (queue-entry -> bind) latency
percentiles, and the per-batch device-solve seconds. A workload-level
``threshold`` (pods/s, the upstream scheduler_perf field) FAILS the
workload when measured POST-WARMUP steady-state throughput lands below
it — the perf CLI exits nonzero, so perf regressions gate like test
failures (scheduler_perf.go's threshold assert [U]).
Steady-state means the first measured batch (which usually carries the
one-time warm-up: the kernel build, the first allocations) is excluded,
time-weighted over the remaining batches: gating the avg let one slow
warm-up dominate the whole run and made the floor either flaky or
toothless.

Scheduling drains through Scheduler.run_pipelined (double-buffered device
solves) by default; pass pipelined=False for the synchronous loop.

Copied from ``kubernetes_tpu/perf/runner.py``. ``PerfRunner`` takes
``device`` (None = the card) for the ``Scheduler`` it builds, and ``yaml``
is imported inside the loaders, so the module imports without it. The
``performance-config.yaml`` beside it is the JAX package's, verbatim.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..api.objects import Node, Pod
from ..scheduler import Scheduler, SchedulerConfig
from ..state.cluster import ClusterState

DEFAULT_NODE = {
    "metadata": {"name": "node-{{.Index}}"},
    "status": {
        "allocatable": {"cpu": "32", "memory": "128Gi", "pods": "110"},
        "capacity": {"cpu": "32", "memory": "128Gi", "pods": "110"},
    },
}
DEFAULT_POD = {
    "metadata": {"name": "pod-{{.Index}}"},
    "spec": {
        "containers": [
            {
                "name": "c",
                "image": "registry.k8s.io/pause:3.9",
                "resources": {"requests": {"cpu": "1", "memory": "500Mi"}},
            }
        ]
    },
}


@dataclass
class WorkloadResult:
    test_case: str
    workload: str
    scheduled: int = 0
    unschedulable: int = 0
    measured_pods: int = 0
    measure_seconds: float = 0.0
    solve_seconds: float = 0.0
    samples: list[float] = field(default_factory=list)  # pods/s per batch
    # per measured batch: (wall seconds, pods bound) — the time-weighted
    # inputs behind the steady-state number (a rate mean over batches
    # would over-weight tiny batches)
    batch_samples: list[tuple[float, int]] = field(default_factory=list)
    # per-pod e2e latency (first queue entry -> bind), measured phases only
    pod_latencies: list[float] = field(default_factory=list)
    threshold: float = 0.0  # pods/s floor (scheduler_perf threshold assert)
    passed: bool = True

    def steady_pods_per_sec(self) -> float:
        """Post-warmup steady-state throughput: pods/s time-weighted
        over the measured batches EXCLUDING the first (which usually
        carries the one-time warm-up). Falls back to the overall avg
        when only one batch was measured."""
        tail = self.batch_samples[1:]
        dt = sum(t for t, _ in tail)
        if dt > 0:
            return sum(n for _, n in tail) / dt
        if self.measure_seconds:
            return self.measured_pods / self.measure_seconds
        return 0.0

    def throughput_summary(self) -> dict[str, float]:
        if not self.samples:
            return {"avg": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0, "steady": 0.0}
        a = np.asarray(self.samples)
        return {
            "avg": float(
                self.measured_pods / self.measure_seconds
                if self.measure_seconds
                else a.mean()
            ),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            # cold-start honesty: the first measured batch usually carries
            # the warm-up; "steady" drops it (time-weighted) so one
            # CLI run shows both the cold and the warm story
            "steady": float(self.steady_pods_per_sec()),
        }

    def latency_summary(self) -> dict[str, float]:
        """Per-pod e2e schedule-latency percentiles (BASELINE.md's 'p99
        per-pod schedule latency' metric) over the measured phases."""
        if not self.pod_latencies:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
        a = np.asarray(self.pod_latencies)
        return {
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
        }

    def check_threshold(self) -> None:
        """scheduler_perf.go's per-workload threshold assert, gated on
        POST-WARMUP steady-state pods/s: the avg was dominated by the
        first measured batch's warm-up, so one slow warm-up could flake
        the gate while a genuine sustained regression hid under a fast
        one — the steady number is what the floor protects."""
        if self.threshold and (self.batch_samples or self.measure_seconds):
            if self.steady_pods_per_sec() < self.threshold:
                self.passed = False


def _resolve_count(op: Mapping, params: Mapping) -> int:
    if "countParam" in op:
        return int(params[op["countParam"].lstrip("$")])
    return int(op.get("count") or 0)


def _load_template(
    op: Mapping, key: str, base_dir: Path, default: Mapping
) -> Mapping:
    inline = op.get(f"{key}Template")
    if inline:
        return inline
    path = op.get(f"{key}TemplatePath")
    if path:
        import yaml

        with open(base_dir / path) as f:
            return yaml.safe_load(f)
    return default


def _instantiate(template: Mapping, index: int, prefix: str) -> dict:
    import json

    d = json.loads(json.dumps(template).replace("{{.Index}}", str(index)))
    meta = d.setdefault("metadata", {})
    if meta.get("generateName"):
        meta["name"] = f"{meta['generateName']}{index}"
    elif not meta.get("name"):
        meta["name"] = f"{prefix}-{index}"
    elif "{{.Index}}" not in ((template.get("metadata") or {}).get("name") or ""):
        # fixed template name: suffix the index so objects stay unique
        meta["name"] = f"{meta['name']}-{index}"
    return d


class PerfRunner:
    def __init__(
        self,
        config: SchedulerConfig | None = None,
        base_dir: str | Path = ".",
        pipelined: bool = True,
        device=None,
    ):
        self.config = config or SchedulerConfig()
        self.base_dir = Path(base_dir)
        self.pipelined = pipelined
        # the device of every Scheduler this runner builds (None = the
        # card, raising without CUDA)
        self.device = device

    def run_file(
        self, path: str | Path, workload_filter: str | None = None
    ) -> list[WorkloadResult]:
        import yaml

        with open(path) as f:
            cases = yaml.safe_load(f)
        base = Path(path).parent
        out = []
        for case in cases:
            for wl in case.get("workloads") or [{"name": "default", "params": {}}]:
                if workload_filter and wl["name"] != workload_filter:
                    continue
                params = wl.get("params") or {}
                out.append(
                    self.run_workload(
                        case["name"],
                        wl["name"],
                        case.get("workloadTemplate") or [],
                        params,
                        base,
                        # upstream puts the throughput floor on the
                        # workload entry (scheduler_perf threshold field);
                        # accept it in params too
                        threshold=float(
                            wl.get("threshold")
                            or params.get("threshold")
                            or 0.0
                        ),
                    )
                )
        return out

    def run_workload(
        self,
        case_name: str,
        wl_name: str,
        ops: list[Mapping],
        params: Mapping[str, Any],
        base_dir: Path | None = None,
        threshold: float = 0.0,
    ) -> WorkloadResult:
        base_dir = base_dir or self.base_dir
        cluster = ClusterState()
        sched = Scheduler(cluster, self.config, device=self.device)
        res = WorkloadResult(
            test_case=case_name, workload=wl_name, threshold=threshold
        )
        node_seq = 0
        pod_seq = 0

        def consume(r, measure: bool, prev_at: float) -> float:
            n = len(r.scheduled)
            res.scheduled += n
            res.unschedulable += len(r.unschedulable)
            res.solve_seconds += r.solve_seconds
            at = r.completed_at or time.perf_counter()
            if measure and n:
                dt = max(at - prev_at, 1e-9)
                res.samples.append(n / dt)
                res.batch_samples.append((dt, n))
                res.measured_pods += n
                res.pod_latencies.extend(r.e2e_latencies)
            return at

        def drain(measure: bool) -> None:
            t0 = time.perf_counter()
            prev_at = t0
            while True:
                if self.pipelined:
                    results = sched.run_pipelined()
                else:
                    results = [sched.schedule_batch()]
                got_sched = False
                got_any = False
                for r in results:
                    prev_at = consume(r, measure, prev_at)
                    got_sched = got_sched or bool(r.scheduled)
                    got_any = got_any or r.progressed
                if not got_any:
                    break
                if not got_sched:
                    break  # only stuck pods remain
            if measure:
                res.measure_seconds += time.perf_counter() - t0

        for op in ops:
            opcode = op.get("opcode")
            if opcode == "createNodes":
                count = _resolve_count(op, params)
                tpl = _load_template(op, "node", base_dir, DEFAULT_NODE)
                for _ in range(count):
                    cluster.create_node(
                        Node.from_dict(_instantiate(tpl, node_seq, "node"))
                    )
                    node_seq += 1
            elif opcode == "createPods":
                count = _resolve_count(op, params)
                tpl = _load_template(op, "pod", base_dir, DEFAULT_POD)
                ns = op.get("namespace")
                measure = bool(op.get("collectMetrics"))
                for _ in range(count):
                    d = _instantiate(tpl, pod_seq, "pod")
                    if ns:
                        d.setdefault("metadata", {})["namespace"] = ns
                    cluster.create_pod(Pod.from_dict(d))
                    pod_seq += 1
                drain(measure)
            elif opcode == "createPodsSteady":
                # open-loop sustained workload: pods
                # ARRIVE at a fixed rate while the scheduler drains
                # concurrently, so throughput and the per-pod e2e p99
                # reflect queueing under load, not closed-loop batching.
                # Interleaved single-threaded: create every arrival that
                # is due by wall clock, then run a bounded pipelined
                # burst, repeat (the 1-vCPU host's analog of the
                # creator-goroutine + scheduler race in scheduler_perf).
                count = _resolve_count(op, params)
                rate = float(
                    op.get("ratePodsPerSec")
                    or params.get(
                        str(op.get("rateParam", "")).lstrip("$") or "", 0
                    )
                    or 1000.0
                )
                tpl = _load_template(op, "pod", base_dir, DEFAULT_POD)
                measure = bool(op.get("collectMetrics"))
                t0 = time.perf_counter()
                prev_at = t0
                created = 0
                while created < count or sched.pending:
                    due = min(
                        count, int((time.perf_counter() - t0) * rate) + 1
                    )
                    while created < due:
                        cluster.create_pod(
                            Pod.from_dict(_instantiate(tpl, pod_seq, "pod"))
                        )
                        pod_seq += 1
                        created += 1
                    made_progress = False
                    for r in (
                        sched.run_pipelined(max_batches=2)
                        if self.pipelined
                        else [sched.schedule_batch()]
                    ):
                        prev_at = consume(r, measure, prev_at)
                        made_progress = made_progress or r.progressed
                    if created >= count and not made_progress:
                        break  # drained (or only stuck pods remain)
                if measure:
                    res.measure_seconds += time.perf_counter() - t0
            elif opcode == "createNamespaces":
                pass  # namespaces are implicit in this state service
            elif opcode == "barrier":
                drain(False)
            elif opcode == "sleep":
                time.sleep(float(op.get("duration") or 0))
            elif opcode == "churn":
                # background create/delete between batches; the interleaved
                # batches may also bind earlier pending pods, so their
                # results count toward the workload totals
                number = int(op.get("number") or 1)
                tpl = _load_template(op, "pod", base_dir, DEFAULT_POD)
                for _ in range(number):
                    d = _instantiate(tpl, pod_seq, "churn")
                    pod_seq += 1
                    created = cluster.create_pod(Pod.from_dict(d))
                    r = sched.schedule_batch()
                    res.scheduled += len(r.scheduled)
                    res.unschedulable += len(r.unschedulable)
                    res.solve_seconds += r.solve_seconds
                    try:
                        cluster.delete_pod(created.namespace, created.name)
                    except Exception:
                        pass
            else:
                raise ValueError(f"unsupported opcode {opcode!r}")
        res.check_threshold()
        return res
