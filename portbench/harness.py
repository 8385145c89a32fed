"""One run of one cell: set-up, the measured window, the check, the result.

The served path is the program's own: pods are created as events in a
``kubernetes_tpu_torch.state.ClusterState`` from the generator's dicts
(``Pod.from_dict``), and a ``kubernetes_tpu_torch.scheduler.Scheduler`` with
the configuration's settings binds them through ``run_pipelined``, the loop
that ``serve`` and the scheduler_perf runner drive. The harness keeps, in
order, every binding the loop returned and every pod it deleted, and hands
them with the dicts to the plain reference once the window has closed.

Everything a cell needs is found by name: its configuration
(``configs/``), its traffic file (``traffic/``) and the arrival process
that file names (``processes/<process>.py``, a class ``Process`` built on
``Run``), its own overrides (``cells/<cell>.json``, optional) and a reader
per per-layer metric (``metrics/``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import gen, reference
from .trace import DeviceSlice, Spans, wrap_layers

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_tpu")
# every number the reference compares is exact: a correct run reads 0 on each
LIMITS = {
    "infeasible_binds": 0,
    "score_gap": 0,
    "double_or_unknown_binds": 0,
    "readback_mismatches": 0,
}


def forbidden_modules(names) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """The cell's entry in BENCHMARK.json, its configuration and its traffic
    parameters (the traffic file, then the cell's own file over it)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    config = load_json(ROOT / {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]])
    params = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    own = BENCH_DIR / "cells" / f"{name}.json"
    if own.exists():
        params.update(load_json(own))
    return cell, config, params


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else the
    reader of its quantity, ``metrics/<part before the first dot>.py``
    (``tensorize_share.backlog`` reads as ``tensorize_share``)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"
    return _load(path, f"portbench_metric_{path.stem.replace('.', '_')}")


def load_process(name: str):
    """The arrival process a traffic file names: ``processes/<name>.py``."""
    return _load(BENCH_DIR / "processes" / f"{name}.py", f"portbench_process_{name}").Process


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Run:
    """The state of one run: the program's objects and what it answered. An
    arrival process subclasses it with ``warmup`` and ``window``."""

    def __init__(self, cell, config, params, seed, device, trace, solver_overrides=None):
        import torch

        from kubernetes_tpu_torch.utils.compile_cache import enable_persistent_cache

        # the port builds its kernels into its own directory in this checkout,
        # so a second run there loads them and builds nothing
        enable_persistent_cache(ROOT / "kubernetes_tpu_torch" / "_build")
        from kubernetes_tpu_torch.api.objects import Node, Pod
        from kubernetes_tpu_torch.obs import ObsConfig
        from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
        from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
        from kubernetes_tpu_torch.state.cluster import ClusterState

        self.torch, self.Pod = torch, Pod
        self.cell, self.config, self.params = cell, config, params
        self.traffic = gen.Traffic(config, seed)
        self.pods = gen.StreamPods(self.traffic)
        self.batch = int(config["scheduler"]["batch_size"])
        self.per_call = int(params["batches_per_call"])
        # in order: ("bind", [(key, node), ...]) per batch the loop returned,
        # ("delete", [key, ...]) per group of pods deleted
        self.events: list[tuple[str, list]] = []
        # what the process tells the metric readers and the run's log
        self.extra: dict = {}
        self.node_dicts = gen.node_dicts(config)
        self.cs = ClusterState()
        self.cs.create_nodes(Node.from_dict(d) for d in self.node_dicts)
        solver = dict(tie_break=config["scheduler"]["tie_break"],
                      balanced_fdtype=config["scheduler"]["balanced_fdtype"],
                      seed=int(seed) % (2 ** 31))
        solver.update(solver_overrides or {})
        self.sched = Scheduler(
            self.cs,
            SchedulerConfig(batch_size=self.batch, solver=ExactSolverConfig(**solver),
                            obs=ObsConfig(profile=True) if trace else None),
            device=device,
        )
        self.spans = Spans()
        self.slice = DeviceSlice(torch, self.spans) if trace and device != "cpu" else None
        if trace:
            wrap_layers(self.spans)
        self.bound_in_window = 0
        self.failed_in_window = 0
        self.slice_batches = 0
        self.slice_keys: list[str] = []
        self.t1: float | None = None
        self.stages_end: dict = {}
        self.progress: list[tuple[float, int]] = []

    # -- the program's side --

    def create(self, n: int) -> None:
        """The stream's next ``n`` pods, created in the ClusterState."""
        start = self.pods.created
        with self.spans.span("ingest"):
            for d in self.traffic.pods(start, start + n):
                self.cs.create_pod(self.Pod.from_dict(d))
        self.pods.created = start + n

    def delete(self, start: int, stop: int) -> None:
        """Pods ``start`` to ``stop - 1`` of the stream, deleted."""
        keys = [self.traffic.key(j) for j in range(start, stop)]
        with self.spans.span("delete"):
            for key in keys:
                ns, name = key.split("/", 1)
                self.cs.delete_pod(ns, name)
        self.events.append(("delete", keys))

    def call(self, max_batches: int, in_window: bool) -> None:
        results = self.sched.run_pipelined(max_batches=max_batches)
        t = time.perf_counter()
        tracing = self.slice is not None and self.slice.prof is not None
        for r in results:
            self.events.append(("bind", list(r.scheduled)))
            if in_window:
                self.bound_in_window += len(r.scheduled)
                self.progress.append((t, self.bound_in_window))
                self.failed_in_window += len(r.unschedulable) + len(r.bind_failures)
            if tracing:
                self.slice_keys.extend(k for k, _ in r.scheduled)
        if tracing:
            self.slice_batches += len(results)

    def closing(self, now: float) -> bool:
        """Called once the window's time is up: the first call closes the
        window (its end and the StageProfiler's seconds then) and, in a
        traced run, starts the device slice, which runs the same loop on for
        the cell's ``trace_batches`` batches. True while the loop goes on.
        The slice follows the window so that the profiler, which slows the
        host while it records, touches none of the window's numbers."""
        if self.t1 is None:
            self.t1 = now
            self.stages_end = self.stage_seconds()
            if self.slice is None:
                return False
            self.slice.start()
            return True
        if self.slice is not None and self.slice.prof is not None:
            if self.slice_batches < int(self.params["trace_batches"]):
                return True
            self.slice.stop(len(self.slice_keys))
        return False

    def stage_seconds(self) -> dict:
        tel = self.sched.telemetry
        if tel is None or tel.profiler is None:
            return {}
        return dict(tel.profiler.snapshot()["stage_seconds"])

    # -- the arrival process --

    def warmup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float) -> dict:
        """Runs the window; returns ``t0``, ``t1``, ``attempted``,
        ``failed`` and ``e2e`` (end-to-end metric name -> value)."""
        raise NotImplementedError


class GcClock:
    """The garbage collector's pauses while it is installed."""

    def __init__(self):
        self.runs = [0, 0, 0]
        self.seconds = 0.0
        self._t: float | None = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.runs[info["generation"]] += 1
            self._t = None


class Context:
    """What a per-layer metric's reader gets: the run itself, and the
    numbers most readers want."""

    def __init__(self, run: Run, window: dict, stages: dict):
        self.run = run
        self.cell = run.cell["name"]
        self.config = run.config
        self.window_s = window["t1"] - window["t0"]
        self.stage_s = stages
        self.extra = run.extra
        self.slice = run.slice.result if run.slice is not None else None
        self.slice_pods = [run.pods[k] for k in run.slice_keys if k in run.pods]

    def stage_share(self, *stages: str) -> float | None:
        """Percent of the window's wall the program's StageProfiler put to
        ``stages``; None when the profiler was off."""
        if not self.stage_s:
            return None
        return 100.0 * sum(self.stage_s.get(s, 0.0) for s in stages) / self.window_s


def _flat(events):
    for kind, items in events:
        if kind == "bind":
            for key, node in items:
                yield ("bind", key, node)
        else:
            for key in items:
                yield ("delete", key)


def run_cell(cell: dict, config: dict, params: dict, bench: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             solver_overrides: dict | None = None) -> dict:
    """One run; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = load_process(params["process"])(cell, config, params, seed, device, trace, solver_overrides)
    gc_clock = GcClock()
    try:
        run.warmup()
        if device != "cpu":
            run.torch.cuda.synchronize()
        stages0 = run.stage_seconds()
        gc.callbacks.append(gc_clock)
        try:
            window = run.window(seconds)
        finally:
            gc.callbacks.remove(gc_clock)
        stages1 = run.stages_end
    finally:
        run.spans.restore()
    setup_s = window["t0"] - t_start
    window_s = window["t1"] - window["t0"]
    edges = np.linspace(window["t0"], window["t1"], 5)
    counts = [max([b for t, b in run.progress if t <= e] or [0]) for e in edges[1:]]
    print("portbench: pods bound in each quarter of the window: "
          + ", ".join(str(c - p) for p, c in zip([0] + counts[:-1], counts)), file=sys.stderr)
    print(f"portbench: the garbage collector paused {gc_clock.runs[0]} / {gc_clock.runs[1]} / "
          f"{gc_clock.runs[2]} times (generations 0 / 1 / 2) for {gc_clock.seconds:.6f} s in all, "
          f"the window and a traced slice", file=sys.stderr)
    for k, v in run.extra.items():
        print(f"portbench: {k} {v}", file=sys.stderr)
    cuda = device != "cpu"
    mem_peak = int(run.torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_modules(sys.modules)
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}; the benchmark runs the port alone")

    if trace:
        print(f"portbench: traced window {window_s:.3f} s, {run.bound_in_window / window_s:.3f} pods bound/s "
              f"(the StageProfiler and the span wrappers on)", file=sys.stderr)
    if run.slice is not None and run.slice.result is not None:
        r = run.slice.result
        print(f"portbench: device slice {r['window_s']:.6f} s, busy {r['busy_s']:.6f} s, {r['launches']} launches, "
              f"{r['pods']} pods; first device event {r['first_event_offset_s']} s after its start, "
              f"last {r['last_event_offset_s']} s before its end", file=sys.stderr)
    stages = {k: stages1.get(k, 0.0) - stages0.get(k, 0.0) for k in stages1}
    metrics = {}
    if trace:
        ctx = Context(run, window, stages)
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                v = load_reader(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        del ctx
    else:
        e2e = dict(window["e2e"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]) and m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # the program's answers as it reads them back, then its state is freed
    # before the reference runs
    store = {p.key: p.node_name or "" for p in run.cs.list_pods()}
    nodes = {name: (info.used.get("cpu", 0), info.used.get("memory", 0), list(info.pods))
             for name, info in run.sched.cache.nodes.items()}
    events, pods, node_dicts = run.events, run.pods, run.node_dicts
    n_binds = sum(len(items) for kind, items in events if kind == "bind")
    k = min(n_binds, int(params["reference_score_checks"]))
    sample = set(gen.rng(seed, 3).choice(n_binds, size=k, replace=False).tolist()) if k else set()
    if n_binds:
        sample.add(n_binds - 1)
    slice_result = run.slice.result if run.slice is not None else None
    torch = run.torch
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = reference.judge(node_dicts, pods, _flat(events), store, nodes, sample)
    print(f"portbench: reference judged {numbers['_bindings']} bindings, scored {numbers['_score_checked']}, "
          f"in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in LIMITS.items()}
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(window["attempted"]),
        "failed": int(window["failed"]),
        "metrics": metrics,
        "device": device_info(cuda, mem_peak, slice_result if trace else None),
    }
    if trace and slice_result is not None:
        out["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in slice_result["device_s_by_name"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in slice_result["idle_s_by_span"].items()),
                                key=lambda kv: -kv[1])[:10],
        }
    out["checks"] = checks
    return out


def device_info(cuda: bool, mem_peak: int, slice_result: dict | None) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": mem_peak}
    if slice_result is not None:
        info["busy_s"] = slice_result["busy_s"]
        info["window_s"] = slice_result["window_s"]
    return info


def check_lines(out: dict) -> list[str]:
    return [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in out["checks"].items()]
