"""Spans from the benchmark's own side, and the device trace of one slice.

``Spans`` wraps calls into the program's layers (the queue's pop, tensorize,
the solve's dispatch, the apply and the commit of a batch) with wall-clock
spans, kept in memory while a slice is being traced. Nothing inside the
program is changed: the wrappers sit on the classes for the run and are
removed after it.

``DeviceSlice`` runs ``torch.profiler`` (CUDA activity only, so the host
pays no per-operation cost) over a slice of the window and reduces its
device events: the union of device intervals (busy time), the gaps between
them, each gap put to the innermost host span that was open at its middle,
kernel launches (every device event but copies and fills, as
chip_rates.py counts them) and device seconds per kernel name. Both clocks
are the Unix clock in nanoseconds: the profiler converts the device's
timestamps to it, and the spans read ``time.time_ns``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 160


class Spans:
    def __init__(self):
        self.on = False
        self.items: list[tuple[str, int, int]] = []
        self._wrapped: list[tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, label: str) -> None:
        orig = getattr(owner, attr)
        spans = self

        def wrapper(*a, **k):
            if not spans.on:
                return orig(*a, **k)
            t = time.time_ns()
            try:
                return orig(*a, **k)
            finally:
                spans.items.append((label, t, time.time_ns()))

        self._wrapped.append((owner, attr, orig))
        setattr(owner, attr, wrapper)

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._wrapped):
            setattr(owner, attr, orig)
        self._wrapped.clear()

    @contextmanager
    def span(self, label: str):
        if not self.on:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((label, t, time.time_ns()))


def wrap_layers(spans: Spans) -> None:
    """The program's layer boundaries the slice's idle gaps are put to."""
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.solver.exact import ExactSolver
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    spans.wrap(Scheduler, "run_pipelined", "loop")
    spans.wrap(PriorityQueue, "pop_batch", "queue.pop")
    spans.wrap(Scheduler, "_tensorize_group", "tensorize")
    spans.wrap(ExactSolver, "solve", "solve.dispatch")
    spans.wrap(Scheduler, "_apply_flight", "apply")
    spans.wrap(Scheduler, "_commit_all", "commit")


def union(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans: list[tuple[str, int, int]], t: int) -> str:
    """The label of the shortest span open at ``t``; "harness" for none."""
    best, width = "harness", None
    for label, s, e in spans:
        if s <= t < e and (width is None or e - s < width):
            best, width = label, e - s
    return best


def reduce_slice(device_events, spans, t0: int, t1: int, pods: int) -> dict:
    """The slice's device numbers from ``(name, start_ns, end_ns)`` device
    events and the host ``spans``, over ``[t0, t1]``."""
    busy = union([(s, e) for _, s, e in device_events], t0, t1)
    busy_ns = sum(e - s for s, e in busy)
    per_name: dict[str, int] = defaultdict(int)
    launches = 0
    for name, s, e in device_events:
        per_name[name[:NAME_CHARS]] += e - s
        if not name.startswith(COPY_PREFIXES):
            launches += 1
    idle_by: dict[str, int] = defaultdict(int)
    for s, e in gaps(busy, t0, t1):
        idle_by[innermost(spans, (s + e) // 2)] += e - s
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "launches": launches,
        "pods": pods,
        "device_s_by_name": {k: v / 1e9 for k, v in per_name.items()},
        "idle_s_by_span": {k: v / 1e9 for k, v in idle_by.items()},
        "first_event_offset_s": (min(s for _, s, _ in device_events) - t0) / 1e9 if device_events else None,
        "last_event_offset_s": (t1 - max(e for _, _, e in device_events)) / 1e9 if device_events else None,
    }


class DeviceSlice:
    """torch.profiler over one slice of the window."""

    def __init__(self, torch, spans: Spans):
        self.torch = torch
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = 0
        self.result: dict | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.spans.items.clear()
        self.spans.on = True
        self.t0 = time.time_ns()

    def stop(self, pods: int) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.spans.on = False
        self.prof.stop()
        from torch.autograd import DeviceType

        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        self.prof = None
        self.result = reduce_slice(events, list(self.spans.items), self.t0, self.t1, pods)
