"""Zero-dep span tracing for the scheduling loops (the tentpole of the
trace layer, SURVEY §6.1's *host-side* complement to ``utils/tracing``'s
jax-profiler device traces).

Spans are OTel-shaped — name, span/trace/parent ids, attributes, start
and end timestamps — but carry **three** time bases from the injectable
``Clock``: ``now()`` (the scheduling clock; ``FakeClock`` virtual time
in the simulator, so recorded spans replay deterministically),
``perf()`` (the duration clock) and ``unix_ns()`` (integer Unix
nanoseconds, ``t0_ns`` / ``t1_ns``: the clock torch.profiler stamps
device events with, so a span can be set against a device trace). No
OpenTelemetry dependency, no network exporter: spans land in the
in-memory flight recorder ring and, optionally, a JSONL file.

Hot-path contract (TPU001): a *disabled* tracer's ``span()`` returns a
preallocated no-op context manager — one attribute check, no
allocation, no jax import, no host↔device sync. Enabling tracing adds
host-side dict work only; it never reads device values (the sanctioned
deferred-read points in ``analysis/registry.py`` stay the only ones).

Span ids are sequence numbers, not random — two same-seed simulator
runs emit byte-identical span streams (the sim's determinism contract
extends to observability output).

Copied from ``kubernetes_tpu/obs/span.py``.
"""

from __future__ import annotations

import itertools
import threading

from .. import metrics
from ..utils.clock import Clock


class Span:
    """One timed operation. ``trace_id`` groups every span of one
    scheduling batch (the ``Scheduler._trace_step`` counter, shared
    with the jax-profiler step annotation).

    A plain ``__slots__`` class, not a dataclass: spans are created at
    per-pod volume on the bind path (and per sampled watch event), and
    the obs-overhead ladder holds the whole layer to <= 5% sustained
    throughput — instance-dict allocation is measurable there."""

    __slots__ = (
        "name", "span_id", "trace_id", "parent_id", "start_wall",
        "start_perf", "start_ns", "attrs", "end_wall", "end_perf",
        "end_ns", "status",
    )

    def __init__(
        self,
        name: str,
        span_id: int,
        trace_id: int,
        parent_id: "int | None",
        start_wall: float,  # Clock.now() — virtual in the simulator
        start_perf: float,  # Clock.perf() — duration base
        attrs: dict | None = None,
        start_ns: int = 0,  # Clock.unix_ns() — the device trace's clock
    ) -> None:
        self.name = name
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.start_wall = start_wall
        self.start_perf = start_perf
        self.start_ns = start_ns
        self.attrs = attrs if attrs is not None else {}
        self.end_wall = 0.0
        self.end_perf = 0.0
        self.end_ns = 0
        self.status = "ok"  # ok | error

    @property
    def duration(self) -> float:
        return self.end_perf - self.start_perf

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def as_dict(self) -> dict:
        d = {
            "k": "span",
            "v": 1,
            "name": self.name,
            "span": self.span_id,
            "trace": self.trace_id,
            "parent": self.parent_id,
            "start": self.start_wall,
            "end": self.end_wall,
            "dur": self.end_perf - self.start_perf,
            "t0_ns": self.start_ns,
            "t1_ns": self.end_ns,
            "status": self.status,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NoopSpan:
    """Yielded by a disabled tracer: absorbs ``set()`` without work."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager for one live span: pushes itself on the tracer's
    thread-local parent stack so nested spans link automatically."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self.span = span

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def __enter__(self) -> Span:
        self._tracer._stack().append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = self._tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        if exc_type is not None:
            self.span.status = "error"
            self.span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self.span)
        return False


class Tracer:
    """Span factory + export fan-out.

    ``recorder`` (obs.recorder.FlightRecorder) receives every finished
    span; ``sink`` is an optional callable(dict) for JSONL export (the
    CLI wires a file writer). ``enabled=False`` short-circuits to the
    shared no-op — the production default.
    """

    def __init__(
        self,
        clock: Clock | None = None,
        enabled: bool = False,
        recorder=None,
        sink=None,
    ) -> None:
        self.clock = clock or Clock()
        self.enabled = enabled
        self.recorder = recorder
        self.sink = sink
        # itertools.count: C-atomic increment — the span hot path pays
        # no lock acquire per id (span volume at sustained-stream rate
        # is thousands/s; the obs-overhead ladder budget is 5%)
        self._seq = itertools.count(1)
        self._local = threading.local()
        # current trace (batch) id; the scheduler sets it per cycle
        self.trace_id = 0
        # per-name metric children resolved once: labels() is a lock +
        # tuple-keyed dict lookup per call, measurable at per-pod span
        # volume (bind spans)
        self._span_counters: dict = {}

    # -- internals --

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        return next(self._seq)

    def _finish(self, span: Span) -> None:
        span.end_wall = self.clock.now()
        span.end_perf = self.clock.perf()
        span.end_ns = self.clock.unix_ns()
        counter = self._span_counters.get(span.name)
        if counter is None:
            counter = self._span_counters[span.name] = (
                metrics.trace_spans_total.labels(span.name)
            )
        counter.inc()
        if self.recorder is not None:
            self.recorder.record_span(span)
        if self.sink is not None:
            self.sink(span.as_dict())

    # -- public surface --

    def span(self, name: str, trace_id: int | None = None, **attrs):
        """Open a span under the current thread's innermost live span.
        Disabled tracers return the shared no-op (zero allocation)."""
        if not self.enabled:
            return _NOOP
        stack = self._stack()
        parent = stack[-1] if stack else None
        return _SpanCtx(
            self,
            Span(
                name,
                self._next_id(),
                (
                    trace_id
                    if trace_id is not None
                    else (parent.trace_id if parent else self.trace_id)
                ),
                parent.span_id if parent else None,
                self.clock.now(),
                self.clock.perf(),
                attrs,  # the **kwargs dict is already fresh
                self.clock.unix_ns(),
            ),
        )

    def current(self) -> Span | None:
        """The innermost live span on this thread (None when idle or
        disabled) — the structured-logging formatter reads span/trace
        ids from here."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None
