"""Where a solve's host time goes, and the solvers' blocking card reads.

``SolveTimes`` is one ExactSolver's account of its last ``solve()`` call,
kept as plain data the way ``dispatch_counts`` is kept, so that the
Scheduler hands it to the StageProfiler after each call. Its sub-stages,
in the order a solve runs them:

    prepare    host work before the run: the trivial tensors, the pod
               rows (``_pod_inputs``), the chunk kinds and compact rows
    upload     the session's sync and dirty-column heal, the class tables,
               the batch and pod rows, and the per-shard table views
    issue      the run's host issue: the scan's steps, or the grouped
               path's chunks and iterations (``_Run.__call__``,
               ``_solve_chain``), one timer pair per call
    card_read  the blocking device-to-host reads inside the run (nested
               in ``issue``)
    capture    the CUDA graph captures inside the run, of the scan's steps
               and of the quota chunks' iterations (``solver/graphs.py``;
               nested in ``issue``)

Beside them it counts the card reads, and in ``counts`` the call's solve
counts by their ledger keys, one entry of ``COUNT_SERIES`` each: the scan's
steps and the grouped loop's iterations, the scan steps' CUDA graph
replays and captures (``solver/graphs.py``), the grouped path's chunks
that held a valid pod, their pods and their loop's iterations by chunk
kind (``CHUNK_KINDS``), the spread iterations that kept the water-fill,
the quota iterations' graph replays and captures (``QUOTA_KINDS``), and
the chunks whose whole loop ran in one fused launch (``FUSED_KINDS``).
A new count is its increment, its entry and, if it needs one, its series.

A fused loop counts its iterations and kept water-fills on the card, in a
device row per call; ``deferred`` holds the call's rows, each copied into
pinned memory without waiting for the card (``DeferredCounts``). The
StageProfiler adds them to its batch ledger once the card has written them,
which it has by the time the batch's assignments have been read.

With a Tracer set (the Scheduler's, when its spans are on) each
sub-stage is also a span of the same name, ``card_read`` carrying its
site and ``capture`` its kind (``scan``, or the quota chunk's kind); with
a ``utils/tracing`` session on, a ``record_function`` range of the same
name, so the operator's Chrome trace shows them against the kernels.
Off, a sub-stage costs two clock reads.

``COUNTS`` / ``SECONDS`` are the process's hot-path cells of the blocking
reads inside the solvers (ROADMAP speed lever 7), by site: the grouped
random loop's exit test, the relax planner's convergence test, the
auction's round test, the webhook evaluation's result and the preemption
dry-run's verdicts. The StageProfiler folds their deltas once per batch
into ``scheduler_solve_card_reads_total{site}`` and
``scheduler_solve_card_read_seconds_total{site}``. A read waits on the
card, so the two clock reads around it cost nothing measurable.
"""

from __future__ import annotations

import contextlib
import time

from ..utils import tracing

SOLVE_STAGES = ("prepare", "upload", "issue", "card_read", "capture")
# the grouped path's chunk kinds, indexed by solver/grouped.py's KIND_*
# values; the fast kinds are the ones whose chunks run the grouped loop
CHUNK_KINDS = ("slow", "plain", "spread", "anti")
FAST_KINDS = CHUNK_KINDS[1:]
# the fast kinds whose random loop replays graphs of its iterations
QUOTA_KINDS = CHUNK_KINDS[2:]
# the fast kinds whose whole random loop may run in one fused launch
# (ops/grouped_spread.py)
FUSED_KINDS = ("spread",)
SITES = ("grouped", "relax", "auction", "evaluate", "preemption")
KERNELS = ("domain_counts", "threefry_scan", "threefry_grouped", "grouped_spread")

# each solve count's ledger key -> the registry series (an attribute of
# ``metrics``) and label (None: unlabelled) its per-batch delta advances;
# SolveTimes.counts, the issue span and the StageProfiler read it
COUNT_SERIES = {
    "scan_steps": ("solve_steps_total", "scan_steps"),
    "grouped_iterations": ("solve_steps_total", "grouped_iterations"),
    "graph_replays": ("solve_graph_replays_total", None),
    "graph_captures": ("solve_graph_captures_total", None),
    **{f"chunks.{k}": ("solve_chunks_total", k) for k in CHUNK_KINDS},
    **{f"chunk_pods.{k}": ("solve_chunk_pods_total", k) for k in CHUNK_KINDS},
    **{f"chunk_iterations.{k}": ("solve_chunk_iterations_total", k) for k in FAST_KINDS},
    "waterfill_iterations": ("solve_waterfill_iterations_total", None),
    **{f"grouped_graph_replays.{k}": ("solve_grouped_graph_replays_total", k)
       for k in QUOTA_KINDS},
    **{f"grouped_graph_captures.{k}": ("solve_grouped_graph_captures_total", k)
       for k in QUOTA_KINDS},
    **{f"fused_chunks.{k}": ("solve_fused_chunks_total", k) for k in FUSED_KINDS},
}

COUNTS = dict.fromkeys(SITES, 0)
SECONDS = dict.fromkeys(SITES, 0.0)


def note(site: str, t0: float) -> None:
    """One blocking read at ``site`` that began at ``time.perf_counter()``
    ``t0`` and has just returned."""
    SECONDS[site] += time.perf_counter() - t0
    COUNTS[site] += 1


def launch_counts() -> tuple[int, int, int, int]:
    """The kernel launch cells, in ``KERNELS`` order."""
    from ..ops import domain_counts as dc
    from ..ops import grouped_spread as gs
    from ..ops import threefry as tf

    return dc.LAUNCHES, tf.SCAN_LAUNCHES, tf.GROUPED_LAUNCHES, gs.LAUNCHES


class DeferredCounts:
    """Counts that the card holds at the end of a call: the int64 device
    row ``row``, whose position i adds to each count that ``keys[i]``
    names. The row is copied into pinned memory now, behind the work that
    writes it, without waiting for the card (a row on the CPU is copied
    as it is)."""

    __slots__ = ("keys", "host", "event")

    def __init__(self, row, keys: tuple) -> None:
        import torch

        self.keys = keys
        self.event = None
        if not row.is_cuda:
            self.host = row.clone()
            return
        self.host = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
        self.host.copy_(row, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self) -> bool:
        """Whether the card has written the row (does not wait)."""
        return self.event is None or self.event.query()

    def values(self) -> dict:
        """The counts by key; waits for the card if it has not written the
        row yet."""
        if self.event is not None:
            self.event.synchronize()
        out: dict = {}
        for v, names in zip(self.host.tolist(), self.keys):
            for k in names:
                out[k] = out.get(k, 0) + int(v)
        return out


class _NoSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Stage:
    """One timed sub-stage: its seconds go to ``times.seconds[name]``,
    and, when traced, a span and a profiler range of the same name."""

    __slots__ = ("times", "name", "attrs", "t0", "dt", "span", "ctx")

    def __init__(self, times: "SolveTimes", name: str, attrs: dict) -> None:
        self.times = times
        self.name = name
        self.attrs = attrs
        self.span = _NO_SPAN
        self.ctx = None
        self.dt = 0.0

    @property
    def traced(self) -> bool:
        return self.span is not _NO_SPAN

    def set(self, **attrs) -> None:
        self.span.set(**attrs)

    def __enter__(self) -> "_Stage":
        tm = self.times
        if tm.tracer is not None or tracing.enabled():
            self.ctx = contextlib.ExitStack()
            if tm.tracer is not None:
                self.span = self.ctx.enter_context(
                    tm.tracer.span(self.name, **self.attrs))
            self.ctx.enter_context(tracing.stage(self.name))
        self.t0 = tm.perf()
        return self

    def __exit__(self, *exc) -> bool:
        tm = self.times
        self.dt = tm.perf() - self.t0
        tm.seconds[self.name] += self.dt
        if self.ctx is not None:
            return self.ctx.__exit__(*exc)
        return False


class SolveTimes:
    """One solver's sub-stage seconds and counts of its last solve call.
    ``perf`` is the duration clock (the Scheduler gives its own, so a
    simulator on virtual time reads virtual seconds); ``tracer`` an
    enabled obs Tracer, or None."""

    def __init__(self) -> None:
        self.perf = time.perf_counter
        self.tracer = None
        self.begin()

    def begin(self) -> None:
        """Zero the account for a new solve call."""
        self.seconds = dict.fromkeys(SOLVE_STAGES, 0.0)
        self.counts = dict.fromkeys(COUNT_SERIES, 0)
        self.deferred: list[DeferredCounts] = []
        self.card_reads = 0

    def defer(self, row, keys: tuple) -> None:
        """Counts of the call that the card holds in ``row`` (see
        ``DeferredCounts``)."""
        self.deferred.append(DeferredCounts(row, keys))

    def stage(self, name: str) -> _Stage:
        return _Stage(self, name, {})

    def capture(self, kind: str) -> _Stage:
        """The timed capture of a CUDA graph of ``kind``'s work: ``scan``
        (a scan step) or a quota chunk's kind (an iteration)."""
        return _Stage(self, "capture", {"kind": kind})

    def read(self, site: str, fn, parts):
        """``fn(parts)``, a lockstep combine that reads the card at
        ``site``, timed and counted."""
        with _Stage(self, "card_read", {"site": site}) as st:
            out = fn(parts)
        SECONDS[site] += st.dt
        COUNTS[site] += 1
        self.card_reads += 1
        return out
