"""Where a solve's host time goes, and the solvers' blocking card reads.

``SolveTimes`` is one ExactSolver's account of its last ``solve()`` call,
kept as plain attributes the way ``dispatch_counts`` is kept, so that the
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

Beside them it counts the scan's steps, the grouped loop's iterations and
the card reads, and of the scan's steps those replayed from a CUDA graph
(``graph_replays``) and the graphs captured (``graph_captures``,
``solver/graphs.py``). Of the grouped path it counts, by chunk kind
(``CHUNK_KINDS``), the chunks that held a valid pod (``chunks``), their
valid pods (``chunk_pods``) and, for the fast kinds, the loop's iterations
(``chunk_iterations``, which add up to ``grouped_iterations``), the
spread iterations that kept the water-fill (``waterfill_iterations``, a
flag the random loop's exit-test read brings back with the count placed),
and, for the quota kinds (``QUOTA_KINDS``), the iterations replayed from a
CUDA graph of the iteration (``grouped_graph_replays``) and the graphs
captured (``grouped_graph_captures``).
With a Tracer set (the Scheduler's, when its spans are on)
each sub-stage is also a span of the same name, ``card_read`` carrying its
site; with a ``utils/tracing`` session on, a ``record_function`` range of
the same name, so the operator's Chrome trace shows them against the
kernels. Off, a sub-stage costs two clock reads.

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

SOLVE_STAGES = ("prepare", "upload", "issue", "card_read")
# the grouped path's chunk kinds, indexed by solver/grouped.py's KIND_*
# values; the fast kinds are the ones whose chunks run the grouped loop
CHUNK_KINDS = ("slow", "plain", "spread", "anti")
FAST_KINDS = CHUNK_KINDS[1:]
# the fast kinds whose random loop replays graphs of its iterations
QUOTA_KINDS = CHUNK_KINDS[2:]
SITES = ("grouped", "relax", "auction", "evaluate", "preemption")
KERNELS = ("domain_counts", "threefry_scan", "threefry_grouped")

COUNTS = dict.fromkeys(SITES, 0)
SECONDS = dict.fromkeys(SITES, 0.0)


def note(site: str, t0: float) -> None:
    """One blocking read at ``site`` that began at ``time.perf_counter()``
    ``t0`` and has just returned."""
    SECONDS[site] += time.perf_counter() - t0
    COUNTS[site] += 1


def launch_counts() -> tuple[int, int, int]:
    """The kernel launch cells, in ``KERNELS`` order."""
    from ..ops import domain_counts as dc
    from ..ops import threefry as tf

    return dc.LAUNCHES, tf.SCAN_LAUNCHES, tf.GROUPED_LAUNCHES


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
        self.scan_steps = 0
        self.grouped_iterations = 0
        self.graph_replays = 0
        self.graph_captures = 0
        self.card_reads = 0
        self.chunks = dict.fromkeys(CHUNK_KINDS, 0)
        self.chunk_pods = dict.fromkeys(CHUNK_KINDS, 0)
        self.chunk_iterations = dict.fromkeys(FAST_KINDS, 0)
        self.waterfill_iterations = 0
        self.grouped_graph_replays = dict.fromkeys(QUOTA_KINDS, 0)
        self.grouped_graph_captures = dict.fromkeys(QUOTA_KINDS, 0)

    def chunk_counts(self) -> dict:
        """The grouped path's counts, flat: ``chunks.<kind>``,
        ``chunk_pods.<kind>``, ``chunk_iterations.<kind>``,
        ``waterfill_iterations``, ``grouped_graph_replays.<kind>`` and
        ``grouped_graph_captures.<kind>``, the keys of the StageProfiler's
        ledger."""
        out = {f"chunks.{k}": v for k, v in self.chunks.items()}
        out.update((f"chunk_pods.{k}", v) for k, v in self.chunk_pods.items())
        out.update((f"chunk_iterations.{k}", v) for k, v in self.chunk_iterations.items())
        out["waterfill_iterations"] = self.waterfill_iterations
        out.update((f"grouped_graph_replays.{k}", v)
                   for k, v in self.grouped_graph_replays.items())
        out.update((f"grouped_graph_captures.{k}", v)
                   for k, v in self.grouped_graph_captures.items())
        return out

    def stage(self, name: str) -> _Stage:
        return _Stage(self, name, {})

    def read(self, site: str, fn, parts):
        """``fn(parts)``, a lockstep combine that reads the card at
        ``site``, timed and counted."""
        with _Stage(self, "card_read", {"site": site}) as st:
            out = fn(parts)
        SECONDS[site] += st.dt
        COUNTS[site] += 1
        self.card_reads += 1
        return out
