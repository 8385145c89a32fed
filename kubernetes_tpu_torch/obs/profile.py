"""Continuous per-stage profiler: where did each batch's wall time go?

A bounded per-batch **stage ledger** assembled host-side from numbers
the dispatch loops already compute — ``prep.tensorize_seconds``, the
dispatch span, the deferred-read wait, the locked validate/apply
region, the per-entry bind wall — plus within-batch deltas of the
transfer/decision counters (h2d/d2h bytes, sub-batch splits, stream
chains, discards). Zero new device syncs (TPU001-clean): every number
is either a ``clock.perf()`` difference the loop already took or a
host-side prometheus cell read, the CounterWindow discipline from
``tuning/window.py``.

Exported as ``scheduler_profile_stage_seconds{stage}`` (cumulative
seconds per stage — ``rate()`` it to see the live stage mix), rendered
by ``python -m kubernetes_tpu.obs top`` and ``GET /debug/profile``.

Stage taxonomy (one batch's life):

    tensorize     host: cluster state -> padded device arrays
    dispatch      host: solve dispatch (upload + jit call, async)
    fence_wait    host: work discarded to fences (stale flights)
    deferred_read device->host: blocking assignment read (the RTT)
    validate      host: assignment validation under the lock
    apply         host: assume/reserve under the lock
    bind          host: commit to the state service (api round-trip)

Seven more stages overlap those seven, so the stage mix
(``stage_fraction``) leaves them out:

    upload        dispatch's uploads: the session's sync and heals, the
                  class tables, the batch and pod rows
    prepare       dispatch's host work before the run
    issue         dispatch's run: the scan's steps, the grouped chunks
    card_read     blocking card reads inside issue (lever 7)
    capture       CUDA graph captures inside issue (solver/graphs.py)
    enqueue       the watch handler, every event (overlaps bind, whose
                  confirmations it handles)
    gc            the interpreter's collector pauses (overlap anything)

The first five are the solver's own account of each call
(``solver/timing.py``); dispatch less upload, prepare and issue is
dispatch's self time (card_read and capture are parts of issue).
``enqueue`` and ``gc`` are process-wide cells the profiler folds by
delta at each batch. The ledger also carries the per-batch deltas of the
program's bare counters (kernel launches, the mesh's combines, the card
reads by site) and of the solve counts the Scheduler hands over
(``timing.COUNT_SERIES``), and advances their registry counters once per
batch.

Copied from ``kubernetes_tpu/obs/profile.py``; the seven overlapping
stages and the program's counters are the port's.
"""

from __future__ import annotations

import gc
import sys
import threading
import weakref
from collections import deque

from .. import metrics
from ..solver import timing

STAGES = (
    "tensorize",
    "dispatch",
    "fence_wait",
    "deferred_read",
    "validate",
    "apply",
    "bind",
)
NESTED_STAGES = ("upload", "prepare", "issue", "card_read", "capture", "enqueue", "gc")
ALL_STAGES = STAGES + NESTED_STAGES


def _cell(counter) -> float:
    return counter._value.get()  # prometheus_client internal, host-side


def _labeled_total(counter) -> float:
    """Sum over every child of a labeled counter (the
    ``tuning/window.py`` discipline) without materializing new labels."""
    try:
        with counter._lock:
            children = list(counter._metrics.values())
    except AttributeError:
        return 0.0
    return float(sum(c._value.get() for c in children))


def _global(module: str, name: str):
    """Reader of one of the program's bare hot-path cells, a module
    global its launch or combine sites bump. A module never imported has
    counted nothing (and the ops modules import torch, which this one
    does not)."""
    key = f"{__package__.rsplit('.', 1)[0]}.{module}"
    return lambda: getattr(sys.modules.get(key), name, 0)


# within-batch deltas folded into each ledger entry: transfer volume,
# the chain/split/discard decisions the loops tick, the kernel launches,
# the mesh's combines and the solvers' card reads by site. All host-side
# cells (the device never syncs to serve a read here).
_DELTA_READERS = {
    "h2d_bytes": lambda: _cell(metrics.h2d_bytes_total),
    "d2h_bytes": lambda: _cell(metrics.d2h_bytes_total),
    "subbatches": lambda: _cell(metrics.pipeline_subbatches_total),
    "solve_discards": lambda: _cell(metrics.solves_discarded_total),
    "slot_discards": lambda: _cell(metrics.stream_slot_discard_total),
    "unhidden_reads": lambda: _cell(metrics.stream_unhidden_reads_total),
    "launches.domain_counts": _global("ops.domain_counts", "LAUNCHES"),
    "launches.threefry_scan": _global("ops.threefry", "SCAN_LAUNCHES"),
    "launches.threefry_grouped": _global("ops.threefry", "GROUPED_LAUNCHES"),
    "launches.grouped_spread": _global("ops.grouped_spread", "LAUNCHES"),
    "combines": _global("parallel.sharding", "COMBINES"),
    "combine_s": _global("parallel.sharding", "COMBINE_S"),
    **{f"card_reads.{s}": (lambda s=s: timing.COUNTS[s]) for s in timing.SITES},
    **{f"card_read_s.{s}": (lambda s=s: timing.SECONDS[s]) for s in timing.SITES},
}


def _exported() -> dict:
    """Ledger key -> the registry counter child its per-batch delta
    advances."""
    out = {f"launches.{k}": metrics.kernel_launches_total.labels(k) for k in timing.KERNELS}
    out["combines"] = metrics.mesh_combines_total
    out["combine_s"] = metrics.mesh_combine_seconds_total
    for s in timing.SITES:
        out[f"card_reads.{s}"] = metrics.solve_card_reads_total.labels(s)
        out[f"card_read_s.{s}"] = metrics.solve_card_read_seconds_total.labels(s)
    for k, (series, label) in timing.COUNT_SERIES.items():
        c = getattr(metrics, series)
        out[k] = c if label is None else c.labels(label)
    for g in range(3):
        out[f"gc_runs.{g}"] = metrics.gc_collections_total.labels(str(g))
    return out


class _GcPauses:
    """The collector's pauses, cumulative, as a ``gc.callbacks`` entry.
    Written by the collector alone (one collection at a time, whichever
    thread runs it) and read by delta, so it takes no lock: a lock here
    could be held by the very thread a collection interrupts."""

    __slots__ = ("perf", "seconds", "runs", "_t")

    def __init__(self, perf) -> None:
        self.perf = perf
        self.seconds = 0.0
        self.runs = [0, 0, 0]
        self._t: float | None = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = self.perf()
        elif self._t is not None:
            self.seconds += self.perf() - self._t
            self.runs[info["generation"]] += 1
            self._t = None


def _uninstall(cb) -> None:
    if cb in gc.callbacks:
        gc.callbacks.remove(cb)


class StageProfiler:
    """Always-on per-batch stage attribution.

    The loops call :meth:`add` at the seams they already time and
    :meth:`observe_batch` once per applied batch (next to the SLO
    tick in ``_commit_all``); readers call :meth:`snapshot` from any
    thread. ``capacity`` bounds the ledger — a serving process retains
    the recent history, never the run. The watch handler calls
    :meth:`enqueue` per event, and the collector's pauses are timed
    while the profiler lives.
    """

    def __init__(self, clock=None, capacity: int = 512) -> None:
        import time as _time

        self._perf = clock.perf if clock is not None else _time.perf_counter
        self._ledger: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # stages accumulated since the last observe_batch (the loops'
        # add() calls between two commits belong to the batch closing)
        self._pending: dict[str, float] = {}
        self._pending_counts = dict.fromkeys(timing.COUNT_SERIES, 0)
        # solve counts the card still holds (timing.DeferredCounts)
        self._deferred: list = []
        self._totals = {s: 0.0 for s in ALL_STAGES}
        self._counters = {k: r() for k, r in _DELTA_READERS.items()}
        self._last_t: float | None = None
        self.batches = 0
        self.pods = 0
        self._stage_cells = {
            s: metrics.profile_stage_seconds.labels(s) for s in ALL_STAGES
        }
        self._export = _exported()
        # the watch handler's seconds and events, cumulative (written
        # under the cluster lock that delivers events)
        self._enqueue_s = 0.0
        self._events = 0
        self._gc = _GcPauses(self._perf)
        self._process_last = (0.0, 0, 0.0, [0, 0, 0])
        gc.callbacks.append(self._gc)
        weakref.finalize(self, _uninstall, self._gc)

    # -- driver-thread writes --

    def add(self, stage: str, seconds: float) -> None:
        """Attribute ``seconds`` of already-measured wall time to a
        stage of the batch currently in flight."""
        if seconds <= 0.0:
            return
        self._pending[stage] = self._pending.get(stage, 0.0) + seconds

    def add_solve(self, times) -> None:
        """One solve call's account (``solver/timing.py`` SolveTimes):
        its sub-stage seconds and its counts (``timing.COUNT_SERIES``)."""
        for stage, seconds in times.seconds.items():
            self.add(stage, seconds)
        pending = self._pending_counts
        for k, v in times.counts.items():
            pending[k] += v
        self._deferred.extend(times.deferred)

    def _fold_deferred(self) -> None:
        """Adds the deferred solve counts the card has written to the
        batch in flight; the others wait for a later batch (a batch's own
        have been written once its assignments were read)."""
        waiting = []
        for d in self._deferred:
            if d.ready():
                for k, v in d.values().items():
                    self._pending_counts[k] += v
            else:
                waiting.append(d)
        self._deferred = waiting

    def enqueue(self, seconds: float) -> None:
        """One watch event's handling."""
        self._enqueue_s += seconds
        self._events += 1

    def observe_batch(self, *, step: int, pods: int) -> dict:
        """Close the in-flight batch's ledger entry: fold the pending
        stage seconds and the counter deltas since the previous batch,
        tick the stage metrics, append to the bounded ledger."""
        now = self._perf()
        wall = 0.0 if self._last_t is None else max(now - self._last_t, 0.0)
        self._last_t = now
        # the process-wide cells, by delta since the previous batch
        process = (self._enqueue_s, self._events, self._gc.seconds, list(self._gc.runs))
        last, self._process_last = self._process_last, process
        self._pending["enqueue"] = process[0] - last[0]
        self._pending["gc"] = process[2] - last[2]
        stages = {s: self._pending.get(s, 0.0) for s in ALL_STAGES}
        self._pending.clear()
        self._fold_deferred()
        deltas = dict(self._pending_counts, events=process[1] - last[1])
        for g in range(3):
            deltas[f"gc_runs.{g}"] = process[3][g] - last[3][g]
        self._pending_counts = dict.fromkeys(timing.COUNT_SERIES, 0)
        for k, read in _DELTA_READERS.items():
            cur = read()
            # a cell reset by hand (tests, chip_smoke) counts no negative work
            deltas[k] = max(cur - self._counters[k], 0)
            self._counters[k] = cur
        for k, child in self._export.items():
            if deltas[k] > 0:
                child.inc(deltas[k])
        entry = {
            "step": step,
            "pods": pods,
            "wall_s": round(wall, 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            **{k: round(v, 6) for k, v in deltas.items()},
        }
        with self._lock:
            self._ledger.append(entry)
            self.batches += 1
            self.pods += pods
            for s, v in stages.items():
                if v > 0.0:
                    self._totals[s] += v
                    self._stage_cells[s].inc(v)
        return entry

    # -- any-thread reads --

    def snapshot(self, recent: int = 32) -> dict:
        """JSON-ready profile state: cumulative stage seconds, the
        stage mix, and the trailing ``recent`` ledger entries."""
        with self._lock:
            totals = dict(self._totals)
            tail = list(self._ledger)[-recent:]
            batches, pods = self.batches, self.pods
        # the mix is over the seven disjoint stages; the nested ones
        # overlap them
        accounted = sum(totals[s] for s in STAGES)
        return {
            "batches": batches,
            "pods": pods,
            "stage_seconds": {
                s: round(totals[s], 6) for s in ALL_STAGES
            },
            "stage_fraction": {
                s: round(totals[s] / accounted, 4) if accounted else 0.0
                for s in STAGES
            },
            "recent": tail,
        }


def render_top(snapshot: dict) -> str:
    """Terminal rendering of a ``Telemetry.snapshot()`` document (the
    ``python -m kubernetes_tpu.obs top`` view — same doc GET
    /debug/profile serves). Pure string formatting, separately
    unit-tested; tolerant of partially-enabled telemetry (profiler
    without sentinel, sentinel without bundles)."""
    lines: list[str] = []
    prof = snapshot.get("profile") or {}
    batches = prof.get("batches", 0)
    pods = prof.get("pods", 0)
    lines.append(f"flight telemetry — {batches} batches, {pods} pods")
    if prof:
        totals = prof.get("stage_seconds", {})
        fracs = prof.get("stage_fraction", {})
        lines.append(
            f"  {'stage':<14} {'total_s':>10} {'frac':>7} "
            f"{'per_batch_ms':>13}"
        )
        for s in STAGES:
            tot = float(totals.get(s, 0.0))
            per_batch_ms = (tot / batches * 1000.0) if batches else 0.0
            lines.append(
                f"  {s:<14} {tot:>10.4f} "
                f"{float(fracs.get(s, 0.0)) * 100.0:>6.1f}% "
                f"{per_batch_ms:>13.3f}"
            )
        nested = [s for s in NESTED_STAGES if s in totals]
        if nested:
            lines.append("  overlapping the above (dispatch's parts, the "
                         "watch handler, the collector):")
        for s in nested:
            tot = float(totals[s])
            per_batch_ms = (tot / batches * 1000.0) if batches else 0.0
            lines.append(
                f"    {s:<12} {tot:>10.4f} {'':>7} {per_batch_ms:>13.3f}"
            )
        recent = prof.get("recent") or []
        if recent:
            last = recent[-1]
            lines.append(
                f"  last batch: step={last.get('step')} "
                f"pods={last.get('pods')} wall_s={last.get('wall_s')} "
                f"h2d={last.get('h2d_bytes', 0):.0f}B "
                f"d2h={last.get('d2h_bytes', 0):.0f}B"
            )
    sent = snapshot.get("sentinel")
    if sent:
        lines.append(
            f"  sentinel: degraded={sent.get('degraded', False)} "
            f"fired_total={sent.get('fired_total', 0)} "
            f"suppressed_windows={sent.get('suppressed_windows', 0)}"
        )
        for a in (sent.get("recent_anomalies") or [])[-4:]:
            lines.append(
                f"    anomaly[{a.get('window')}] {a.get('signal')} "
                f"({a.get('kind')}): value={a.get('value')} "
                f"baseline={a.get('baseline')}"
            )
    bundles = snapshot.get("bundles")
    if bundles:
        trig = ",".join(
            f"{k}={v}"
            for k, v in sorted((bundles.get("by_trigger") or {}).items())
        )
        written = bundles.get("written") or ()
        n_written = (
            len(written) if isinstance(written, (list, tuple)) else written
        )
        lines.append(
            f"  bundles: captures={bundles.get('captures', 0)} "
            f"written={n_written} "
            f"missed={bundles.get('missed', 0)} "
            f"triggers=[{trig or '-'}]"
        )
    return "\n".join(lines)
