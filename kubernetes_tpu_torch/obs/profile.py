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

Copied from ``kubernetes_tpu/obs/profile.py``.
"""

from __future__ import annotations

import threading
from collections import deque

from .. import metrics

STAGES = (
    "tensorize",
    "dispatch",
    "fence_wait",
    "deferred_read",
    "validate",
    "apply",
    "bind",
)


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


# within-batch deltas folded into each ledger entry: transfer volume
# and the chain/split/discard decisions the loops tick. All host-side
# cells (the device never syncs to serve a read here).
_DELTA_READERS = {
    "h2d_bytes": lambda: _cell(metrics.h2d_bytes_total),
    "d2h_bytes": lambda: _cell(metrics.d2h_bytes_total),
    "subbatches": lambda: _cell(metrics.pipeline_subbatches_total),
    "solve_discards": lambda: _cell(metrics.solves_discarded_total),
    "slot_discards": lambda: _cell(metrics.stream_slot_discard_total),
    "unhidden_reads": lambda: _cell(metrics.stream_unhidden_reads_total),
}


class StageProfiler:
    """Always-on per-batch stage attribution.

    The loops call :meth:`add` at the seams they already time and
    :meth:`observe_batch` once per applied batch (next to the SLO
    tick in ``_commit_all``); readers call :meth:`snapshot` from any
    thread. ``capacity`` bounds the ledger — a serving process retains
    the recent history, never the run.
    """

    def __init__(self, clock=None, capacity: int = 512) -> None:
        import time as _time

        self._perf = clock.perf if clock is not None else _time.perf_counter
        self._ledger: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # stages accumulated since the last observe_batch (the loops'
        # add() calls between two commits belong to the batch closing)
        self._pending: dict[str, float] = {}
        self._totals = {s: 0.0 for s in STAGES}
        self._counters = {k: r() for k, r in _DELTA_READERS.items()}
        self._last_t: float | None = None
        self.batches = 0
        self.pods = 0
        self._stage_cells = {
            s: metrics.profile_stage_seconds.labels(s) for s in STAGES
        }

    # -- driver-thread writes --

    def add(self, stage: str, seconds: float) -> None:
        """Attribute ``seconds`` of already-measured wall time to a
        stage of the batch currently in flight."""
        if seconds <= 0.0:
            return
        self._pending[stage] = self._pending.get(stage, 0.0) + seconds

    def observe_batch(self, *, step: int, pods: int) -> dict:
        """Close the in-flight batch's ledger entry: fold the pending
        stage seconds and the counter deltas since the previous batch,
        tick the stage metrics, append to the bounded ledger."""
        now = self._perf()
        wall = 0.0 if self._last_t is None else max(now - self._last_t, 0.0)
        self._last_t = now
        stages = {s: self._pending.get(s, 0.0) for s in STAGES}
        self._pending.clear()
        deltas = {}
        for k, read in _DELTA_READERS.items():
            cur = read()
            deltas[k] = cur - self._counters[k]
            self._counters[k] = cur
        entry = {
            "step": step,
            "pods": pods,
            "wall_s": round(wall, 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            **{k: round(v, 1) for k, v in deltas.items()},
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
        accounted = sum(totals.values())
        return {
            "batches": batches,
            "pods": pods,
            "stage_seconds": {
                s: round(totals[s], 6) for s in STAGES
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
