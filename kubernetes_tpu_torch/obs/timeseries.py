"""Bounded in-memory time series over the scheduler's health signals.

The substrate under the anomaly sentinel (``obs/sentinel.py``) and the
``/debug/profile`` surface: a fixed-capacity ring of **windowed
samples**, each one the aggregation of ``window_batches`` applied
batches (pods/s over the window, p99 from the SLO engine, counter-delta
rates). Windowing is what makes the multi-window regression rules
cheap — the sentinel compares ring slices, never raw batches — and the
ring bound is what makes the whole layer safe to leave always-on in a
serving process.

Everything here is host-side arithmetic over numbers the loops already
tick (the CounterWindow discipline from ``tuning/window.py``): zero
device syncs, driver-thread writes, lock-guarded reads so the debug
endpoints can snapshot concurrently.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field


@dataclass(frozen=True)
class WindowSample:
    """One aggregated window of applied batches."""

    seq: int  # monotone window counter (0-based)
    t: float  # virtual/wall perf timestamp at window close
    batches: int  # batches aggregated into this window
    pods: int  # pods applied across the window
    signals: dict = field(default_factory=dict)  # name -> float


class TimeSeriesRing:
    """Fixed-capacity ring of :class:`WindowSample`.

    ``mean(signal, n)`` / ``mean_prev(signal, n)`` are the two reads the
    sentinel's fast-vs-slow rules need: the trailing ``n`` windows and
    the ``n`` windows immediately before them.
    """

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 4:
            raise ValueError("timeseries capacity must be >= 4")
        self._ring: deque[WindowSample] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._ring)

    def append(
        self, *, t: float, batches: int, pods: int, signals: dict
    ) -> WindowSample:
        sample = WindowSample(
            seq=self._seq, t=t, batches=batches, pods=pods,
            signals=dict(signals),
        )
        with self._lock:
            self._ring.append(sample)
            self._seq += 1
        return sample

    def last(self) -> WindowSample | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def mean(self, signal: str, n: int) -> float:
        """Mean of ``signal`` over the trailing ``n`` windows (0.0 when
        the ring is empty)."""
        with self._lock:
            tail = list(self._ring)[-n:]
        if not tail:
            return 0.0
        return sum(s.signals.get(signal, 0.0) for s in tail) / len(tail)

    def mean_prev(self, signal: str, n: int, skip: int) -> float:
        """Mean of ``signal`` over the ``n`` windows immediately before
        the trailing ``skip`` windows — the baseline the spike rule
        compares the fast window against."""
        with self._lock:
            ring = list(self._ring)
        base = ring[-(skip + n): -skip] if skip else ring[-n:]
        if not base:
            return 0.0
        return sum(s.signals.get(signal, 0.0) for s in base) / len(base)

    def snapshot(self, n: int = 32) -> list[dict]:
        """The trailing ``n`` samples as JSON-ready dicts (newest last)."""
        with self._lock:
            tail = list(self._ring)[-n:]
        return [
            {
                "seq": s.seq,
                "t": round(s.t, 6),
                "batches": s.batches,
                "pods": s.pods,
                "signals": {
                    k: round(v, 6) for k, v in sorted(s.signals.items())
                },
            }
            for s in tail
        ]
