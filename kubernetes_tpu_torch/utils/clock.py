"""Injectable clock, mirroring k8s.io/utils/clock — the queue/cache tests
need deterministic time (reference queue tests inject
k8s.io/utils/clock/testing#FakeClock).

Two faces:

- ``now()``   — the scheduling clock (backoff expiry, assume TTLs, permit
  deadlines, e2e latency bases). Monotonic wall time on the real clock.
- ``perf()``  — the duration clock (metric observations, solve/host wall
  splits). ``time.perf_counter`` on the real clock.
- ``unix_ns()`` — span stamps in integer Unix nanoseconds, the clock
  ``torch.profiler`` puts device events on. ``time.time_ns`` on the real
  clock.

``FakeClock`` drives all three from one virtual timeline so the cluster
simulator (``kubernetes_tpu/sim``) runs fully virtual-time: no test ever
sleeps, and a recorded trace replays bit-for-bit regardless of host
speed.

Copied from ``kubernetes_tpu/utils/clock.py``.
"""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        return time.monotonic()

    def perf(self) -> float:
        return time.perf_counter()

    def unix_ns(self) -> int:
        return time.time_ns()

    def sleep(self, seconds: float) -> None:
        """Blocking wait on the clock's timeline (BulkClient's retry
        backoff); the fake clock advances virtually instead, so
        backoff paths are testable without real delay."""
        time.sleep(seconds)


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def perf(self) -> float:
        return self._now

    def unix_ns(self) -> int:
        return round(self._now * 1e9)

    def advance(self, seconds: float) -> None:
        self._now += seconds

    def set(self, t: float) -> None:
        self._now = t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)
