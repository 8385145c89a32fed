"""Bounded in-memory flight recorder: the last-N spans and per-pod
decision records, always cheap enough to leave on, dumpable when
something goes wrong.

Triggers (mirroring aircraft FDR semantics — the recorder is only read
after an event):

- **crash**: the scheduler loops dump on an escaping exception
  (``Scheduler`` wires ``dump_path``);
- **invariant**: the simulator dumps when an invariant checker flags a
  violation (``sim/harness.py``);
- **manual**: ``GET /debug/flightrecorder`` on the extender server, or
  ``FlightRecorder.dump()`` from code.

The ring holds serialized dicts (not live Span objects) so a dump never
races a span still being mutated; ``collections.deque(maxlen=...)``
gives O(1) append with hard memory bounds. All mutation is
lock-guarded — the serve path records from the drain executor, the
event loop, and gRPC workers concurrently.

Copied from ``kubernetes_tpu/obs/recorder.py``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from pathlib import Path

from .. import metrics


def canonical(obj) -> str:
    """One canonical JSON encoding (sorted keys, no whitespace) so
    same-seed simulator runs dump byte-identical streams."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class FlightRecorder:
    def __init__(
        self,
        span_capacity: int = 4096,
        decision_capacity: int = 8192,
        dump_path: str | None = None,
    ) -> None:
        self._spans: deque[dict] = deque(maxlen=span_capacity)
        self._decisions: deque[dict] = deque(maxlen=decision_capacity)
        self._lock = threading.Lock()
        # default target for crash/invariant dumps; dump() may override
        self.dump_path = dump_path
        self.dropped_spans = 0
        self.dropped_decisions = 0

    # -- ingest --

    def record_span(self, span) -> None:
        d = span.as_dict() if hasattr(span, "as_dict") else dict(span)
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped_spans += 1
            self._spans.append(d)

    def record_decision(self, rec: dict) -> None:
        with self._lock:
            if len(self._decisions) == self._decisions.maxlen:
                self.dropped_decisions += 1
            self._decisions.append(rec)

    # -- read side --

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def decisions(self) -> list[dict]:
        with self._lock:
            return list(self._decisions)

    def snapshot(self) -> dict:
        """Everything the /debug endpoints serve, one consistent cut."""
        with self._lock:
            return {
                "spans": list(self._spans),
                "decisions": list(self._decisions),
                "dropped_spans": self.dropped_spans,
                "dropped_decisions": self.dropped_decisions,
            }

    def lines(self, snapshot: dict | None = None) -> list[str]:
        """The JSONL dump body: decision records then spans, each one
        canonical-JSON per line (the explain CLI reads either kind).
        Pass an already-taken ``snapshot`` to serialize exactly that
        cut instead of re-reading the live ring."""
        snap = snapshot if snapshot is not None else self.snapshot()
        return [canonical(r) for r in snap["decisions"]] + [
            canonical(s) for s in snap["spans"]
        ]

    def dump(
        self,
        path: str | None = None,
        trigger: str = "manual",
        snapshot: dict | None = None,
    ) -> str | None:
        """Write the ring (or a caller-supplied ``snapshot`` of it) to
        ``path`` (or the configured dump_path) as JSONL. Returns the
        path written, or None when no target is configured. Never
        raises — a failing dump must not mask the crash that triggered
        it."""
        target = path or self.dump_path
        metrics.flight_recorder_dumps_total.labels(trigger).inc()
        if target is None:
            return None
        try:
            Path(target).write_text(
                "\n".join(self.lines(snapshot)) + "\n"
            )
        except OSError:
            return None
        return target
