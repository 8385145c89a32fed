"""Replayable trace format for the cluster simulator.

A trace is a JSON-lines stream, written in strict chronological order:

- one ``{"k": "h", ...}`` header (seed, profile, cycle count, harness
  config) — enough to re-derive a fresh run;
- ``{"k": "e", "c": <cycle>, "op": ..., ...}`` churn events, exactly as
  the generators produced them (pods/nodes serialized through the api
  objects' wire shapes, so replay rebuilds identical objects);
- ``{"k": "d", "t": <tag>, "x": <value>}`` fault **decisions** — every
  point where an injector consulted randomness DURING a scheduler run
  (bind faults, watch-delivery pumps, duplications, extender verdicts,
  permit stalls). Their count depends on scheduler-internal call
  sequences, so they are journaled by consumption order instead of
  being re-derived;
- one ``{"k": "f", ...}`` footer (final bindings, violations, summary).

Replay applies the event lines literally and feeds the decision lines
back through the same injectors (``DecisionJournal`` in replay mode),
so a recorded failure reproduces bit-for-bit even if the generator code
has since changed. Determinism of a *fresh* run is separate and
stronger: same seed + profile ⇒ byte-identical trace (the CLI's
``--selfcheck`` and scripts/ci.sh verify this).

Nothing wall-clock ever enters a trace — the harness runs on
``utils.clock.FakeClock`` virtual time.

Copied from ``kubernetes_tpu/sim/trace.py``.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path


def canonical(obj) -> str:
    """One canonical JSON encoding so traces are byte-comparable."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class TraceWriter:
    def __init__(self) -> None:
        self.lines: list[str] = []

    def write(self, record: dict) -> None:
        self.lines.append(canonical(record))

    def header(self, **fields) -> None:
        self.write({"k": "h", "v": 1, **fields})

    def event(self, cycle: int, op: str, **fields) -> None:
        self.write({"k": "e", "c": cycle, "op": op, **fields})

    def decision(self, tag: str, value) -> None:
        self.write({"k": "d", "t": tag, "x": value})

    def footer(self, **fields) -> None:
        self.write({"k": "f", **fields})

    def digest(self) -> str:
        h = hashlib.sha256()
        for line in self.lines:
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    def dump(self, path: str | Path) -> None:
        Path(path).write_text("\n".join(self.lines) + "\n")


class TraceError(Exception):
    """A replay diverged from (or could not parse) its trace."""


class TraceReader:
    """Parsed trace: header dict, events grouped by cycle, decisions in
    consumption order, footer dict (None when the run died mid-write)."""

    def __init__(self, lines: list[str]) -> None:
        self.header: dict | None = None
        self.events_by_cycle: dict[int, list[dict]] = {}
        self.decisions: list[dict] = []
        self.footer: dict | None = None
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise TraceError(f"line {i + 1}: not JSON: {e}") from e
            kind = rec.get("k")
            if kind == "h":
                self.header = rec
            elif kind == "e":
                self.events_by_cycle.setdefault(int(rec["c"]), []).append(rec)
            elif kind == "d":
                self.decisions.append(rec)
            elif kind == "f":
                self.footer = rec
            else:
                raise TraceError(f"line {i + 1}: unknown record kind {kind!r}")
        if self.header is None:
            raise TraceError("trace has no header record")

    @classmethod
    def load(cls, path: str | Path) -> "TraceReader":
        return cls(Path(path).read_text().splitlines())
