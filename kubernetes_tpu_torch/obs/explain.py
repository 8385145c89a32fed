"""Reconstruct one pod's scheduling history from a decision journal (or
a flight-recorder dump): the `kubectl describe pod` events story, but
sourced from the scheduler's own trace layer and including per-plugin
rejection attribution.

Input is any JSONL stream mixing ``{"k": "dec"}`` decision records and
``{"k": "span"}`` spans (a journal file, a flight-recorder dump, or the
``/debug/flightrecorder`` JSON body re-flattened by the CLI). Pods
match by exact uid, exact ``ns/name`` key, or bare pod name.

``--fleet`` mode (``explain_pod(..., fleet=True)``) reconstructs the
CROSS-REPLICA history: the input is replicas' merged journals (the hub
aggregation surface, several per-replica files, or one combined dump),
records are ordered by the PR 8 fleet merge/tie-break key
(``journal.fleet_merge_key`` — the same rule the fleet sim's
journal-completeness invariant proved), and the render shows each
record's writing replica plus the journey ``trace`` id the handoff
rows propagated, so an enqueue→handoff→re-admit→solve→bind journey
reads as ONE trace even though it crossed processes.

Copied from ``kubernetes_tpu/obs/explain.py``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from .journal import TERMINAL_OUTCOMES, fleet_merge_key, summarize_plugins

# gang-record reason shapes (scheduler.py _gang_gate / _release_gang_round
# / _quarantine_gang write these verbatim — the parse below is the read
# side of that contract)
_GANG_PARK = re.compile(
    r"waiting for pod group (?P<gid>\S+): "
    r"(?P<have>\d+)/(?P<need>\d+) members present"
)
_GANG_GID = re.compile(r"pod group (?P<gid>[^\s:]+)")


@dataclass
class Explanation:
    ref: str
    records: list[dict] = field(default_factory=list)  # journal order
    spans: list[dict] = field(default_factory=list)  # terminal batch's spans
    fleet: bool = False  # cross-replica mode (render replica columns)

    @property
    def found(self) -> bool:
        return bool(self.records)

    @property
    def replicas(self) -> list[str]:
        """Writing replicas in first-appearance order (the handoff
        chain the pod traversed)."""
        seen: list[str] = []
        for rec in self.records:
            r = rec.get("replica", "")
            if r and r not in seen:
                seen.append(r)
        return seen

    @property
    def traces(self) -> list[str]:
        """Distinct journey trace ids in first-appearance order. A
        single-element list is the propagation proof: every record —
        across every replica — shares one trace."""
        seen: list[str] = []
        for rec in self.records:
            t = rec.get("trace", "")
            if t and t not in seen:
                seen.append(t)
        return seen

    @property
    def gang_events(self) -> list[dict]:
        """The pod's gang assembly chain, reconstructed from its
        ``gang_incomplete`` / gang-quarantine records: per round, the
        pod group id, how many of N members were present (parked
        rounds), which member's failure released a staged round, and
        the quarantine verdict. Empty for non-gang pods."""
        events: list[dict] = []
        for rec in self.records:
            outcome = rec.get("outcome", "")
            reason = rec.get("reason", "")
            if outcome == "gang_incomplete":
                park = _GANG_PARK.search(reason)
                if park:
                    events.append(
                        {
                            "kind": "parked",
                            "step": rec.get("step"),
                            "gid": park.group("gid"),
                            "have": int(park.group("have")),
                            "need": int(park.group("need")),
                        }
                    )
                    continue
                kind = "released"
                if reason.startswith("gang quarantined:"):
                    kind = "quarantine_release"
                elif reason.startswith("gang bind failed:"):
                    kind = "bind_failed"
                gid = _GANG_GID.search(reason)
                events.append(
                    {
                        "kind": kind,
                        "step": rec.get("step"),
                        "gid": gid.group("gid") if gid else "",
                        "reason": reason,
                    }
                )
            elif outcome == "quarantined" and "pod group" in reason:
                gid = _GANG_GID.search(reason)
                events.append(
                    {
                        "kind": "quarantined",
                        "step": rec.get("step"),
                        "gid": gid.group("gid") if gid else "",
                        "reason": reason,
                    }
                )
        return events

    @property
    def terminal(self) -> dict | None:
        """The pod's last terminal-outcome record (None = still open:
        every record is a permit_wait/discarded intermediate)."""
        for rec in reversed(self.records):
            if rec.get("outcome") in TERMINAL_OUTCOMES:
                return rec
        return None

    def render(self) -> str:
        if not self.records:
            return f"pod {self.ref!r}: no journal records found"
        first = self.records[0]
        uid = first.get("uid") or "?"
        lines = [f"pod {first['pod']} (uid {uid}): {len(self.records)} record(s)"]
        if self.fleet:
            reps = self.replicas
            lines.append(
                "  replicas: "
                + (" -> ".join(reps) if reps else "(none tagged)")
            )
            traces = self.traces
            if len(traces) == 1:
                lines.append(f"  trace: {traces[0]} (one journey trace)")
            elif traces:
                lines.append(
                    f"  trace: {len(traces)} distinct journeys "
                    f"({', '.join(traces)})"
                )
        term = self.terminal
        if term is None:
            last = self.records[-1]
            lines.append(
                f"  state: OPEN — last record is {last['outcome']!r} at "
                f"step {last['step']} (no terminal outcome yet)"
            )
        elif term["outcome"] == "bound":
            lines.append(
                f"  terminal outcome: bound to {term.get('node', '?')} "
                f"(step {term['step']}, t={term['t']})"
            )
        else:
            lines.append(
                f"  terminal outcome: {term['outcome']} "
                f"(step {term['step']}, t={term['t']})"
            )
            if term.get("plugins"):
                lines.append(f"    plugins: {summarize_plugins(term['plugins'])}")
            if term.get("reason"):
                lines.append(f"    reason: {term['reason']}")
        gang = self.gang_events
        if gang:
            gid = next((e["gid"] for e in gang if e["gid"]), "?")
            lines.append(f"  gang assembly (pod group {gid}):")
            for e in gang:
                if e["kind"] == "parked":
                    lines.append(
                        f"    step {e['step']}: parked — "
                        f"{e['have']}/{e['need']} members present"
                    )
                elif e["kind"] == "quarantined":
                    lines.append(
                        f"    step {e['step']}: quarantined — {e['reason']}"
                    )
                else:
                    verb = {
                        "released": "round released",
                        "bind_failed": "atomic bind failed, round released",
                        "quarantine_release": (
                            "staged round rolled back for quarantine"
                        ),
                    }[e["kind"]]
                    lines.append(
                        f"    step {e['step']}: {verb} — {e['reason']}"
                    )
        lines.append("  history:")
        for rec in self.records:
            bits = [
                f"step {rec['step']}",
                f"cycle {rec['cycle']}",
                f"t={rec['t']}",
                rec["outcome"],
            ]
            if self.fleet and rec.get("replica"):
                bits.insert(0, f"[{rec['replica']}]")
            if rec.get("node"):
                bits.append(f"-> {rec['node']}")
            if rec.get("nominated"):
                bits.append(f"nominated={rec['nominated']}")
            if rec.get("attempts"):
                bits.append(f"attempt {rec['attempts']}")
            if rec.get("drain_chunk") is not None:
                # backlog drains (Scheduler.drain_backlog) tag records
                # with the chunk that solved them
                bits.append(f"drain_chunk={rec['drain_chunk']}")
            line = "    " + " ".join(bits)
            if rec.get("plugins"):
                line += f"  [{summarize_plugins(rec['plugins'])}]"
            if rec.get("reason"):
                line += f"  ({rec['reason']})"
            lines.append(line)
        if self.spans:
            lines.append("  spans of the terminal batch:")
            for sp in self.spans:
                indent = "      " if sp.get("parent") else "    "
                lines.append(
                    f"{indent}{sp['name']}: {sp['dur'] * 1e3:.3f} ms"
                    + (f" {sp['attrs']}" if sp.get("attrs") else "")
                )
        return "\n".join(lines)


def parse_stream(lines) -> tuple[list[dict], list[dict]]:
    """(decisions, spans) from a JSONL iterable; unknown/broken lines
    are skipped (a flight-recorder dump may be truncated mid-crash)."""
    decisions: list[dict] = []
    spans: list[dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        kind = rec.get("k") if isinstance(rec, dict) else None
        if kind == "dec":
            decisions.append(rec)
        elif kind == "span":
            spans.append(rec)
    return decisions, spans


def _matches(rec: dict, ref: str) -> bool:
    if rec.get("uid") == ref or rec.get("pod") == ref:
        return True
    pod = rec.get("pod") or ""
    return "/" in pod and pod.split("/", 1)[1] == ref


def merge_fleet_records(records: list[dict]) -> list[dict]:
    """Total-order one pod's records gathered from SEVERAL replicas'
    journals: the PR 8 merge/tie-break key first (latest-t wins,
    terminal then 'bound' preferred on ties, within-replica step as
    the same-replica tiebreak), the writing replica as the final
    cross-replica determinism tiebreak. Byte-deterministic for any
    input permutation of the same record set — the `--selfcheck`
    contract of the fleet explain smoke."""
    return sorted(
        records,
        key=lambda r: (fleet_merge_key(r), r.get("replica", "")),
    )


def explain_pod(
    decisions: list[dict],
    ref: str,
    spans: list[dict] | None = None,
    fleet: bool = False,
) -> Explanation:
    records = [r for r in decisions if _matches(r, ref)]
    if fleet:
        records = merge_fleet_records(records)
    out = Explanation(ref=ref, records=records, fleet=fleet)
    term = out.terminal
    if term is not None and spans:
        if fleet:
            # step counters are per-replica (the merge key's own
            # caveat), so a bare-step join would attach another
            # replica's unrelated batch: require the span to carry the
            # terminal record's replica tag too (the scheduler's root
            # spans do; untagged spans stay unattributed rather than
            # wrongly attributed)
            term_replica = term.get("replica", "")
            out.spans = [
                s
                for s in spans
                if s.get("trace") == term["step"]
                and (s.get("attrs") or {}).get("replica", "")
                == term_replica
            ]
        else:
            out.spans = [
                s for s in spans if s.get("trace") == term["step"]
            ]
    return out
