"""Per-pod decision journal: one JSONL record per pod per solved batch,
so "why is pod X still pending" is answerable from a file instead of a
re-run under the profiler.

Each record carries the pod's **outcome** for that batch and, for
unschedulable pods, **per-plugin filter attribution** computed from the
already-materialized host-side solve tensors (``_PreparedGroup``'s
numpy tables: pod requests, node capacities, the static class mask, the
port occupancy vocab). No device read happens here — the assignments
were already downloaded through the one sanctioned deferred-read point
(``analysis/registry.py``), and everything else lives on the host, so
journaling is TPU001-clean by construction.

Attribution granularity follows what the tensors materialize:

- ``NodeResourcesFit``   — request vs (allocatable - used) + pod count,
  from the NodeBatch/PodBatch tensors;
- ``NodeAffinity``       — the fused static-family mask row (NodeName,
  NodeUnschedulable, TaintToleration, NodeAffinity, volume plugins,
  plus any folded out-of-tree/extender/DRA verdicts), reported under
  the family's dominant member like the scheduler's per-plugin timing
  metric does;
- ``NodePorts``          — the pod's conflict vocab vs per-node port
  occupancy;
- residual rejections (nodes every host-side mask accepts but the
  solve still rejected) are attributed to the in-scan constraint the
  pod actually carries — ``PodTopologySpread`` / ``InterPodAffinity``
  — or to ``BatchCarriedUsage`` (capacity consumed by earlier pods of
  the same batch, which only exists device-side).

Determinism contract (shared with ``sim/trace.py``): records are
canonical JSON with sorted keys, timestamps come off the injectable
``Clock``, and attribution is pure numpy over deterministic inputs —
two same-seed simulator runs produce **byte-identical** journals.

Copied from ``kubernetes_tpu/obs/journal.py``.
"""

from __future__ import annotations

import json

import numpy as np

from .. import metrics
from ..utils.clock import Clock
from .recorder import canonical

SCHEMA_VERSION = 1

OUTCOMES = frozenset(
    {
        "bound",
        "unschedulable",
        "bind_failure",
        "permit_wait",
        "permit_rejected",
        "permit_timeout",
        "discarded",
        # a solve-boundary failure (device error / corrupt output /
        # poison batch) requeued this pod for a retry — the retry
        # history `explain <pod>` shows (non-terminal)
        "solver_error",
        # poison-batch bisection isolated the solve failure to this
        # pod: it sits out a TTL'd backoff before re-admission
        "quarantined",
        # a fresh scheduler incarnation's cold-start recovery pass
        # re-adopted this pod from cluster truth after a crash orphaned
        # it mid-flight (assumed/parked/queued state evaporated with
        # the dead process)
        "recovered",
        # the continuous rebalancer evicted this bound pod to
        # defragment (kubernetes_tpu/rebalance): node= the source,
        # nominated= the auction's target hint. Non-terminal — the pod
        # re-enters the queue and its next attempt journals the
        # migration's outcome.
        "evicted_for_rebalance",
        # the pod's gang (kubernetes_tpu/gang) did not land whole this
        # round — a member failed, the quorum never assembled, or the
        # atomic commit was released — so every staged placement was
        # rolled back and the gang requeued. Non-terminal: the gang
        # retries as a unit (a partial gang is never bound).
        "gang_incomplete",
        # the telemetry sentinel fired an anomaly (flight telemetry
        # tentpole): the "pod" is the synthetic `telemetry/<signal>`
        # carrier, never a cluster pod, so completeness invariants —
        # which iterate real pods — ignore it. Non-terminal and
        # non-retiring by construction (there is no journey to retire).
        "telemetry_anomaly",
    }
)
# a pod whose LAST journal record is one of these has a settled fate for
# the run; permit_wait, discarded, and solver_error always lead to
# another attempt. quarantined IS terminal: the pod's fate is settled
# and attributable (the re-admit after the TTL starts a new history).
# recovered IS terminal for the same cross-incarnation reason: it closes
# a history the crash left dangling (permit_wait/discarded/solver_error
# with no process left to continue it) — the adopting incarnation's own
# records then form the pod's next history.
TERMINAL_OUTCOMES = frozenset(
    {
        "bound", "unschedulable", "bind_failure", "permit_rejected",
        "permit_timeout", "quarantined", "recovered",
    }
)

# outcomes that RETIRE a pod's journey trace (obs tentpole): the pod's
# current scheduling journey is over — a later re-entry (rebalance
# migration, quarantine re-admit, a fresh incarnation's adoption)
# starts a new history with a fresh trace. Deliberately narrower than
# TERMINAL_OUTCOMES: unschedulable/bind_failure/permit verdicts retry
# the SAME journey, and a trace must survive those retries (and fleet
# handoffs between them) to render as one chain.
_TRACE_RETIRING_OUTCOMES = frozenset({"bound", "quarantined", "recovered"})

_REQUIRED_KEYS = ("k", "v", "step", "cycle", "pod", "outcome", "t")

# optional decision-record fields and their required types — the schema
# catch-up covering everything added since PR 3: journal tags
# (``replica``/``incarnation`` from the fleet/restart layers,
# ``drain_chunk``/``drain_trace`` from backlog drains), the journey
# ``trace`` id the cross-replica handoff propagates, and the per-record
# extras. ``validate_line`` is STRICT about key membership: a field
# added to the writer without a validator entry fails tier-1 (and the
# CI obs smoke) instead of silently passing validate — that is the
# drift gate.
_OPTIONAL_FIELDS: dict[str, type] = {
    "uid": str,
    "node": str,
    "reason": str,
    "profile": str,
    "nominated": str,
    "replica": str,
    "trace": str,
    "attempts": int,
    "incarnation": int,
    "drain_chunk": int,
    "drain_trace": int,
    "plugins": dict,
}
_KNOWN_KEYS = frozenset(_REQUIRED_KEYS) | frozenset(_OPTIONAL_FIELDS)

# span records: required keys plus the optional ones every emitting
# site may attach (parent/status/attrs — tuning spans, dispatch spans,
# the recover/bisect roots all stay inside this surface)
_SPAN_REQUIRED = ("name", "span", "trace", "start", "end", "dur")
_SPAN_KNOWN = frozenset(_SPAN_REQUIRED) | {
    "k", "v", "parent", "status", "attrs", "t0_ns", "t1_ns",
}


def fleet_merge_key(rec: dict) -> tuple:
    """The PR 8 cross-replica journal merge/tie-break key, shared
    between the fleet sim's journal-completeness invariant and
    ``obs explain --fleet``: latest virtual time wins; on a t-tie
    prefer terminal, then ``bound`` (a bind is irrevocable — a fenced
    zombie's same-instant ``bind_failure`` can never supersede the
    survivor's successful bind), then the within-replica step (steps
    are NOT comparable across replicas, so it only breaks same-replica
    ties)."""
    return (
        rec["t"],
        1 if rec["outcome"] in TERMINAL_OUTCOMES else 0,
        1 if rec["outcome"] == "bound" else 0,
        rec["step"],
    )


def attribute_failure(prep, idx: int) -> dict[str, list[int]]:
    """Per-plugin ``{name: [rejected, of]}`` for pod ``idx`` of a
    prepared group, from the group's host tensors. ``of`` is the live
    node count; families that rejected nothing are omitted."""
    slot_nodes = prep.slot_nodes
    valid = [j for j, n in enumerate(slot_nodes) if n is not None]
    total = len(valid)
    out: dict[str, list[int]] = {}
    if not total:
        return out
    vs = np.asarray(valid, dtype=np.int64)
    batch, pbatch, static = prep.batch, prep.pbatch, prep.static

    req = pbatch.req[idx]  # [K]
    free = batch.allocatable[:, vs] - batch.used[:, vs]
    fit_ok = (req[:, None] <= free).all(axis=0) & (
        batch.pod_count[vs] + 1 <= batch.max_pods[vs]
    )
    if not bool(pbatch.feasible_static[idx]):
        # requests a resource no node advertises: every node fails Fit
        fit_ok[:] = False
    n = int((~fit_ok).sum())
    if n:
        out["NodeResourcesFit"] = [n, total]

    static_ok = static.mask[int(static.class_of[idx])][vs]
    n = int((~static_ok).sum())
    if n:
        out["NodeAffinity"] = [n, total]

    ports_ok = np.ones(total, dtype=bool)
    ports = prep.ports
    if ports is not None and ports.num_ports:
        conflict_rows = np.nonzero(ports.pod_conflict[idx])[0]
        if conflict_rows.size:
            ports_ok = ~(ports.used[np.ix_(conflict_rows, vs)] > 0).any(axis=0)
            n = int((~ports_ok).sum())
            if n:
                out["NodePorts"] = [n, total]

    residual = int((fit_ok & static_ok & ports_ok).sum())
    if residual:
        pod = prep.pods[idx]
        if pod.topology_spread_constraints:
            label = "PodTopologySpread"
        elif pod.affinity is not None and (
            pod.affinity.pod_affinity is not None
            or pod.affinity.pod_anti_affinity is not None
        ):
            label = "InterPodAffinity"
        else:
            label = "BatchCarriedUsage"
        out[label] = [residual, total]
    return out


def summarize_plugins(plugins: dict[str, list[int]]) -> str:
    """Human line for a plugins dict: 'NodeResourcesFit rejected 14/16
    nodes, PodTopologySpread 2/16' (the ISSUE's explain shape)."""
    if not plugins:
        return ""
    parts = []
    for name in sorted(plugins):
        rej, of = plugins[name]
        parts.append(f"{name} rejected {rej}/{of} nodes")
    return ", ".join(parts)


class PodDecisionJournal:
    """Collects decision records in memory (``lines``), fans them out to
    the flight recorder and an optional line sink (streaming JSONL
    file). One instance per Scheduler; all writes happen on scheduler
    threads that already serialize per batch."""

    def __init__(
        self,
        clock: Clock | None = None,
        recorder=None,
        sink=None,
        capacity: int | None = None,
    ):
        self.clock = clock or Clock()
        self.recorder = recorder
        self.sink = sink
        # capacity=None keeps every line (the sim's byte-identity and
        # completeness contracts need the full history); a long-running
        # serve process passes a bound and relies on the streaming sink
        # for durability, so memory stays O(capacity).
        #
        # Serialization is LAZY: ``record`` appends the dict to a
        # pending list and the canonical-JSON encode runs at the first
        # ``lines`` read (per-cycle fleet shipping, sim finish, dump,
        # /debug) — off the per-pod hot path, where the obs-overhead
        # ladder budgets the whole layer at <= 5%. The byte contract is
        # unchanged: canonical() is deterministic whenever it runs.
        if capacity is None:
            self._lines: list[str] = []
        else:
            from collections import deque

            self._lines = deque(maxlen=capacity)
        self._pending: list[dict] = []
        # constant fields merged into every record (e.g. the fleet
        # replica identity) — set once at wiring time, before any
        # record is written, so same-seed runs stay byte-identical
        self.tags: dict = {}
        # journey-trace propagation (the cross-replica tentpole): pod
        # key -> the trace id its whole scheduling journey shares. The
        # FIRST record for a pod mints "<origin>:<step>" (origin = the
        # writing replica/incarnation identity set at wiring time);
        # every later record re-uses it, a fleet handoff ships it on
        # the handoff row so the ADOPTING replica's records continue
        # the SAME trace, and a terminal outcome retires it (a
        # post-terminal re-admit — quarantine TTL, rebalance eviction —
        # starts a fresh history with a fresh trace, the documented
        # history semantics). Deterministic: derived from the step
        # counter the records already carry.
        self.pod_traces: dict[str, str] = {}
        self.origin: str = "s-1"
        # monotone record count (never decremented by a bounded deque's
        # eviction): the fleet journal-shipping cursor reads this
        self.total_records = 0
        # per-outcome metric children resolved once, and the prometheus
        # inc BATCHED python-side (one mutex-guarded float add per
        # record is measurable at per-pod journal volume): counts
        # accumulate in a plain dict and flush to the registry at every
        # ``lines`` read / pending flush
        self._outcome_counters: dict = {}
        self._outcome_pending: dict[str, int] = {}

    def record(
        self,
        step: int,
        cycle: int,
        pod,
        outcome: str,
        *,
        node: str = "",
        reason: str = "",
        plugins: dict | None = None,
        profile: str = "",
        attempts: int = 0,
        nominated: str = "",
    ) -> dict:
        rec: dict = {
            "k": "dec",
            "v": SCHEMA_VERSION,
            "step": step,
            "cycle": cycle,
            "pod": pod.key,
            "uid": pod.uid or "",
            "outcome": outcome,
            "t": self.clock.now(),
        }
        if node:
            rec["node"] = node
        if reason:
            rec["reason"] = reason
        if plugins:
            rec["plugins"] = plugins
        if profile:
            rec["profile"] = profile
        if attempts:
            rec["attempts"] = attempts
        if nominated:
            rec["nominated"] = nominated
        trace = self.pod_traces.get(pod.key)
        if trace is None:
            # origin identity + minting step + pod key: unique per
            # journey, deterministic, and self-describing about WHERE
            # the journey started (the handoff row ships it onward)
            trace = f"{self.origin}:{step}:{pod.key}"
            self.pod_traces[pod.key] = trace
        rec["trace"] = trace
        if outcome in _TRACE_RETIRING_OUTCOMES:
            # the journey genuinely ended: bound (a later rebalance
            # eviction starts a migration journey), quarantined (the
            # TTL re-admit starts a new history — documented), or
            # recovered (the adopting incarnation's records form the
            # next history). NOT every TERMINAL outcome: unschedulable
            # / bind_failure / permit verdicts lead to retries of the
            # SAME journey, and retiring there would shatter one
            # journey into per-attempt traces.
            self.pod_traces.pop(pod.key, None)
        if self.tags:
            rec.update(self.tags)
        self.total_records += 1
        self._pending.append(rec)
        self._outcome_pending[outcome] = (
            self._outcome_pending.get(outcome, 0) + 1
        )
        if len(self._pending) >= 4096:
            # amortized flush bound: a serve process that is never
            # read must not grow the pending list without limit
            self._flush_pending()
        if self.recorder is not None:
            self.recorder.record_decision(rec)
        if self.sink is not None:
            self.sink(rec)
        return rec

    def unschedulable(
        self, step: int, cycle: int, pod, prep, idx: int, *,
        reason: str = "", nominated: str = "", attempts: int = 0,
    ) -> dict:
        """The failure-path record: outcome + per-plugin attribution
        from the group's materialized tensors."""
        return self.record(
            step, cycle, pod, "unschedulable",
            reason=reason,
            plugins=attribute_failure(prep, idx),
            profile=prep.profile,
            nominated=nominated,
            attempts=attempts,
        )

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, []
        self._lines.extend(canonical(r) for r in pending)
        counts, self._outcome_pending = self._outcome_pending, {}
        for outcome, n in counts.items():
            counter = self._outcome_counters.get(outcome)
            if counter is None:
                counter = self._outcome_counters[outcome] = (
                    metrics.journal_records_total.labels(outcome)
                )
            counter.inc(n)

    @property
    def lines(self):
        """The canonical-JSONL record lines (list for unbounded
        journals, deque for bounded ones). Flushes the lazily-held
        pending records through ``canonical`` first — every reader
        sees the complete, deterministic byte stream."""
        if self._pending:
            self._flush_pending()
        return self._lines

    def dump(self, path) -> None:
        from pathlib import Path

        Path(path).write_text("\n".join(self.lines) + "\n")

    def last_outcomes(self) -> dict[str, dict]:
        """pod key -> its most recent record (the sim's completeness
        invariant reads this)."""
        out: dict[str, dict] = {}
        for line in self.lines:
            rec = json.loads(line)
            out[rec["pod"]] = rec
        return out


def validate_line(line: str) -> str | None:
    """Schema check for one journal/flight-recorder JSONL line. Returns
    an error string, or None when valid. Span lines (``k == "span"``)
    are accepted and shallow-checked; unknown kinds are errors.

    STRICT about key membership on both kinds: a writer-side field
    added without a matching ``_OPTIONAL_FIELDS`` / ``_SPAN_KNOWN``
    entry is a validation error, so schema drift fails tier-1 (and the
    CI obs smoke, which validates a freshly recorded journal) instead
    of silently passing."""
    try:
        rec = json.loads(line)
    except ValueError as e:
        return f"not JSON: {e}"
    if not isinstance(rec, dict):
        return "not a JSON object"
    kind = rec.get("k")
    if kind == "span":
        for key in _SPAN_REQUIRED:
            if key not in rec:
                return f"span record missing {key!r}"
        for key in rec:
            if key not in _SPAN_KNOWN:
                return f"span record has unknown field {key!r}"
        if "attrs" in rec and not isinstance(rec["attrs"], dict):
            return "span attrs is not an object"
        if "status" in rec and rec["status"] not in ("ok", "error"):
            return f"span status {rec['status']!r} not ok|error"
        return None
    if kind != "dec":
        return f"unknown record kind {kind!r}"
    for key in _REQUIRED_KEYS:
        if key not in rec:
            return f"decision record missing {key!r}"
    for key in rec:
        if key not in _KNOWN_KEYS:
            return f"decision record has unknown field {key!r}"
    if rec["v"] != SCHEMA_VERSION:
        return f"unsupported schema version {rec['v']!r}"
    if not isinstance(rec["pod"], str):
        return "field 'pod' is not a string"
    for key in ("step", "cycle"):
        if not isinstance(rec[key], int) or isinstance(rec[key], bool):
            return f"field {key!r} is not an integer"
    if not isinstance(rec["t"], (int, float)) or isinstance(
        rec["t"], bool
    ):
        return "field 't' is not a number"
    if rec["outcome"] not in OUTCOMES:
        return f"unknown outcome {rec['outcome']!r}"
    for key, typ in _OPTIONAL_FIELDS.items():
        if key in rec and not isinstance(rec[key], typ):
            return (
                f"field {key!r} is {type(rec[key]).__name__}, "
                f"expected {typ.__name__}"
            )
    # int-typed fields must not be bools (bool subclasses int)
    for key in ("attempts", "incarnation", "drain_chunk", "drain_trace"):
        if key in rec and isinstance(rec[key], bool):
            return f"field {key!r} is bool, expected int"
    plugins = rec.get("plugins")
    if plugins is not None:
        for name, pair in plugins.items():
            if (
                not isinstance(pair, list)
                or len(pair) != 2
                or not all(isinstance(x, int) for x in pair)
            ):
                return f"plugins[{name!r}] is not [rejected, of]"
    return None


def validate_lines(lines) -> list[str]:
    """All schema errors across an iterable of lines (empty = valid)."""
    errors = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        err = validate_line(line)
        if err is not None:
            errors.append(f"line {i + 1}: {err}")
    return errors
