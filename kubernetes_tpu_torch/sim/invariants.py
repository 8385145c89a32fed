"""Invariant checkers the simulator runs after every scheduler drive.

Each checker is a small, separately-testable unit (mirrors the
known-bad-fixture-per-rule pattern of tests/test_static_analysis.py —
tests/test_sim_invariants.py feeds each one a crafted violation):

- ``BindTransitionTracker``  — no double-bind: watches the state
  service directly (ground truth, no injected delay) and flags any pod
  whose nodeName moves A→B, plus any pod the scheduler reports
  scheduled twice without an intervening delete;
- ``check_capacity``         — per-node allocatable is never exceeded
  by the bound-pod request sum (and pod count never exceeds the node's
  pods allocatable);
- ``check_lost_pods``        — every unbound pod this scheduler owns is
  accounted for: scheduling queue (active/backoff/unschedulable/gated),
  in-flight map, WaitingPods map, or still-undelivered watch ADDs.
  Anything else fell out of the bookkeeping and would never schedule;
- ``check_constraints``      — hard-shape placements hold: hostPort
  exclusivity per node and required hostname anti-affinity among bound
  pods (the checks guarding the pipelined loop's occupancy-carrying
  path; spread skew is deliberately unchecked — node churn re-shapes
  domains after placement);
- ``check_no_partial_gangs`` — no pod group is ever partially bound:
  a gang with one bound and one unbound live member means the atomic
  gang commit (kubernetes_tpu_torch/gang) leaked a partial bind;
- ``MonotonicCounters``      — sampled Counter series never decrease;
- ``check_resilience``       — under injected solver-boundary faults:
  the fallback ladder engaged (breaker trips), the breaker re-closed
  to the top tier after the fault window, and poison batches were
  isolated into quarantine instead of lost;
- eventual progress is checked by the harness's settle loop (bounded
  rounds of drain + virtual-clock advance), emitting a ``progress``
  violation when the loop fails to quiesce — the livelock detector the
  pipelined loop's backstop exists to satisfy.

Copied from ``kubernetes_tpu/sim/invariants.py``; ``check_telemetry``
replays bundles on the harness's device, and ``MonotonicCounters`` reads
the port's registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from .. import metrics
from ..state.cluster import ClusterState, Event


@dataclass(frozen=True)
class Violation:
    invariant: str  # double_bind | capacity | lost_pod | progress |
    # monotonic | constraint | journal | global_overcommit |
    # resilience | recovery | fencing | rebalance | gang | telemetry
    cycle: int
    detail: str

    def as_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "cycle": self.cycle,
            "detail": self.detail,
        }


def _record(violations: list[Violation], inv: str, cycle: int, detail: str):
    metrics.sim_invariant_violations_total.labels(inv).inc()
    violations.append(Violation(inv, cycle, detail))


class BindTransitionTracker:
    """Subscribes straight to the state service (never through the
    delayed bus) and accumulates double-bind violations as they
    happen. ``drain`` collects them tagged with the current cycle."""

    def __init__(self, cluster: ClusterState) -> None:
        self._node_of: dict[str, str] = {
            p.key: p.node_name for p in cluster.list_pods() if p.node_name
        }
        self._pending: list[str] = []
        self._sched_bound: set[str] = set()
        # EVICTED-pod deletes observed BEFORE the scheduler's bind
        # report for that pod drained (record_results runs once per
        # drive, so an evict-and-rebind inside one drive delivers its
        # DELETED while _sched_bound is still empty): each credit
        # legitimizes exactly one re-bind of the key. Only evictions
        # bank — the subresource emits an Events-API `Evicted` record
        # immediately before its DELETED, and keying on it keeps the
        # double-bind check strict for every OTHER bound-pod delete
        # (a churn-deleted pod's key must never legally re-bind).
        self._delete_credits: dict[str, int] = {}
        self._evict_marks: dict[str, int] = {}
        cluster.subscribe(self._on_event)

    def _on_event(self, ev: Event) -> None:
        if ev.kind == "Event":
            if getattr(ev.obj, "reason", "") == "Evicted":
                key = (
                    f"{ev.obj.regarding_namespace}/"
                    f"{ev.obj.regarding_name}"
                )
                self._evict_marks[key] = self._evict_marks.get(key, 0) + 1
            return
        if ev.kind != "Pod":
            return
        pod = ev.obj
        if ev.type == "DELETED":
            self._node_of.pop(pod.key, None)
            evicted = self._evict_marks.get(pod.key, 0) > 0
            if evicted:
                self._evict_marks[pod.key] -= 1
                if not self._evict_marks[pod.key]:
                    del self._evict_marks[pod.key]
            if pod.key in self._sched_bound:
                self._sched_bound.discard(pod.key)
            elif pod.node_name and evicted:
                # an EVICTED bound pod deleted before its bind report
                # drained: bank the delete (see _delete_credits).
                # Plain deletes and pending-pod deletes bank nothing —
                # they can't legitimize a re-bind.
                self._delete_credits[pod.key] = (
                    self._delete_credits.get(pod.key, 0) + 1
                )
            return
        if not pod.node_name:
            return
        prev = self._node_of.get(pod.key)
        if prev is not None and prev != pod.node_name:
            self._pending.append(
                f"pod {pod.key} rebound {prev} -> {pod.node_name}"
            )
        self._node_of[pod.key] = pod.node_name

    def record_results(self, scheduled: Iterable[tuple[str, str]]) -> None:
        """Feed one drive's BatchResult.scheduled entries: a pod bound
        twice by the scheduler — with neither an observed delete nor a
        banked bound-delete credit in between — is a double-bind even
        if the state service masked it."""
        for key, node in scheduled:
            if key in self._sched_bound:
                if self._delete_credits.get(key, 0) > 0:
                    self._delete_credits[key] -= 1
                    if not self._delete_credits[key]:
                        del self._delete_credits[key]
                else:
                    self._pending.append(
                        f"scheduler bound pod {key} twice (latest to {node})"
                    )
            self._sched_bound.add(key)

    def drain(self, cycle: int, violations: list[Violation]) -> None:
        for detail in self._pending:
            _record(violations, "double_bind", cycle, detail)
        self._pending.clear()


def check_capacity(
    cluster: ClusterState, cycle: int, violations: list[Violation]
) -> None:
    nodes = {n.name: n for n in cluster.list_nodes()}
    used: dict[str, dict[str, int]] = {}
    count: dict[str, int] = {}
    for pod in cluster.list_pods():
        if not pod.node_name or pod.node_name not in nodes:
            continue  # node deleted after the bind: capacity is moot
        u = used.setdefault(pod.node_name, {})
        for r, v in pod.resource_request().items():
            u[r] = u.get(r, 0) + v
        count[pod.node_name] = count.get(pod.node_name, 0) + 1
    for name in sorted(used):
        node = nodes[name]
        for r in sorted(used[name]):
            v = used[name][r]
            if r == "pods" or v <= 0:
                continue
            if v > node.allocatable.get(r, 0):
                _record(
                    violations, "capacity", cycle,
                    f"node {name}: {r} used {v} > allocatable "
                    f"{node.allocatable.get(r, 0)}",
                )
        if count.get(name, 0) > node.allowed_pod_number:
            _record(
                violations, "capacity", cycle,
                f"node {name}: {count[name]} pods > allowed "
                f"{node.allowed_pod_number}",
            )


def check_constraints(
    cluster: ClusterState, cycle: int, violations: list[Violation]
) -> None:
    """Hard-shape placement invariants over the CURRENT bound pods —
    the checks that guard the pipelined loop's occupancy-carrying path:

    - **hostPort exclusivity**: no two bound pods on one node share a
      (port, protocol). Time-robust: a real kubelet would refuse the
      second pod no matter when each bound.
    - **required hostname anti-affinity**: a bound pod whose required
      anti term (topologyKey kubernetes.io/hostname) matches ANOTHER
      pod bound to the same node. Sound here because sim pod labels are
      immutable, hostname labels never flap, and the profiles that
      generate anti shapes run no external binds (a delayed watch can
      only make the scheduler OVER-count peers — conservative).

    Topology-spread skew is deliberately NOT checked: node churn moves
    domain membership after placement, so a historical placement can
    look skewed without any scheduler bug.
    """
    by_node: dict[str, list] = {}
    for pod in cluster.list_pods():
        if pod.node_name:
            by_node.setdefault(pod.node_name, []).append(pod)
    for name in sorted(by_node):
        pods = sorted(by_node[name], key=lambda q: q.key)
        ports_seen: dict[tuple, str] = {}
        for pod in pods:
            for port in pod.host_ports():
                prev = ports_seen.get(port)
                if prev is not None:
                    _record(
                        violations, "constraint", cycle,
                        f"node {name}: hostPort {port} held by both "
                        f"{prev} and {pod.key}",
                    )
                else:
                    ports_seen[port] = pod.key
        for pod in pods:
            anti = (
                pod.affinity.pod_anti_affinity
                if pod.affinity is not None
                else None
            )
            if anti is None or not anti.required:
                continue
            for term in anti.required:
                if (
                    term.topology_key != "kubernetes.io/hostname"
                    or term.label_selector is None
                ):
                    continue
                for other in pods:
                    if other.key == pod.key:
                        continue
                    if not term.matches_namespace(
                        pod.namespace, other.namespace
                    ):
                        continue
                    if term.label_selector.matches(other.labels):
                        _record(
                            violations, "constraint", cycle,
                            f"node {name}: {pod.key} requires hostname "
                            f"anti-affinity but co-resides with "
                            f"matching pod {other.key}",
                        )
                        break


def check_no_partial_gangs(
    cluster: ClusterState, cycle: int, violations: list[Violation]
) -> None:
    """No pod group is ever partially bound (the gang tentpole's sim
    contract): a violation is a gang with at least one BOUND
    and at least one UNBOUND live member. Sound because the scheduler
    binds a gang only through ``ClusterState.bind_gang`` — atomic under
    the cluster lock — and this runs after every drive: any path that
    bound some members and released the rest would be caught here
    before the next cycle's churn. Delete churn cannot fake a
    violation (removing a bound member leaves the survivors all-bound;
    removing a queued member leaves them all-unbound), and a
    half-CREATED gang mid-arrival is all-unbound too.
    """
    from ..gang import GangTracker

    bound: dict[str, list[str]] = {}
    unbound: dict[str, list[str]] = {}
    for pod in cluster.list_pods():
        gid = GangTracker.gang_of(pod)
        if gid is None:
            continue
        side = bound if pod.node_name else unbound
        side.setdefault(gid, []).append(pod.key)
    for gid in sorted(set(bound) & set(unbound)):
        _record(
            violations, "gang", cycle,
            f"pod group {gid} is partially bound: "
            f"bound={sorted(bound[gid])} pending={sorted(unbound[gid])} "
            "— gang commit must be atomic (all members or none)",
        )


def check_lost_pods(
    cluster: ClusterState,
    scheduler,
    cycle: int,
    violations: list[Violation],
    undelivered: Callable[[], set[str]] = lambda: set(),
) -> None:
    tracked = set(scheduler.queue.entries())
    tracked |= set(scheduler._in_flight)
    tracked |= set(scheduler._waiting)
    # quarantined pods are parked by the resilience layer with a TTL'd
    # re-admit — tracked, not lost
    tracked |= set(scheduler._quarantine)
    tracked |= undelivered()
    for pod in cluster.list_pods():
        if pod.node_name or pod.scheduler_name not in scheduler.solvers:
            continue
        if pod.key not in tracked:
            _record(
                violations, "lost_pod", cycle,
                f"pod {pod.key} is unbound but tracked by neither the "
                "queue, the in-flight map, the WaitingPods map, nor an "
                "undelivered watch event",
            )


def check_journal_completeness(
    cluster: ClusterState,
    scheduler,
    cycle: int,
    violations: list[Violation],
    last_outcomes: dict[str, dict],
    sched_bound: set[str],
    undelivered: set[str] = frozenset(),
) -> None:
    """Trace-completeness invariant for the obs decision journal: every
    pod the scheduler ever owned has a journal history with a terminal
    outcome — scheduler-bound pods end on ``bound``; unbound (and
    delivered, ungated) pods end on a terminal failure outcome. A pod
    ending on a non-terminal record (``discarded``/``permit_wait``)
    after quiescence means a code path dropped the pod without
    journaling its fate — exactly the blind spot the journal exists to
    close."""
    from ..obs.journal import TERMINAL_OUTCOMES

    entries = scheduler.queue.entries()
    for pod in sorted(cluster.list_pods(), key=lambda p: p.key):
        if pod.key in undelivered:
            continue  # the scheduler cannot journal what it never saw
        rec = last_outcomes.get(pod.key)
        if pod.node_name:
            # externally-bound pods never enter a scheduling cycle;
            # only binds this scheduler reported are held to account
            if pod.key in sched_bound and (
                rec is None or rec["outcome"] != "bound"
            ):
                _record(
                    violations, "journal", cycle,
                    f"scheduler-bound pod {pod.key} lacks a terminal "
                    "'bound' journal record (last: "
                    f"{rec['outcome'] if rec else None})",
                )
            continue
        if pod.scheduler_name not in scheduler.solvers:
            continue  # ignored at queue-add, like frameworkForPod misses
        if entries.get(pod.key) == "gated":
            continue  # never entered a scheduling cycle
        if rec is None:
            _record(
                violations, "journal", cycle,
                f"unbound pod {pod.key} never appeared in the decision "
                "journal",
            )
        elif rec["outcome"] not in TERMINAL_OUTCOMES:
            _record(
                violations, "journal", cycle,
                f"unbound pod {pod.key}'s last journal outcome "
                f"{rec['outcome']!r} is non-terminal",
            )


def check_no_global_overcommit(
    cluster: ClusterState,
    cycle: int,
    violations: list[Violation],
    binds: Iterable[tuple[str, str, str]] = (),
    owners: "dict[str, str] | None" = None,
) -> None:
    """The fleet tier's flagship invariant: with N active
    replicas each solving a shard concurrently, the FLEET as a whole
    must never overcommit a node. Two halves:

    - **disjoint ownership** — every bind a replica reported this
      drive landed on a node the ring assigned to that replica at the
      time (``binds`` = (replica, pod key, node), ``owners`` = the
      node -> replica assignment snapshotted right after the drive).
      A buggy ring or a stale partition view shows up here even when
      capacity happens to hold;
    - **global capacity** — the bound-pod request sum per node never
      exceeds allocatable, counted across ALL replicas' commits (the
      single-scheduler capacity check, re-run fleet-wide — two
      replicas double-booking one node trips this even if each
      replica's local view was consistent).
    """
    if owners is not None:
        for replica, pod_key, node in binds:
            actual = owners.get(node)
            if actual != replica:
                _record(
                    violations, "global_overcommit", cycle,
                    f"replica {replica} bound {pod_key} to node {node} "
                    f"owned by {actual!r} (shards must be disjoint)",
                )
    check_capacity(cluster, cycle, violations)


def check_fleet_journal_completeness(
    cluster: ClusterState,
    schedulers: list,
    cycle: int,
    violations: list[Violation],
    sched_bound: set[str],
) -> None:
    """Journal completeness held FLEET-WIDE: a pod may legitimately
    traverse several replicas' journals (routed, handed off, adopted
    after a replica loss), so the invariant merges every replica's
    records — latest by (t, step), terminal preferred on ties — and
    requires each owned pod's merged history to end terminally, and
    each fleet-bound pod to end ``bound``. The blind spot this closes:
    a replica loss orphaning pods that then never reach a terminal
    outcome anywhere."""
    from ..obs.journal import TERMINAL_OUTCOMES, fleet_merge_key
    import json

    # merge key: the tie-break, now shared with `obs explain
    # --fleet` (obs/journal.py fleet_merge_key) — latest virtual time
    # wins; on a t-tie prefer terminal, then 'bound' (a bind is
    # irrevocable, so no same-instant record from another replica can
    # supersede it — e.g. a fenced zombie's bind_failure racing the
    # survivor's successful bind in the same cycle), then the
    # within-replica step (steps are NOT comparable across replicas,
    # so it only breaks same-replica ties)
    _key = fleet_merge_key

    merged: dict[str, dict] = {}
    for sched in schedulers:
        if sched.journal is None:
            continue
        for line in sched.journal.lines:
            rec = json.loads(line)
            cur = merged.get(rec["pod"])
            if cur is None or _key(rec) >= _key(cur):
                merged[rec["pod"]] = rec
    solver_names = set()
    for sched in schedulers:
        solver_names |= set(sched.solvers)
    tracked_entries: dict[str, str] = {}
    for sched in schedulers:
        tracked_entries.update(sched.queue.entries())
    for pod in sorted(cluster.list_pods(), key=lambda p: p.key):
        rec = merged.get(pod.key)
        if pod.node_name:
            if pod.key in sched_bound and (
                rec is None or rec["outcome"] != "bound"
            ):
                _record(
                    violations, "journal", cycle,
                    f"fleet-bound pod {pod.key} lacks a terminal "
                    "'bound' record in any replica's journal (last: "
                    f"{rec['outcome'] if rec else None})",
                )
            continue
        if pod.scheduler_name not in solver_names:
            continue
        if tracked_entries.get(pod.key) == "gated":
            continue
        if rec is None:
            _record(
                violations, "journal", cycle,
                f"unbound pod {pod.key} never appeared in any "
                "replica's decision journal",
            )
        elif rec["outcome"] not in TERMINAL_OUTCOMES:
            _record(
                violations, "journal", cycle,
                f"unbound pod {pod.key}'s merged last outcome "
                f"{rec['outcome']!r} (replica "
                f"{rec.get('replica', '?')}) is non-terminal",
            )


def check_resilience(
    scheduler,
    cycle: int,
    violations: list[Violation],
    *,
    device_faults: int = 0,
    poison_hits: int = 0,
) -> None:
    """Degraded-mode resilience invariants, checked after quiescence
    for profiles that injected solver-boundary faults:

    - **fallback engaged** — injected device faults must have tripped
      at least one breaker (the ladder actually absorbed the outage;
      zero trips would mean the faults never reached the solve path);
    - **breaker re-closed** — once the fault window has passed and the
      scheduler has settled, every profile must be back at the TOP
      ladder tier (probes climbed back up; a permanently-degraded
      scheduler after a transient fault is a resilience bug);
    - **poison isolated** — poison-pod hits must have produced at
      least one quarantine (the bisection found the poison instead of
      infinitely retrying or losing the batch). Terminal journaling of
      the quarantined pods is covered by the journal-completeness
      invariant (``quarantined`` is a terminal outcome).
    """
    r = scheduler.resilience
    if device_faults > 0 and r.trips < 1:
        _record(
            violations, "resilience", cycle,
            f"{device_faults} device solver faults were injected but "
            "no breaker ever tripped — the ladder never engaged",
        )
    if device_faults > 0:
        for profile in scheduler.solvers:
            idx = r.tier_index(profile)
            if idx != 0:
                _record(
                    violations, "resilience", cycle,
                    f"profile {profile} is still at ladder tier "
                    f"{r.ladder[idx]!r} after the fault window — the "
                    "breaker never re-closed",
                )
        if r.trips >= 1 and r.recloses < 1:
            # tier_index alone goes vacuous once the settle loop has
            # advanced virtual time past every open window (elapsed
            # windows count as the top tier) — require a PROBE to have
            # actually succeeded, not just the clock to have moved
            # (device-fault profiles keep arrivals flowing after the
            # window precisely so a real probe runs)
            _record(
                violations, "resilience", cycle,
                f"breaker tripped {r.trips}x but never re-closed via "
                "a successful probe — the scheduler only LOOKS "
                "recovered because the fault windows elapsed",
            )
    if poison_hits > 0 and not scheduler._quarantine_counts:
        _record(
            violations, "resilience", cycle,
            f"{poison_hits} poison-batch failures were injected but "
            "no pod was ever quarantined — the bisection never "
            "isolated the poison",
        )


def check_tuning(
    cycle: int,
    violations: list[Violation],
    *,
    summary: dict,
    expect_shift: bool = False,
    max_moves_per_knob: int = 8,
) -> None:
    """Closed-loop auto-tuning invariants (kubernetes_tpu_torch/tuning),
    checked after quiescence for profiles that enabled the tuner:

    - **engaged** — the controllers must have probed at least once
      (zero probes means the tick never reached them and every other
      clause would pass vacuously);
    - **settled** — after churn stops, every controller must be
      settled (a tuner still thrashing a knob on a steady workload is
      the oscillation hysteresis exists to prevent). Scoped to
      CONVERGENCE OPPORTUNITY: a shift detected near the end of the
      drive leaves the tuner legitimately mid-re-convergence, so the
      clause only fires when the batches seen since the last unsettle
      reach the controllers' structural settle bound (probe budget x
      evaluation windows — summary's ``settle_bound``);
    - **no guardrail breach** — a tuner-APPLIED value failing its
      guard (e.g. a drain chunk whose HBM estimate exceeds the budget)
      must never happen: proposals are guarded before application, so
      ``guardrail_breaches`` is pinned at exactly 0;
    - **no knob thrash** — accepted moves per knob are bounded
      (``max_moves_per_knob``): the hysteresis margin makes an A<->B
      oscillation structurally impossible within one workload regime,
      so an unbounded move count means the margin logic broke;
    - **shift detected** — when the profile shifted the workload
      mid-drive, the tuner must have seen it (``shifts >= 1``) — a
      settled tuner that sleeps through a regime change serves the OLD
      workload's knobs forever.
    """
    probes = summary.get("probes", 0)
    if probes < 1:
        _record(
            violations, "tuning", cycle,
            "the tuning runtime never probed a knob — the controllers "
            "never engaged (every other tuning clause is vacuous)",
        )
        return
    if summary.get("settled") != 1 and summary.get(
        "batches_since_unsettle", 10**9
    ) >= summary.get("settle_bound", 0):
        _record(
            violations, "tuning", cycle,
            "tuning controllers still unsettled after quiescence "
            f"despite {summary.get('batches_since_unsettle')} batches "
            f"of opportunity (bound {summary.get('settle_bound')}): "
            f"knobs={summary.get('knobs')} — the hysteresis/settle "
            "machinery failed to converge on a steady workload",
        )
    breaches = summary.get("guardrail_breaches", 0)
    if breaches != 0:
        _record(
            violations, "tuning", cycle,
            f"{breaches} guardrail breach(es): a tuner-applied value "
            "failed its guard — proposals must be rejected BEFORE "
            "application, never applied and rolled back",
        )
    moves = summary.get("max_knob_moves", 0)
    if moves > max_moves_per_knob:
        _record(
            violations, "tuning", cycle,
            f"a knob accepted {moves} moves (> {max_moves_per_knob}) — "
            "knob thrash: the hysteresis margin is not bounding the "
            "climb",
        )
    if expect_shift and summary.get("shifts", 0) < 1:
        _record(
            violations, "tuning", cycle,
            "the profile shifted the workload mid-drive but the tuner "
            "never detected it — settled knobs are serving a workload "
            "that no longer exists",
        )


def merged_last_outcomes(journal_line_sets) -> dict[str, dict]:
    """Last-record-wins merge of decision journals across scheduler
    INCARNATIONS (the process-lifecycle analog of the fleet merge):
    within one incarnation records append in virtual-time order, and a
    successor incarnation's records all follow its predecessor's on the
    shared timeline, so feeding the line sets in incarnation order and
    letting the last record win yields each pod's true final outcome.
    The journal-completeness invariant then holds ACROSS a crash: the
    recovery pass's terminal ``recovered`` records close every history
    the dead incarnation left dangling."""
    import json

    out: dict[str, dict] = {}
    for lines in journal_line_sets:
        for line in lines:
            rec = json.loads(line)
            out[rec["pod"]] = rec
    return out


def check_recovery(
    cycle: int,
    violations: list[Violation],
    *,
    crash_expected: bool,
    crashes: int,
    incarnations: int,
    orphans_at_restart: int,
    recovered_records: int,
) -> None:
    """Crash-restart recovery invariants (the crash_restart profile):

    - **crash engaged** — the profile demanded a mid-batch kill and
      one actually fired (zero crashes would make every other
      assertion vacuous);
    - **fresh incarnation** — a crash was followed by a restarted
      Scheduler (incarnations advanced);
    - **orphans re-adopted and journaled** — the pods the crash
      orphaned (unbound at restart) each got a terminal ``recovered``
      record from the fresh incarnation, so the merged
      cross-incarnation journal stays complete. Bounded recovery —
      every orphan accounted for immediately after the restart — is
      asserted by the lost-pod check the harness runs right after
      constructing the new incarnation.
    """
    if not crash_expected:
        return
    if crashes < 1:
        _record(
            violations, "recovery", cycle,
            "the profile demanded a mid-batch crash but none fired — "
            "the process-lifecycle fault never engaged",
        )
        return
    if incarnations < 2:
        _record(
            violations, "recovery", cycle,
            f"{crashes} crash(es) fired but only {incarnations} "
            "incarnation(s) ever ran — the restart never happened",
        )
    if orphans_at_restart > 0 and recovered_records < 1:
        _record(
            violations, "recovery", cycle,
            f"the crash orphaned {orphans_at_restart} unbound pod(s) "
            "but the fresh incarnation journaled zero terminal "
            "'recovered' records — cross-incarnation journal "
            "completeness cannot hold",
        )


def check_hub_partition(
    cycle: int,
    violations: list[Violation],
    *,
    fenced_commits: int,
    zombie_binds_while_fenced: int,
    stale_rejections: int,
) -> None:
    """Partition-safety invariants (the hub_partition profile):

    - **all-zombie-commits-fenced** — every bind the fenced replica
      attempted was rejected with Conflict: zero of its commits landed
      while its fence was revoked, and at least one attempt actually
      happened (zero attempts would make the fence assertion vacuous);
    - **conservative admission engaged** — while peer occupancy rows
      were aged out past the staleness bound, at least one cross-shard-
      constrained placement was rejected as stale rather than admitted
      against rows that may hide peers' placements. (That no violating
      placement ever landed is asserted by the constraint/overcommit
      checks that run every cycle.)
    """
    if fenced_commits < 1:
        _record(
            violations, "fencing", cycle,
            "the zombie replica never had a commit rejected by the "
            "fence — the zombie-writes-after-lease-loss fault never "
            "engaged",
        )
    if zombie_binds_while_fenced > 0:
        _record(
            violations, "fencing", cycle,
            f"{zombie_binds_while_fenced} bind(s) by the fenced "
            "replica LANDED — the commit fence leaked a zombie write",
        )
    if stale_rejections < 1:
        _record(
            violations, "fencing", cycle,
            "no placement was ever rejected by the occupancy-staleness "
            "bound — conservative admission never engaged during the "
            "partition",
        )


def check_hub_failover(
    cycle: int,
    violations: list[Violation],
    *,
    promotions: int,
    epoch: int,
    deposed_write_rejections: int,
    flush_dedup_hits: int,
    stale_rejections: int,
    hub_journal_missing: int,
    old_primary_reads_ok,
    expect_dedup: bool = True,
) -> None:
    """Hub-HA invariants (the hub_failover profile): a primary-hub
    kill mid-drive must heal WITHOUT operator action, and the fencing
    epoch must make the old primary harmless.

    - **exactly one failover** — the standby promoted once, and the
      fleet ends at epoch 2 (initial grant + one takeover; more would
      mean lease flapping, zero would mean the fault never engaged);
    - **stale-primary writes rejected** — the resurrected old primary
      rejected >= 1 replica-facing write with the typed HubDeposed
      (that none LANDED is covered by the overcommit/constraint checks
      that run every cycle — here we pin that the fence actually
      fired, not vacuously);
    - **idempotent flush proven** — the injected reply-loss-after-
      apply forced >= 1 hub-side dedup hit (the double-apply hazard's
      regression clause, exercised inside the chaos loop);
    - **conservative admission engaged** — the blackout window drove
      >= 1 staleness rejection instead of admitting against a view
      the dead hub could no longer refresh;
    - **journal aggregation complete** — after heal, every line each
      replica's journal shipped is present in the serving hub's
      aggregation surface (zero lost to the failover: pre-kill lines
      arrived via replication, blackout lines via the cursor-retrying
      client buffers);
    - **old primary serves reads** — its debug/status surface stayed
      readable after resurrection (the operator's post-mortem path).
    """
    if promotions != 1:
        _record(
            violations, "hub_failover", cycle,
            f"expected exactly one standby promotion, saw {promotions} "
            "(0 = the kill never engaged, >1 = lease flapping)",
        )
    if epoch != 2:
        _record(
            violations, "hub_failover", cycle,
            f"fleet ended at hub epoch {epoch}, expected 2 (initial "
            "grant + exactly one epoch-fenced takeover)",
        )
    if deposed_write_rejections < 1:
        _record(
            violations, "hub_failover", cycle,
            "the deposed old primary never rejected a replica-facing "
            "write — the stale-primary fence was never exercised",
        )
    if expect_dedup and flush_dedup_hits < 1:
        _record(
            violations, "hub_failover", cycle,
            "no write-behind flush was deduped — the injected "
            "reply-loss-after-apply never forced the idempotency path",
        )
    if stale_rejections < 1:
        _record(
            violations, "hub_failover", cycle,
            "no placement was rejected by the staleness bound during "
            "the blackout — conservative admission never engaged",
        )
    if hub_journal_missing > 0:
        _record(
            violations, "hub_failover", cycle,
            f"{hub_journal_missing} journal line(s) shipped by "
            "replicas are missing from the serving hub's aggregation "
            "surface after heal — the failover lost history",
        )
    if old_primary_reads_ok is False:
        _record(
            violations, "hub_failover", cycle,
            "the resurrected old primary failed to serve its "
            "read/status surface — post-mortem reads must survive "
            "deposition",
        )


class RebalanceTracker:
    """Independent witness for the rebalancer's eviction activity:
    subscribes straight to the state service and counts the Events-API
    ``Evicted`` records the eviction subresource emits, re-checking PDB
    allowances against its OWN mirror (seeded from the PDBs' original
    ``disruptionsAllowed``, decremented per observed eviction) — so a
    bug in the enforcement code cannot vouch for itself."""

    def __init__(self, cluster: ClusterState) -> None:
        import dataclasses

        self._cluster = cluster
        # snapshot the PDBs at construction: selector + the ORIGINAL
        # allowance (the live objects decrement as evictions land)
        self._pdbs = [
            dataclasses.replace(pdb) for pdb in cluster.list_pdbs()
        ]
        self._allow = [pdb.disruptions_allowed for pdb in self._pdbs]
        self.evictions = 0
        self.evicted_keys: list[str] = []
        self.pdb_overruns = 0
        cluster.subscribe(self._on_event)

    def _on_event(self, ev: Event) -> None:
        if ev.kind != "Event":
            return
        rec = ev.obj
        if getattr(rec, "reason", "") != "Evicted":
            return
        self.evictions += 1
        key = f"{rec.regarding_namespace}/{rec.regarding_name}"
        self.evicted_keys.append(key)
        try:
            pod = self._cluster.get_pod(
                rec.regarding_namespace, rec.regarding_name
            )
        except Exception:
            return  # vanished before delivery: nothing to match
        for i, pdb in enumerate(self._pdbs):
            if pdb.matches(pod):
                self._allow[i] -= 1
                if self._allow[i] < 0:
                    self.pdb_overruns += 1


def check_rebalance(
    cycle: int,
    violations: list[Violation],
    *,
    history,
    budget: int,
    pdb_overruns: int,
    migrations_completed: int,
    churn_end_t: float,
    final_packing: float,
    expect_runs: bool = True,
    tol: float = 0.02,
) -> None:
    """Continuous-rebalancer invariants (the fragmentation profile),
    checked after quiescence:

    - **engaged** — the profile demanded rebalancing and at least one
      pass actually ran (zero passes would make everything else
      vacuous);
    - **churn budget** — no pass evicted more than the configured
      budget;
    - **PDB never violated** — the independent tracker's allowance
      mirror never went negative (a PDB-guarded pod moving at 0
      disruptions allowed is exactly the bug the eviction subresource
      must make impossible);
    - **migrations complete** — evictions are only half a migration:
      when anything was evicted, at least one evicted pod must have
      re-bound (an evict-and-strand rebalancer destroys capacity);
    - **utilization monotonic** — across the SETTLE-phase passes
      (``t >= churn_end_t``: churn has stopped, so packing changes are
      the rebalancer's alone) the packed utilization each pass observes
      must be non-decreasing (within ``tol``), and the final packed
      utilization must not regress below the first settle-phase pass's.
      During-churn passes are exempt: arrivals and deletes legitimately
      move packing both ways under the rebalancer's feet.
    """
    if not history:
        if expect_runs:
            _record(
                violations, "rebalance", cycle,
                "the profile demanded rebalancing but no pass ever "
                "ran — the defragmentation loop never engaged",
            )
        return
    for r in history:
        if r.evicted > budget:
            _record(
                violations, "rebalance", cycle,
                f"rebalance pass at t={r.t} evicted {r.evicted} pods "
                f"> churn budget {budget}",
            )
    if pdb_overruns > 0:
        _record(
            violations, "rebalance", cycle,
            f"{pdb_overruns} eviction(s) landed on pods whose "
            "PodDisruptionBudget had no disruptions left — the PDB "
            "gate leaked",
        )
    total_evicted = sum(r.evicted for r in history)
    if total_evicted > 0 and migrations_completed < 1:
        _record(
            violations, "rebalance", cycle,
            f"{total_evicted} eviction(s) but zero completed "
            "migrations — the rebalancer evicts and strands",
        )
    settle = [r for r in history if r.t >= churn_end_t]
    for prev, cur in zip(settle, settle[1:]):
        if cur.packing_before < prev.packing_before - tol:
            _record(
                violations, "rebalance", cycle,
                "packed utilization regressed across settle-phase "
                f"rebalance passes: {prev.packing_before:.4f} -> "
                f"{cur.packing_before:.4f}",
            )
    if settle and migrations_completed >= 1 and (
        final_packing < settle[0].packing_before - tol
    ):
        _record(
            violations, "rebalance", cycle,
            f"final packed utilization {final_packing:.4f} regressed "
            f"below the first settle-phase pass's "
            f"{settle[0].packing_before:.4f}",
        )


def packed_utilization(cluster: ClusterState) -> float:
    """Dominant-resource fill of the in-use nodes, from cluster TRUTH
    (pod objects, not the scheduler's snapshot) — the invariant-side
    mirror of rebalance/detector.py's packed_utilization, computed
    through an independent path so the two can disagree when one is
    buggy."""
    nodes = {n.name: n for n in cluster.list_nodes()}
    used: dict[str, dict[str, int]] = {}
    for pod in cluster.list_pods():
        if pod.node_name and pod.node_name in nodes:
            u = used.setdefault(pod.node_name, {})
            for r, v in pod.resource_request().items():
                u[r] = u.get(r, 0) + v
    if not used:
        return 1.0
    tot_u = {"cpu": 0, "memory": 0}
    tot_a = {"cpu": 0, "memory": 0}
    for name, u in used.items():
        alloc = nodes[name].allocatable
        for r in ("cpu", "memory"):
            tot_u[r] += u.get(r, 0)
            tot_a[r] += alloc.get(r, 0)
    fracs = [
        tot_u[r] / tot_a[r] for r in ("cpu", "memory") if tot_a[r] > 0
    ]
    return max(fracs) if fracs else 1.0


class MonotonicCounters:
    """Counter series must never decrease between checks. ``sample``
    is injectable so known-bad tests can feed a regressing series; the
    default reads the live metrics registry."""

    WATCHED = (
        "scheduler_schedule_attempts_total",
        "scheduler_queue_incoming_pods_total",
        "scheduler_tpu_solves_discarded_total",
        "scheduler_pipeline_fallback_total",
        "scheduler_preemption_attempts_total",
    )

    def __init__(self, sample: Callable[[], dict[str, float]] | None = None):
        self._sample = sample or self._sample_registry
        self._last: dict[str, float] = {}

    @staticmethod
    def _sample_registry() -> dict[str, float]:
        # the port's registry (metrics/prom.py) keeps a counter's name
        # without ``_total`` and hands out one child per label tuple
        out: dict[str, float] = {}
        for family in metrics.REGISTRY.collect():
            if family._type != "counter":
                continue
            name = family._name + "_total"
            if name in MonotonicCounters.WATCHED:
                out[name] = sum(c.value() for _, c in family.children())
        return out

    def observe(self, cycle: int, violations: list[Violation]) -> None:
        cur = self._sample()
        for name in sorted(self._last):
            if cur.get(name, 0.0) < self._last[name]:
                _record(
                    violations, "monotonic", cycle,
                    f"counter {name} went backwards: "
                    f"{self._last[name]} -> {cur.get(name, 0.0)}",
                )
        self._last = cur


def check_telemetry(
    cycle: int,
    violations: list[Violation],
    *,
    summary: dict,
    bundle_dir: str | None = None,
    device=None,
) -> None:
    """Flight-telemetry invariants, checked after quiescence for
    profiles that enabled the always-on telemetry loop
    (``profile.telemetry``). This is the closed-loop forensic
    contract — profile, detect, capture, replay — asserted end to end:

    - **sentinel fired** — a profile that injects a health regression
      (the ``anomaly_storm`` solver-fault window) must have produced
      at least one anomaly; a silent sentinel through a storm means
      the detection rules never engaged;
    - **capture engaged** — every anomaly/breaker trigger routes
      through the bundle capturer, so at least one capture event must
      have been counted (capture counting is independent of whether a
      bundle directory was configured — the ``--selfcheck`` re-run
      leans on that);
    - **bundles replay bit-identical** — every bundle directory
      written under ``bundle_dir`` must re-execute offline to the
      exact assignments the live run produced. A replay mismatch is
      the worst telemetry bug there is: a forensic artifact that lies.
      Chained/split solves are legitimately non-replayable standalone
      (the bundle records why), but when a directory was configured at
      least one written bundle must close the loop.
    """
    if summary.get("anomalies", 0) < 1:
        _record(
            violations, "telemetry", cycle,
            "telemetry profile ran a fault storm but the anomaly "
            "sentinel never fired",
        )
    if summary.get("bundles_captured", 0) < 1:
        _record(
            violations, "telemetry", cycle,
            "anomaly/breaker triggers fired but no capture event was "
            "counted — the capture seam is disconnected",
        )
    if not bundle_dir:
        return
    import os

    from ..obs.bundle import replay_bundle

    dirs = sorted(
        d for d in os.listdir(bundle_dir) if d.startswith("bundle-")
    )
    if not dirs:
        _record(
            violations, "telemetry", cycle,
            "a bundle directory was configured but no bundle was "
            "written to it",
        )
        return
    replayed_ok = 0
    for d in dirs:
        try:
            rep = replay_bundle(os.path.join(bundle_dir, d), device)
        except Exception as exc:  # noqa: BLE001 - any failure is the finding
            _record(
                violations, "telemetry", cycle,
                f"bundle {d} failed to load/replay: {exc!r}",
            )
            continue
        if not rep["replayable"]:
            continue
        if rep["ok"]:
            replayed_ok += 1
        else:
            _record(
                violations, "telemetry", cycle,
                f"bundle {d} replay diverged from the live run: "
                f"{rep['detail']}",
            )
    if replayed_ok < 1:
        _record(
            violations, "telemetry", cycle,
            f"{len(dirs)} bundles written but none replayed "
            "bit-identical — the forensic loop never closed",
        )


def check_megaplan(
    cycle: int,
    violations: list[Violation],
    *,
    summary: dict | None,
    ratio_floor: float = 0.9,
) -> None:
    """Convex-relaxation mega-planner invariants (megaplan profiles),
    checked after quiescence. Three claims, all asserted
    non-vacuously:

    - **engaged** — the warm-start relaxation actually iterated AND
      re-ranked at least one backlog pod before the first chunk
      popped; a megaplan profile that drains in plain FIFO order is
      the feature silently disconnected, not a pass;
    - **valid** — the probe's relaxed+rounded+repaired plan survived
      the sequential oracle's feasibility replay (every placed pick in
      the feasible set given identical history — no overcommit, every
      filter honored). Tie-set parity is deliberately not required: a
      global plan trades per-step greedy optimality for packing;
    - **quality** — the plan's placements clear ``ratio_floor`` of the
      oracle's own greedy run on the identical snapshot. The floor is
      the acceptance bar for trusting the relaxation to ORDER work:
      a plan much worse than greedy would make the warm-start an
      anti-signal.
    """
    if summary is None:
        _record(
            violations, "megaplan", cycle,
            "megaplan profile ran but the pre-drain probe produced no "
            "summary — the probe never saw a backlog",
        )
        return
    if summary.get("iterations", 0) < 1:
        _record(
            violations, "megaplan", cycle,
            "warm-start relaxation never iterated — the mega-planner "
            "did not engage",
        )
    if summary.get("ranked", 0) < 1:
        _record(
            violations, "megaplan", cycle,
            "relaxed plan re-ranked zero backlog pods — the "
            "warm-start reorder seam is disconnected",
        )
    if not summary.get("plan_valid", False):
        _record(
            violations, "megaplan", cycle,
            "relaxed+rounded+repaired plan failed the oracle "
            f"feasibility replay ({summary.get('plan_errors', '?')} "
            "errors)",
        )
    ratio = summary.get("objective_ratio", 0.0)
    if ratio < ratio_floor:
        _record(
            violations, "megaplan", cycle,
            f"megaplan objective ratio {ratio} below the "
            f"{ratio_floor} floor vs the exact anchor "
            f"({summary.get('relax_placed')} vs "
            f"{summary.get('exact_placed')} placed)",
        )


def check_fleet_drain(
    cycle: int,
    violations: list[Violation],
    *,
    backlog: int,
    drained: int,
    double_binds: int,
    lost: int,
    leases_reassigned: int,
    expect_reassign: bool,
) -> None:
    """Fleet backlog-drain invariants (the fleet_backlog_drain
    profile, ROADMAP #5a), checked after quiescence. The hub's lease
    ledger promises exactly-once drain semantics across a fleet of
    concurrent drainers — including through a mid-drain replica kill:

    - **engaged** — a backlog existed and the ledger recorded drain
      progress; a fleet-drain profile that drains nothing (or whose
      coordinator never installed a ledger) is the feature silently
      disconnected, not a pass;
    - **none lost** — every cycle-0 backlog pod ended bound somewhere
      in the fleet (``lost`` counts the stragglers). A dead replica's
      outstanding lease keys must come back as orphans and drain at a
      survivor;
    - **none doubled** — zero backlog pods were reported scheduled by
      more than one replica: the one-granted-lease-per-pod rule held
      (the per-cycle double-bind tracker asserts the cluster-level
      half; this clause pins the drain-lease partitioning itself);
    - **reassignment engaged** (kill profiles) — the dead replica's
      lease actually returned and a survivor claimed it at least once;
      zero reassignments under a replica kill means the
      return-on-retire seam is disconnected.
    """
    if backlog < 1:
        _record(
            violations, "fleet_drain", cycle,
            "fleet-drain profile ran with an empty backlog — the "
            "drain invariants are vacuous",
        )
        return
    if drained < 1:
        _record(
            violations, "fleet_drain", cycle,
            "the drain ledger recorded zero pods drained — the "
            "coordinator/lease seam never engaged",
        )
    if lost > 0:
        _record(
            violations, "fleet_drain", cycle,
            f"{lost} backlog pod(s) ended unbound fleet-wide — the "
            "drain lost work (a returned lease's keys must be "
            "reassigned, not dropped)",
        )
    if double_binds > 0:
        _record(
            violations, "fleet_drain", cycle,
            f"{double_binds} backlog pod(s) were scheduled by more "
            "than one replica — a pod belonged to two drain leases",
        )
    if expect_reassign and leases_reassigned < 1:
        _record(
            violations, "fleet_drain", cycle,
            "a replica died mid-drain but no lease was ever "
            "reassigned — the return-on-retire seam is disconnected",
        )
