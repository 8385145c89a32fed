"""Fault injectors at the scheduler's real boundaries.

Each injector sits on a seam production code already exposes — none of
them monkeypatch scheduler internals:

- ``BindFaultInjector``   → ``ClusterState.bind_fault`` (the apiserver-
  side rejection hook the binding subresource consults);
- ``DelayedWatchBus``     → interposed between ``ClusterState._emit``
  and ``Scheduler._on_event`` via subscribe/unsubscribe, modeling the
  informer relay: at-least-once delivery, arbitrary delay, duplication,
  but never reordering (client-go watch streams are ordered);
- ``FlakyExtenderTransport`` → ``HTTPExtenderClient.transport`` (the
  wire seam), so timeout/5xx verdicts travel the real ExtenderError
  paths including the non-ignorable batch abort;
- ``StallingPermitPlugin`` → a real out-of-tree PermitPlugin, parking
  pods in the WaitingPods map;
- ``SolverFaultInjector``   → ``Scheduler._solve_fault`` (the
  solver-boundary seam, called with (pods, tier) before every solve
  attempt at every fallback-ladder tier): injected device/runtime
  errors at device tiers (exercising the circuit breaker + fallback
  ladder) and poison-pod failures at EVERY tier including host
  (exercising the bisection quarantine).

Every random draw an injector makes DURING a scheduler run goes through
the :class:`DecisionJournal`, because the number and order of draws
depend on scheduler-internal call sequences. Recording them makes a
trace replay bit-for-bit even across generator/scheduler code drift;
asserting the tag on replay catches call-sequence divergence at the
first differing decision instead of at the final-bindings diff.

Copied from ``kubernetes_tpu/sim/faults.py``.
"""

from __future__ import annotations

import random
from typing import Callable

from .. import metrics
from ..framework.interface import PermitPlugin, Status, StatusCode
from ..state.cluster import ApiError, ClusterState, Event
from .trace import TraceError, TraceWriter


class DecisionJournal:
    """Record mode: compute the value, journal it, return it.
    Replay mode: pop the next journaled decision, assert the tag
    matches (divergence = the run is no longer following the trace),
    return the recorded value."""

    def __init__(
        self, writer: TraceWriter | None, replay: list[dict] | None = None
    ) -> None:
        self._writer = writer
        self._replay = list(replay) if replay is not None else None
        self._pos = 0

    @property
    def replaying(self) -> bool:
        return self._replay is not None

    def decide(self, tag: str, compute: Callable[[], object]):
        if self._replay is not None:
            if self._pos >= len(self._replay):
                raise TraceError(
                    f"replay exhausted its decision journal at {tag!r} "
                    f"(decision #{self._pos + 1})"
                )
            rec = self._replay[self._pos]
            self._pos += 1
            if rec["t"] != tag:
                raise TraceError(
                    f"replay diverged at decision #{self._pos}: trace has "
                    f"{rec['t']!r}, run asked for {tag!r}"
                )
            return rec["x"]
        value = compute()
        if self._writer is not None:
            self._writer.decision(tag, value)
        return value

    def leftover(self) -> int:
        """Unconsumed decisions after a replay (should be 0)."""
        return 0 if self._replay is None else len(self._replay) - self._pos


class BindFaultInjector:
    """Installed as ``cluster.bind_fault``: fails scheduler-initiated
    binds with apiserver-shaped errors. Suspended while the harness
    itself binds (external competing binds are churn, not faults)."""

    def __init__(
        self, journal: DecisionJournal, rng: random.Random, rate: float
    ) -> None:
        self._journal = journal
        self._rng = rng
        self.rate = rate
        self.suspended = False
        self.settling = False  # drain phase: stop injecting so runs settle
        self.injected = 0

    def __call__(self, pod, node_name: str) -> None:
        if self.suspended or self.settling or self.rate <= 0:
            return
        fault = self._journal.decide(
            "bind_fault", lambda: int(self._rng.random() < self.rate)
        )
        if fault:
            self.injected += 1
            metrics.sim_faults_injected_total.labels("bind_conflict").inc()
            raise ApiError(
                "Conflict", f"sim: injected bind conflict for {pod.key}"
            )


class DelayedWatchBus:
    """At-least-once, in-order watch delivery between the state service
    and ONE subscriber (the scheduler). ``ingest`` runs under the
    cluster lock (ClusterState emits synchronously); delivery happens at
    ``pump``/``pump_all``, which re-acquires the lock so the handler's
    holds(cluster.lock) contract is preserved.

    Delay policy is the caller's: the harness pumps between cycles and —
    through the scheduler's post-dispatch hook — inside the
    dispatch→apply window of in-flight solves, which is exactly where
    delayed events exercise the conflict fence. Duplication re-delivers
    an event immediately after its original (adjacent duplicate): the
    at-least-once shape informers actually produce, without reordering.
    """

    def __init__(
        self,
        cluster: ClusterState,
        deliver: Callable[[Event], None],
        journal: DecisionJournal,
        rng: random.Random,
        *,
        delaying: bool = True,
        dup_rate: float = 0.0,
    ) -> None:
        self._cluster = cluster
        self._deliver = deliver
        self._journal = journal
        self._rng = rng
        self.delaying = delaying
        self.dup_rate = dup_rate
        self.pending: list[Event] = []
        self.delivered = 0
        self.duplicated = 0

    # runs under cluster.lock (ClusterState._emit fires synchronously)
    def ingest(self, ev: Event) -> None:
        if not self.delaying:
            self._deliver_one(ev)
            return
        metrics.sim_faults_injected_total.labels("watch_delay").inc()
        self.pending.append(ev)

    def _deliver_one(self, ev: Event) -> None:
        self._deliver(ev)
        self.delivered += 1
        if self.dup_rate > 0:
            dup = self._journal.decide(
                "watch_dup", lambda: int(self._rng.random() < self.dup_rate)
            )
            if dup:
                self.duplicated += 1
                metrics.sim_faults_injected_total.labels(
                    "watch_duplicate"
                ).inc()
                self._deliver(ev)

    def pump(self, n: int) -> int:
        """Deliver the next ``n`` pending events (in order), under the
        cluster lock. Returns how many were delivered."""
        if n <= 0 or not self.pending:
            return 0
        batch, self.pending = self.pending[:n], self.pending[n:]
        with self._cluster.lock:
            for ev in batch:
                self._deliver_one(ev)
        return len(batch)

    def pump_all(self) -> int:
        return self.pump(len(self.pending))

    def pending_pod_adds(self) -> set[str]:
        """Keys of pods whose ADDED event has not been delivered yet —
        the lost-pod invariant must not count them against the
        scheduler (it cannot know about them)."""
        return {
            ev.obj.key
            for ev in self.pending
            if ev.kind == "Pod" and ev.type == "ADDED"
        }


class FlakyExtenderTransport:
    """Injectable wire for ``HTTPExtenderClient``: answers filter/
    prioritize with pass-all verdicts, or fails the call (timeout / 5xx)
    per journaled decision. Failures raise OSError — the transport
    contract — which the client maps onto ExtenderError exactly like a
    real connection error."""

    def __init__(
        self, journal: DecisionJournal, rng: random.Random, rate: float
    ) -> None:
        self._journal = journal
        self._rng = rng
        self.rate = rate
        self.settling = False
        self.calls = 0
        self.failed = 0

    def __call__(self, verb: str, payload: dict):
        self.calls += 1
        mode = "ok"
        if not self.settling and self.rate > 0:
            def draw():
                if self._rng.random() >= self.rate:
                    return "ok"
                return self._rng.choice(["timeout", "http500"])

            mode = self._journal.decide("extender_fault", draw)
        if mode == "timeout":
            self.failed += 1
            metrics.sim_faults_injected_total.labels("extender_timeout").inc()
            raise OSError("sim: injected extender timeout")
        if mode == "http500":
            self.failed += 1
            metrics.sim_faults_injected_total.labels("extender_5xx").inc()
            raise OSError("sim: injected HTTP 500")
        if "filter" in verb:
            if payload.get("nodenames") is not None:
                names = list(payload["nodenames"])
            else:
                names = [
                    d.get("metadata", {}).get("name")
                    for d in (payload.get("nodes") or {}).get("items") or []
                ]
            return {"nodenames": names}
        return []  # prioritize: empty HostPriorityList (no opinion)


class SolverFaultInjector:
    """Installed as ``Scheduler._solve_fault``: raises
    ``SolverFaultError`` from inside the dispatch path, the one real
    boundary the sim couldn't previously reach (every other injector
    sits above ``schedule_batch``).

    Two failure modes:

    - **device faults** (``rate`` within the optional virtual-clock
      ``window``): raised at every tier EXCEPT the pure-host rung —
      a real accelerator outage cannot take down host python, and the
      exemption is what makes "the ladder always has a working floor"
      testable. Draws are journaled (replay-stable).
    - **poison pods**: any batch containing a POISON_LABEL-marked pod
      fails at EVERY tier including host (data that breaks
      tensorize/solve), deterministically — no RNG, no journal entry —
      which is exactly the shape the bisection quarantine isolates.
    """

    def __init__(
        self,
        journal: DecisionJournal,
        rng: random.Random,
        clock,
        *,
        rate: float = 0.0,
        window: tuple = (),
    ) -> None:
        self._journal = journal
        self._rng = rng
        self._clock = clock
        self.rate = rate
        self.window = tuple(window)
        self.settling = False
        self.injected = 0
        self.poison_hits = 0

    def __call__(self, pods, tier: str) -> None:
        from ..resilience import TIER_HOST, SolverFaultError
        from .generators import POISON_LABEL

        poison = sorted(
            p.key for p in pods if p.labels.get(POISON_LABEL)
        )
        if poison:
            self.poison_hits += 1
            metrics.sim_faults_injected_total.labels("poison_pod").inc()
            raise SolverFaultError(
                f"sim: poison pod(s) {', '.join(poison)} break the "
                f"solve (tier {tier})"
            )
        if tier == TIER_HOST or self.settling or self.rate <= 0:
            return
        if self.window:
            now = self._clock.now()
            if not (self.window[0] <= now < self.window[1]):
                return
        fault = self._journal.decide(
            "solver_fault", lambda: int(self._rng.random() < self.rate)
        )
        if fault:
            self.injected += 1
            metrics.sim_faults_injected_total.labels("solver_fault").inc()
            raise SolverFaultError(
                f"sim: injected device solve failure (tier {tier})"
            )


class SimulatedCrash(Exception):
    """The scheduler process died (kill -9, OOM, GC-stall eviction).
    Raised from the ``_pre_commit_hook`` seam — after a batch's pods
    are assumed and approved, before any bind commits — and caught by
    the HARNESS, never the scheduler: from the cluster's point of view
    the process simply stopped, with every piece of incarnation-local
    state (assumed pods, Permit waiters, in-flight maps, deferred
    solves) evaporating. The harness then constructs a fresh
    incarnation on the same ClusterState (sim/harness.py)."""


class CrashInjector:
    """Installed as ``Scheduler._pre_commit_hook``: once armed, the
    next batch that reaches its commit point dies mid-batch — the
    deterministic kill-after-assume-before-bind the crash_restart
    profile drives. One-shot: the raise disarms it (the restarted
    incarnation keeps running)."""

    def __init__(self) -> None:
        self.armed = False
        self.crashes = 0

    def arm(self) -> None:
        self.armed = True

    def __call__(self, pending) -> None:
        if not self.armed:
            return
        self.armed = False
        self.crashes += 1
        metrics.sim_faults_injected_total.labels("crash").inc()
        raise SimulatedCrash(
            f"sim: process crash mid-batch ({len(pending)} pod(s) "
            "assumed+approved, none committed)"
        )


class StallingPermitPlugin(PermitPlugin):
    """Out-of-tree Permit plugin: WAITs a pod's FIRST attempt with some
    probability; retries (and everything in settling mode) pass. Parked
    pods are later allowed by the harness or expire on the virtual
    clock — both verdict paths of the WaitingPods map."""

    def __init__(
        self,
        journal: DecisionJournal,
        rng: random.Random,
        rate: float,
        timeout: float,
    ) -> None:
        self._journal = journal
        self._rng = rng
        self.rate = rate
        self.timeout = timeout
        self.settling = False
        self._stalled_once: set[str] = set()
        self.stalls = 0

    def name(self) -> str:
        return "SimStallingPermit"

    def permit(self, state, pod, node_name: str):
        if (
            self.settling
            or self.rate <= 0
            or pod.key in self._stalled_once
        ):
            return Status.success(), 0.0
        stall = self._journal.decide(
            "permit_stall", lambda: int(self._rng.random() < self.rate)
        )
        if stall:
            self._stalled_once.add(pod.key)
            self.stalls += 1
            metrics.sim_faults_injected_total.labels("permit_stall").inc()
            return Status(StatusCode.WAIT), self.timeout
        return Status.success(), 0.0
