"""Scheduling queue: activeQ / podBackoffQ / unschedulablePods with the
reference's ordering and retry semantics, plus batch-pop for the TPU solver.

Reference: pkg/scheduler/backend/queue/scheduling_queue.go#PriorityQueue.
- activeQ heap ordered by the queueSort plugin — PrioritySort.Less: higher
  .spec.priority first, earlier queue timestamp within a priority
  (plugins/queuesort/priority_sort.go);
- podBackoffQ heap by backoff expiry; backoff = initial 1s doubling per
  attempt, capped at 10s (#calculateBackoffDuration); flushed every 1s
  (#flushBackoffQCompleted);
- unschedulablePods map; pods parked there move back on cluster events
  (#MoveAllToActiveOrBackoffQueue) or after the 5-minute forced flush
  (#flushUnschedulablePodsLeftover);
- schedulingCycle / moveRequestCycle bookkeeping closes the lost-wakeup race:
  a pod rejected in cycle C goes straight to backoff/active (not the
  unschedulable map) if a move request happened at cycle >= C, because the
  event that would have woken it may have fired mid-cycle;
- PreEnqueue gating (plugins/schedulinggates): pods with schedulingGates wait
  in a gated map and enter the queue only when gates clear.

Divergence from the reference, by design: Pop() becomes pop_batch(K) — the
solver schedules K pods per device solve. Ordering inside the batch is
exactly the heap order, and the exact solver preserves it (lax.scan in batch
order), so batching is observationally equivalent to K sequential Pops.
QueueingHintFn is simplified to "move everything" for now (hint functions
land with the plugin kernels that register them).

Copied from ``kubernetes_tpu/state/queue.py``.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

from .. import metrics
from ..api.objects import Pod
from ..utils.clock import Clock


class _SortKey:
    """Heap key adapter for a custom QueueSort comparator
    (interface.go#QueueSortPlugin.Less). __eq__ reports comparator ties
    so tuple comparison falls through to the FIFO seq tiebreaker."""

    __slots__ = ("info", "less")

    def __init__(self, info: "QueuedPodInfo", less) -> None:
        self.info = info
        self.less = less

    def __lt__(self, other: "_SortKey") -> bool:
        return self.less(self.info, other.info)

    def __eq__(self, other) -> bool:
        return not self.less(self.info, other.info) and not self.less(
            other.info, self.info
        )

    __hash__ = None

DEFAULT_POD_INITIAL_BACKOFF = 1.0
DEFAULT_POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_FLUSH_INTERVAL = 30.0
MAX_UNSCHEDULABLE_DURATION = 300.0  # 5 min forced re-activation


@dataclass
class QueuedPodInfo:
    pod: Pod
    timestamp: float  # time (re-)entered the queue — PrioritySort tiebreak
    initial_attempt_timestamp: float
    attempts: int = 0
    unschedulable_since: float | None = None
    gated: bool = False

    @property
    def key(self) -> str:
        return self.pod.key


class PriorityQueue:
    def __init__(
        self,
        clock: Clock | None = None,
        pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
        pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
        honor_scheduling_gates: bool = True,
        pre_enqueue=None,
        less=None,
    ):
        self._clock = clock or Clock()
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff
        # PodSchedulingReadiness feature gate: when off, schedulingGates
        # are ignored (pre-1.26 behavior) and nothing parks as gated
        self._honor_gates = honor_scheduling_gates
        # out-of-tree PreEnqueue point (interface.go#PreEnqueuePlugin):
        # pod -> bool; False parks the pod as gated exactly like
        # schedulingGates, re-evaluated on pod update
        self._pre_enqueue = pre_enqueue
        # out-of-tree QueueSort point: QueuedPodInfo x2 -> bool ("pops
        # first"); replaces the default PrioritySort heap key
        self._less = less
        self._seq = itertools.count()

        self._active: list[tuple[int, float, int, str]] = []  # (-prio, ts, seq, key)
        self._backoff: list[tuple[float, int, str]] = []  # (ready_at, seq, key)
        self._unschedulable: dict[str, QueuedPodInfo] = {}
        self._gated: dict[str, QueuedPodInfo] = {}
        self._info: dict[str, QueuedPodInfo] = {}
        # which structure a pod key lives in: active|backoff|unsched|gated
        self._where: dict[str, str] = {}
        # incremental per-structure sizes so pending_counts is O(1) — the
        # scheduler refreshes the pending_pods gauge on every queue
        # transition, which must not cost an O(pods) scan per watch event
        self._counts = {"active": 0, "backoff": 0, "unsched": 0, "gated": 0}

        self.scheduling_cycle = 0
        self._move_request_cycle = -1

    # -- helpers --

    def __len__(self) -> int:
        return len(self._info)

    def _set_where(self, key: str, where: str) -> None:
        old = self._where.get(key)
        if old is not None:
            self._counts[old] -= 1
        self._counts[where] += 1
        self._where[key] = where

    def _unset_where(self, key: str) -> None:
        old = self._where.pop(key, None)
        if old is not None:
            self._counts[old] -= 1

    def pending_counts(self) -> dict[str, int]:
        """pending_pods{queue=...} metric shape (O(1): incrementally
        maintained by the _set_where/_unset_where transitions)."""
        c = self._counts
        return {
            "active": c["active"],
            "backoff": c["backoff"],
            "unschedulable": c["unsched"],
            "gated": c["gated"],
        }

    def entries(self) -> dict[str, str]:
        """Pod key -> structure it currently lives in (``active`` |
        ``backoff`` | ``unsched`` | ``gated``). Read-only snapshot for
        observers (the sim's lost-pod invariant checker accounts every
        unbound pod against this map plus the scheduler's in-flight and
        waiting sets) — never a mutation surface."""
        return dict(self._where)

    def active_pods(self) -> list[Pod]:
        """Live activeQ pods, unordered snapshot — the mega-planner's
        warm-start reads the POPULATION to plan over (heap order is
        what ``reorder_active`` is about to rewrite anyway)."""
        return [
            self._info[key].pod
            for key, where in self._where.items()
            if where == "active"
        ]

    def reorder_active(self, rank: dict[str, int]) -> int:
        """Warm-start reorder (ISSUE 19): re-key the activeQ heap's
        tiebreak slot with an externally computed rank so pods the
        mega-planner expects to co-locate pop adjacently and the drain
        chunks pack against pre-fitted capacity. PRIORITY STAYS THE
        PRIMARY KEY — PrioritySort's contract is untouched; the rank
        only permutes pods WITHIN a priority band (it replaces the
        queue-timestamp tiebreak, which carries no cross-pod semantics
        beyond FIFO fairness). Unranked pods keep popping after ranked
        ones in their band, FIFO among themselves via the seq slot.
        No-op (returns 0) under a custom QueueSort ``less`` — an
        out-of-tree comparator owns the full key and must not be
        second-guessed. Returns the number of live entries re-keyed."""
        if self._less is not None or not self._active:
            return 0
        fresh: list[tuple[int, float, int, str]] = []
        rekeyed = 0
        for neg_prio, _ts, seq, key in self._active:
            if self._where.get(key) != "active":
                continue  # stale entry: drop during the rebuild
            r = rank.get(key)
            if r is None:
                fresh.append((neg_prio, float("inf"), seq, key))
            else:
                fresh.append((neg_prio, float(r), seq, key))
                rekeyed += 1
        heapq.heapify(fresh)
        self._active = fresh
        return rekeyed

    def _push_active(self, info: QueuedPodInfo) -> None:
        if self._less is not None:
            key0 = _SortKey(info, self._less)
            heapq.heappush(
                self._active, (key0, 0.0, next(self._seq), info.key)
            )
        else:
            heapq.heappush(
                self._active,
                (
                    -info.pod.effective_priority,
                    info.timestamp,
                    next(self._seq),
                    info.key,
                ),
            )
        self._set_where(info.key, "active")

    def _gate(self, pod: Pod) -> bool:
        """PreEnqueue verdict: True = park as gated. The in-tree
        schedulinggates check and any out-of-tree PreEnqueue plugin both
        gate here (scheduling_queue.go#runPreEnqueuePlugins)."""
        if pod.scheduling_gates and self._honor_gates:
            return True
        return self._pre_enqueue is not None and not self._pre_enqueue(pod)

    def _activate(self, info: QueuedPodInfo) -> bool:
        """EVERY path into the active heap funnels through the PreEnqueue
        gate (scheduling_queue.go#moveToActiveQ): a mutable out-of-tree
        PreEnqueue plugin may have closed since the pod last entered, and
        unlike schedulingGates (which are never re-added) that verdict is
        not monotone. Returns False when the pod parked as gated."""
        if self._gate(info.pod):
            info.gated = True
            self._gated[info.key] = info
            self._info[info.key] = info
            self._set_where(info.key, "gated")
            return False
        info.gated = False
        self._push_active(info)
        return True

    def _backoff_duration(self, attempts: int) -> float:
        """#calculateBackoffDuration: 1s doubling per prior attempt, capped."""
        d = self._initial_backoff
        for _ in range(attempts - 1):
            d *= 2
            if d >= self._max_backoff:
                return self._max_backoff
        return min(d, self._max_backoff)

    def _backoff_ready_at(self, info: QueuedPodInfo) -> float:
        return info.timestamp + self._backoff_duration(max(info.attempts, 1))

    def _push_backoff(self, info: QueuedPodInfo) -> None:
        heapq.heappush(
            self._backoff, (self._backoff_ready_at(info), next(self._seq), info.key)
        )
        self._set_where(info.key, "backoff")

    # -- add / update / delete (informer handlers) --

    def add(self, pod: Pod) -> None:
        now = self._clock.now()
        info = QueuedPodInfo(
            pod=pod, timestamp=now, initial_attempt_timestamp=now
        )
        if self._gate(pod):
            # PreEnqueue rejection (schedulinggates or out-of-tree plugin)
            info.gated = True
            self._gated[pod.key] = info
            self._info[pod.key] = info
            self._set_where(pod.key, "gated")
            metrics.queue_incoming_pods_total.labels("gated", "PodAdd").inc()
            return
        self._info[pod.key] = info
        self._push_active(info)
        metrics.queue_incoming_pods_total.labels("active", "PodAdd").inc()

    def update(self, pod: Pod) -> None:
        info = self._info.get(pod.key)
        if info is None:
            self.add(pod)
            return
        info.pod = pod
        where = self._where[pod.key]
        if where == "gated" and not self._gate(pod):
            info.gated = False
            del self._gated[pod.key]
            info.timestamp = self._clock.now()
            self._push_active(info)
        elif where == "unsched":
            # spec update may make it schedulable: move to active/backoff
            # (reference: isPodUpdated => move)
            self._move_one(info)

    def delete(self, pod_key: str) -> None:
        self._info.pop(pod_key, None)
        self._gated.pop(pod_key, None)
        self._unschedulable.pop(pod_key, None)
        self._unset_where(pod_key)
        # lazy deletion for heap entries: popping skips stale keys

    # -- pop --

    def pop_batch(self, max_pods: int) -> list[QueuedPodInfo]:
        """K sequential Pops worth of pods, in exact heap order."""
        self.flush_backoff_completed()
        out: list[QueuedPodInfo] = []
        while len(out) < max_pods and self._active:
            _, _, _, key = heapq.heappop(self._active)
            if self._where.get(key) != "active":
                continue  # stale entry
            info = self._info[key]
            info.attempts += 1
            self.scheduling_cycle += 1
            self._unset_where(key)
            del self._info[key]
            out.append(info)
        return out

    def take_for_gang(self, matches, exclude=frozenset()) -> list[QueuedPodInfo]:
        """Pop every queued pod for which ``matches(pod)`` is true out
        of the active/backoff/unschedulable structures, with exactly
        ``pop_batch``'s per-pod bookkeeping (attempt charge +
        scheduling-cycle advance). The scheduler's gang gate uses this
        to pull the rest of a ready pod group into the batch
        regardless of heap position or backoff state — a gang pops as
        a UNIT. Gated pods stay put (their PreEnqueue gates have not
        cleared, and a gang cannot be ready while a member is gated).
        Heap entries for taken pods go stale and are skipped by the
        lazy-deletion discipline every pop already applies."""
        out: list[QueuedPodInfo] = []
        for key in sorted(self._where):
            if key in exclude or self._where.get(key) == "gated":
                continue
            info = self._info.get(key)
            if info is None or not matches(info.pod):
                continue
            info.attempts += 1
            self.scheduling_cycle += 1
            self._unschedulable.pop(key, None)
            self._unset_where(key)
            del self._info[key]
            out.append(info)
        return out

    # -- failure / retry paths --

    def requeue_popped(self, info: QueuedPodInfo) -> None:
        """Return a popped pod to the active queue as if the pop had not
        happened: the attempt is uncharged and the original queue
        timestamp keeps its PrioritySort/FIFO position. Used when a
        dispatched device solve is DISCARDED by the pipelined loop's
        fence (Scheduler.run_pipelined) — the failure is the solve's, not
        the pod's, so no backoff applies. The PreEnqueue gate still runs
        (_activate), matching every other path into the active heap."""
        info.attempts = max(info.attempts - 1, 0)
        self._info[info.key] = info
        self._activate(info)
        metrics.queue_incoming_pods_total.labels(
            self._where[info.key], "SolveDiscarded"
        ).inc()

    def add_unschedulable(self, info: QueuedPodInfo, pod_scheduling_cycle: int) -> None:
        """#AddUnschedulableIfNotPresent."""
        now = self._clock.now()
        info.timestamp = now
        info.unschedulable_since = now
        self._info[info.key] = info
        if self._move_request_cycle >= pod_scheduling_cycle:
            # an event fired while this pod was in flight: don't park it
            self._push_backoff(info)
            metrics.queue_incoming_pods_total.labels(
                "backoff", "ScheduleAttemptFailure"
            ).inc()
        else:
            self._unschedulable[info.key] = info
            self._set_where(info.key, "unsched")
            metrics.queue_incoming_pods_total.labels(
                "unschedulable", "ScheduleAttemptFailure"
            ).inc()

    def _move_one(self, info: QueuedPodInfo) -> None:
        self._unschedulable.pop(info.key, None)
        now = self._clock.now()
        if self._backoff_ready_at(info) > now:
            self._push_backoff(info)
        else:
            info.timestamp = now
            self._activate(info)

    def move_all_to_active_or_backoff(self, event: str = "", worth=None) -> None:
        """#MoveAllToActiveOrBackoffQueue with QueueingHints: ``worth`` is
        the isPodWorthRequeuing gate (scheduling_queue.go) — a predicate
        over QueuedPodInfo built by the event handler from what actually
        changed (e.g. "does this pod fit the updated node's new free
        capacity"). Pods failing the hint STAY parked; ``worth=None``
        moves everything (events with no registered hint — safe,
        strictly more wakeups than the reference)."""
        self._move_request_cycle = self.scheduling_cycle
        for info in list(self._unschedulable.values()):
            if worth is None or worth(info):
                self._move_one(info)
                metrics.queue_incoming_pods_total.labels(
                    self._where[info.key], event or "ClusterEvent"
                ).inc()

    def flush_backoff_completed(self) -> None:
        """#flushBackoffQCompleted (reference runs this every 1s; we run it
        on every pop_batch as well)."""
        now = self._clock.now()
        while self._backoff:
            ready_at, _, key = self._backoff[0]
            if self._where.get(key) != "backoff":
                heapq.heappop(self._backoff)
                continue
            if ready_at > now:
                break
            heapq.heappop(self._backoff)
            info = self._info[key]
            info.timestamp = now
            self._activate(info)
            metrics.queue_incoming_pods_total.labels(
                self._where[key], "BackoffComplete"
            ).inc()

    def flush_unschedulable_leftover(self) -> None:
        """#flushUnschedulablePodsLeftover: pods stuck > 5 min forced back."""
        now = self._clock.now()
        for info in list(self._unschedulable.values()):
            if (
                info.unschedulable_since is not None
                and now - info.unschedulable_since > MAX_UNSCHEDULABLE_DURATION
            ):
                self._move_one(info)
