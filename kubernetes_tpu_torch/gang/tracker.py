"""Gang membership bookkeeping (host-side, no device surface).

The tracker answers three questions the scheduler's pop gate and
commit path ask under the cluster lock:

- which gang does this pod belong to, and how many members does the
  gang need (``gang_of`` / ``min_member``);
- how long has the gang been waiting to assemble (``note_seen`` /
  ``first_seen`` — the min-member timeout that keeps a forever-short
  gang from parking its members in the queue indefinitely);
- how many consecutive solve rounds released the gang without a full
  commit (``note_incomplete`` — past ``GangConfig.quarantine_after``
  the whole gang is quarantined as a unit, exactly like a poison pod,
  so an unsatisfiable gang cannot starve the batch loop).

Everything here is guarded by the scheduler's cluster lock (the same
discipline as ``Scheduler._quarantine``): ktpu: guarded-by(cluster.lock)

Copied from ``kubernetes_tpu/gang/tracker.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.objects import Pod

GANG_LABEL = "scheduling.x-k8s.io/pod-group"
MIN_MEMBER_ANNOTATION = "scheduling.x-k8s.io/pod-group-min-member"


class GangUnsatisfiableError(Exception):
    """Raised/recorded when a gang is quarantined as a unit: its
    membership can never assemble (min-member timeout) or its solve
    deterministically fails every round (consecutive-incomplete
    limit)."""


@dataclass(frozen=True)
class GangConfig:
    """Runtime gang-scheduling configuration (config/types.py parses
    the ``gang:`` YAML section into one of these)."""

    # seconds a gang may wait below its min-member quorum before the
    # members present are quarantined (TTL re-admit still applies, so
    # a late-arriving member can complete the gang after re-admission)
    min_member_timeout: float = 30.0
    # consecutive released (incomplete) solve rounds before the whole
    # gang quarantines as a unit
    quarantine_after: int = 3
    # heterogeneity scoring weight (score points per 1.0 of relative
    # throughput); 0 disables the fold
    throughput_weight: int = 0
    # workload-class -> {accelerator-class -> relative throughput}
    class_throughput: dict = field(default_factory=dict)


class GangTracker:
    """Per-gang assembly + failure bookkeeping."""

    def __init__(self, config: GangConfig) -> None:
        self.config = config
        # gang id -> wall-clock first seen below quorum / first popped
        self._first_seen: dict[str, float] = {}
        # gang id -> consecutive incomplete (released) rounds
        self._incomplete: dict[str, int] = {}

    @staticmethod
    def gang_of(pod: Pod) -> str | None:
        """The pod's gang id (``namespace/group``), or None."""
        name = pod.labels.get(GANG_LABEL)
        if not name:
            return None
        return f"{pod.namespace}/{name}"

    @staticmethod
    def min_member(pod: Pod) -> int:
        """The pod's declared quorum; malformed or missing annotations
        degrade to 1 (the pod schedules as a singleton gang) rather
        than wedging admission."""
        raw = pod.annotations.get(MIN_MEMBER_ANNOTATION, "")
        try:
            return max(int(raw), 1)
        except (TypeError, ValueError):
            return 1

    def note_seen(self, gang_id: str, now: float) -> float:
        """Record (and return) the gang's first-seen timestamp."""
        return self._first_seen.setdefault(gang_id, now)

    def first_seen(self, gang_id: str) -> float | None:
        return self._first_seen.get(gang_id)

    def note_incomplete(self, gang_id: str) -> int:
        """One more released round; returns the consecutive count."""
        n = self._incomplete.get(gang_id, 0) + 1
        self._incomplete[gang_id] = n
        return n

    def incomplete_rounds(self, gang_id: str) -> int:
        return self._incomplete.get(gang_id, 0)

    def note_complete(self, gang_id: str) -> float | None:
        """The gang fully committed: reset failure bookkeeping and
        return the first-seen timestamp (time-to-full-gang metric)."""
        self._incomplete.pop(gang_id, None)
        return self._first_seen.pop(gang_id, None)

    def note_quarantined(self, gang_id: str) -> None:
        """The gang quarantined as a unit: the TTL re-admit starts a
        fresh assembly window with a fresh incomplete budget (the
        per-pod quarantine backoff already grows across repeats)."""
        self._incomplete.pop(gang_id, None)
        self._first_seen.pop(gang_id, None)
