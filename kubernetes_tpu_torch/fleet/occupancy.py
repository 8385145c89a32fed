"""Cross-shard occupancy exchange: the compact rows fleet replicas
trade before committing placements, so cross-shard
``PodTopologySpread`` / inter-pod anti-affinity stay enforceable
without a global lock.

A replica's shard-filtered cache (state/cluster.py filtered watch)
deliberately contains ONLY its own nodes and pods — peers' placements
are invisible to it. The exchange is the one channel that crosses the
partition: each replica publishes

- **node rows** — (node, zone) for every node it owns: the domain
  inventory peers need to compute global spread skew (an empty peer
  zone is a min-count domain even though no pod row mentions it);
- **pod rows** — (pod, node, zone, namespace, labels) for every
  *label-bearing* pod it has assumed (``pending``) or bound
  (``committed``) on its shard. Label-free pods can never match a
  spread selector or an (anti-)affinity term, so they stay off the
  wire — that is what keeps the rows compact.

Rows are the host-side mirror of the device-resident
``BatchCarriedUsage`` occupancy carry (solver/exact.py): the same
"placements earlier in flight count against constraints solved later"
idea, stretched across replicas instead of chained sub-batches — and
they ride the same tensorcodec wire framing over the bulk gRPC
boundary (server/bulk.py ``ExchangeOccupancy``).

Concurrency contract: the hub serializes every mutation under one lock
and bumps a monotonically increasing ``version``, and admission is
atomic AT THE HUB for every fleet shape — in-process or cross-process.
``compare_and_stage`` is a fenced compare-and-swap on pending rows:
the replica re-checks its cross-shard constraints host-side against a
peer view taken at version V, then lands the pending row only if the
hub is STILL at V (any interleaved stage/commit/withdraw by a peer
moved it). Two replicas racing a hard-spread placement therefore can
never both land it: the hub serializes the two CAS calls, the first
wins, the second gets a typed ``AdmitConflict`` and re-admits against
the fresh rows (which now include the winner's pending row). The CAS
is *fenced* with the token discipline: ``retire`` (a membership
transition declaring the replica dead) revokes its hub write
privilege, so a zombie's CAS — or any other row mutation — rejects
with ``AdmitConflict(fenced=True)`` until the replica re-registers by
wholesale republish (``publish_nodes`` / ``replace_pod_rows``, the
resync path every heal already takes). Cross-process replicas reach
all of this over the bulk service's ``HubOp`` RPC via
``fleet.runtime.RemoteOccupancyExchange``; version conflicts map to
gRPC ABORTED and fenced conflicts to FAILED_PRECONDITION — semantic
rejections the BulkClient never retries (unlike UNAVAILABLE).

Granularity scope note: by default the CAS compares against the ONE
hub-wide version, so any interleaved write — even a row that cannot
touch the admitted pod's spread domain — costs the admit a
re-fetch/re-check round (bounded by FleetRuntime._CAS_ATTEMPTS, then
an ordinary requeue; ``scheduler_fleet_admit_cas_conflict_total`` is
the observability). The fleet backlog drain made that contention
measurable (N replicas' write-behind flushes all bump the one
version), so ``compare_and_stage(domain_scope=True)`` now offers
PER-DOMAIN versioning, keyed on what actually interferes: a
LABEL-FREE row's only cross-replica effect is capacity on its node,
and a node lives in exactly one zone — so label-free rows bump only
their zone's domain version. Label-bearing rows can shift spread
skew / anti-affinity evaluation in EVERY zone (selectors are global),
and membership mutations (publish/replace/retire/handoff) reshape the
domain inventory itself — those bump the hub-wide domain FLOOR.
Fleet-drain ledger mutations bump neither (the ledger touches no
occupancy row), which is precisely the churn the scoped CAS stops
paying for. A domain-scoped CAS conflicts iff
``max(zone_version, floor) > expected_version`` — same typed
rejection, same fence, strictly fewer spurious retries
(``FleetConfig.cas_domain`` opts a replica in).

High availability (hub HA): the hub is no longer necessarily one
process. Every mutation appends a version-keyed entry to an
append-only OP LOG; one or more STANDBY hubs replicate it (snapshot +
log catch-up on join — fleet/ha.py ``StandbyReplicator``) so a standby
holds the same versioned row state, handoff queue, and journal
aggregation deque as the primary. Hubs carry a monotone ``hub_epoch``
granted by a lease (fleet/ha.py ``HubLease``, the LeaderElector
discipline applied per-hub): only the current lease holder is PRIMARY
and may serve the replica-facing surface; a hub whose lease was taken
over (a deposed old primary, or a not-yet-promoted standby) rejects
that surface with the typed ``HubDeposed`` — the fencing
ladder extended to the hub tier, so a partitioned old primary can
never accept a CAS the new primary doesn't know about (CAS version
continuity across the epoch boundary is the invariant: the standby
replicated the version counter, so the new primary continues it).
Debug/replication reads (``hub_status`` / ``journal_lines`` /
``ops_since`` / ``snapshot``) stay open on a deposed hub — a
post-mortem needs them — while ``RemoteOccupancyExchange`` verifies
the epoch on every reply is monotone, so a client that has seen the
new primary structurally ignores anything an old one still serves.

Copied from ``kubernetes_tpu/fleet/occupancy.py``.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, replace
from typing import Iterable, Mapping

import numpy as np

from .. import metrics
from . import drain as fleet_drain

PENDING = "pending"
COMMITTED = "committed"


class ExchangeUnreachable(Exception):
    """The occupancy hub cannot be reached from this replica (network
    partition / hub outage). Raised by every hub operation while the
    replica is partitioned; FleetRuntime degrades to its cached peer
    view, whose growing age drives admission conservative
    (fleet/runtime.py occupancy-staleness bounds)."""


class AdmitConflict(Exception):
    """Typed hub-side rejection of a row mutation — the cross-process
    analog of the state service's fenced ``ApiError`` (a flag, not a
    message-prefix contract).

    ``fenced=False``: a ``compare_and_stage`` lost its compare — the
    hub version moved past ``expected_version`` between the caller's
    peer-view fetch and its CAS (a peer landed a row first). The caller
    re-fetches and re-admits; ``version`` carries the hub version at
    rejection time. ``fenced=True``: the caller's hub write privilege
    was revoked by ``retire`` (its membership was declared dead) — no
    mutation lands until it re-registers wholesale via resync.

    This is a SEMANTIC rejection, never a transport failure: over the
    wire it maps to gRPC ABORTED / FAILED_PRECONDITION, which the
    BulkClient deliberately does not retry (a blind retry of a lost
    race would re-land the very write the CAS exists to reject —
    the committing-Solve never-retries rule)."""

    def __init__(
        self, message: str, *, fenced: bool = False,
        version: int | None = None,
    ) -> None:
        self.fenced = fenced
        self.version = version
        super().__init__(message)


class HubDeposed(ExchangeUnreachable):
    """Typed rejection from a hub that does not hold the primary lease
    (a deposed old primary after a failover, or a standby that was
    never promoted): the replica-facing surface — reads and writes
    alike — must come from the CURRENT primary, or staleness bounds
    and the CAS fence both unravel. Over the wire this maps to gRPC
    PERMISSION_DENIED (a status no other hub rejection uses), which
    ``RemoteOccupancyExchange`` treats as "this endpoint is not the
    hub": rotate to the next endpoint, never retry here. For a fleet
    replica a deposed hub is functionally unreachable — hence the
    subclassing, so every conservative-degradation handler
    (dirty flag, cached-view aging, staleness bounds) runs unchanged —
    but the process itself is alive: its debug/replication surface
    (hub_status / journal_lines / ops_since / snapshot) still serves,
    and the wire mapping + failover client distinguish it from a dead
    endpoint. Distinct from ``AdmitConflict``, which is a semantic
    answer about one row and is never retried anywhere."""

    def __init__(self, message: str, *, epoch: int = 0, role: str = "") -> None:
        self.epoch = epoch
        self.role = role
        super().__init__(message)


@dataclass(frozen=True)
class NodeRow:
    """Domain-inventory row: one owned node and its zone key."""

    node: str
    zone: str = ""


@dataclass(frozen=True)
class PodRow:
    """One label-bearing placement a replica holds (assumed or
    bound)."""

    pod: str  # ns/name key
    node: str
    zone: str
    namespace: str
    labels: tuple[tuple[str, str], ...]  # sorted items
    state: str = PENDING  # pending | committed

    @staticmethod
    def for_pod(pod, node: str, zone: str, state: str = PENDING) -> "PodRow":
        return PodRow(
            pod=pod.key,
            node=node,
            zone=zone,
            namespace=pod.namespace,
            labels=tuple(sorted(pod.labels.items())),
            state=state,
        )


@dataclass(frozen=True)
class PeerView:
    """One consistent snapshot of every OTHER replica's rows, plus the
    hub version it was taken at — the Conflict-on-stale fence value.
    ``peer_ages`` carries, per peer that has ever published, the
    seconds since its last successful publish at view time: a peer
    partitioned from the hub stops publishing, its age grows, and
    admission against its frozen rows turns conservative once the age
    passes the staleness bound (fleet/runtime.py)."""

    version: int
    node_rows: tuple[NodeRow, ...]
    pod_rows: tuple[PodRow, ...]
    peer_ages: tuple[tuple[str, float], ...] = ()


class OccupancyExchange:
    """The in-process hub (one per fleet; the sim's replicas share it
    directly, cross-process deployments reach it through the bulk
    service's ``ExchangeOccupancy`` RPC). All iteration is sorted so
    any serialized view is deterministic."""

    def __init__(
        self, clock=None, *, hub_id: str = "hub", lease=None,
        oplog_capacity: int = 65_536,
    ) -> None:
        from ..utils.clock import Clock

        self._lock = threading.Lock()
        self._version = 0  # ktpu: replicated
        # -- high availability (hub HA) --
        # identity + lease: a standalone hub (lease=None, every
        # deployment before HA) is permanently primary at epoch 1 —
        # zero behavior change. With a lease (fleet/ha.py HubLease)
        # the hub starts as a STANDBY and only serves the
        # replica-facing surface while it holds the lease; the lease
        # grant IS the monotone hub_epoch.
        self._hub_id = hub_id
        self._lease = lease
        self._epoch = 1 if lease is None else 0
        self._role = "primary" if lease is None else "standby"
        # set at every primary -> deposed transition: a deposed hub
        # must catch up from its successor (note_caught_up) before
        # try_promote will re-grant it — re-promoting with stale state
        # would regress the version counter behind a HIGHER epoch
        self._needs_catchup = False
        # append-only op log (replication): every mutation appends
        # (opseq, version_after, ts, kind, payload); standbys consume
        # via ops_since / snapshot. Bounded: a standby further behind
        # than the retained window re-joins via snapshot.
        from collections import deque as _deque

        self._oplog: _deque = _deque(maxlen=oplog_capacity)
        self._opseq = 0
        # idempotent client flush dedup: replica -> (client id, last
        # applied flush_seq). A retried write-behind flush whose reply
        # was lost after the server-side apply lands exactly once.
        self._flush_seen: dict[str, tuple[str, int]] = {}  # ktpu: replicated
        self.flush_dedup_hits = 0
        # fault seams + failover accounting: set_down models the whole
        # hub process dying (every op from every replica raises
        # ExchangeUnreachable); set_flush_fault injects a reply loss
        # AFTER a server-side apply_ops apply (the double-apply
        # hazard's trigger); deposed_write_rejections counts writes a
        # non-primary hub fenced off (the stale-primary proof the
        # failover sim pins).
        self._down = False
        self._flush_faults = 0
        self.deposed_write_rejections = 0
        # publish timestamps (staleness bounds): replica -> when it
        # last successfully wrote anything to the hub. Off the
        # injectable clock so the sim's virtual timeline covers row
        # aging too.
        self._clock = clock or Clock()
        self._published_at: dict[str, float] = {}
        # replicas currently partitioned from the hub (sim fault seam):
        # every operation FROM a partitioned replica raises
        # ExchangeUnreachable — its writes don't land, its reads fail,
        # and its published_at freezes, which is what peers' staleness
        # bounds key off.
        self._partitioned: set[str] = set()
        # replicas whose hub write privilege is revoked (retire()): the
        # fencing-token discipline extended to the hub — a peer
        # observed this replica's lease stale and retired it, so its
        # row mutations must not land until it re-registers by
        # wholesale republish (publish_nodes / replace_pod_rows — the
        # path every heal's forced resync already takes). Reads stay
        # open: a zombie reading rows is harmless, a zombie WRITING
        # rows would distort every peer's admission.
        self._revoked: set[str] = set()
        # metric children resolved once: stage/commit run per placed
        # pod on the scheduler's apply path, and the label lookup is
        # measurable there (ops mirror the metric help string)
        self._m = {
            op: metrics.fleet_occupancy_rows_total.labels(op)
            for op in ("staged", "committed", "withdrawn", "retired",
                       "handoff")
        }
        self._node_rows: dict[str, dict[str, NodeRow]] = {}  # replica -> node -> row; ktpu: replicated
        self._pod_rows: dict[str, dict[str, PodRow]] = {}  # replica -> pod -> row; ktpu: replicated
        # pod handoffs: to-replica -> pod key -> (hop count, journey
        # trace id). A replica whose shard cannot legally host a routed
        # pod (persistent cross-shard conflict) releases it here for
        # the next replica in the pod's rendezvous chain
        # (fleet/runtime.py). The trace id is the journey trace
        # threaded ACROSS the handoff: the adopting replica's journal
        # records continue the same trace, so `obs explain --fleet`
        # renders enqueue→handoff→re-admit→bind as ONE trace.
        self._handoffs: dict[str, dict[str, tuple[int, str]]] = {}  # ktpu: replicated
        # append-only journal aggregation surface (the cross-replica
        # obs tentpole): replicas ship bounded decision-journal
        # segments — piggybacked on the existing write-behind flush,
        # no new RPC cadence — and `obs explain --fleet` reads the
        # merged stream. Bounded: a long-lived hub keeps the recent
        # window, not unbounded history (replicas' own sinks are the
        # durable store).
        from collections import deque

        self._journal: deque[str] = deque(maxlen=262_144)  # ktpu: replicated
        # replicas whose solve breaker is open (degraded-mode solve
        # resilience): peers prefer them LAST in rendezvous handoff
        # chains — don't route refugees to a sick replica. The replica
        # keeps serving its own shard (the fallback ladder guarantees
        # forward progress); this flag only shapes cross-shard routing.
        self._degraded: set[str] = set()  # ktpu: replicated
        # fleet backlog drain ledger (fleet/drain.py state dict, None
        # while no drain is active): partitions, granted leases, the
        # done map, and the orphan pool. Replicated as INCREMENTAL
        # "drain" op-log entries replayed through the same pure
        # state-machine functions, so a promoted standby continues the
        # ledger without a gap — a 512k-key ledger must not be
        # re-shipped wholesale per progress report.
        self._drain: dict | None = None  # ktpu: replicated
        # per-domain CAS versions (scope note up top): zone -> hub
        # version at the last label-free row landing in it, plus the
        # hub-wide floor every globally-visible mutation advances.
        # Reset conservatively (floor = version) on snapshot install —
        # a freshly promoted standby starts strict and relaxes as new
        # writes refine the map.
        self._domain_versions: dict[str, int] = {}
        self._domain_floor = 0

    @property
    # ktpu: fence-exempt(down-gated wake-seed read; admission-relevant version reads ride peers_version, which is fenced)
    def version(self) -> int:
        # bookkeeping surface (wake-version seeding, tests), down-
        # gated but deliberately NOT role-fenced: admission-relevant
        # version reads ride peers_version/peers_view, which are.
        # A stale wake seed only delays a conflict-parked wakeup by
        # one poll.
        with self._lock:
            self._check_down_locked()
            return self._version

    @property
    def hub_epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def opseq(self) -> int:
        """Applied op-log cursor (replication bookkeeping)."""
        with self._lock:
            return self._opseq

    @property
    def role(self) -> str:
        with self._lock:
            return self._role

    # -- high availability: lease, roles, op log --

    def try_promote(self, *, allow_stale: bool = False) -> int | None:
        """Attempt to take (or retake) the hub lease. Returns the
        granted epoch, or None while another hub's lease is live. A
        grant past epoch 1 is a FAILOVER — the previous primary was
        deposed — and ticks ``scheduler_hub_failover_total``. The
        standby's replicated state (rows, handoffs, journal, flush
        dedup, and crucially the VERSION counter) is what it starts
        serving from, so CAS version continuity holds across the
        epoch boundary.

        A hub that was DEPOSED refuses to re-promote until it has
        caught up from the hub that superseded it
        (``note_caught_up``, set by StandbyReplicator at lag 0):
        re-acquiring an expired lease at a HIGHER epoch while serving
        PRE-deposition state would regress the version counter and
        hide the interim primary's committed rows behind an epoch the
        clients' monotone check must accept — exactly the continuity
        the fence exists for. ``allow_stale=True`` is the operator
        override for the disaster case (every caught-up hub is gone
        and stale state beats no hub)."""
        if self._lease is None:
            return None  # standalone hub: permanently primary
        with self._lock:
            if (
                self._needs_catchup
                and not allow_stale
                and self._lease.epoch != self._epoch
            ):
                # a SUCCESSOR took the lease past our epoch: our state
                # may have diverged — refuse until the snapshot
                # re-join. (Lease epoch == ours means nobody ever took
                # over — a transient self-expiry with no standby — so
                # there is no successor timeline to diverge from and
                # refusing would wedge the only hub forever.)
                return None
        granted = self._lease.try_acquire(self._hub_id)
        if granted is None:
            return None
        with self._lock:
            if (
                self._needs_catchup
                and not allow_stale
                and granted != self._epoch
            ):
                # raced a successor's expiry: the grant just advanced
                # the epoch past our (possibly stale) state — hand the
                # lease back rather than serve stale rows at an epoch
                # clients must accept
                self._lease.release(self._hub_id)
                return None
            epoch_advanced = granted != self._epoch
            became_primary = self._role != "primary"
            self._epoch = granted
            self._role = "primary"
            self._needs_catchup = False
        if epoch_advanced or became_primary:
            metrics.hub_epoch.set(granted)
        if granted > 1 and epoch_advanced:
            # an actual takeover — NOT the same-holder renewal this
            # method also serves
            metrics.hub_failover_total.inc()
        return granted

    def note_caught_up(self) -> None:
        """Replication reached lag 0 against the current primary
        (StandbyReplicator): a previously-deposed hub is eligible for
        promotion again."""
        with self._lock:
            self._needs_catchup = False

    @property
    def needs_catchup(self) -> bool:
        """True after a deposition, until replication catches up. A
        deposed hub's history may have DIVERGED from its successor's
        (ops it acked that never replicated), and its opseq cursor is
        meaningless against the new timeline — the replicator reads
        this flag and re-joins via FULL SNAPSHOT instead of a log
        suffix, so the successor's state replaces (never merges with)
        the stale one."""
        with self._lock:
            return self._needs_catchup

    def heartbeat(self) -> bool:
        """Primary lease renewal (the hub's liveness loop). A failed
        renewal means the lease moved on — self-depose so the stale
        incarnation fences its own replica-facing surface even before
        any peer tells it anything."""
        if self._lease is None:
            return True
        with self._lock:
            if self._role != "primary":
                return False
        if self._lease.renew(self._hub_id):
            return True
        with self._lock:
            if self._role == "primary":
                self._role = "deposed"
                self._needs_catchup = True
        return False

    def set_down(self, down: bool) -> None:
        """Fault seam: the hub process is gone (crash/kill). EVERY
        operation — any replica, reads and writes, replication —
        raises ExchangeUnreachable until the seam clears. Clearing it
        models the old process resurfacing (partitioned-zombie style:
        alive, lease long lost)."""
        with self._lock:
            self._down = down

    def set_flush_fault(self, count: int = 1) -> None:
        """Fault seam: the next ``count`` apply_ops calls apply fully
        server-side, then raise ExchangeUnreachable — the lost-reply
        window behind the write-behind double-apply hazard. The
        client's retry of the same (client, flush_seq) must dedup."""
        with self._lock:
            self._flush_faults = int(count)

    # callers hold self._lock
    def _check_down_locked(self) -> None:
        if self._down:
            raise ExchangeUnreachable(
                f"occupancy hub {self._hub_id} is down"
            )

    # callers hold self._lock
    # ktpu: fence-check
    def _ensure_primary_locked(self, *, write: bool, op: str) -> None:
        """Role fence for the replica-facing surface: only the live
        lease holder serves it. A primary whose lease silently expired
        (the deposed-zombie case) discovers it here and self-deposes;
        writes it rejected are counted — the failover sim's
        stale-primary-writes-rejected proof."""
        if self._lease is None:
            return
        if self._role == "primary" and not self._lease.valid(self._hub_id):
            self._role = "deposed"
            self._needs_catchup = True
        if self._role != "primary":
            if write:
                self.deposed_write_rejections += 1
            raise HubDeposed(
                f"hub {self._hub_id} is {self._role} at epoch "
                f"{self._epoch}: {op!r} must go to the current primary",
                epoch=self._epoch,
                role=self._role,
            )

    # callers hold self._lock; appends one replication entry. ts rides
    # the entry so a standby's publish stamps replay the PRIMARY's
    # timeline (read-only touches don't replicate — a promoted
    # standby's peer ages then read slightly OLDER than truth, which
    # errs conservative).
    # ktpu: fenced-by-caller
    def _log(self, kind: str, payload: list) -> None:
        self._opseq += 1
        self._oplog.append(
            [self._opseq, self._version, self._clock.now(), kind, payload]
        )

    # -- partition seam (hub reachability, per replica) --

    def set_partitioned(self, replica: str, partitioned: bool) -> None:
        """Sim/fault seam: model ``replica`` losing (or regaining) its
        network path to the hub. While partitioned, every hub operation
        from that replica raises ExchangeUnreachable."""
        with self._lock:
            if partitioned:
                self._partitioned.add(replica)
            else:
                self._partitioned.discard(replica)

    def _check_reachable(self, replica: str) -> None:
        # callers hold self._lock or tolerate the benign race (the
        # partition flag only ever flips between whole sim cycles)
        self._check_down_locked()
        if replica in self._partitioned:
            raise ExchangeUnreachable(
                f"replica {replica} is partitioned from the occupancy hub"
            )

    # ktpu: fenced-by-caller
    def _check_write_fence(self, replica: str) -> None:
        # callers hold self._lock
        if replica in self._revoked:
            raise AdmitConflict(
                f"replica {replica} was retired at the hub (membership "
                "declared it dead): row mutations are fenced until it "
                "re-registers by wholesale republish",
                fenced=True,
                version=self._version,
            )

    def _touch(self, replica: str) -> None:
        """Refresh ``replica``'s liveness stamp. Rows are maintained
        incrementally (every change stages/commits/withdraws
        immediately), so between changes no-news-is-good-news AS LONG
        AS the replica can still reach the hub: any successful
        reachability-gated operation — reads included — proves its
        rows are current and refreshes the stamp. Without the
        read-side touch, a healthy but IDLE peer (no pod churn) would
        age past max_row_age_s and starve every cross-shard-
        constrained pod fleet-wide."""
        self._published_at[replica] = self._clock.now()

    # callers hold self._lock and have ALREADY bumped self._version for
    # the mutation being recorded (domain versions store the post-bump
    # value — the version a domain-scoped CAS must not be older than).
    # Scope rule from the module docstring: a label-free row's only
    # cross-replica effect is capacity on its node, and a node lives in
    # one zone — zone-local; a label-bearing row can shift spread/anti
    # evaluation in every zone — hub-wide floor.
    # ktpu: fenced-by-caller
    def _bump_domain_row_locked(self, row: PodRow) -> None:
        if row.labels:
            self._domain_floor = self._version
        else:
            self._domain_versions[row.zone] = self._version

    # callers hold self._lock, post-bump (see above): membership-shaped
    # mutations (publish/replace/retire/handoff/claim/degraded) change
    # what EVERY domain's admission can see
    # ktpu: fenced-by-caller
    def _bump_domain_floor_locked(self) -> None:
        self._domain_floor = self._version

    def peers_version(self, replica: str) -> int:
        """The hub version as seen from ``replica`` (reachability-
        gated, unlike the raw ``version`` property)."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=False, op="peers_version")
            self._touch(replica)
            return self._version

    # -- publishing --

    def publish_nodes(self, replica: str, rows: Iterable[NodeRow]) -> None:
        """Replace ``replica``'s domain inventory (called at startup
        and on every resync — the owned set is replaced wholesale, not
        diffed, so a missed event can never leave a stale row). A
        wholesale republish is the replica re-asserting itself from
        cluster truth, so it also clears a hub write fence (the healed
        zombie's forced resync routes here)."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="publish_nodes")
            self._revoked.discard(replica)
            self._version += 1
            self._bump_domain_floor_locked()
            self._node_rows[replica] = {r.node: r for r in rows}
            self._touch(replica)
            self._log(
                "nodes",
                [replica, [[r.node, r.zone] for r in self._node_rows[replica].values()]],
            )

    def stage(self, replica: str, row: PodRow) -> None:
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="stage")
            self._check_write_fence(replica)
            self._stage_locked(replica, row)
        self._m["staged"].inc()

    # callers hold self._lock and have run the reachability/role/fence
    # checks (stage, compare_and_stage, apply_ops share this effect)
    # ktpu: fenced-by-caller
    def _stage_locked(self, replica: str, row: PodRow) -> None:
        self._version += 1
        self._bump_domain_row_locked(row)
        self._pod_rows.setdefault(replica, {})[row.pod] = row
        self._touch(replica)
        self._log("row", [replica, pod_row_to_list(row)])

    def compare_and_stage(
        self, replica: str, row: PodRow, expected_version: int,
        *, domain_scope: bool = False,
    ) -> int:
        """Cross-process atomic admit: land ``row`` as pending ONLY if
        the hub is still at ``expected_version`` — the version the
        caller's host-side constraint recheck ran against. Any
        interleaved mutation (a peer's stage/commit/withdraw, a
        handoff, a membership retire) moved the version, so the
        caller's view may hide a racing placement: reject with a typed
        ``AdmitConflict`` and let the caller re-fetch + re-admit.
        Returns the new hub version on success. Fenced (retired)
        replicas reject regardless of version.

        ``domain_scope=True`` narrows the compare to the row's DOMAIN
        (module-docstring scope note): conflict iff a write that could
        actually interfere — a row in the same zone, any label-bearing
        row, any membership mutation — landed past ``expected_version``.
        Interleaved writes that provably cannot touch this row's
        admission (label-free rows in OTHER zones, fleet-drain ledger
        mutations) no longer cost the caller a re-fetch round. The
        caller still passes the same fetched view version either way —
        opting in changes only which interleavings reject."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="cas_stage")
            self._check_write_fence(replica)
            if domain_scope:
                effective = max(
                    self._domain_versions.get(row.zone, 0),
                    self._domain_floor,
                )
                conflict = effective > expected_version
            else:
                effective = self._version
                conflict = self._version != expected_version
            if conflict:
                raise AdmitConflict(
                    f"hub version moved to {effective} past the "
                    f"admitted view at {expected_version}: a peer's row "
                    "landed first — re-fetch and re-admit",
                    version=self._version,
                )
            self._stage_locked(replica, row)
            version = self._version
        self._m["staged"].inc()
        return version

    def replace_pod_rows(self, replica: str, rows: Iterable[PodRow]) -> None:
        """Replace ``replica``'s pod rows wholesale (resync): rows are
        rebuilt from cluster truth whenever the partition moves, so a
        pod whose DELETE the shard filter later hides from this
        replica can never leave a ghost row behind. Clears a hub write
        fence like publish_nodes (same re-registration argument)."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="replace_pod_rows")
            self._revoked.discard(replica)
            self._version += 1
            self._bump_domain_floor_locked()
            self._pod_rows[replica] = {r.pod: r for r in rows}
            self._touch(replica)
            self._log(
                "rows",
                [replica, [pod_row_to_list(r) for r in self._pod_rows[replica].values()]],
            )

    def commit(self, replica: str, pod_key: str) -> None:
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="commit")
            self._check_write_fence(replica)
            if not self._commit_locked(replica, pod_key):
                return
        self._m["committed"].inc()

    # callers hold self._lock post-checks; True if the row transitioned
    # ktpu: fenced-by-caller
    def _commit_locked(self, replica: str, pod_key: str) -> bool:
        row = self._pod_rows.get(replica, {}).get(pod_key)
        if row is None or row.state == COMMITTED:
            return False
        self._version += 1
        self._bump_domain_row_locked(row)
        committed = replace(row, state=COMMITTED)
        self._pod_rows[replica][pod_key] = committed
        self._touch(replica)
        self._log("row", [replica, pod_row_to_list(committed)])
        return True

    def withdraw(self, replica: str, pod_key: str) -> None:
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="withdraw")
            # fenced like every other mutation: today a retired
            # replica's rows are already dropped (nil data effect),
            # but an asymmetric escape hatch is one refactor away from
            # a zombie deleting a live row
            self._check_write_fence(replica)
            if not self._withdraw_locked(replica, pod_key):
                return
        self._m["withdrawn"].inc()

    # callers hold self._lock post-checks; True if a row was removed
    # ktpu: fenced-by-caller
    def _withdraw_locked(self, replica: str, pod_key: str) -> bool:
        row = self._pod_rows.get(replica, {}).pop(pod_key, None)
        if row is None:
            return False
        self._version += 1
        self._bump_domain_row_locked(row)
        self._touch(replica)
        self._log("row_del", [replica, pod_key])
        return True

    def retire(self, replica: str) -> None:
        """Drop a dead replica's rows: its committed placements become
        visible to the adopting replica through its own resync re-list,
        so keeping them here would double-count. Unclaimed handoffs
        addressed to it revert to plain hash routing — the new route
        owner adopts the pod at its membership-change resync. Also
        REVOKES the replica's hub write privilege (the fencing-token
        discipline): if it is actually a zombie, its next row mutation
        (stage / CAS / commit / withdraw / handoff / degraded-flag)
        rejects with a typed fenced AdmitConflict until its healed
        incarnation re-registers wholesale."""
        with self._lock:
            self._check_down_locked()
            self._ensure_primary_locked(write=True, op="retire")
            self._revoked.add(replica)
            had = (
                bool(self._node_rows.pop(replica, None))
                | bool(self._pod_rows.pop(replica, None))
                | bool(self._handoffs.pop(replica, None))
            )
            self._degraded.discard(replica)
            # a retired replica's frozen publish stamp must not keep
            # peers' staleness bounds conservative forever
            self._published_at.pop(replica, None)
            if had:
                self._version += 1
                self._bump_domain_floor_locked()
            self._log("retire", [replica])
            # a dead replica's drain lease returns for reassignment:
            # outstanding keys (and an unclaimed base partition) become
            # orphans the next claimant adopts — no backlog pod is lost
            # to a mid-drain death. Rides retire so every death path
            # (membership change, sim kill, operator) returns it.
            if self._drain is not None:
                if fleet_drain.return_leases(self._drain, replica):
                    self._version += 1
                self._log("drain", ["return", replica])
        self._m["retired"].inc()

    # -- degraded flags (solve-resilience breaker state) --

    def set_degraded(self, replica: str, degraded: bool) -> None:
        """Publish/clear a replica's degraded flag (its solve circuit
        breaker tripped / re-closed). Bumps the version so peers'
        conflict-parked pods re-evaluate their handoff chains."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="set_degraded")
            self._check_write_fence(replica)
            if degraded == (replica in self._degraded):
                return
            if degraded:
                self._degraded.add(replica)
            else:
                self._degraded.discard(replica)
            self._version += 1
            self._bump_domain_floor_locked()
            self._touch(replica)
            self._log("degraded", [replica, bool(degraded)])

    def degraded_replicas(self) -> frozenset:
        # replica-facing like peers_view (maybe_hand_off orders the
        # fleet-wide handoff chain by these flags): a deposed hub's
        # frozen flags must not route refugees toward a peer whose
        # breaker opened during the blackout
        with self._lock:
            self._check_down_locked()
            self._ensure_primary_locked(write=False, op="degraded_replicas")
            return frozenset(self._degraded)

    # -- journal aggregation (obs explain --fleet's hub surface) --

    def ship_journal(self, replica: str, lines) -> None:
        """Append a replica's journal segment to the aggregation
        surface. Reachability-gated (a partitioned replica's segment
        waits out the partition with its buffered rows) but NOT
        write-fenced: journal lines are append-only observability of
        decisions that already happened — a fenced zombie's history is
        exactly what a post-mortem needs to see."""
        lines = list(lines)
        if not lines:
            return
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="ship_journal")
            self._touch(replica)
            self._journal.extend(lines)
            self._log("journal", [replica, lines])
        metrics.fleet_journal_segments_total.inc()
        metrics.fleet_journal_lines_total.inc(len(lines))

    # ktpu: fence-exempt(down-gated observability read; a standby's merged journal is exactly what obs explain --fleet wants)
    def journal_lines(self) -> list[str]:
        """The aggregated journal stream, in arrival order. `obs
        explain --fleet` re-orders per pod with the merge rules,
        so arrival order only needs to be deterministic, not sorted.
        Down-gated (a dead hub answers nothing); ``debug_state`` is
        the harness's bypass."""
        with self._lock:
            self._check_down_locked()
            return list(self._journal)

    # -- pod handoffs --

    def hand_off(
        self, to_replica: str, pod_key: str, hops: int,
        from_replica: str | None = None,
        trace: str = "",
    ) -> None:
        with self._lock:
            self._check_down_locked()
            self._ensure_primary_locked(write=True, op="hand_off")
            if from_replica is not None:
                self._check_reachable(from_replica)
                self._check_write_fence(from_replica)
                self._touch(from_replica)
            self._version += 1
            self._bump_domain_floor_locked()
            self._handoffs.setdefault(to_replica, {})[pod_key] = (
                hops, trace,
            )
            self._log("handoff", [to_replica, pod_key, hops, trace])
        self._m["handoff"].inc()

    def claim_handoffs(self, replica: str) -> list[tuple[str, int, str]]:
        """Pop every handoff addressed to ``replica`` (sorted, so
        claim order is deterministic). Each claim is (pod key, hops,
        journey trace id) — the trace rode the handoff row so the
        adopting replica's journal continues the SAME trace."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="claim_handoffs")
            self._touch(replica)  # liveness: the poll proves contact
            rows = self._handoffs.pop(replica, None)
            if not rows:
                return []
            self._version += 1
            self._bump_domain_floor_locked()
            self._log("claim", [replica])
            return [
                (k, hops, trace)
                for k, (hops, trace) in sorted(rows.items())
            ]

    # ktpu: fence-exempt(down-gated sim-invariant surface; reads on a standby are harmless and never on the wire)
    def pending_handoff_keys(self) -> set[str]:
        """Pods released by one replica and not yet claimed by the
        next — the fleet lost-pod invariant counts these as tracked.
        Down-gated like every other op (set_down models the whole
        process dying — a dead hub answers nothing); the sim harness
        introspects a downed hub via ``debug_state`` instead."""
        with self._lock:
            self._check_down_locked()
            return {
                k for rows in self._handoffs.values() for k in rows
            }

    # -- fleet backlog drain (the fleet/drain.py ledger, hub-hosted) --

    def drain_init(
        self, replica: str, partitions: Mapping, residual,
        *, membership_version: int = 0,
    ) -> dict:
        """Install a fresh drain ledger: the coordinator (whoever
        hosts the hub primary) ran the global relax plan, partitioned
        the backlog by planned-node shard ownership, and registers the
        result here. Epoch-fenced like every hub write — a deposed
        coordinator's plan never lands — and rejected while a previous
        drain still has outstanding work (two concurrent global plans
        would hand the same pod to two leases)."""
        partitions = {
            str(r): [str(k) for k in ks]
            for r, ks in partitions.items()
        }
        residual = [str(k) for k in residual]
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="drain_init")
            self._check_write_fence(replica)
            if (
                self._drain is not None
                and not fleet_drain.status(self._drain)["complete"]
            ):
                raise AdmitConflict(
                    "a fleet backlog drain is already in progress: "
                    "its ledger must drain dry before a new global "
                    "plan may land",
                    version=self._version,
                )
            self._drain = fleet_drain.new_state(
                partitions, residual,
                epoch=self._epoch,
                membership_version=int(membership_version),
            )
            self._version += 1
            self._touch(replica)
            self._log(
                "drain",
                ["init", partitions, residual, self._epoch,
                 int(membership_version)],
            )
            st = fleet_drain.status(self._drain)
        metrics.fleet_drain_partitions.set(st["partitions"])
        metrics.fleet_drain_residual_pods.set(st["residual"])
        return st

    def drain_claim(self, replica: str) -> dict | None:
        """Grant ``replica`` its next drain lease (fleet/drain.py
        claim order: its own partition, then orphaned work, then the
        serialized residual cohort). Idempotent — a retried claim
        re-serves the granted lease verbatim. Returns None when no
        work is claimable (the replica polls again next cycle)."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="drain_claim")
            self._check_write_fence(replica)
            # liveness: the claim poll proves contact either way
            self._touch(replica)
            if self._drain is None:
                return None
            lease, reassigned = fleet_drain.claim(self._drain, replica)
            if lease is None:
                return None
            self._version += 1
            self._log("drain", ["claim", replica])
        if reassigned:
            metrics.fleet_drain_lease_reassignments_total.inc()
        return lease

    def drain_progress(self, replica: str, keys) -> int:
        """Record pods ``replica`` drained under its lease (one report
        per applied chunk). Doubles as the replica's LIVENESS refresh:
        a long chunk keeps writing nothing else to the hub, and
        without the touch here its publish stamp would age past
        ``max_row_age_s`` mid-drain and flip every peer's constrained
        admission conservative (the staleness interaction the drain
        tentpole must not regress)."""
        keys = [str(k) for k in keys]
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="drain_progress")
            self._check_write_fence(replica)
            self._touch(replica)
            if self._drain is None:
                return 0
            n = fleet_drain.progress(self._drain, replica, keys)
            if n:
                self._version += 1
                self._log("drain", ["progress", replica, keys])
        return n

    def drain_complete(self, replica: str, lease_id: str) -> bool:
        """Mark ``replica``'s granted lease done (its partition slice
        fully drained through its slot ring)."""
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="drain_complete")
            self._check_write_fence(replica)
            self._touch(replica)
            if self._drain is None:
                return False
            ok = fleet_drain.complete(
                self._drain, replica, str(lease_id)
            )
            if ok:
                self._version += 1
                self._log(
                    "drain", ["complete", replica, str(lease_id)]
                )
        return ok

    # ktpu: fence-exempt(down-gated observability read: footers, metrics, the sim's ledger introspection)
    def drain_status(self) -> dict:
        """Counts-only ledger summary (``active=False`` while no drain
        ledger is installed). Down-gated like every read; served by
        standbys too — 'how far did the drain get' is a post-failover
        question."""
        with self._lock:
            self._check_down_locked()
            if self._drain is None:
                return {"active": False}
            return dict(fleet_drain.status(self._drain), active=True)

    # ktpu: fence-exempt(down-gated sim-invariant surface, like pending_handoff_keys)
    def drain_outstanding_keys(self) -> list:
        """Backlog keys not yet drained — the fleet lost-pod invariant
        counts these as hub-tracked (mid-reassignment they sit in no
        replica's queue, exactly like an unclaimed handoff)."""
        with self._lock:
            self._check_down_locked()
            if self._drain is None:
                return []
            return fleet_drain.outstanding_keys(self._drain)

    # callers hold self._lock (apply_replicated): replay one "drain"
    # op-log entry through the SAME pure state-machine functions the
    # primary ran, so the standby's ledger is bit-identical without
    # ever shipping the 512k-key state wholesale
    # ktpu: fence-exempt(standby log replay: the replication apply path MUST write while not primary — fencing it would invert HA)
    def _apply_drain_locked(self, payload) -> None:
        sub = payload[0]
        if sub == "init":
            _sub, partitions, residual, epoch, mv = payload
            self._drain = fleet_drain.new_state(
                partitions, residual,
                epoch=int(epoch), membership_version=int(mv),
            )
            return
        if self._drain is None:
            return
        if sub == "claim":
            fleet_drain.claim(self._drain, payload[1])
        elif sub == "progress":
            fleet_drain.progress(self._drain, payload[1], payload[2])
        elif sub == "complete":
            fleet_drain.complete(self._drain, payload[1], payload[2])
        elif sub == "return":
            fleet_drain.return_leases(self._drain, payload[1])

    # ktpu: fence-exempt(post-mortem bypass: reading a dead process's last state; dispatch_hub_op never exposes it)
    def debug_state(self) -> dict:
        """Harness/post-mortem introspection that deliberately
        bypasses the down seam (reading a dead process's LAST state is
        what a post-mortem of its persisted image would do): pending
        handoff keys + journal lines. Never served over the wire —
        dispatch_hub_op does not expose it."""
        with self._lock:
            return {
                "pending_handoffs": {
                    k for rows in self._handoffs.values() for k in rows
                },
                "journal": list(self._journal),
                "degraded": sorted(self._degraded),
                "version": self._version,
                "opseq": self._opseq,
                "drain": copy.deepcopy(self._drain),
            }

    # -- reading --

    def peers_view(self, replica: str) -> PeerView:
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=False, op="peers_view")
            self._touch(replica)  # liveness: the fetch proves contact
            node_rows = tuple(
                self._node_rows[r][n]
                for r in sorted(self._node_rows)
                if r != replica
                for n in sorted(self._node_rows[r])
            )
            pod_rows = tuple(
                self._pod_rows[r][p]
                for r in sorted(self._pod_rows)
                if r != replica
                for p in sorted(self._pod_rows[r])
            )
            now = self._clock.now()
            peer_ages = tuple(
                (r, max(now - self._published_at[r], 0.0))
                for r in sorted(self._published_at)
                if r != replica
            )
            return PeerView(self._version, node_rows, pod_rows, peer_ages)

    # ktpu: fence-exempt(replication-verification surface: standbys and tests compare raw rows across roles; down-gated, never on the wire)
    def replica_rows(self, replica: str) -> tuple[tuple[NodeRow, ...], tuple[PodRow, ...]]:
        """Raw row export for one replica (replication verification:
        standby-vs-primary comparisons in the HA tests and sims).
        Down-gated like every read — a dead hub answers nothing;
        ``debug_state`` is the deliberate bypass."""
        with self._lock:
            self._check_down_locked()
            return (
                tuple(
                    self._node_rows.get(replica, {})[n]
                    for n in sorted(self._node_rows.get(replica, {}))
                ),
                tuple(
                    self._pod_rows.get(replica, {})[p]
                    for p in sorted(self._pod_rows.get(replica, {}))
                ),
            )

    # -- idempotent write-behind flush (the apply_ops surface) --

    _FLUSH_OP_KINDS = frozenset({"stage", "commit", "withdraw", "journal"})

    def apply_ops(
        self, replica: str, ops: list, *,
        flush_seq: int | None = None, flush_client: str = "",
    ) -> dict:
        """One write-behind flush (RemoteOccupancyExchange) applied
        ATOMICALLY under the hub lock: journal lines land first
        (append-only observability, deliberately not fence-gated — a
        fenced zombie's history is what the post-mortem needs), then
        the buffered stage/commit/withdraw row mutations, fence-
        checked as a unit.

        IDEMPOTENT on ``(replica, flush_client, flush_seq)``: the
        client seals each flush batch with a monotone sequence before
        sending, and a batch whose reply was lost AFTER the
        server-side apply (UNAVAILABLE on the wire) is retried with
        the SAME key — the hub recognizes it and drops the retry
        whole, so rows are never double-staged and journal lines never
        double-append (the latent hazard this closes: the old path
        re-landed the entire buffer). ``flush_client`` scopes the
        sequence to one client incarnation, so a restarted replica
        starting back at seq 0 is never mistaken for a stale retry.
        The dedup watermark is itself replicated (a ``flush_seen`` op
        log entry), so a retry that lands on the PROMOTED standby
        after a failover still dedups. ``flush_seq=None`` (a caller
        predating the sealed-batch client) applies without dedup —
        rows are idempotent upserts either way."""
        for kind, _arg in ops:
            if kind not in self._FLUSH_OP_KINDS:
                # validate BEFORE any effect: a partial apply that
                # died on a bogus kind would double-append its journal
                # lines on retry (the seen watermark is only recorded
                # for fully-applied batches)
                raise ValueError(f"unknown apply_ops kind {kind!r}")
        counts = {"staged": 0, "committed": 0, "withdrawn": 0}
        fenced = False
        flush_fault = False
        journal_landed = 0
        with self._lock:
            self._check_reachable(replica)
            self._ensure_primary_locked(write=True, op="apply_ops")
            if flush_seq is not None:
                seen_client, seen_seq = self._flush_seen.get(
                    replica, ("", -1)
                )
                if flush_client == seen_client and int(flush_seq) <= seen_seq:
                    self.flush_dedup_hits += 1
                    metrics.fleet_flush_dedup_total.inc()
                    return {"deduped": True}
            journal = [arg for kind, arg in ops if kind == "journal"]
            if journal:
                self._journal.extend(journal)
                self._log("journal", [replica, list(journal)])
            fenced = replica in self._revoked
            if not fenced:
                for kind, arg in ops:
                    if kind == "stage":
                        self._stage_locked(replica, pod_row_from_list(arg))
                        counts["staged"] += 1
                    elif kind == "commit":
                        counts["committed"] += self._commit_locked(
                            replica, arg
                        )
                    elif kind == "withdraw":
                        counts["withdrawn"] += self._withdraw_locked(
                            replica, arg
                        )
            if flush_seq is not None:
                self._flush_seen[replica] = (flush_client, int(flush_seq))
                self._log(
                    "flush_seen", [replica, flush_client, int(flush_seq)]
                )
            journal_landed = len(journal)
            if self._flush_faults > 0:
                self._flush_faults -= 1
                flush_fault = True
        for op_name, n in counts.items():
            if n:
                self._m[op_name].inc(n)
        if journal_landed:
            metrics.fleet_journal_segments_total.inc()
            metrics.fleet_journal_lines_total.inc(journal_landed)
        if fenced:
            raise AdmitConflict(
                f"replica {replica} is fenced at the hub: the flush's "
                "row mutations were dropped (its journal lines landed "
                "— append-only history is not fence-gated)",
                fenced=True,
            )
        if flush_fault:
            raise ExchangeUnreachable(
                "injected reply loss AFTER the server-side apply "
                "(set_flush_fault seam): the client must retry this "
                "flush under the same (client, seq) key and the hub "
                "must dedup it"
            )
        return {"applied": counts, "journal": journal_landed}

    # -- replication surface (standby catch-up; fleet/ha.py) --

    def ops_since(self, since: int):
        """Op-log entries past ``since``, plus the latest opseq.
        Returns ``(None, latest)`` when ``since`` predates the
        retained window — the standby must re-join via snapshot.
        Served regardless of role (a deposed primary can still be
        caught up FROM; replication is not the replica-facing
        surface), but not while down."""
        with self._lock:
            self._check_down_locked()
            latest = self._opseq
            if since >= latest:
                return [], latest
            floor = self._oplog[0][0] if self._oplog else self._opseq + 1
            if since < floor - 1:
                return None, latest
            return [list(e) for e in self._oplog if e[0] > since], latest

    # ktpu: fence-exempt(replication pull path: a standby joining MUST read the primary's state; down-gated)
    def snapshot(self) -> dict:
        """Full JSON-able state export for standby join (and the wire
        half of repl_sync when the log window has moved past the
        standby's cursor)."""
        with self._lock:
            self._check_down_locked()
            return {
                "opseq": self._opseq,
                "version": self._version,
                "nodes": {
                    r: [[n.node, n.zone] for _k, n in sorted(rows.items())]
                    for r, rows in self._node_rows.items()
                },
                "pods": {
                    r: [pod_row_to_list(p) for _k, p in sorted(rows.items())]
                    for r, rows in self._pod_rows.items()
                },
                "handoffs": {
                    to: [[k, h, t] for k, (h, t) in sorted(rows.items())]
                    for to, rows in self._handoffs.items()
                },
                "degraded": sorted(self._degraded),
                "revoked": sorted(self._revoked),
                "publishedAt": dict(self._published_at),
                "journal": list(self._journal),
                "flushSeen": {
                    r: [c, s] for r, (c, s) in self._flush_seen.items()
                },
                "drain": copy.deepcopy(self._drain),
            }

    # ktpu: fence-exempt(standby join: the replication apply path MUST write while not primary — fencing it would invert HA)
    def install_snapshot(self, snap: dict) -> None:
        """Replace this hub's replicated state wholesale (standby
        join). Role/epoch/lease are NOT part of the snapshot — a
        standby stays a standby until its own lease grant promotes
        it."""
        with self._lock:
            self._opseq = int(snap.get("opseq") or 0)
            self._version = int(snap.get("version") or 0)
            self._node_rows = {
                r: {n: NodeRow(node=n, zone=z) for n, z in rows}
                for r, rows in (snap.get("nodes") or {}).items()
            }
            self._pod_rows = {
                r: {
                    row.pod: row
                    for row in (pod_row_from_list(v) for v in rows)
                }
                for r, rows in (snap.get("pods") or {}).items()
            }
            self._handoffs = {
                to: {k: (int(h), str(t)) for k, h, t in rows}
                for to, rows in (snap.get("handoffs") or {}).items()
            }
            self._degraded = set(snap.get("degraded") or ())
            self._revoked = set(snap.get("revoked") or ())
            self._published_at = {
                r: float(t)
                for r, t in (snap.get("publishedAt") or {}).items()
            }
            self._journal.clear()
            self._journal.extend(snap.get("journal") or ())
            self._flush_seen = {
                r: (str(c), int(s))
                for r, (c, s) in (snap.get("flushSeen") or {}).items()
            }
            self._drain = copy.deepcopy(snap.get("drain"))
            # domain versions restart conservative: floor at the
            # installed version means a domain-scoped CAS behaves
            # hub-wide until new writes refine the per-zone map —
            # strictly MORE conflicts, never a missed one
            self._domain_versions = {}
            self._domain_floor = self._version
            self._oplog.clear()

    # ktpu: fence-exempt(standby log replay: the replication apply path MUST write while not primary — fencing it would invert HA)
    def apply_replicated(self, entry) -> None:
        """Apply one op-log entry on a STANDBY: raw state effects,
        version-keyed — no reachability/fence/role checks (those ran
        at the primary when the op first landed) and no metric ticks
        (the op was already counted where it happened). The entry is
        re-appended to this hub's own log so a healed old primary can
        later catch up FROM the promoted standby. Entries at or below
        the applied cursor are ignored (catch-up windows overlap
        harmlessly)."""
        opseq, version, ts, kind, payload = entry
        with self._lock:
            if opseq <= self._opseq:
                return
            if kind == "nodes":
                r, rows = payload
                self._node_rows[r] = {
                    n: NodeRow(node=n, zone=z) for n, z in rows
                }
                self._revoked.discard(r)
                self._published_at[r] = ts
            elif kind == "row":
                r, rowlist = payload
                row = pod_row_from_list(rowlist)
                self._pod_rows.setdefault(r, {})[row.pod] = row
                self._published_at[r] = ts
            elif kind == "rows":
                r, rows = payload
                self._pod_rows[r] = {
                    row.pod: row
                    for row in (pod_row_from_list(v) for v in rows)
                }
                self._revoked.discard(r)
                self._published_at[r] = ts
            elif kind == "row_del":
                r, pod_key = payload
                self._pod_rows.get(r, {}).pop(pod_key, None)
                self._published_at[r] = ts
            elif kind == "retire":
                (r,) = payload
                self._revoked.add(r)
                self._node_rows.pop(r, None)
                self._pod_rows.pop(r, None)
                self._handoffs.pop(r, None)
                self._degraded.discard(r)
                self._published_at.pop(r, None)
            elif kind == "degraded":
                r, flag = payload
                if flag:
                    self._degraded.add(r)
                else:
                    self._degraded.discard(r)
            elif kind == "journal":
                _r, lines = payload
                self._journal.extend(lines)
            elif kind == "handoff":
                to, pod_key, hops, trace = payload
                self._handoffs.setdefault(to, {})[pod_key] = (
                    int(hops), str(trace),
                )
            elif kind == "claim":
                (r,) = payload
                self._handoffs.pop(r, None)
                self._published_at[r] = ts
            elif kind == "flush_seen":
                r, client, seq = payload
                self._flush_seen[r] = (str(client), int(seq))
            elif kind == "drain":
                self._apply_drain_locked(payload)
            # unknown kinds are skipped (forward compatibility), but
            # the cursor still advances — the primary wrote them
            self._opseq = opseq
            self._version = version
            # replayed mutations refine the standby's domain map with
            # the same scope rule the primary applied ("row" entries
            # land in _pod_rows above; everything else that moved the
            # version is membership-shaped or ledger churn)
            if kind == "row":
                r, rowlist = payload
                self._bump_domain_row_locked(pod_row_from_list(rowlist))
            elif kind == "drain":
                pass  # ledger churn bumps no domain (the whole point)
            else:
                self._domain_floor = version
            self._oplog.append(list(entry))

    # ktpu: fence-exempt(down-gated observability read; role/epoch are part of the PAYLOAD here, not a gate)
    def hub_status(self) -> dict:
        """The ``GET /debug/hub`` body (and the failover sim's
        introspection): role, epoch, replicated-state cursors, and
        the HA counters. Deliberately served by standbys and deposed
        primaries alike — 'who do you think you are' is exactly the
        question an operator asks a suspect hub."""
        with self._lock:
            self._check_down_locked()
            return {
                "hub": self._hub_id,
                "role": self._role,
                "epoch": self._epoch,
                "needs_catchup": self._needs_catchup,
                "version": self._version,
                "opseq": self._opseq,
                "replicas": sorted(self._published_at),
                "pod_rows": sum(len(v) for v in self._pod_rows.values()),
                "pending_handoffs": sum(
                    len(v) for v in self._handoffs.values()
                ),
                "journal_lines": len(self._journal),
                "flush_dedup_hits": self.flush_dedup_hits,
                "deposed_write_rejections": self.deposed_write_rejections,
                "drain": (
                    fleet_drain.status(self._drain)
                    if self._drain is not None
                    else None
                ),
            }


# -- wire framing (server/tensorcodec.py, the BatchCarriedUsage wire) --


def pod_row_to_list(r: PodRow) -> list:
    """JSON-meta shape of one pod row for the HubOp RPC (state rides
    inline — single-row ops don't need the columnar committed array
    the bulk ExchangeOccupancy payload uses)."""
    return [
        r.pod, r.node, r.zone, r.namespace,
        [list(kv) for kv in r.labels], r.state,
    ]


def pod_row_from_list(v) -> PodRow:
    pod, node, zone, ns, labels, state = v
    return PodRow(
        pod=pod, node=node, zone=zone, namespace=ns,
        labels=tuple((k, val) for k, val in labels), state=state,
    )


def encode_rows(
    replica: str,
    version: int,
    node_rows: Iterable[NodeRow],
    pod_rows: Iterable[PodRow],
) -> bytes:
    """One occupancy payload: row identities/labels in the JSON meta,
    the numeric columns (pending/committed flags) as wire arrays —
    the same meta + column framing the bulk solve path uses."""
    from ..server import tensorcodec

    node_rows = list(node_rows)
    pod_rows = list(pod_rows)
    meta = {
        "replica": replica,
        "version": int(version),
        "nodes": [[r.node, r.zone] for r in node_rows],
        "pods": [
            [r.pod, r.node, r.zone, r.namespace, [list(kv) for kv in r.labels]]
            for r in pod_rows
        ],
    }
    committed = np.fromiter(
        (1 if r.state == COMMITTED else 0 for r in pod_rows),
        dtype=np.int8,
        count=len(pod_rows),
    )
    return tensorcodec.encode(meta, {"committed": committed})


def decode_rows(
    data: bytes,
) -> tuple[str, int, list[NodeRow], list[PodRow]]:
    from ..server import tensorcodec

    meta, arrays = tensorcodec.decode(data)
    node_rows = [NodeRow(node=n, zone=z) for n, z in meta.get("nodes") or []]
    committed = arrays.get("committed")
    pod_rows = []
    for i, (pod, node, zone, ns, labels) in enumerate(meta.get("pods") or []):
        pod_rows.append(
            PodRow(
                pod=pod,
                node=node,
                zone=zone,
                namespace=ns,
                labels=tuple((k, v) for k, v in labels),
                state=(
                    COMMITTED
                    if committed is not None and i < len(committed) and committed[i]
                    else PENDING
                ),
            )
        )
    return (
        str(meta.get("replica") or ""),
        int(meta.get("version") or 0),
        node_rows,
        pod_rows,
    )


def ingest_payload(exchange: OccupancyExchange, data: bytes) -> bytes:
    """Server half of the ``ExchangeOccupancy`` RPC: replace the
    sender's rows wholesale, reply with the hub's merged view of every
    OTHER replica (encoded the same way). Routed through the public
    replace surface so the mutations land in the replication op log
    like every other write (they used to poke hub internals, which
    would have been invisible to a standby)."""
    replica, _version, node_rows, pod_rows = decode_rows(data)
    exchange.publish_nodes(replica, node_rows)
    exchange.replace_pod_rows(replica, pod_rows)
    exchange._m["staged"].inc()
    view = exchange.peers_view(replica)
    return encode_rows("", view.version, view.node_rows, view.pod_rows)


def dispatch_hub_op(hub: OccupancyExchange, op: str, meta: Mapping) -> dict:
    """Dispatch one occupancy-hub operation by name — the ONE op
    surface behind both transports: ``server/bulk.py``'s HubOp gRPC
    method (which maps the typed exceptions to status codes) and
    ``fleet/ha.py``'s LocalHubClient (which raises them directly), so
    the failover client exercises identical semantics in-process and
    over the wire. Raises the hub's typed exceptions
    (ExchangeUnreachable / HubDeposed / AdmitConflict / ValueError);
    every successful reply carries the hub's ``epoch`` — the value
    ``RemoteOccupancyExchange`` verifies is monotone (the client-side
    half of the epoch fence)."""
    replica = str(meta.get("replica") or "")
    out: dict = {}
    if op == "version":
        out["version"] = hub.version
    elif op == "peers_version":
        out["version"] = hub.peers_version(replica)
    elif op == "publish_nodes":
        hub.publish_nodes(
            replica,
            [NodeRow(node=n, zone=z) for n, z in meta.get("nodes") or []],
        )
    elif op == "stage":
        hub.stage(replica, pod_row_from_list(meta["row"]))
    elif op == "cas_stage":
        out["version"] = hub.compare_and_stage(
            replica,
            pod_row_from_list(meta["row"]),
            int(meta["expect"]),
            domain_scope=bool(meta.get("domain_scope")),
        )
    elif op == "replace_pod_rows":
        hub.replace_pod_rows(
            replica,
            [pod_row_from_list(r) for r in meta.get("rows") or []],
        )
    elif op == "commit":
        hub.commit(replica, meta["pod"])
    elif op == "withdraw":
        hub.withdraw(replica, meta["pod"])
    elif op == "apply_ops":
        # write-behind flush: a batch of buffered stage/commit/
        # withdraw mutations plus piggybacked journal segments (kind
        # "journal"), applied atomically and deduped on the client's
        # (flush_client, flush_seq) key — see OccupancyExchange
        # .apply_ops for the idempotency contract
        seq = meta.get("flush_seq")
        out.update(
            hub.apply_ops(
                replica,
                meta.get("ops") or [],
                flush_seq=None if seq is None else int(seq),
                flush_client=str(meta.get("flush_client") or ""),
            )
        )
    elif op == "ship_journal":
        hub.ship_journal(replica, meta.get("lines") or [])
    elif op == "journal_lines":
        out["lines"] = hub.journal_lines()
    elif op == "retire":
        hub.retire(replica)
    elif op == "set_degraded":
        hub.set_degraded(replica, bool(meta.get("degraded")))
    elif op == "degraded_replicas":
        out["replicas"] = sorted(hub.degraded_replicas())
    elif op == "hand_off":
        hub.hand_off(
            meta["to"], meta["pod"], int(meta.get("hops") or 0),
            from_replica=meta.get("from") or None,
            trace=str(meta.get("trace") or ""),
        )
    elif op == "claim_handoffs":
        # (pod, hops, journey trace) — the trace context rides the
        # handoff row across the wire (cross-replica trace propagation)
        out["handoffs"] = [
            [k, h, trace] for k, h, trace in hub.claim_handoffs(replica)
        ]
    elif op == "pending_handoff_keys":
        out["keys"] = sorted(hub.pending_handoff_keys())
    elif op == "peers_view":
        view = hub.peers_view(replica)
        out = {
            "version": view.version,
            "nodes": [[r.node, r.zone] for r in view.node_rows],
            "pods": [pod_row_to_list(r) for r in view.pod_rows],
            "peerAges": [[r, a] for r, a in view.peer_ages],
        }
    elif op == "repl_sync":
        # standby catch-up (fleet/ha.py StandbyReplicator): op-log
        # entries past the standby's cursor, or the full snapshot when
        # the retained window has moved past it
        ops, latest = hub.ops_since(int(meta.get("since") or 0))
        out["latest"] = latest
        if ops is None:
            out["snapshot"] = hub.snapshot()
        else:
            out["ops"] = ops
    elif op == "drain_init":
        # the fleet backlog drain ledger (fleet/drain.py): coordinator
        # installs the global plan's partitions; replicas claim leases,
        # report per-chunk progress (their liveness refresh mid-drain),
        # and complete — all epoch-fenced hub writes
        out["status"] = hub.drain_init(
            replica,
            meta.get("partitions") or {},
            meta.get("residual") or [],
            membership_version=int(meta.get("membership_version") or 0),
        )
    elif op == "drain_claim":
        out["lease"] = hub.drain_claim(replica)
    elif op == "drain_progress":
        out["done"] = hub.drain_progress(replica, meta.get("keys") or [])
    elif op == "drain_complete":
        out["ok"] = hub.drain_complete(
            replica, str(meta.get("lease") or "")
        )
    elif op == "drain_status":
        out["status"] = hub.drain_status()
    elif op == "hub_status":
        out["status"] = hub.hub_status()
    else:
        raise ValueError(f"unknown hub op {op!r}")
    out["epoch"] = hub.hub_epoch
    return out
