"""Hub high availability: the lease that grants hub epochs, the
standby replicator, and the in-process hub client.

The occupancy hub (fleet/occupancy.py) was a single process — a crash
meant fleet-wide conservative admission until an operator intervened.
This module is the failover half of hub HA:

- ``HubLease`` — one lease per fleet deployment granting monotone
  **hub epochs**: the LeaderElector discipline (duration > renew
  cadence, takeover only after expiry) applied per-hub, on the
  injectable clock so the failover sim runs fully virtual-time. The
  epoch grant is the fencing token of the hub tier — exactly the
  bind-fence / hub-write-fence ladder, one level up.
- ``StandbyReplicator`` — pull-based consumption of the primary's
  append-only op log (``repl_sync``): log catch-up while the cursor is
  inside the retained window, snapshot re-join when it is not, and the
  ``scheduler_hub_replication_lag_rows`` gauge either way. The standby
  holds the same versioned row state, handoff queue, journal
  aggregation deque, and flush-dedup watermarks as the primary, so a
  promotion continues the CAS version counter without a gap (version
  continuity across the epoch boundary — the core failover invariant).
- ``LocalHubClient`` — the ``hub_op`` surface of ``BulkClient``
  dispatched straight against a hub object, no socket: the HA sim and
  tests drive ``RemoteOccupancyExchange``'s endpoint-failover machinery
  deterministically through the SAME ``dispatch_hub_op`` table the gRPC
  server uses, so in-process and on-wire semantics cannot drift.

Scope note: ``HubLease`` coordinates hubs within one process tree (the
sim, tests, the bench ladder). A multi-host deployment backs the same
interface with a real coordination store (the Lease objects the
per-shard LeaderElectors already use); the hub only ever calls
``try_acquire`` / ``renew`` / ``valid``.

Copied from ``kubernetes_tpu/fleet/ha.py``.
"""

from __future__ import annotations

import threading

from .. import metrics
from .occupancy import OccupancyExchange, dispatch_hub_op


class HubLease:
    """Monotone epoch grants with expiry-gated takeover. ``duration_s``
    is the fencing window: a primary that fails to renew within it can
    be superseded, and once superseded its own ``valid`` check fails —
    so a deposed zombie self-fences even before hearing anything."""

    def __init__(self, clock=None, duration_s: float = 10.0) -> None:
        from ..utils.clock import Clock

        self._clock = clock or Clock()
        self.duration_s = float(duration_s)
        self._lock = threading.Lock()
        self._holder: str | None = None
        self._epoch = 0
        self._renewed_at = float("-inf")

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def holder(self) -> str | None:
        with self._lock:
            return self._holder

    def try_acquire(self, holder: str) -> int | None:
        """Grant (or re-confirm) the lease. A new holder only acquires
        after the incumbent's lease EXPIRED — never concurrently — and
        every ownership change bumps the epoch. The incumbent
        re-acquiring is a renewal, not a new epoch."""
        with self._lock:
            now = self._clock.now()
            if self._holder == holder:
                self._renewed_at = now
                return self._epoch
            if (
                self._holder is None
                or now - self._renewed_at > self.duration_s
            ):
                self._holder = holder
                self._epoch += 1
                self._renewed_at = now
                return self._epoch
            return None

    def renew(self, holder: str) -> bool:
        """Refresh the lease — only the current holder, and only while
        its lease has not already expired (an expired holder must go
        back through try_acquire and risk losing the race, exactly the
        LeaderElector renewDeadline discipline)."""
        with self._lock:
            now = self._clock.now()
            if (
                self._holder != holder
                or now - self._renewed_at > self.duration_s
            ):
                return False
            self._renewed_at = now
            return True

    def valid(self, holder: str) -> bool:
        with self._lock:
            return (
                self._holder == holder
                and self._clock.now() - self._renewed_at
                <= self.duration_s
            )

    def release(self, holder: str) -> None:
        """Hand the lease back without waiting out the duration (a hub
        that acquired it and then refused to serve — the stale-
        re-promotion race). The epoch is NOT rewound: monotone gaps
        are harmless, a reused epoch is not."""
        with self._lock:
            if self._holder == holder:
                self._renewed_at = float("-inf")


class LocalHubClient:
    """In-process ``hub_op`` client: same call shape as
    ``BulkClient.hub_op``, dispatched through the shared
    ``dispatch_hub_op`` table, raising the hub's typed exceptions
    directly (the gRPC transport maps them to status codes and the
    remote adapter maps them back — this client just skips the wire)."""

    def __init__(self, hub: OccupancyExchange) -> None:
        self._hub = hub

    def hub_op(self, op: str, **meta) -> dict:
        return dispatch_hub_op(self._hub, op, meta)

    def close(self) -> None:
        pass


class StandbyReplicator:
    """Pull-based standby catch-up: ``poll()`` fetches the primary's
    op log past this standby's cursor (``repl_sync``) and applies it;
    a cursor behind the primary's retained window re-joins via
    snapshot. The source is anything with ``hub_op`` — a
    ``LocalHubClient`` in-process, a ``BulkClient`` across processes —
    so replication rides the same transport as everything else."""

    def __init__(self, standby: OccupancyExchange, source) -> None:
        self.standby = standby
        self._source = source
        self.snapshots_installed = 0
        self.ops_applied = 0
        self.lag = 0

    def poll(self) -> int:
        """One replication round; returns entries applied (a snapshot
        install counts as one). Raises ExchangeUnreachable when the
        source is gone — the caller (the standby's serving loop / the
        sim harness) just polls again later; a dead primary is exactly
        when the standby stops being able to catch up and promotion
        decides instead."""
        from .occupancy import ExchangeUnreachable

        since = self.standby.opseq
        if getattr(self.standby, "needs_catchup", False):
            # re-join after a deposition: this hub's history may have
            # diverged from the successor's and its opseq cursor is
            # meaningless against the new timeline — force a full
            # snapshot (since=-1 is always below the retained window)
            # so the successor's state REPLACES the stale one
            since = -1
        try:
            out = self._source.hub_op("repl_sync", since=since)
        except ExchangeUnreachable:
            raise
        except ConnectionError as e:
            raise ExchangeUnreachable(str(e)) from None
        except Exception as e:
            # a BulkClient source surfaces transport failures as raw
            # grpc.RpcError (the unreachable mapping lives in the
            # remote adapter, which replication does not ride) —
            # normalize so the caller's documented contract holds
            #. Anything without a status code is a
            # real bug and propagates.
            if callable(getattr(e, "code", None)):
                raise ExchangeUnreachable(str(e)) from None
            raise
        latest = int(out.get("latest") or 0)
        applied = 0
        if out.get("snapshot") is not None:
            self.standby.install_snapshot(out["snapshot"])
            self.snapshots_installed += 1
            applied = 1
        else:
            for entry in out.get("ops") or []:
                self.standby.apply_replicated(entry)
                applied += 1
        self.ops_applied += applied
        self.lag = max(latest - self.standby.opseq, 0)
        metrics.hub_replication_lag_rows.set(self.lag)
        if self.lag == 0:
            # caught up to the source: a previously-deposed hub
            # becomes eligible for re-promotion again
            self.standby.note_caught_up()
        return applied
