"""File-backed hub lease: the ``HubLease`` surface over SQLite.

``fleet/ha.py``'s in-memory ``HubLease`` coordinates hubs within one
process tree; its scope note promises the same interface over a real
coordination store for multi-host deployments. ``SqliteHubLease`` is
that store, provable OFFLINE: one row in one SQLite file (stdlib
``sqlite3`` — nothing to install), every transition a ``BEGIN
IMMEDIATE`` transaction so two hub processes racing on the same file
serialize at the database lock, and the epoch — the fencing token —
PERSISTED, so a restarted coordination store can never hand out a
reused epoch (monotone gaps are harmless, a reused epoch is not).

Semantics mirror ``HubLease`` exactly — the failover suite runs
against both backends:

- ``try_acquire`` by the incumbent is a renewal (no epoch bump); a new
  holder only acquires after the incumbent's lease EXPIRED, and every
  ownership change bumps the epoch;
- ``renew`` refuses a non-holder and an already-expired holder;
- ``release`` expires the lease without rewinding the epoch.

The injectable clock keeps the failover sim fully virtual-time; wall
time never touches the stored state (``renewed_at`` is whatever the
clock said, compared against the same clock later).

Copied from ``kubernetes_tpu/fleet/leasestore.py``.
"""

from __future__ import annotations

import contextlib
import sqlite3
import threading

__all__ = ["SqliteHubLease"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS hub_lease (
    id INTEGER PRIMARY KEY CHECK (id = 0),
    holder TEXT,
    epoch INTEGER NOT NULL,
    renewed_at REAL
)
"""

# renewed_at NULL encodes "never renewed" (float('-inf') in the
# in-memory lease): IEEE infinities don't survive every SQLite
# round-trip, NULL does
_SEED = (
    "INSERT OR IGNORE INTO hub_lease (id, holder, epoch, renewed_at) "
    "VALUES (0, NULL, 0, NULL)"
)


class SqliteHubLease:
    """``HubLease`` over one SQLite file. Safe across threads AND
    processes: each call opens its own connection (no shared handle to
    trip ``check_same_thread``) and mutates inside ``BEGIN
    IMMEDIATE``, so concurrent acquirers serialize at the file lock
    exactly like the in-memory lease serializes at its mutex."""

    def __init__(
        self, path, clock=None, duration_s: float = 10.0
    ) -> None:
        from ..utils.clock import Clock

        self._clock = clock or Clock()
        self.duration_s = float(duration_s)
        self._path = str(path)
        # local serialization for same-process callers: cheaper than
        # colliding on SQLITE_BUSY, and mirrors HubLease's mutex
        self._lock = threading.Lock()
        with self._connect() as db:
            db.execute(_SCHEMA)
            db.execute(_SEED)
            db.commit()

    def _connect(self):
        return contextlib.closing(
            sqlite3.connect(
                self._path, timeout=5.0, isolation_level=None
            )
        )

    @staticmethod
    def _row(db):
        holder, epoch, renewed_at = db.execute(
            "SELECT holder, epoch, renewed_at FROM hub_lease "
            "WHERE id = 0"
        ).fetchone()
        renewed = (
            float("-inf") if renewed_at is None else float(renewed_at)
        )
        return holder, int(epoch), renewed

    @property
    def epoch(self) -> int:
        with self._lock, self._connect() as db:
            return self._row(db)[1]

    @property
    def holder(self) -> str | None:
        with self._lock, self._connect() as db:
            return self._row(db)[0]

    def try_acquire(self, holder: str) -> int | None:
        """Grant (or re-confirm) the lease — the in-memory contract,
        transactional: takeover only after the incumbent expired,
        ownership changes bump the PERSISTED epoch, the incumbent
        re-acquiring is a renewal at its current epoch."""
        with self._lock, self._connect() as db:
            now = self._clock.now()
            db.execute("BEGIN IMMEDIATE")
            try:
                cur, epoch, renewed = self._row(db)
                if cur == holder:
                    db.execute(
                        "UPDATE hub_lease SET renewed_at = ? "
                        "WHERE id = 0",
                        (now,),
                    )
                    db.execute("COMMIT")
                    return epoch
                if cur is None or now - renewed > self.duration_s:
                    db.execute(
                        "UPDATE hub_lease SET holder = ?, "
                        "epoch = epoch + 1, renewed_at = ? "
                        "WHERE id = 0",
                        (holder, now),
                    )
                    db.execute("COMMIT")
                    return epoch + 1
                db.execute("COMMIT")
                return None
            except BaseException:
                db.execute("ROLLBACK")
                raise

    def renew(self, holder: str) -> bool:
        with self._lock, self._connect() as db:
            now = self._clock.now()
            db.execute("BEGIN IMMEDIATE")
            try:
                cur, _epoch, renewed = self._row(db)
                if cur != holder or now - renewed > self.duration_s:
                    db.execute("COMMIT")
                    return False
                db.execute(
                    "UPDATE hub_lease SET renewed_at = ? WHERE id = 0",
                    (now,),
                )
                db.execute("COMMIT")
                return True
            except BaseException:
                db.execute("ROLLBACK")
                raise

    def valid(self, holder: str) -> bool:
        with self._lock, self._connect() as db:
            cur, _epoch, renewed = self._row(db)
            return (
                cur == holder
                and self._clock.now() - renewed <= self.duration_s
            )

    def release(self, holder: str) -> None:
        """Expire without waiting out the duration; the epoch is NOT
        rewound (the in-memory lease's rule, now durable)."""
        with self._lock, self._connect() as db:
            db.execute("BEGIN IMMEDIATE")
            try:
                cur, _epoch, _renewed = self._row(db)
                if cur == holder:
                    db.execute(
                        "UPDATE hub_lease SET renewed_at = NULL "
                        "WHERE id = 0"
                    )
                db.execute("COMMIT")
            except BaseException:
                db.execute("ROLLBACK")
                raise
