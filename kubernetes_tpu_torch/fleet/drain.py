"""Hub-coordinated fleet backlog drain (ROADMAP item #5a).

One coordinator — whoever hosts the hub primary, epoch-fenced by the
same ``HubLease`` every other hub write rides — takes the backlog, runs
the relax mega-plan ONCE globally, and partitions pods to replicas by
the shard that owns each pod's planned node. Pods the plan left
unplaced, pods whose planned node no shard owns, and cross-shard-
CONSTRAINED pods (spread / anti-affinity — correctness must not be
traded for parallelism) fall into a small *residual cohort* that drains
serialized, after the shard partitions, against near-final occupancy.

Each replica then claims a *drain lease* over its partition and drains
it through its own ``drain_backlog`` slot ring under its own HBM
budget. The lease ledger lives on the hub (``OccupancyExchange`` hosts
it, replicates it to standbys, and fences every mutation with the
epoch + write-fence discipline all row traffic uses), so:

- a pod belongs to exactly ONE granted lease at a time — no pod drains
  twice;
- a replica death returns its lease (``return_leases`` rides the hub's
  ``retire``): outstanding keys become *orphans* and the next claimant
  adopts them — no pod is lost;
- the residual cohort is a single lease granted only once every shard
  lease has completed — serialized by construction.

This module is deliberately PURE: functions over a JSON-able state
dict. The hub owns locking, fencing, version bumps, and replication
(`occupancy.py`); replicas talk to it through ``FleetRuntime`` /
``RemoteOccupancyExchange`` drain ops. Keeping the ledger logic free of
I/O is what makes the known-bad sim fixtures and the unit suite cheap.

Copied from ``kubernetes_tpu/fleet/drain.py``.
"""

from __future__ import annotations

__all__ = [
    "GRANTED",
    "DONE",
    "RETURNED",
    "partition_backlog",
    "new_state",
    "claim",
    "progress",
    "complete",
    "return_leases",
    "outstanding_keys",
    "status",
]

GRANTED = "granted"
DONE = "done"
RETURNED = "returned"


def partition_backlog(
    keys, planned, assignment, *, gang_of=None, cross_shard=None
):
    """Split the backlog into per-replica partitions + the residual.

    ``keys`` is the backlog in PLAN ORDER (the relax warm-start rank —
    partitions preserve it so each replica drains its slice in the same
    global-plan order a single replica would). ``planned`` maps pod key
    to its relax-planned node name (or None when the plan left it
    unplaced); ``assignment`` maps node name to owning replica (the
    ring's node assignment). ``gang_of`` returns a pod's gang id (""
    for none): a gang drains WHOLE at the replica owning its first
    planned member — splitting an all-or-nothing group across drain
    leases would deadlock its barrier. ``cross_shard`` is the
    constraint predicate (spread / anti-affinity): True sends the pod
    to the residual cohort, where serialization keeps the existing
    fenced-CAS admit semantics intact.

    Returns ``(partitions, residual)`` — ``{replica: [keys...]}`` plus
    the residual key list, both deterministic in plan order.
    """
    gang_of = gang_of or (lambda key: "")
    cross_shard = cross_shard or (lambda key: False)
    target: dict = {}
    gang_target: dict = {}
    gang_residual: set = set()
    for k in keys:
        node = planned.get(k)
        owner = assignment.get(node) if node else None
        if cross_shard(k):
            owner = None
        target[k] = owner
        gid = gang_of(k)
        if gid:
            if owner is None:
                # one residual member sends the WHOLE gang residual
                gang_residual.add(gid)
            elif gid not in gang_target:
                gang_target[gid] = owner
    partitions: dict = {}
    residual: list = []
    for k in keys:
        gid = gang_of(k)
        if gid:
            owner = (
                None if gid in gang_residual else gang_target.get(gid)
            )
        else:
            owner = target[k]
        if owner is None:
            residual.append(k)
        else:
            partitions.setdefault(owner, []).append(k)
    return partitions, residual


def new_state(
    partitions, residual, *, epoch=0, membership_version=0
) -> dict:
    """A fresh drain ledger. JSON-able end to end: it replicates to
    hub standbys as an op-log payload and rides snapshots, so string
    keys and plain lists only."""
    return {
        "epoch": int(epoch),
        "membershipVersion": int(membership_version),
        "partitions": {
            str(r): list(ks) for r, ks in sorted(partitions.items())
        },
        "residual": list(residual),
        # replica -> lease id of its base-partition claim ("" once the
        # partition was orphaned by return_leases — never regrant it)
        "claimed": {},
        # lease id -> {replica, keys, state: granted|done|returned,
        #              epoch, membershipVersion, kind}
        "leases": {},
        "done": {},  # pod key -> replica that drained it
        "orphans": [],  # returned keys awaiting reassignment
        "residualGranted": False,
        "nextLease": 1,
        "reassigned": 0,
    }


def _grant(state: dict, replica: str, keys, kind: str) -> dict:
    lid = f"L{state['nextLease']}"
    state["nextLease"] += 1
    lease = {
        "replica": str(replica),
        "keys": list(keys),
        "state": GRANTED,
        "epoch": state["epoch"],
        "membershipVersion": state["membershipVersion"],
        "kind": kind,
    }
    state["leases"][lid] = lease
    return dict(lease, id=lid)


def _granted_leases(state: dict):
    for lid in sorted(state["leases"], key=lambda s: int(s[1:])):
        if state["leases"][lid]["state"] == GRANTED:
            yield lid, state["leases"][lid]


def claim(state: dict, replica: str):
    """Grant ``replica`` its next drain lease. Deterministic order:

    1. an already-granted lease re-serves verbatim (idempotent — the
       claim RPC may be retried after a lost reply);
    2. the replica's own base partition, once;
    3. the orphan pool (a dead replica's returned work), whole — this
       is the reassignment path, counted in ``reassigned``;
    4. the residual cohort, as ONE lease to the first claimant after
       every shard lease completed — serialized by construction.

    Returns ``(lease_dict_with_id | None, reassigned: bool)``.
    """
    replica = str(replica)
    for lid, lease in _granted_leases(state):
        if lease["replica"] == replica:
            return dict(lease, id=lid), False
    if replica in state["partitions"] and replica not in state["claimed"]:
        keys = [
            k
            for k in state["partitions"][replica]
            if k not in state["done"]
        ]
        out = _grant(state, replica, keys, "partition")
        state["claimed"][replica] = out["id"]
        return out, False
    if state["orphans"]:
        keys = [k for k in state["orphans"] if k not in state["done"]]
        state["orphans"] = []
        state["reassigned"] += 1
        return _grant(state, replica, keys, "orphan"), True
    if (
        state["residual"]
        and not state["residualGranted"]
        and not any(True for _ in _granted_leases(state))
        and all(r in state["claimed"] for r in state["partitions"])
    ):
        keys = [k for k in state["residual"] if k not in state["done"]]
        state["residualGranted"] = True
        return _grant(state, replica, keys, "residual"), False
    return None, False


def progress(state: dict, replica: str, keys) -> int:
    """Record pods ``replica`` drained under its granted lease.
    Returns how many were newly marked done. Keys outside the lease
    (concurrently admitted non-backlog pods riding the same flight)
    and keys already done are ignored — the ledger only ever records a
    pod done ONCE, so a zombie's late report after its lease was
    returned and reassigned cannot double-count."""
    replica = str(replica)
    lease_keys: set = set()
    for _lid, lease in _granted_leases(state):
        if lease["replica"] == replica:
            lease_keys.update(lease["keys"])
    if not lease_keys:
        return 0
    n = 0
    for k in keys:
        if k in lease_keys and k not in state["done"]:
            state["done"][k] = replica
            n += 1
    return n


def complete(state: dict, replica: str, lease_id: str) -> bool:
    """Mark a granted lease done. Keys the replica did NOT report
    drained stay un-done in the ledger — they remain the replica's
    pods through the ordinary fleet routing it adopted them under
    (queued or waiting), so the status surface stays truthful without
    double-tracking them as orphans."""
    lease = state["leases"].get(str(lease_id))
    if (
        lease is None
        or lease["replica"] != str(replica)
        or lease["state"] != GRANTED
    ):
        return False
    lease["state"] = DONE
    return True


def return_leases(state: dict, replica: str) -> int:
    """Return a dead replica's drain work for reassignment (rides the
    hub's ``retire``). Outstanding keys of its granted leases — and
    its base partition if it died before ever claiming — become
    orphans the next claimant adopts. Returns how many keys were
    orphaned."""
    replica = str(replica)
    orphaned = 0
    for _lid, lease in list(_granted_leases(state)):
        if lease["replica"] != replica:
            continue
        for k in lease["keys"]:
            if k not in state["done"]:
                state["orphans"].append(k)
                orphaned += 1
        lease["state"] = RETURNED
    if replica in state["partitions"] and replica not in state["claimed"]:
        state["claimed"][replica] = ""  # never regrant the base claim
        for k in state["partitions"][replica]:
            if k not in state["done"]:
                state["orphans"].append(k)
                orphaned += 1
    return orphaned


def outstanding_keys(state: dict) -> list:
    """Every backlog key not yet drained, in plan order — the sim's
    lost-pod invariant counts these as hub-tracked (like pending
    handoffs): mid-reassignment they sit in no replica's queue."""
    out = []
    for r in sorted(state["partitions"]):
        out.extend(
            k for k in state["partitions"][r] if k not in state["done"]
        )
    out.extend(k for k in state["residual"] if k not in state["done"])
    return out


def status(state: dict) -> dict:
    """Counts-only summary (footer lines, metrics, drain_status op)."""
    total = sum(
        len(ks) for ks in state["partitions"].values()
    ) + len(state["residual"])
    done = len(state["done"])
    return {
        "pods": total,
        "partitions": len(state["partitions"]),
        "residual": len(state["residual"]),
        "done": done,
        "outstanding": total - done,
        "orphans": len(state["orphans"]),
        "reassigned": state["reassigned"],
        "leases": len(state["leases"]),
        "granted": sum(1 for _ in _granted_leases(state)),
        "residualGranted": bool(state["residualGranted"]),
        "complete": total == done,
    }
