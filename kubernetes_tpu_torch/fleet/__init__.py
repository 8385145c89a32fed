"""Fleet mode: the active-active scale-out tier.

``--leader-elect`` style HA is active/passive — one process solves,
the rest idle. Fleet mode instead partitions the *cluster* across N
active scheduler replicas: each owns a deterministic shard of nodes
(fleet/ring.py — zone-keyed, balance-capped, bounded remap on
membership change), schedules the pods the ring routes to it, and
solves its shard concurrently with its peers. Cross-shard
``PodTopologySpread`` / inter-pod anti-affinity is resolved without a
global lock: replicas exchange compact occupancy rows
(fleet/occupancy.py, the host-side mirror of the device
``BatchCarriedUsage`` carry, framed by the same tensorcodec wire) and
re-validate each placement pre-assume (fleet/reconciler.py), retrying
conflicts through the scheduler's existing requeue machinery.

Wiring: set ``SchedulerConfig.fleet = FleetConfig(replica=...,
replicas=(...))``; replicas sharing a process (sim, tests, bench)
share one ``OccupancyExchange``; cross-process replicas share the same
hub over the bulk gRPC service's ``HubOp`` method
(``RemoteOccupancyExchange``, config key ``fleet.hubAddress``) with
admission kept atomic hub-side by the fenced compare-and-stage, and
each replica owns an exclusive device slice via ``fleet.meshSlice``.

The hub itself is replicated (fleet/ha.py): standby hubs consume the
primary's op log, a ``HubLease`` grants monotone fencing epochs, and
``RemoteOccupancyExchange`` takes an endpoint LIST
(``fleet.hubAddress`` accepts comma-separated "host:port"s) and fails
over with jittered backoff — a deposed primary rejects writes with the
typed ``HubDeposed`` and clients verify the epoch on every reply is
monotone, so a partitioned old primary can never accept a CAS the new
primary doesn't know about. ``SqliteHubLease`` (fleet/leasestore.py)
backs the same lease interface with one SQLite file — persisted
fencing epochs, provable multi-host offline.

The fleet BACKLOG DRAIN (fleet/drain.py) shards a cold
512k-pod backlog across the fleet: the hub-primary-hosted coordinator
runs the relax mega-plan once globally, partitions pods by
planned-node shard ownership, and hands each replica an epoch-fenced
drain lease; replicas drain their partitions concurrently through
their own ``drain_backlog`` slot rings (``fleet_drain_backlog``), a
dead replica's lease returns for reassignment, and the cross-shard-
constrained residual drains serialized at the end.

Copied from ``kubernetes_tpu/fleet/__init__.py``.
"""

from . import drain
from .ha import HubLease, LocalHubClient, StandbyReplicator
from .leasestore import SqliteHubLease
from .membership import FleetMembership, shard_index
from .occupancy import (
    AdmitConflict,
    COMMITTED,
    PENDING,
    ExchangeUnreachable,
    HubDeposed,
    NodeRow,
    OccupancyExchange,
    PeerView,
    PodRow,
    decode_rows,
    dispatch_hub_op,
    encode_rows,
)
from .reconciler import CrossShardReconciler
from .ring import HashRing, RingNode, ring_nodes_from
from .runtime import FleetConfig, FleetRuntime, RemoteOccupancyExchange

__all__ = [
    "AdmitConflict",
    "COMMITTED",
    "PENDING",
    "CrossShardReconciler",
    "ExchangeUnreachable",
    "RemoteOccupancyExchange",
    "FleetConfig",
    "FleetMembership",
    "FleetRuntime",
    "HashRing",
    "HubDeposed",
    "HubLease",
    "LocalHubClient",
    "NodeRow",
    "StandbyReplicator",
    "dispatch_hub_op",
    "OccupancyExchange",
    "PeerView",
    "PodRow",
    "RingNode",
    "SqliteHubLease",
    "decode_rows",
    "drain",
    "encode_rows",
    "ring_nodes_from",
    "shard_index",
]
