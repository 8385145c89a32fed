"""FleetRuntime: one replica's view of the active-active fleet, wired
into the Scheduler.

Responsibilities:

- **partition** — maintain the ring assignment (node -> replica) for
  the current membership + node set, recomputed synchronously inside
  the watch filter (under the cluster lock) so ownership answers are
  never staler than the event stream;
- **shard-filtered watch** — the predicate passed to
  ``ClusterState.subscribe(..., filter=...)``: Node events for owned
  nodes, bound-Pod events for pods on owned nodes (plus the routing
  replica, so its queue bookkeeping sees external binds), unbound-Pod
  events for pods the ring routes here; cluster-scoped kinds pass
  through. The replica's cache therefore IS its shard — the smaller
  snapshot is where the fleet's pods/s scaling comes from;
- **resync** — when membership or the partition shifts beyond single
  delivered events, rebuild cache/queue from cluster truth before the
  next solve and re-publish the node inventory;
- **occupancy** — stage/commit/withdraw this replica's label-bearing
  placements on the exchange, and ``admit()`` each solved placement
  against peers' rows before it is assumed (fleet/reconciler.py).

Ownership admission is the overcommit fence: even before a resync has
rebuilt the cache, ``admit`` rejects placements on nodes the current
assignment no longer grants this replica, so two replicas can never
both commit onto one node (the no-global-overcommit invariant the
fleet sim checks).

Copied from ``kubernetes_tpu/fleet/runtime.py``. ``RemoteOccupancyExchange`` imports ``grpc`` (through ``server/bulk.py``'s
client) only when it opens a channel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import metrics
from ..api.objects import Pod
from ..state.cluster import ClusterState, Event
from .membership import FleetMembership, shard_index
from .occupancy import (
    AdmitConflict,
    COMMITTED,
    ExchangeUnreachable,
    NodeRow,
    OccupancyExchange,
    PENDING,
    PeerView,
    PodRow,
)
from .reconciler import CrossShardReconciler, ZONE_KEY
from .ring import HashRing, RingNode, _h, ring_nodes_from


@dataclass
class FleetConfig:
    """SchedulerConfig.fleet: turning this on makes the Scheduler one
    active replica of an N-way fleet instead of the sole owner of the
    cluster."""

    replica: str  # this replica's identity
    replicas: tuple[str, ...] = ()  # the configured universe (incl. self)
    # base lease name for the per-shard LeaderElector identity
    # (<lease>-shard-<i>, i = rank of the replica in the sorted universe)
    lease: str = "kubernetes-tpu-scheduler"
    # the occupancy exchange hub. In-process fleets (the sim, tests, the
    # bench A/B) share one OccupancyExchange; cross-process replicas
    # reach a shared hub over the bulk gRPC boundary — pass a
    # RemoteOccupancyExchange here, or just set hub_address below and
    # let FleetRuntime construct one. None + no hub_address = private
    # hub (single-replica fleet degenerates gracefully).
    exchange: object = None
    # "host:port" of a bulk gRPC server whose HubOp method serves the
    # shared hub (config key fleet.hubAddress). Comma-separate several
    # for a replicated hub deployment ("primary:port,standby:port"):
    # RemoteOccupancyExchange fails over between them with jittered
    # backoff, verifying the hub epoch on every reply is monotone.
    # Ignored when an exchange object is passed explicitly.
    hub_address: str = ""
    # production liveness: poll peers' per-shard leases every
    # lease_poll_s seconds and flip membership when one goes stale
    # (utils/leaderelection.py shard= + membership.refresh_from_leases).
    # Off by default: in-process fleets (the sim, tests) drive
    # membership explicitly via set_alive, and polling a lease-less
    # store would mark every peer dead.
    lease_membership: bool = False
    lease_poll_s: float = 2.0
    # occupancy-staleness bound: the maximum age (seconds) of the
    # cross-shard occupancy view admission may trust. Staleness = the
    # time since this replica's last successful hub fetch PLUS the
    # oldest peer's liveness age inside that view (a peer's true
    # silence = its age at fetch time + how long ago the fetch was;
    # any reachability-proving hub contact refreshes a peer's
    # stamp). Beyond the bound,
    # admission turns CONSERVATIVE: cross-shard-constrained placements
    # (hard spread, required anti-affinity) are rejected — requeue and
    # retry once the exchange heals — rather than admitted against
    # rows that may hide peers' placements. Ownership-only pods are
    # unaffected (disjoint shards need no row exchange).
    max_row_age_s: float = 30.0
    # write-behind flush batch for the remote hub adapter (config key
    # fleet.flushBatch): plain row mutations buffer client-side and
    # land as ONE apply_ops RPC at this cap. Auto-tunable at runtime
    # (tuning/, knob "fleet_flush"); 0 = the adapter's
    # built-in default. In-process hubs ignore it (no wire to batch).
    flush_batch: int = 0
    # per-domain CAS versioning (config key fleet.casDomain; the
    # occupancy module docstring's granularity scope note): scope each
    # compare_and_stage to the row's interference domain instead of
    # the one hub-wide version, so N replicas' concurrent write-behind
    # flushes (a fleet backlog drain's steady state) stop costing
    # every constrained admit a spurious re-fetch round. Off by
    # default — measure scheduler_fleet_admit_cas_conflict_total
    # first; the bench fleet-drain ladder turns it on and reports the
    # conflict delta.
    cas_domain: bool = False

    def __post_init__(self) -> None:
        if not self.replicas:
            self.replicas = (self.replica,)
        self.replicas = tuple(sorted(set(self.replicas) | {self.replica}))


class RemoteOccupancyExchange:
    """Client half of the cross-process occupancy hub: the full
    OccupancyExchange surface, each operation one ``HubOp`` RPC on the
    bulk gRPC boundary (server/bulk.py — the same tensorcodec-framed
    wire the 17–37k pods/s bulk solve path uses).

    Semantics mirror the in-process hub exactly — that is the contract
    FleetRuntime leans on:

    - a hub-side ``ExchangeUnreachable`` (the partition seam) arrives
      as gRPC UNAVAILABLE and is re-raised as ``ExchangeUnreachable``,
      so the machinery (dirty flag, cached-view aging, the
      occupancy-staleness bound turning admission conservative) runs
      unchanged over the real wire; any other transport failure
      (server down, deadline, broken connection) degrades the same way;
    - typed ``AdmitConflict`` rejections arrive as ABORTED (version
      race) / FAILED_PRECONDITION (hub write fence) and are re-raised
      typed. The underlying BulkClient never retries them — a CAS
      conflict is a semantic answer, not a flake.

    The client is built with ``retries=0``: hub ops have their OWN
    retry story at the fleet layer (requeue, resync republish, the
    staleness bound), and transparent transport retries underneath it
    would stretch the partition-detection latency the staleness bound
    is calibrated against.

    HUB FAILOVER (hub HA): ``target`` may name SEVERAL endpoints
    (comma-separated) — a primary and its standbys. An op that fails
    unreachable-class on the active endpoint (UNAVAILABLE, connection
    loss, a typed ``HubDeposed`` from a hub that lost its lease, or a
    reply carrying a LOWER epoch than one already verified — the
    client-side half of the epoch fence) rotates to the next endpoint
    under full-jitter backoff; semantic ``AdmitConflict`` rejections
    never rotate or retry (the existing rule). When a reply's epoch
    ADVANCES past the highest seen, a failover happened: the adapter
    records it (``consume_failover``) so FleetRuntime forces a
    wholesale resync republish — the new primary's replicated rows may
    trail whatever the old one acked last, and re-registering from
    cluster truth is the dirty-heal path that closes the gap.

    IDEMPOTENT FLUSHES: each flush batch is SEALED with a monotone
    ``(flush_client, flush_seq)`` key before its first send, and a
    retry after a lost reply re-sends the SAME sealed batch under the
    SAME key — the hub dedups it whole, which closes the latent
    double-apply hazard where UNAVAILABLE after a server-side apply
    re-landed the entire buffer (double-staged rows, double-appended
    journal lines). The dedup watermark replicates with the rest of
    the hub state, so the retry dedups even when it lands on the
    promoted standby.

    WRITE-BEHIND ROW TRAFFIC: plain ``stage`` / ``commit`` /
    ``withdraw`` calls buffer client-side and flush as ONE
    ``apply_ops`` RPC — before every read (so any view this replica
    admits against reflects its own prior writes), at the buffer cap,
    and at every resync poll. Per-row unary RPCs would otherwise put
    a wire round trip inside the per-pod apply loop (measured ~4x
    throughput loss on the ladder #8 fleet arm). This is sound
    because the admission-critical row landings don't ride the
    buffer: a cross-shard-CONSTRAINED placement lands synchronously
    via ``compare_and_stage`` (the atomic admit), commit is a
    state-only transition the reconciler ignores (pending and
    committed rows count alike), and a lagging withdraw only makes
    peers OVER-count — conservative. The one scope note: an
    UNconstrained label-bearing pod's stage row (a potential selector
    target for someone else's constraint) may lag peers' views by up
    to one flush window (bounded by the buffer cap and the per-cycle
    resync poll), the cross-process analog of the scope notes.
    A buffer that cannot flush (hub unreachable) is retained and
    retried; the wholesale resync republish supersedes it either way.
    """

    _BUFFER_CAP = 256  # default flush batch (FleetConfig.flush_batch=0)
    # base of the full-jitter backoff between endpoint attempts during
    # a failover rotation (seconds; doubles per extra hop)
    _FAILOVER_BACKOFF_S = 0.05

    def __init__(
        self,
        target: str,
        replica: str = "",
        *,
        client=None,
        clients=None,
        clock=None,
        flush_batch: int = 0,
        flush_client_id: str = "",
    ) -> None:
        import random

        from ..server.bulk import BulkClient
        from ..utils.clock import Clock

        self._clock = clock or Clock()
        if clients is not None:
            # explicit client objects (the HA sim/tests: LocalHubClient
            # per in-process hub) — endpoint i is clients[i]
            self._clients = list(clients)
            self._targets = [
                f"client-{i}" for i in range(len(self._clients))
            ]
        elif client is not None:
            self._clients = [client]
            self._targets = [target or "client-0"]
        else:
            self._targets = [
                t.strip() for t in str(target).split(",") if t.strip()
            ]
            self._clients = [
                BulkClient(t, retries=0, clock=clock)
                for t in self._targets
            ]
        if not self._clients:
            raise ValueError("RemoteOccupancyExchange needs >= 1 endpoint")
        self._active = 0
        # highest hub epoch verified on any reply — replies below it
        # come from a deposed primary and are structurally ignored
        self._seen_epoch = 0
        self._failover_pending = False
        self.failovers = 0
        # deterministic per-replica jitter stream (the sim's
        # byte-determinism leans on seeded randomness)
        self._rng = random.Random(f"{replica}/hub-failover")
        self._replica = replica
        # flush-idempotency identity: scopes this client incarnation's
        # flush_seq stream at the hub, so a RESTARTED replica starting
        # back at seq 0 is never mistaken for a stale retry. Random —
        # it never lands in journals/traces, so determinism holds.
        if not flush_client_id:
            import uuid

            flush_client_id = f"{replica or 'r'}-{uuid.uuid4().hex[:8]}"
        self._flush_client = flush_client_id
        self._flush_seq = 0
        # sealed flush batches awaiting an acknowledged apply_ops:
        # [(seq, ops)] in send order; the OPEN buffers below seal into
        # one batch at flush time
        self._sealed: list = []
        # instance flush batch: the auto-tunable write-behind cap
        # (tuning/ knob "fleet_flush"); class default
        # unless configured
        self._buffer_cap = int(flush_batch) or self._BUFFER_CAP
        # buffered [kind, arg] mutations awaiting one apply_ops RPC;
        # callers are single-threaded per replica (the scheduler's
        # locked apply phase / driver loop)
        self._buffer: list = []
        # journal lines ride the SAME apply_ops flush but live in a
        # SEPARATE buffer: row mutations are superseded by the
        # wholesale resync republish (replace_pod_rows clears them),
        # journal lines are append-only history that nothing
        # re-creates — clearing them with the rows would silently
        # lose hub-aggregation lines the shipping cursor already
        # advanced past. Bounded: a long partition
        # drops the OLDEST lines at the cap, counted so the loss is
        # observable instead of silent.
        self._journal_buffer: list = []
        self.journal_lines_dropped = 0
        self._JOURNAL_BUFFER_CAP = 8192
        # a flush observed the hub write fence (this replica was
        # retired): sticky until re-registration, surfaced as a typed
        # AdmitConflict at the NEXT row mutation so FleetRuntime's
        # handlers set _needs_resync exactly like the in-process path
        # (a read-path flush has no caller prepared for the typed
        # conflict, so it cannot raise there)
        self._fenced_seen = False

    @property
    def _client(self):
        """The active endpoint's client (kept for introspection and
        the single-endpoint tests that monkeypatch it)."""
        return self._clients[self._active]

    def _call_endpoint(self, client, op: str, **meta) -> dict:
        """One attempt against one endpoint, errors normalized to the
        hub's typed exceptions (a LocalHubClient raises them directly;
        the gRPC transport arrives as status codes)."""
        import grpc

        from .occupancy import (
            AdmitConflict,
            ExchangeUnreachable,
            HubDeposed,
        )

        try:
            return client.hub_op(op, **meta)
        except (AdmitConflict, ExchangeUnreachable):
            raise  # already typed (HubDeposed subclasses unreachable)
        except grpc.RpcError as e:
            code = getattr(e, "code", lambda: None)()
            name = code.name if code is not None else ""
            details = getattr(e, "details", lambda: "")() or name
            if name == "ABORTED":
                raise AdmitConflict(details) from None
            if name == "FAILED_PRECONDITION":
                raise AdmitConflict(details, fenced=True) from None
            if name == "PERMISSION_DENIED":
                raise HubDeposed(details) from None
            raise ExchangeUnreachable(details) from None
        except ConnectionError as e:
            raise ExchangeUnreachable(str(e)) from None

    def _op(self, op: str, **meta) -> dict:
        """One hub op with endpoint failover: unreachable-class
        failures (incl. HubDeposed and stale-epoch replies) rotate
        through the endpoint list under full-jitter backoff; semantic
        AdmitConflict rejections surface immediately from whichever
        endpoint answered (and make it the active one — a hub that
        answers semantically IS the serving primary)."""
        import time

        from .occupancy import AdmitConflict, ExchangeUnreachable

        t0 = time.perf_counter()
        try:
            last: Exception | None = None
            n = len(self._clients)
            for attempt in range(n):
                idx = (self._active + attempt) % n
                if attempt:
                    # full jitter: N replicas failing over at the same
                    # instant must not stampede the standby in lockstep
                    self._clock.sleep(
                        self._rng.uniform(
                            0.0,
                            self._FAILOVER_BACKOFF_S
                            * (2 ** (attempt - 1)),
                        )
                    )
                try:
                    out = self._call_endpoint(
                        self._clients[idx], op, **meta
                    )
                except AdmitConflict:
                    self._active = idx
                    raise
                except ExchangeUnreachable as e:  # incl. HubDeposed
                    last = e
                    continue
                epoch = int(out.get("epoch") or 0)
                if epoch and epoch < self._seen_epoch:
                    # a stale (lower-epoch) hub answered — the epoch
                    # fence says its answer is void: rotate on
                    last = ExchangeUnreachable(
                        f"hub endpoint {self._targets[idx]} answered "
                        f"with stale epoch {epoch} < {self._seen_epoch}"
                    )
                    continue
                if epoch > self._seen_epoch:
                    if self._seen_epoch:
                        # the epoch advanced mid-session: a failover.
                        # Flag it so FleetRuntime forces the wholesale
                        # resync republish at its next poll.
                        self._failover_pending = True
                        self.failovers += 1
                        metrics.hub_failover_total.inc()
                    self._seen_epoch = epoch
                    metrics.hub_epoch.set(epoch)
                self._active = idx
                return out
            raise (
                last
                if last is not None
                else ExchangeUnreachable("no hub endpoints configured")
            )
        finally:
            metrics.fleet_hub_rpc_seconds.labels(op).observe(
                time.perf_counter() - t0
            )

    def consume_failover(self) -> bool:
        """True once per observed hub failover (epoch advance):
        FleetRuntime polls this in maybe_resync and forces a wholesale
        republish from cluster truth — the new primary's replicated
        rows may trail whatever the deposed one acked last."""
        moved, self._failover_pending = self._failover_pending, False
        return moved

    def hub_status(self) -> dict:
        """The serving hub's status plus this client's failover state
        (the ``GET /debug/hub`` body for a remote-hub fleet)."""
        out = self._op("hub_status")
        status = dict(out.get("status") or {})
        status["client"] = {
            "endpoints": list(self._targets),
            "active": self._targets[self._active],
            "seen_epoch": self._seen_epoch,
            "failovers": self.failovers,
            "pending_flush": self._pending_flush(),
        }
        return status

    def flush(self) -> None:
        """Drain the write-behind buffers: the open buffer (rows +
        piggybacked journal lines) SEALS into one batch under a fresh
        ``(flush_client, flush_seq)`` key, then every sealed batch
        ships in order, one apply_ops RPC each (steady state: exactly
        one). On a transport failure the unacknowledged batches are
        RETAINED — a retry re-sends the SAME sealed batch under the
        SAME key, and the hub's dedup drops it whole if the lost reply
        hid a completed apply (the double-apply fix). A fenced
        rejection DROPS that batch's rows — a retired replica's rows
        must not land; its healed incarnation re-registers from truth
        — but NOT the journal half: the hub lands journal lines before
        the fence-checked row ops, so the fenced RPC's lines are
        already aggregated."""
        from .occupancy import AdmitConflict

        if self._buffer or self._journal_buffer:
            ops = [
                ["journal", line] for line in self._journal_buffer
            ] + self._buffer
            self._sealed.append((self._flush_seq, ops))
            self._flush_seq += 1
            self._buffer = []
            self._journal_buffer = []
        while self._sealed:
            seq, ops = self._sealed[0]
            try:
                self._op(
                    "apply_ops", replica=self._replica, ops=ops,
                    flush_seq=seq, flush_client=self._flush_client,
                )
            except AdmitConflict:
                # fenced: the rows must not land — drop the batch, and
                # remember so the next mutation surfaces the typed
                # conflict (the in-process hub raises it inline;
                # silently succeeding here would leave every later row
                # discarded without the replica ever learning to
                # resync). Its journal lines landed pre-fence.
                self._fenced_seen = True
                self._sealed.pop(0)
                continue
            except Exception:
                self._cap_retained()
                raise
            self._sealed.pop(0)

    def _cap_retained(self) -> None:
        """Bound the retained sealed batches through a long partition:
        row ops are droppable (the raise sets the caller's dirty flag
        and the first reachable resync republishes wholesale from
        truth); journal lines have no republish path, so only the
        OLDEST beyond the cap drop, counted so the loss is observable
        instead of silent."""
        rows = sum(
            1
            for _seq, ops in self._sealed
            for kind, _arg in ops
            if kind != "journal"
        )
        if rows > 4 * self._buffer_cap:
            self._strip_sealed_rows()
        jl = sum(
            1
            for _seq, ops in self._sealed
            for kind, _arg in ops
            if kind == "journal"
        )
        excess = jl - self._JOURNAL_BUFFER_CAP
        if excess > 0:
            self.journal_lines_dropped += excess
            trimmed = []
            for seq, ops in self._sealed:
                kept = []
                for op in ops:
                    if op[0] == "journal" and excess > 0:
                        excess -= 1
                        continue
                    kept.append(op)
                trimmed.append((seq, kept))
            self._sealed = trimmed
        # a batch emptied by the caps still consumed its seq — dropping
        # it is safe (the hub's dedup watermark only ever compares <=)
        self._sealed = [(s, ops) for s, ops in self._sealed if ops]

    def _strip_sealed_rows(self) -> None:
        """Drop the ROW halves of retained sealed batches, keeping
        journal ops (rows re-create via the wholesale republish;
        journal history re-creates nowhere). Emptied batches drop
        whole — their consumed seq is safe, the dedup watermark only
        compares <=. Shared by the retention cap and the resync
        republish that supersedes buffered rows."""
        self._sealed = [
            (seq, [o for o in ops if o[0] == "journal"])
            for seq, ops in self._sealed
        ]
        self._sealed = [(s, ops) for s, ops in self._sealed if ops]

    def _pending_flush(self) -> int:
        return (
            len(self._buffer)
            + len(self._journal_buffer)
            + sum(len(ops) for _seq, ops in self._sealed)
        )

    def _buffered(self, kind: str, arg) -> None:
        if self._fenced_seen:
            from .occupancy import AdmitConflict

            # sticky until re-registration: rows of a retired replica
            # must not even buffer, and the caller (FleetRuntime's
            # stage/commit/withdraw handlers) flags the resync that
            # re-registers
            raise AdmitConflict(
                f"replica {self._replica} observed the hub write fence "
                "at a prior flush: no row mutation may land until a "
                "wholesale republish re-registers it",
                fenced=True,
            )
        self._buffer.append([kind, arg])
        if len(self._buffer) >= self._buffer_cap:
            self.flush()

    def set_buffer_cap(self, n: int) -> None:
        """Retarget the write-behind flush batch (the auto-tuner's
        "fleet_flush" knob). Safe at any point: the cap is only
        consulted on append, and a shrink below the current buffer
        length simply flushes at the next mutation."""
        self._buffer_cap = max(int(n), 1)

    # -- the OccupancyExchange surface --

    @property
    def version(self) -> int:
        self.flush()
        return int(self._op("version")["version"])

    def peers_version(self, replica: str) -> int:
        self.flush()
        return int(self._op("peers_version", replica=replica)["version"])

    def publish_nodes(self, replica: str, rows) -> None:
        self.flush()
        self._op(
            "publish_nodes", replica=replica,
            nodes=[[r.node, r.zone] for r in rows],
        )
        self._fenced_seen = False  # wholesale republish re-registers

    def stage(self, replica: str, row: PodRow) -> None:
        from .occupancy import pod_row_to_list

        self._buffered("stage", pod_row_to_list(row))

    def compare_and_stage(
        self, replica: str, row: PodRow, expected_version: int,
        *, domain_scope: bool = False,
    ) -> int:
        from .occupancy import pod_row_to_list

        # the CAS never buffers — it IS the atomic admit. Flush first
        # so expected_version (from the flushed-before read) stays
        # consistent with this replica's own write stream.
        self.flush()
        return int(
            self._op(
                "cas_stage", replica=replica, row=pod_row_to_list(row),
                expect=int(expected_version),
                domain_scope=bool(domain_scope),
            )["version"]
        )

    def replace_pod_rows(self, replica: str, rows) -> None:
        from .occupancy import pod_row_to_list

        # wholesale from truth supersedes anything buffered — open
        # buffer AND the row halves of retained sealed batches (their
        # journal lines still ship; nothing re-creates journal history)
        self._buffer.clear()
        self._strip_sealed_rows()
        self._op(
            "replace_pod_rows", replica=replica,
            rows=[pod_row_to_list(r) for r in rows],
        )
        self._fenced_seen = False  # wholesale republish re-registers

    def commit(self, replica: str, pod_key: str) -> None:
        self._buffered("commit", pod_key)

    def withdraw(self, replica: str, pod_key: str) -> None:
        self._buffered("withdraw", pod_key)

    def retire(self, replica: str) -> None:
        self.flush()
        self._op("retire", replica=replica)

    # -- fleet backlog drain ledger ops (fleet/drain.py) --

    def drain_init(
        self, replica: str, partitions, residual,
        *, membership_version: int = 0,
    ) -> dict:
        self.flush()
        return dict(
            self._op(
                "drain_init", replica=replica,
                partitions={
                    str(r): list(ks) for r, ks in partitions.items()
                },
                residual=list(residual),
                membership_version=int(membership_version),
            ).get("status")
            or {}
        )

    def drain_claim(self, replica: str) -> dict | None:
        self.flush()
        lease = self._op("drain_claim", replica=replica).get("lease")
        return dict(lease) if lease else None

    def drain_progress(self, replica: str, keys) -> int:
        # flush first: the progress report asserts this chunk's rows
        # landed, so the buffered stage/commit ops must precede it
        self.flush()
        return int(
            self._op(
                "drain_progress", replica=replica, keys=list(keys)
            ).get("done")
            or 0
        )

    def drain_complete(self, replica: str, lease_id: str) -> bool:
        self.flush()
        return bool(
            self._op(
                "drain_complete", replica=replica, lease=str(lease_id)
            ).get("ok")
        )

    def drain_status(self) -> dict:
        return dict(self._op("drain_status").get("status") or {})

    def set_degraded(self, replica: str, degraded: bool) -> None:
        self.flush()
        self._op("set_degraded", replica=replica, degraded=bool(degraded))

    def degraded_replicas(self) -> frozenset:
        return frozenset(self._op("degraded_replicas")["replicas"] or ())

    def hand_off(
        self, to_replica: str, pod_key: str, hops: int,
        from_replica: str | None = None,
        trace: str = "",
    ) -> None:
        self.flush()
        self._op(
            "hand_off", to=to_replica, pod=pod_key, hops=int(hops),
            trace=trace,
            **({"from": from_replica} if from_replica is not None else {}),
        )

    def claim_handoffs(self, replica: str) -> list:
        self.flush()
        return [
            (row[0], int(row[1]), str(row[2]) if len(row) > 2 else "")
            for row in self._op("claim_handoffs", replica=replica)[
                "handoffs"
            ]
            or []
        ]

    def ship_journal(self, replica: str, lines) -> None:
        """Journal segments ride the SAME apply_ops flush as the
        buffered row mutations — the tentpole's no-new-RPC-cadence
        contract — but in their own buffer: they are NOT fence-gated
        (append-only observability, so they bypass the sticky-fence
        check — a fenced zombie's history still reaches the hub at
        its next flush), and they must survive the row buffer's
        destructive paths (the resync republish clears rows it
        supersedes; nothing re-creates journal history)."""
        self._journal_buffer.extend(lines)
        if self._pending_flush() >= self._buffer_cap:
            self.flush()

    def journal_lines(self) -> list[str]:
        self.flush()
        return list(self._op("journal_lines")["lines"] or [])

    def pending_handoff_keys(self) -> set:
        self.flush()
        return set(self._op("pending_handoff_keys")["keys"] or ())

    def peers_view(self, replica: str) -> PeerView:
        from .occupancy import pod_row_from_list

        self.flush()
        out = self._op("peers_view", replica=replica)
        return PeerView(
            version=int(out["version"]),
            node_rows=tuple(
                NodeRow(node=n, zone=z) for n, z in out.get("nodes") or []
            ),
            pod_rows=tuple(
                pod_row_from_list(r) for r in out.get("pods") or []
            ),
            peer_ages=tuple(
                (r, float(a)) for r, a in out.get("peerAges") or []
            ),
        )

    def close(self) -> None:
        try:
            self.flush()
        except Exception:
            pass  # teardown is best-effort; resync owns recovery
        for client in self._clients:
            client.close()


class FleetRuntime:
    def __init__(
        self, config: FleetConfig, cluster: ClusterState, clock
    ) -> None:
        self.config = config
        self.cluster = cluster
        self.clock = clock
        self.replica = config.replica
        if config.exchange is not None:
            self.exchange: OccupancyExchange = config.exchange
        elif config.hub_address:
            self.exchange = RemoteOccupancyExchange(
                config.hub_address, config.replica, clock=clock,
                flush_batch=config.flush_batch,
            )
        else:
            self.exchange = OccupancyExchange()
        self.membership = FleetMembership(config.replicas, config.replica)
        self.ring = HashRing(self.membership.universe)
        # alive-subset ring, cached per membership version: routes_pod
        # runs inside the watch filter for every pod event, and
        # rebuilding the ring there would tax the whole ingest path
        self._alive_ring = self.ring
        self._alive_ring_version = self.membership.version
        self.reconciler = CrossShardReconciler(config.replica)
        self.shard = shard_index(self.membership.universe, config.replica)
        self.lease_name = f"{config.lease}-shard-{self.shard}"
        # node -> replica, recomputed on every Node event and membership
        # change. Reads/writes happen under cluster.lock (the watch
        # filter and the scheduler's apply phase both hold it).
        self._assignment: dict[str, str] = {}  # ktpu: guarded-by(cluster.lock)
        self._needs_resync = False  # ktpu: guarded-by(cluster.lock)
        self._seen_membership_version = self.membership.version
        # cross-shard retry wakeup: pods parked by a reconcile conflict
        # have no waking watch event when a PEER's occupancy changes
        # (peer placements are invisible to this replica's informer by
        # design). Track rejections and the exchange version; when the
        # exchange has moved since the last conflict, the next cycle
        # requeues parked pods for another admission attempt.
        self._conflicts_since_wake = 0  # ktpu: guarded-by(cluster.lock)
        self._wake_version = self.exchange.version
        # pod-routing overrides (the handoff protocol): a pod this
        # replica released to a peer no longer routes here even though
        # the hash says so, and a pod claimed from a peer routes here
        # even though the hash says otherwise. Maintained under
        # cluster.lock; swept against cluster truth on every resync.
        self._routed_away: set[str] = set()  # ktpu: guarded-by(cluster.lock)
        self._routed_here: dict[str, int] = {}  # key -> hops  # ktpu: guarded-by(cluster.lock)
        # consecutive reconcile rejections per pod — the handoff
        # trigger (>= _HANDOFF_AFTER with an alive peer to take it)
        self._reject_counts: dict[str, int] = {}  # ktpu: guarded-by(cluster.lock)
        # per-shard lease poll throttle (config.lease_membership)
        self._last_lease_poll = float("-inf")
        # occupancy-staleness bounds: the last successfully fetched
        # peer view and when it was fetched. While the hub is
        # unreachable admission runs against this cache; its growing
        # age (plus the oldest peer publish age inside it) is the
        # staleness admission compares against max_row_age_s.
        self._peer_view: PeerView | None = None  # ktpu: guarded-by(cluster.lock)
        self._view_at = float("-inf")  # ktpu: guarded-by(cluster.lock)
        # hub writes that failed while partitioned: rows must republish
        # wholesale at the next reachable resync
        self._exchange_dirty = False  # ktpu: guarded-by(cluster.lock)
        # retires that failed while the hub was unreachable (a peer
        # died mid-blackout): re-issued at the next reachable poll —
        # a dead peer's frozen publish stamp left on the hub would
        # otherwise age every survivor's staleness bound forever
        self._pending_retires: set[str] = set()  # ktpu: guarded-by(cluster.lock)
        # conservative-admission rejections under stale rows (the sim's
        # hub_partition invariant asserts the path engaged)
        self.stale_rejections = 0  # ktpu: guarded-by(cluster.lock)
        # cross-process atomic admit bookkeeping: pods whose pending
        # row already landed at the hub via compare_and_stage during
        # admit (the apply phase's stage() must not re-send it), and
        # how many CAS rejections this replica has absorbed (typed
        # AdmitConflict — version races and fenced writes)
        self._cas_staged: set[str] = set()  # ktpu: guarded-by(cluster.lock)
        self.cas_conflicts = 0  # ktpu: guarded-by(cluster.lock)
        # journal-shipping cursor: how many of this replica's journal
        # records have been shipped to the hub's aggregation surface
        # (PodDecisionJournal.total_records is monotone, so the cursor
        # survives a bounded journal's deque eviction)
        self._journal_shipped = 0
        with cluster.lock:
            self._recompute(cluster.list_nodes())
        metrics.fleet_replicas.set(len(self.membership.alive()))

    # -- write-behind flush batch (the auto-tuner's fleet_flush knob) --

    def flush_batch(self) -> int | None:
        """Current write-behind flush batch of the remote hub adapter,
        or None for an in-process hub (nothing to batch — the knob is
        not tunable then)."""
        if isinstance(self.exchange, RemoteOccupancyExchange):
            return self.exchange._buffer_cap
        return None

    def set_flush_batch(self, n: int) -> None:
        """Retarget the remote adapter's flush batch (no-op for an
        in-process hub)."""
        if isinstance(self.exchange, RemoteOccupancyExchange):
            self.exchange.set_buffer_cap(n)

    def hub_status(self) -> dict:
        """The ``GET /debug/hub`` body: the serving hub's role / epoch
        / cursors / HA counters, plus this replica's client-side view
        (endpoints, active endpoint, verified epoch, failovers,
        pending flush). Raises ExchangeUnreachable while no hub
        endpoint answers — the HTTP handler maps that to 503."""
        if isinstance(self.exchange, RemoteOccupancyExchange):
            return self.exchange.hub_status()
        status = self.exchange.hub_status()
        status["client"] = {
            "endpoints": ["in-process"],
            "active": "in-process",
            "seen_epoch": status.get("epoch", 0),
            "failovers": 0,
            "pending_flush": 0,
        }
        return status

    # max journal lines per shipped segment: bounds both the hub-side
    # append and the piggybacked flush payload (a mega-drain's burst
    # catches up over the next few cycles instead of one huge RPC)
    _JOURNAL_SEGMENT_LINES = 1024

    def ship_journal_segment(self, scheduler) -> int:
        """Ship this replica's journal records written since the last
        segment to the hub's append-only aggregation surface — the
        cross-replica `obs explain --fleet` source. Piggybacks on the
        existing transport cadence: the remote adapter buffers the
        lines into the SAME write-behind apply_ops flush the row
        mutations ride (no new RPC cadence); the in-process hub is one
        locked append. Bounded per call; returns lines shipped."""
        journal = scheduler.journal
        if journal is None:
            return 0
        pending = journal.total_records - self._journal_shipped
        if pending <= 0:
            return 0
        lines = journal.lines  # flushes the lazy pending records
        start = len(lines) - pending
        if start < 0:
            # a bounded serve journal evicted unshipped lines before
            # they shipped: skip them (the streaming file sink is the
            # durable store; the hub keeps the recent window)
            self._journal_shipped += -start
            start = 0
            pending = len(lines)
        take = min(pending, self._JOURNAL_SEGMENT_LINES)
        if isinstance(lines, list):
            # unbounded journal (sims, mega-drains): O(take) slice,
            # never a full O(total_records) copy per cycle
            segment = lines[start : start + take]
        else:
            from itertools import islice

            segment = list(islice(lines, start, start + take))
        if not segment:
            return 0
        try:
            self.exchange.ship_journal(self.replica, segment)
        except ExchangeUnreachable:
            return 0  # retry next cycle; cursor unmoved
        except AdmitConflict:
            # journal shipping is not fence-gated at the hub, but a
            # remote adapter's piggybacked flush can still surface the
            # sticky fence — flag the resync like every other handler
            with self.cluster.lock:
                self._needs_resync = True
            return 0
        self._journal_shipped += take
        return take

    _HANDOFF_AFTER = 2
    # bounded re-admission rounds when compare_and_stage loses its
    # version race: each round re-fetches the peer view and re-runs the
    # host-side recheck against the rows that beat it. Exhaustion is an
    # ordinary reconcile rejection (requeue + retry), never a stall.
    _CAS_ATTEMPTS = 3

    # -- partition maintenance --

    def _ring_alive(self) -> HashRing:
        if self._alive_ring_version != self.membership.version:
            self._alive_ring = self.ring.with_alive(
                self.membership.alive()
            )
            self._alive_ring_version = self.membership.version
        return self._alive_ring

    # callers hold the cluster lock (watch filter, init, set_alive): ktpu: holds(cluster.lock)
    def _recompute(self, nodes) -> None:
        """Rebuild the assignment; flag a resync when any node other
        than freshly added/deleted ones changed owner relative to this
        replica (those moves have no dedicated watch event)."""
        ring = self._ring_alive()
        new = ring.assign(ring_nodes_from(nodes))
        old = self._assignment
        if old:
            for name in set(old) & set(new):
                mine_before = old[name] == self.replica
                mine_after = new[name] == self.replica
                if mine_before != mine_after:
                    self._needs_resync = True
        self._assignment = new

    # reads the assignment the filter maintains under the lock: ktpu: holds(cluster.lock)
    def owns_node(self, name: str) -> bool:
        return self._assignment.get(name) == self.replica

    # same locked callers as owns_node: ktpu: holds(cluster.lock)
    def routes_pod(self, pod_key: str, pod: Pod | None = None) -> bool:
        if pod_key in self._routed_here:
            return True
        if pod_key in self._routed_away:
            return False
        # pod-group members route by their GANG id, not their own key:
        # the gang gate assembles a group from ONE replica's queue, so
        # splitting members across the ring would make every gang
        # permanently short. Callers that have the Pod pass it; key-only
        # callers (handoff rows) are never gang members (handoff is
        # disabled for them in _apply_group).
        route_key = pod_key
        if pod is not None:
            from ..gang import GangTracker

            gid = GangTracker.gang_of(pod)
            if gid is not None:
                route_key = f"gang:{gid}"
        return self._ring_alive().route(route_key) == self.replica

    def set_alive(self, replicas) -> bool:
        """Membership transition (the sim's replica_loss driver; the
        production path calls refresh_membership below). Flags a
        resync; the scheduler applies it before its next solve."""
        before = set(self.membership.alive())
        changed = self.membership.set_alive(replicas)
        if changed:
            self._membership_changed(before)
        return changed

    def refresh_membership(self) -> bool:
        """Poll peers' per-shard leases (production liveness)."""
        before = set(self.membership.alive())
        changed = self.membership.refresh_from_leases(
            self.cluster, self.config.lease, self.clock.now()
        )
        if changed:
            self._membership_changed(before)
        return changed

    def _membership_changed(self, before: set) -> None:
        """Shared membership-transition tail: recompute the partition,
        flag a resync, and REVOKE the commit fence of every peer that
        just went dead — the commit-path half of the ownership fence.
        The survivors are about to re-own the dead peer's shard; if it
        is actually a zombie (lease stalled, process alive), its next
        bind finds its token revoked at the state service and gets
        Conflict, so it can never double-bind what a survivor re-owns.
        The revocation is committed at the AUTHORITY (the state
        service), which is what makes it partition-safe: the zombie's
        own stale view is irrelevant."""
        with self.cluster.lock:
            self._recompute(self.cluster.list_nodes())
            self._needs_resync = True
            for dead in sorted(before - set(self.membership.alive())):
                i = shard_index(self.membership.universe, dead)
                self.cluster.revoke_fence(
                    f"{self.config.lease}-shard-{i}"
                )
                # retire the dead peer's exchange state too: its
                # committed placements become visible to the adopting
                # replicas through their own resync re-list (keeping
                # the rows would double-count), its pending rows can
                # never commit (fenced), and its frozen publish stamp
                # must not age the survivors' staleness bound forever —
                # a detected-dead peer is handled by membership, not by
                # conservative admission. (A SILENT hub-partitioned
                # peer that is still lease-alive keeps its rows, and
                # their growing age is exactly what turns peers
                # conservative.) An unreachable hub (mid-failover
                # blackout) defers the retire to the dirty-republish
                # resync instead of crashing the membership transition.
                try:
                    self.exchange.retire(dead)
                except ExchangeUnreachable:
                    self._pending_retires.add(dead)
                    self._exchange_dirty = True
        metrics.fleet_replicas.set(len(self.membership.alive()))

    # -- the shard-filtered watch predicate --

    # ClusterState._emit calls this under its lock: ktpu: holds(cluster.lock)
    def event_filter(self, ev: Event) -> bool:
        if ev.kind == "Node":
            # keep the partition current BEFORE answering ownership —
            # an add/delete changes K, so the capped fill can move
            # other nodes too (flagged for resync by _recompute)
            owned_before = self.owns_node(ev.obj.name)
            self._recompute(self.cluster.list_nodes())
            if ev.type == "DELETED":
                # deliver to the previous owner so its cache drops the
                # node (the new assignment no longer mentions it)
                return owned_before
            return self.owns_node(ev.obj.name)
        if ev.kind == "Pod":
            pod = ev.obj
            if pod.node_name:
                # bound: the owning replica maintains its cache; the
                # routing replica also listens so its queue/in-flight
                # bookkeeping sees external binds of pods it tracked
                return self.owns_node(pod.node_name) or self.routes_pod(
                    pod.key, pod
                )
            return self.routes_pod(pod.key, pod)
        # cluster-scoped kinds (DRA objects, Events, ...) pass through
        return True

    # -- resync --

    def maybe_resync(self, scheduler) -> bool:
        """Apply a pending partition change: rebuild the shard-scoped
        cache and queue from cluster truth, invalidate in-flight
        solves, re-publish the node inventory. Called by both
        scheduling loops before popping a batch."""
        if self.config.lease_membership:
            # production liveness: a dead peer's shard lease going
            # stale is the membership signal (the sim drives set_alive
            # directly instead)
            now = self.clock.now()
            if now - self._last_lease_poll >= self.config.lease_poll_s:
                self._last_lease_poll = now
                self.refresh_membership()
        # ship the journal segment written since the last cycle to the
        # hub's aggregation surface (driver thread, outside the cluster
        # lock: the remote adapter only buffers, the in-process hub is
        # one locked append)
        self.ship_journal_segment(scheduler)
        with self.cluster.lock:
            for dead in sorted(self._pending_retires):
                # a retire deferred by a mid-blackout unreachable hub:
                # the dead peer's rows and frozen publish stamp must
                # come off the (new) hub, or the staleness bound stays
                # conservative fleet-wide forever
                try:
                    self.exchange.retire(dead)
                except ExchangeUnreachable:
                    break  # still dark: retry next poll
                self._pending_retires.discard(dead)
            consume = getattr(self.exchange, "consume_failover", None)
            if consume is not None and consume():
                # the hub epoch advanced (a standby promoted): the new
                # primary's replicated state may trail whatever the
                # deposed one acked last — re-register wholesale from
                # cluster truth (the dirty-republish heal), which
                # the forced resync below does
                self._needs_resync = True
            if self._exchange_dirty:
                # hub writes failed while partitioned: once the hub is
                # reachable again, force a full resync so rows and
                # inventory republish wholesale from truth
                try:
                    self.exchange.peers_version(self.replica)
                except ExchangeUnreachable:
                    pass
                else:
                    self._exchange_dirty = False
                    self._needs_resync = True
            try:
                handoffs = self.exchange.claim_handoffs(self.replica)
            except ExchangeUnreachable:
                handoffs = []  # claims wait out the partition
            # adopt pods peers handed off to this replica (sorted,
            # deterministic): the claim makes this replica the pod's
            # route owner, so its watch events flow here from now on
            for key, hops, trace in handoffs:
                try:
                    ns, name = key.split("/", 1)
                    pod = self.cluster.get_pod(ns, name)
                except Exception:
                    continue  # deleted while in handoff flight
                if pod.node_name:
                    continue  # bound while in handoff flight
                if trace and scheduler.journal is not None:
                    # trace propagation across the handoff: the
                    # releasing replica's journey trace id rode the
                    # handoff row — seed it so this replica's records
                    # for the pod continue the SAME trace (obs explain
                    # --fleet renders the whole chain as one trace)
                    scheduler.journal.pod_traces[key] = trace
                self._routed_here[key] = hops
                self._routed_away.discard(key)
                if (
                    key not in scheduler.queue.entries()
                    and key not in scheduler._in_flight
                    and key not in scheduler._waiting
                    and pod.scheduler_name in scheduler.solvers
                ):
                    scheduler.queue.add(pod)
            if self._conflicts_since_wake:
                try:
                    version = self.exchange.peers_version(self.replica)
                except ExchangeUnreachable:
                    version = self._wake_version  # no news while cut off
                if version != self._wake_version:
                    # peers' occupancy moved since this replica parked
                    # pods on reconcile conflicts: give them another
                    # admission attempt (backoff still applies)
                    self._wake_version = version
                    self._conflicts_since_wake = 0
                    scheduler.queue.move_all_to_active_or_backoff(
                        "FleetOccupancyExchange"
                    )
            if (
                not self._needs_resync
                and self._seen_membership_version == self.membership.version
            ):
                return False
            self._needs_resync = False
            self._seen_membership_version = self.membership.version
            self._resync_locked(scheduler)
        return True

    # ktpu: holds(cluster.lock)
    def _resync_locked(self, scheduler) -> None:
        metrics.fleet_resyncs_total.inc()
        owned = {
            n for n, r in self._assignment.items() if r == self.replica
        }
        cache = scheduler.cache
        # drop nodes (and their pods) that left the shard
        for name in sorted(set(cache.nodes) - owned):
            cache.remove_node(name)
        # adopt nodes that joined the shard, with their bound pods
        pods = self.cluster.list_pods()
        nodes = self.cluster.list_nodes()
        for node in nodes:
            if node.name in owned and node.name not in cache.nodes:
                cache.add_node(node)
        known_nodes = {
            n for n, info in cache.nodes.items() if info.node is not None
        }
        tracked = scheduler.queue.entries()
        for pod in pods:
            if pod.node_name:
                if (
                    pod.node_name in known_nodes
                    and pod.key
                    not in cache.nodes[pod.node_name].pods
                ):
                    cache.add_pod(pod)
                continue
            # unbound: adopt pods now routed here (a dead replica's
            # orphans), shed pods routed away
            routed = self.routes_pod(pod.key, pod)
            is_tracked = (
                pod.key in tracked
                or pod.key in scheduler._in_flight
                or pod.key in scheduler._waiting
            )
            if routed and not is_tracked:
                if pod.scheduler_name in scheduler.solvers:
                    scheduler.queue.add(pod)
            elif not routed and pod.key in tracked:
                scheduler.queue.delete(pod.key)
        # rebuild this replica's pod ROWS from cluster truth: a node
        # that changed owner takes its pods' future DELETE events to
        # the NEW owner's filter, so withdraw() would never fire here
        # and a ghost row would distort peers' admission forever
        #. Committed rows = labeled pods bound on
        # currently-owned nodes; pending rows survive only while this
        # replica still assumes the pod.
        self.rebuild_pod_rows(cache, pods=pods, nodes=nodes)
        # CAS-staged markers are only meaningful between one admit and
        # its stage; the wholesale row rebuild supersedes any leftovers
        self._cas_staged.clear()
        # sweep routing overrides and reject counts against cluster
        # truth (bound/deleted pods need no routing state)
        live_unbound = {p.key for p in pods if not p.node_name}
        self._routed_away &= live_unbound
        self._routed_here = {
            k: v for k, v in self._routed_here.items() if k in live_unbound
        }
        self._reject_counts = {
            k: v
            for k, v in self._reject_counts.items()
            if k in live_unbound
        }
        # in-flight deferred solves were computed against the old shard
        scheduler._conflict_seq += 1
        scheduler._occupancy_seq += 1
        self.publish_inventory()
        metrics.fleet_owned_nodes.set(len(owned))
        scheduler._refresh_pending_gauge()

    # -- occupancy --

    # called from locked regions of the scheduler: ktpu: holds(cluster.lock)
    def publish_inventory(self) -> None:
        rows = [
            NodeRow(node=n.name, zone=n.labels.get(ZONE_KEY, ""))
            for n in self.cluster.list_nodes()
            if self._assignment.get(n.name) == self.replica
        ]
        try:
            self.exchange.publish_nodes(self.replica, rows)
        except ExchangeUnreachable:
            self._exchange_dirty = True

    # called under cluster.lock (resync, the scheduler's recovery
    # pass): ktpu: holds(cluster.lock)
    def rebuild_pod_rows(self, cache, pods=None, nodes=None) -> None:
        """Replace this replica's exchange pod rows wholesale from
        cluster truth + the live cache: committed rows = labeled pods
        bound on currently-owned nodes, pending rows = placements this
        replica currently ASSUMES. Used at every resync and by the
        restart-recovery pass — a dead incarnation's stale PENDING rows
        (assumed but never bound) roll back here, because the fresh
        incarnation's cache assumes nothing yet. ``pods``/``nodes``
        let a caller that already listed the cluster (the resync)
        avoid paying the O(pods)+O(nodes) listing twice under the
        lock."""
        if pods is None:
            pods = self.cluster.list_pods()
        if nodes is None:
            nodes = self.cluster.list_nodes()
        fresh_rows = []
        node_zone = {
            n.name: n.labels.get(ZONE_KEY, "")
            for n in nodes
            if self._assignment.get(n.name) == self.replica
        }
        for pod in pods:
            if pod.labels and pod.node_name in node_zone:
                fresh_rows.append(
                    PodRow.for_pod(
                        pod, pod.node_name,
                        node_zone[pod.node_name], COMMITTED,
                    )
                )
        for pod_key in list(cache._assumed):
            node = cache.pod_node(pod_key)
            if node in node_zone:
                info = cache.nodes.get(node)
                q = info.pods.get(pod_key) if info is not None else None
                if q is not None and q.labels:
                    fresh_rows.append(
                        PodRow.for_pod(q, node, node_zone[node], PENDING)
                    )
        try:
            self.exchange.replace_pod_rows(self.replica, fresh_rows)
        except ExchangeUnreachable:
            self._exchange_dirty = True

    # called under cluster.lock (admit runs in the apply phase): ktpu: holds(cluster.lock)
    def _peers_view_with_age(self) -> "tuple[PeerView | None, float]":
        """The freshest peer view this replica can get, plus its
        staleness: a fresh hub fetch has the age of its oldest peer
        publish; when the hub is unreachable the cached view serves,
        aging from its fetch time. ``(None, inf)`` before any
        successful fetch — maximally conservative."""
        now = self.clock.now()
        try:
            view = self.exchange.peers_view(self.replica)
        except ExchangeUnreachable:
            view = self._peer_view
        else:
            self._peer_view = view
            self._view_at = now
        if view is None:
            return None, float("inf")
        # a peer's true publish age = its age at fetch time + however
        # long ago the fetch was (zero for a fresh fetch)
        fetch_age = max(now - self._view_at, 0.0)
        oldest_peer = max(
            (peer_age for _r, peer_age in view.peer_ages), default=0.0
        )
        return view, fetch_age + oldest_peer

    def _zone_of(self, cache, node_name: str) -> str:
        info = cache.nodes.get(node_name)
        if info is None or info.node is None:
            return ""
        return info.node.labels.get(ZONE_KEY, "")

    @staticmethod
    def _needs_reconcile(pod: Pod) -> bool:
        """Does this pod carry a constraint whose scope can cross the
        shard boundary (hard topology spread, required anti-affinity)?
        Everything else is fully enforced by the shard-local solve.

        Pod-group members always reconcile: each member's pending row
        must land at the hub through the fenced CAS so peers see a
        staging gang (and so a stale view / AdmitConflict on ANY member
        fails the whole gang round before a single bind)."""
        from ..gang import GANG_LABEL

        if GANG_LABEL in pod.labels:
            return True
        if any(
            c.when_unsatisfiable == "DoNotSchedule"
            for c in pod.topology_spread_constraints
        ):
            return True
        anti = (
            pod.affinity.pod_anti_affinity
            if pod.affinity is not None
            else None
        )
        return anti is not None and bool(anti.required)

    # called from _apply_group's locked apply phase: ktpu: holds(cluster.lock)
    def admit(self, pod: Pod, node_name: str, cache) -> str | None:
        """Pre-assume fleet admission: ownership fence first (the
        no-global-overcommit guarantee), then the cross-shard
        constraint recheck against peers' occupancy rows, then —
        for label-bearing cross-shard-constrained pods — the fenced
        compare-and-stage that lands the pending row at the hub
        ATOMICALLY with the recheck's view version. Two replicas
        racing the same hard-spread slot both pass their host-side
        recheck against the same view; the hub serializes their CAS
        calls, exactly one lands, the loser re-fetches (now seeing the
        winner's pending row) and re-admits — or rejects and requeues
        after _CAS_ATTEMPTS rounds of contention.

        Pod-group members stage through this same fenced CAS one row at
        a time; gang atomicity lives one layer up: the scheduler stages
        EVERY member before any binds, a single member's AdmitConflict
        fails the whole gang round, and the release sweep withdraws the
        already-staged rows (scheduler._release_gang_round via
        _unreserve_all → withdraw) so peers never see a half-staged
        gang outlive its round."""
        if not self.owns_node(node_name):
            metrics.fleet_reconcile_conflicts_total.labels(
                "ownership"
            ).inc()
            return (
                f"node {node_name} is no longer owned by replica "
                f"{self.replica} (partition moved)"
            )
        if not self._needs_reconcile(pod):
            # no cross-shard-scoped constraint: ownership (disjoint
            # shards) is the whole fleet story for this pod — skip the
            # O(peer rows) view (the bench's plain sustained arm would
            # otherwise pay it per pod)
            self._reject_counts.pop(pod.key, None)
            return None
        why = None
        for _attempt in range(self._CAS_ATTEMPTS):
            peers, age = self._peers_view_with_age()
            metrics.fleet_occupancy_row_age_seconds.set(
                age if age != float("inf") else -1.0
            )
            if age > self.config.max_row_age_s:
                # occupancy-staleness bound: the view may hide peers'
                # placements (hub unreachable, or a peer stopped
                # publishing). Admitting a cross-shard-constrained
                # placement against it risks exactly the overcommit the
                # exchange exists to prevent — turn CONSERVATIVE and
                # reject; the pod parks and retries when the exchange
                # version moves (the heal republish bumps it) or via
                # the unschedulable flush.
                metrics.fleet_reconcile_conflicts_total.labels(
                    "stale"
                ).inc()
                self.stale_rejections += 1
                self._conflicts_since_wake += 1
                if peers is not None:
                    self._wake_version = peers.version
                self._reject_counts[pod.key] = (
                    self._reject_counts.get(pod.key, 0) + 1
                )
                shown = "inf" if age == float("inf") else f"{age:.0f}s"
                return (
                    f"fleet occupancy view is {shown} stale (bound "
                    f"{self.config.max_row_age_s:.0f}s): conservative "
                    "admission rejects cross-shard-constrained "
                    "placements until the occupancy exchange heals"
                )
            why = self.reconciler.admit(
                pod, node_name, self._zone_of(cache, node_name), cache,
                peers,
            )
            if why is not None:
                break  # a real constraint conflict, not CAS contention
            if not pod.labels:
                # label-free pods publish no row (they can never match
                # a peer's selector/term), so there is nothing for a
                # racing peer to CAS against either way
                self._reject_counts.pop(pod.key, None)
                return None
            try:
                self.exchange.compare_and_stage(
                    self.replica,
                    PodRow.for_pod(
                        pod, node_name,
                        self._zone_of(cache, node_name), PENDING,
                    ),
                    peers.version,
                    domain_scope=self.config.cas_domain,
                )
            # ktpu: ignore[RETRY001]: CAS loop, not a replay — each attempt re-fetches peers.version and re-runs the host-side recheck before re-staging, so a version conflict retries a NEW request; fenced conflicts break out below. Bounded by _CAS_ATTEMPTS.
            except AdmitConflict as e:
                metrics.fleet_admit_cas_conflict_total.labels(
                    "fenced" if e.fenced else "version"
                ).inc()
                self.cas_conflicts += 1
                if e.fenced:
                    # the hub retired this replica (a peer observed its
                    # lease stale): no row may land until the forced
                    # resync re-registers wholesale — reject and let
                    # the bind-time fence / reacquire path sort out
                    # whether this incarnation still owns anything
                    self._needs_resync = True
                    why = (
                        "fleet occupancy hub fenced this replica "
                        "(membership declared it dead): no placement "
                        "row may land until resync re-registers it"
                    )
                    break
                continue  # version moved: re-fetch and re-admit
            except ExchangeUnreachable:
                # the hub vanished between the view fetch and the CAS:
                # the view already passed the staleness bound, so admit
                # against it (partition semantics — the bound is
                # the risk window) and republish wholesale at the first
                # reachable resync
                self._exchange_dirty = True
                self._reject_counts.pop(pod.key, None)
                return None
            else:
                # the pending row is already at the hub: the apply
                # phase's stage() must not re-send it
                self._cas_staged.add(pod.key)
                self._reject_counts.pop(pod.key, None)
                return None
        else:
            why = (
                f"fleet occupancy CAS contention: the hub version moved "
                f"{self._CAS_ATTEMPTS} times during admission — requeue "
                "and retry against quieter rows"
            )
        metrics.fleet_reconcile_conflicts_total.labels(
            "spread" if "spread" in why
            else ("anti" if "anti" in why else "cas")
        ).inc()
        self._conflicts_since_wake += 1
        if peers is not None:
            self._wake_version = peers.version
        self._reject_counts[pod.key] = (
            self._reject_counts.get(pod.key, 0) + 1
        )
        return why

    # called from the scheduler's admit-reject branch under
    # cluster.lock: ktpu: holds(cluster.lock)
    def maybe_hand_off(self, pod: Pod, trace: str = "") -> str | None:
        """After _HANDOFF_AFTER consecutive reconcile rejections,
        release the pod to the next alive replica in its rendezvous
        chain — its shard may be able to host what this one legally
        cannot (e.g. the under-filled spread domain lives there). Hop
        counts cap the walk at one lap of the fleet; a pod the whole
        fleet rejected parks unschedulable wherever it stands.
        ``trace`` is the pod's journey trace id — it rides the handoff
        row so the adopting replica's journal continues the same
        trace. Returns the receiving replica, or None to keep the pod
        local."""
        key = pod.key
        if self._reject_counts.get(key, 0) < self._HANDOFF_AFTER:
            return None
        alive = self.membership.alive()
        if len(alive) < 2:
            return None
        hops = self._routed_here.get(key, 0)
        if hops + 1 >= len(alive):
            return None  # walked the whole fleet: stay parked here
        # degraded replicas (open solve breakers, published through the
        # exchange) sort LAST: refugees route to healthy peers first.
        # Every replica reads the same flag set, so the chain stays a
        # fleet-wide consistent rendezvous order. A dark hub (mid-
        # failover blackout) yields no flags — the hand_off below
        # would fail the same way and keep the pod local regardless.
        try:
            degraded = self.exchange.degraded_replicas()
        except ExchangeUnreachable:
            return None
        chain = sorted(
            alive,
            key=lambda r: (r in degraded, -_h("pod", key, r), r),
        )
        target = chain[(chain.index(self.replica) + 1) % len(chain)]
        if target == self.replica:
            return None
        try:
            self.exchange.hand_off(
                target, key, hops + 1, from_replica=self.replica,
                trace=trace,
            )
        except ExchangeUnreachable:
            return None  # can't release through a hub we can't reach
        except AdmitConflict:
            # fenced at the hub: keep the pod local until the forced
            # resync re-registers this replica
            self._needs_resync = True
            return None
        self._routed_here.pop(key, None)
        self._routed_away.add(key)
        self._reject_counts.pop(key, None)
        return target

    def set_solver_degraded(self, degraded: bool) -> None:
        """Resilience hook (Scheduler wires it to the solve breaker):
        publish this replica's degraded flag through the exchange so
        peers prefer it last in handoff chains. The replica keeps
        serving its shard — the fallback ladder guarantees forward
        progress — it just stops attracting refugees while sick."""
        try:
            self.exchange.set_degraded(self.replica, degraded)
        except (AdmitConflict, ExchangeUnreachable):
            # breaker hooks fire outside the cluster lock (the solve
            # loop holds no lock around dispatch): take it for the
            # dirty flag (a fenced write re-registers at resync too)
            with self.cluster.lock:
                self._exchange_dirty = True

    # called from _apply_group's locked apply phase: ktpu: holds(cluster.lock)
    def stage(self, pod: Pod, node_name: str, cache) -> None:
        if pod.key in self._cas_staged:
            # admit()'s compare_and_stage already landed this pending
            # row atomically with the constraint recheck
            self._cas_staged.discard(pod.key)
            return
        if not pod.labels:
            return  # label-free pods can never match a selector/term
        try:
            self.exchange.stage(
                self.replica,
                PodRow.for_pod(
                    pod, node_name, self._zone_of(cache, node_name), PENDING
                ),
            )
        except ExchangeUnreachable:
            # the row republishes wholesale at the first reachable
            # resync (rebuild_pod_rows) — the placement itself is
            # legitimate, the hub just hasn't heard about it yet
            self._exchange_dirty = True
        except AdmitConflict:
            # hub write fence (this replica was retired): the forced
            # resync re-registers from truth; until then the row stays
            # off the hub, which is conservative for peers
            self._needs_resync = True

    # called from _commit_binding's locked confirmation phase: ktpu: holds(cluster.lock)
    def commit(self, pod_key: str) -> None:
        try:
            self.exchange.commit(self.replica, pod_key)
        except ExchangeUnreachable:
            self._exchange_dirty = True
        except AdmitConflict:
            self._needs_resync = True

    # every caller (unreserve/ingest/reap paths) holds the cluster
    # lock: ktpu: holds(cluster.lock)
    def withdraw(self, pod_key: str) -> None:
        self._cas_staged.discard(pod_key)
        try:
            self.exchange.withdraw(self.replica, pod_key)
        except ExchangeUnreachable:
            self._exchange_dirty = True
        except AdmitConflict:
            self._needs_resync = True

    # -- fleet backlog drain (fleet/drain.py ledger, hub-hosted) --

    def drain_init_from_plan(self, planned: dict, keys) -> dict:
        """Coordinator half of the fleet backlog drain: partition the
        globally-planned backlog by planned-node shard ownership and
        install the ledger at the hub. ``planned`` maps pod key to its
        relax-planned node name (None = unplaced); ``keys`` is the
        backlog in plan order. Cross-shard-constrained pods (the
        reconciler predicate) and gangs route per fleet/drain.py's
        partitioner rules. Epoch-fenced at the hub — a deposed
        coordinator's plan never lands."""
        from . import drain as drain_mod
        from ..gang import GangTracker

        with self.cluster.lock:
            assignment = dict(self._assignment)
            membership_version = self.membership.version

        def _pod_of(key):
            try:
                ns, name = key.split("/", 1)
                return self.cluster.get_pod(ns, name)
            except Exception:
                return None

        def _cross_shard(key):
            pod = _pod_of(key)
            return pod is not None and self._needs_reconcile(pod)

        def _gang_of(key):
            pod = _pod_of(key)
            if pod is None:
                return ""
            return GangTracker.gang_of(pod) or ""

        partitions, residual = drain_mod.partition_backlog(
            keys, planned, assignment,
            gang_of=_gang_of, cross_shard=_cross_shard,
        )
        return self.exchange.drain_init(
            self.replica, partitions, residual,
            membership_version=membership_version,
        )

    def drain_claim(self, scheduler, plan_keys=None) -> dict | None:
        """Claim this replica's next drain lease and ADOPT its keys:
        each becomes this replica's routed pod (the claim_handoffs
        adoption pattern) and enters its queue. When ``plan_keys`` —
        the full drain plan's key set — is provided, pods the plan
        assigns to OTHER replicas' leases are SHED from this queue
        (ring routing filled it by pod-key hash; the drain partition
        is by planned-node owner, and a pod queued at two replicas is
        a double-solve at best). Returns the lease dict (with ``id``
        and ``keys``) or None when nothing is claimable."""
        try:
            lease = self.exchange.drain_claim(self.replica)
        except ExchangeUnreachable:
            with self.cluster.lock:
                self._exchange_dirty = True
            return None
        except AdmitConflict:
            with self.cluster.lock:
                self._needs_resync = True
            return None
        if not lease:
            return None
        lease_keys = [str(k) for k in lease.get("keys") or []]
        with self.cluster.lock:
            tracked = scheduler.queue.entries()
            for key in lease_keys:
                try:
                    ns, name = key.split("/", 1)
                    pod = self.cluster.get_pod(ns, name)
                except Exception:
                    continue  # deleted while the ledger held it
                if pod.node_name:
                    # bound while the ledger held it (a prior lease
                    # holder's bind landed before its death)
                    continue
                self._routed_here[key] = 0
                self._routed_away.discard(key)
                if (
                    key not in tracked
                    and key not in scheduler._in_flight
                    and key not in scheduler._waiting
                    and pod.scheduler_name in scheduler.solvers
                ):
                    scheduler.queue.add(pod)
            if plan_keys is not None:
                mine = set(lease_keys)
                tracked = scheduler.queue.entries()
                for key in sorted(
                    (set(plan_keys) & set(tracked)) - mine
                ):
                    if key in scheduler._in_flight:
                        continue  # too late: this solve owns it now
                    self._routed_away.add(key)
                    self._routed_here.pop(key, None)
                    scheduler.queue.delete(key)
        return lease

    def drain_chunk_progress(self, keys) -> int:
        """Per-applied-chunk progress report — the ledger's done map
        AND this replica's liveness refresh: a replica deep in a long
        drain chunk writes nothing else to the hub, and without the
        report's touch its publish stamp would age past max_row_age_s
        and flip every peer's constrained admission conservative."""
        if not keys:
            return 0
        try:
            return self.exchange.drain_progress(
                self.replica, list(keys)
            )
        except ExchangeUnreachable:
            with self.cluster.lock:
                self._exchange_dirty = True
            return 0
        except AdmitConflict:
            with self.cluster.lock:
                self._needs_resync = True
            return 0

    def drain_complete(self, lease_id: str) -> bool:
        try:
            return bool(
                self.exchange.drain_complete(
                    self.replica, str(lease_id)
                )
            )
        except ExchangeUnreachable:
            with self.cluster.lock:
                self._exchange_dirty = True
            return False
        except AdmitConflict:
            with self.cluster.lock:
                self._needs_resync = True
            return False
