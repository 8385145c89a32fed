"""Multi-scheduler fleet drive: N REAL Schedulers sharding one REAL
ClusterState through the watch bus, on one virtual timeline.

The single-scheduler harness (sim/harness.py) validates the engine's
concurrency story for one process; this drive validates the fleet
tier's (fleet/): every replica subscribes with its
shard filter, solves its own partition, exchanges occupancy rows
through one shared in-process hub, and hands off pods it cannot
legally host. After every cycle the fleet-wide invariants run:

- **no-global-overcommit** (the tentpole's flagship check): every
  bind each replica reported landed on a node the ring assigned to
  that replica at the time, and global per-node capacity holds across
  all replicas' commits;
- the single-scheduler checks (double-bind, constraints, monotonic
  counters) over the shared cluster state;
- **fleet lost-pod**: every unbound routed pod is tracked by SOME
  replica's queue/in-flight/waiting maps or by a pending handoff row;
- **fleet journal completeness** (at the end): each pod's merged
  journal history — across every replica it traversed — ends on a
  terminal outcome.

The ``replica_loss`` profile kills one replica mid-drive
(unsubscribe + stop driving + retire its exchange rows, exactly what
a process crash looks like to the others); the survivors' membership
flip re-owns its shard and adopts its orphaned pods.

Determinism: same contract as the single harness — one thread,
FakeClock, string-seeded RNG, sorted iteration, round-robin replica
drive order — so same seed + profile produce byte-identical
per-replica journals (--selfcheck byte-compares the
digests).

Copied from ``kubernetes_tpu/sim/fleet.py``. ``FleetSimHarness`` and ``run_fleet_sim`` take ``device`` (None = the card,
raising without CUDA): every replica, the drain's planner and the gRPC hub's
``BulkCore`` solve there, all replicas of the run on the one device.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field

from .. import device as device_mod
from .. import metrics
from ..fleet import FleetConfig, OccupancyExchange
from ..obs import ObsConfig
from ..scheduler import Scheduler, SchedulerConfig
from ..solver.exact import ExactSolverConfig
from ..state.cluster import ClusterState
from ..utils.clock import FakeClock
from .generators import ChurnGenerator, apply_event
from .invariants import (
    BindTransitionTracker,
    MonotonicCounters,
    Violation,
    _record,
    check_constraints,
    check_fleet_drain,
    check_fleet_journal_completeness,
    check_hub_failover,
    check_hub_partition,
    check_no_global_overcommit,
    check_no_partial_gangs,
)
from .harness import _GANG_COUNTERS, _counter_value, _gang_throughput_table
from .profiles import Profile, get_profile


@dataclass
class FleetSimResult:
    profile: str
    seed: int
    cycles: int
    replicas: int
    bindings: dict[str, str]  # pod key -> node (final)
    unbound: list[str]
    violations: list[Violation]
    settled: bool
    summary: dict
    # per-replica decision journals (canonical JSONL) + digests
    journals: dict[str, list[str]] = field(default_factory=dict)
    journal_digests: dict[str, str] = field(default_factory=dict)
    # the hub's append-only journal aggregation surface (obs tentpole):
    # every replica's shipped segments merged in arrival order — the
    # one-file `obs explain --fleet` source the CLI writes out
    hub_journal_lines: list[str] = field(default_factory=list)
    # per-replica flight-recorder dumps written on invariant violation
    # (path -> replica), mirroring the single harness's trigger
    flight_dumps: dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations and self.settled


def _digest(lines: list[str]) -> str:
    return hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()


class FleetSimHarness:
    def __init__(
        self,
        profile: Profile | str,
        seed: int = 0,
        cycles: int = 10,
        replicas: int | None = None,
        *,
        pipelined: bool | None = None,
        streaming: bool | None = None,
        max_settle_rounds: int = 12,
        grpc_hub: bool = False,
        flight_dump: str | None = None,
        device=None,
    ) -> None:
        self.flight_dump_path = flight_dump
        # every replica's solves (and the drain planner's relax plan) run
        # here: the card unless the caller asks for the CPU. Replicas of
        # one process share the one device.
        self.device = device_mod.resolve(device)
        self.profile = (
            get_profile(profile) if isinstance(profile, str) else profile
        )
        self.profile.validate()
        if self.profile.watch_delay or self.profile.external_bind_rate:
            raise ValueError(
                f"profile {self.profile.name}: the fleet drive needs "
                "prompt delivery and no external binds (the ownership "
                "invariant and the fleet≡single equivalence both lean "
                "on it)"
            )
        self.seed = seed
        self.cycles = cycles
        self.n = replicas or self.profile.fleet_replicas or 2
        self.pipelined = (
            self.profile.pipelined if pipelined is None else pipelined
        )
        # streaming dispatcher drive per replica (run_streaming)
        self.streaming = (
            self.profile.streaming if streaming is None else streaming
        )
        self.max_settle_rounds = max_settle_rounds
        # the same "{seed}/gen" stream as the single-scheduler harness:
        # with no external binds/shrinks the event stream is identical,
        # which is what makes fleet-vs-single binding equivalence a
        # meaningful assertion
        self._gen_rng = random.Random(f"{seed}/gen")
        self.clock = FakeClock()
        self.cluster = ClusterState(clock=self.clock)
        self.generator = ChurnGenerator(
            self.profile, self._gen_rng, self.cluster
        )
        for node in self.generator.seed_nodes():
            self.cluster.create_node(node)

        # the hub shares the virtual clock so occupancy-row aging (the
        # staleness bounds) rides the same timeline as everything else.
        # HA mode (profile.hub_failover_at >= 0) runs a PRIMARY +
        # STANDBY hub pair under one HubLease: the primary holds epoch
        # 1, the standby replicates its op log (the harness is the
        # hubs' serving loop — replication polls + lease heartbeats
        # tick once per cycle, deterministic on the virtual clock),
        # and replicas reach them through RemoteOccupancyExchange's
        # endpoint-failover client, in-process (LocalHubClient per
        # hub) or over real gRPC (one bulk server per hub).
        self.ha = self.profile.hub_failover_at >= 0
        self.hub_lease = None
        self.hub_primary = None
        self.hub_standby = None
        self._replicator = None
        self._primary_down = False
        self._promotions = 0
        self._blackout_cycles = 0
        self._old_primary_reads_ok = None
        if self.ha:
            from ..fleet.ha import HubLease, StandbyReplicator

            self.hub_lease = HubLease(
                clock=self.clock, duration_s=self.profile.hub_lease_s
            )
            self.hub_primary = OccupancyExchange(
                clock=self.clock, hub_id="hub-a", lease=self.hub_lease
            )
            assert self.hub_primary.try_promote() == 1
            self.hub_standby = OccupancyExchange(
                clock=self.clock, hub_id="hub-b", lease=self.hub_lease
            )
            # self.exchange is the harness's introspection handle (the
            # invariants' pending-handoff/journal reads, the fault
            # seams): the CURRENT primary — re-pointed at promotion
            self.exchange = self.hub_primary
        else:
            self.exchange = OccupancyExchange(clock=self.clock)
        # gRPC-backed hub: the SAME hub object(s) served behind the
        # bulk boundary's HubOp method on localhost — every replica
        # talks through a RemoteOccupancyExchange over a real socket
        # (real tensorcodec wire framing, real status-code conflict
        # mapping), while the harness keeps direct access for its
        # fault seams (set_partitioned / set_down / retire) and
        # invariants. Virtual time is untouched (RPC wall time never
        # enters the FakeClock) and the drive stays single-threaded
        # round-robin, so same seed + flags reproduce byte-identical
        # journals ACROSS RUNS (--selfcheck). Journals are not
        # byte-identical to the in-process-hub drive: the client's
        # write-behind row buffer legitimately shifts WHEN
        # commit/withdraw bumps land on the hub version counter, which
        # re-times conflict-parked wakeups — every invariant still
        # holds, which is the actual contract.
        self.grpc_hub = grpc_hub
        self._hub_servers: list = []
        self._hub_clients: list = []
        self.universe = tuple(f"r{i}" for i in range(self.n))
        replica_exchange = {rid: self.exchange for rid in self.universe}
        if grpc_hub or self.ha:
            from ..fleet.runtime import RemoteOccupancyExchange

            hubs = (
                [self.hub_primary, self.hub_standby]
                if self.ha
                else [self.exchange]
            )
            if grpc_hub:
                from ..server.bulk import BulkCore, make_grpc_server

                targets = []
                for hub in hubs:
                    core = BulkCore(
                        self.cluster, exchange=hub, device=self.device
                    )
                    server, port = make_grpc_server(core, port=0)
                    server.start()
                    self._hub_servers.append(server)
                    targets.append(f"127.0.0.1:{port}")
                make_clients = lambda rid: dict(  # noqa: E731
                    target=",".join(targets)
                )
            else:
                from ..fleet.ha import LocalHubClient

                make_clients = lambda rid: dict(  # noqa: E731
                    target="", clients=[LocalHubClient(h) for h in hubs]
                )
            replica_exchange = {}
            for rid in self.universe:
                remote = RemoteOccupancyExchange(
                    replica=rid, clock=self.clock,
                    # deterministic flush identity: it only rides RPC
                    # meta (never journals/traces), but a stable id
                    # keeps run-to-run wire traffic identical too
                    flush_client_id=f"{rid}-sim",
                    **make_clients(rid),
                )
                self._hub_clients.append(remote)
                replica_exchange[rid] = remote
            if self.ha:
                from ..server.bulk import BulkClient

                source = (
                    BulkClient(targets[0], retries=0, clock=self.clock)
                    if grpc_hub
                    else LocalHubClient(self.hub_primary)
                )
                self._replicator = StandbyReplicator(
                    self.hub_standby, source
                )
        # gang scheduling (gang profiles): every replica shares the same
        # GangConfig — gangs route whole (by gang id) so one replica
        # assembles and atomically commits each gang, staging members
        # through the fenced hub CAS. Same quarantine-TTL reasoning as
        # the single harness (harness._base_config): park quarantined
        # gangs past the settle horizon.
        self._gang_profile = (
            self.profile.gang_rate > 0 or self.profile.gang_short_at >= 0
        )
        gang_cfg = None
        resilience_cfg = None
        if self._gang_profile:
            from ..gang import GangConfig
            from ..resilience import ResilienceConfig

            gang_cfg = GangConfig(
                min_member_timeout=self.profile.gang_min_member_timeout,
                quarantine_after=self.profile.gang_quarantine_after,
                throughput_weight=self.profile.gang_throughput_weight,
                class_throughput=_gang_throughput_table(self.profile),
            )
            resilience_cfg = ResilienceConfig(quarantine_ttl=3600.0)
        self.schedulers: dict[str, Scheduler] = {}
        for rid in self.universe:
            cfg_kwargs: dict = {}
            if resilience_cfg is not None:
                cfg_kwargs["resilience"] = resilience_cfg
            self.schedulers[rid] = Scheduler(
                self.cluster,
                SchedulerConfig(
                    batch_size=self.profile.batch_size,
                    mesh_devices=1,
                    solver=ExactSolverConfig(
                        tie_break="first",
                        group_size=self.profile.group_size,
                    ),
                    obs=ObsConfig(journal=True),
                    gang=gang_cfg,
                    fleet=FleetConfig(
                        replica=rid,
                        replicas=self.universe,
                        exchange=replica_exchange[rid],
                        max_row_age_s=self.profile.fleet_max_row_age_s,
                    ),
                    **cfg_kwargs,
                ),
                clock=self.clock,
                device=self.device,
            )
        self.alive: dict[str, bool] = {rid: True for rid in self.universe}
        self.tracker = BindTransitionTracker(self.cluster)
        self.monotonic = MonotonicCounters()
        self.violations: list[Violation] = []
        self._sched_bound: set[str] = set()
        self._binds_by_replica: dict[str, int] = {
            rid: 0 for rid in self.universe
        }
        self._events_applied = 0
        self._gang_counters0 = {
            k: _counter_value(c) for k, c in _GANG_COUNTERS.items()
        }
        self._lost_replica: str | None = None
        # hub-partition / zombie state (the hub_partition profile):
        # the zombie keeps DRIVING while partitioned — unlike a lost
        # replica it is alive, just lease-stale and hub-unreachable —
        # and every bind it attempts must be rejected by its revoked
        # commit fence
        self._zombie: str | None = None
        self._zombie_fenced = False
        self._zombie_binds_while_fenced = 0
        # fleet backlog drain (the fleet_backlog_drain profile): the
        # cycle-0 backlog drains through the hub's drain-lease ledger
        # (fleet/drain.py) instead of plain per-replica streaming
        self._fleet_drain = self.profile.fleet_drain
        self._drain_plan_keys: set[str] | None = None
        self._backlog_keys: set[str] = set()
        # backlog key -> replicas that reported it scheduled: the
        # drain-partition half of the double-bind story (the tracker
        # asserts the cluster-level half every cycle)
        self._drain_bound: dict[str, list[str]] = {}
        self._planner: Scheduler | None = None
        if self._fleet_drain:
            # the coordinator's full-view planner: a NON-fleet
            # Scheduler on the same cluster — replica caches are
            # ownership-filtered to their shard's nodes, so only an
            # unfiltered subscriber can run the relax mega-plan
            # globally. Never driven: it only plans.
            self._planner = Scheduler(
                self.cluster,
                SchedulerConfig(
                    batch_size=self.profile.batch_size,
                    mesh_devices=1,
                    solver=ExactSolverConfig(
                        tie_break="first",
                        group_size=self.profile.group_size,
                    ),
                ),
                clock=self.clock,
                device=self.device,
            )

    # -- drive --

    def _drive_replica(self, rid: str, cycle: int) -> None:
        sched = self.schedulers[rid]
        results = None
        if self._fleet_drain and self._drain_outstanding():
            # drain mode: claim-adopt-drain one lease chunk through
            # this replica's own drain_backlog slot ring (one chunk
            # per cycle keeps the concurrent-drain interleaving and
            # the mid-lease kill non-vacuous). No claimable lease ->
            # fall through to the normal drive so fresh arrivals and
            # handed-off pods still progress.
            out = sched.fleet_drain_backlog(
                chunk_pods=self.profile.backlog_chunk or 0,
                max_batches=1,
                plan_keys=self._drain_plan_keys,
            )
            if out["leases"]:
                results = out["results"]
        if results is None:
            if self.streaming:
                results = sched.run_streaming(max_batches=200)
            elif self.pipelined:
                results = sched.run_pipelined(max_batches=200)
            else:
                results = sched.run_until_settled(max_batches=200)
        scheduled = [
            (pod, node) for r in results for pod, node in r.scheduled
        ]
        if self._fleet_drain:
            for pod, _node in scheduled:
                if pod in self._backlog_keys:
                    self._drain_bound.setdefault(pod, []).append(rid)
        if rid == self._zombie and self._zombie_fenced and scheduled:
            # a fenced zombie's commit LANDED: the fence leaked
            self._zombie_binds_while_fenced += len(scheduled)
        self.tracker.record_results(scheduled)
        self._sched_bound.update(pod for pod, _ in scheduled)
        self._binds_by_replica[rid] += len(scheduled)
        # ownership half of no-global-overcommit: the binds this
        # replica just reported, against its assignment RIGHT NOW
        # (single-threaded: nothing moved since the bind committed)
        with self.cluster.lock:
            owners = dict(sched.fleet._assignment)
        check_no_global_overcommit(
            self.cluster,
            cycle,
            self.violations,
            binds=[(rid, pod, node) for pod, node in scheduled],
            owners=owners,
        )

    def _drive(self, cycle: int) -> None:
        order = list(self.universe)
        if self._zombie_fenced and self._zombie in order:
            # real replicas run concurrently; the interleaving the
            # commit fence exists for is the zombie racing AHEAD of the
            # survivors that re-owned its shard — so while fenced it
            # drives first each cycle, attempting commits on pods the
            # survivors haven't taken yet (all must reject)
            order.remove(self._zombie)
            order.insert(0, self._zombie)
        for rid in order:
            if self.alive[rid]:
                self._drive_replica(rid, cycle)

    # -- fleet backlog drain (the fleet_backlog_drain profile) --

    def _init_fleet_drain(self) -> None:
        """The coordinator seam, cycle 0: the full-view planner runs
        the relax mega-plan once globally; the first replica partitions
        the backlog by planned-node shard owner and installs the lease
        ledger at the hub (``FleetRuntime.drain_init_from_plan`` ->
        epoch-fenced ``drain_init``). Key order is the planner's queue
        order — the plan order every partition preserves."""
        plan = self._planner.relax_plan_backlog()
        keys = list(plan)
        self._backlog_keys = set(keys)
        self._drain_plan_keys = set(keys)
        self.schedulers[self.universe[0]].fleet.drain_init_from_plan(
            plan, keys
        )

    def _drain_outstanding(self) -> bool:
        st = self.exchange.drain_status()
        return bool(st.get("active")) and st.get("outstanding", 0) > 0

    def _kill_replica(self, rid: str, cycle: int) -> None:
        """A process crash as the rest of the fleet perceives it: the
        watch subscription vanishes, the shard lease goes stale (the
        survivors' membership flips), its exchange rows retire. Its
        journal is retained — the fleet-wide completeness check merges
        it with the survivors'."""
        self.alive[rid] = False
        self._lost_replica = rid
        dead = self.schedulers[rid]
        self.cluster.unsubscribe(dead._on_event)
        self.exchange.retire(rid)
        survivors = [r for r in self.universe if self.alive[r]]
        for r in survivors:
            self.schedulers[r].fleet.set_alive(survivors)

    # -- hub HA (the hub_failover profile) --

    def _ha_tick(self, cycle: int) -> None:
        """One deterministic HA maintenance round per cycle — runs
        AFTER the cycle's clock advance and BEFORE its drive, so the
        serving hub's lease renewal covers the drive's ops even
        through the settle ladder's long (11s/301s) rounds. The
        harness IS the hubs' serving loops on the virtual timeline:
        lease maintenance (``try_promote`` — a same-holder re-acquire
        renews WITHOUT bumping the epoch, so steady state never looks
        like a failover), the standby's replication poll, the
        kill/promote/heal schedule, and the one injected reply-loss
        that proves the idempotent flush path."""
        from ..fleet.occupancy import ExchangeUnreachable

        if not self._primary_down:
            # replication poll BEFORE the kill check: one poll per
            # tick means the standby is caught up to the last
            # completed cycle when the kill lands (lag within the
            # kill's own cycle heals through the clients' retained
            # sealed buffers and the forced republish — rows — while
            # journal lines ride the same retained buffers)
            try:
                self._replicator.poll()
            except ExchangeUnreachable:
                pass
        if cycle == self.profile.hub_failover_at:
            self._kill_primary(cycle)
        if not self._primary_down:
            self.hub_primary.try_promote()  # same-holder lease renew
        elif self._promotions:
            # the promoted standby is the serving hub: keep ITS lease
            # fresh (an unrenewed lease would self-depose it — the
            # exact failure mode the fencing check exists to catch)
            self.hub_standby.try_promote()
        else:
            # blackout: takeover only succeeds once the dead
            # primary's lease expires — the fencing window
            granted = self.hub_standby.try_promote()
            if granted is not None:
                self._promotions += 1
                # the standby is the serving hub now: re-point the
                # harness's introspection handle (invariants, journal
                # aggregation reads, retire calls)
                self.exchange = self.hub_standby
            else:
                self._blackout_cycles += 1
        if cycle == 1:
            # deterministic reply loss: the next apply_ops flush
            # applies server-side, then the reply is lost — the
            # client's sealed-batch retry must dedup (the invariant's
            # dedup_hits >= 1 clause)
            self.hub_primary.set_flush_fault(1)
        if (
            cycle == self.profile.hub_failover_heal
            and self._primary_down
            and self._promotions
        ):
            self._heal_old_primary(cycle)

    def _kill_primary(self, cycle: int) -> None:
        """The primary hub process dies: every op from every replica
        raises ExchangeUnreachable (UNAVAILABLE over the wire), its
        lease renewals stop, and the fleet enters the blackout window
        — conservative admission until the standby's lease grant."""
        self._primary_down = True
        self.hub_primary.set_down(True)
        metrics.sim_faults_injected_total.labels("hub_failover").inc()

    def _heal_old_primary(self, cycle: int) -> None:
        """The OLD primary resurfaces (partitioned-zombie style:
        alive, lease long taken over). It must keep serving its
        debug/read surface — the post-mortem path — while 100% of
        replica-facing writes reject with the typed HubDeposed (its
        own lease-validity check self-deposes it on the first write
        attempt; a replica that failed over already ignores it via
        the epoch-monotone check)."""
        from ..fleet.occupancy import HubDeposed, PodRow

        self.hub_primary.set_down(False)
        try:
            status = self.hub_primary.hub_status()
            self._old_primary_reads_ok = bool(status.get("hub"))
        except Exception:
            self._old_primary_reads_ok = False
        # the write probe: a straggler replica (or the zombie itself)
        # pushing a row at the old primary must get the typed fence
        probe = PodRow(
            pod="probe/stale-write", node="n0", zone="z0",
            namespace="probe", labels=(("app", "probe"),),
        )
        try:
            self.hub_primary.stage(self.universe[0], probe)
        except HubDeposed:
            pass  # counted in deposed_write_rejections — the proof
        else:
            _record(
                self.violations, "hub_failover", cycle,
                "a replica-facing write LANDED on the deposed old "
                "primary — the hub epoch fence leaked",
            )

    def _partition_hub(self, cycle: int) -> None:
        """The hub_partition fault: the last replica loses its network
        path to the occupancy hub AND its lease renewals stall (the
        classic GC-pause zombie). The survivors observe the stale
        lease, mark it dead, and — through the membership transition —
        REVOKE its commit fence at the state service. The zombie keeps
        driving with its stale view; every bind it attempts must now
        reject with Conflict."""
        zombie = self.universe[-1]
        self._zombie = zombie
        self._zombie_fenced = True
        metrics.sim_faults_injected_total.labels("hub_partition").inc()
        metrics.sim_faults_injected_total.labels("lease_fence").inc()
        self.exchange.set_partitioned(zombie, True)
        survivors = [r for r in self.universe if r != zombie]
        for r in survivors:
            # each survivor's poll observes the stale lease: the
            # membership flip re-owns the zombie's shard and revokes
            # its fence (FleetRuntime._membership_changed)
            self.schedulers[r].fleet.set_alive(survivors)

    def _heal_hub(self, cycle: int) -> None:
        """Partition heals: the zombie reaches the hub again,
        re-acquires its lease — a fresh fence token plus a forced full
        resync BEFORE any commit (Scheduler.reacquire_fence) — and
        republishes its rows; the survivors' polls see the lease fresh
        and re-admit it."""
        zombie = self._zombie
        self._zombie_fenced = False
        self.exchange.set_partitioned(zombie, False)
        for r in self.universe:
            if r != zombie:
                self.schedulers[r].fleet.set_alive(self.universe)
        self.schedulers[zombie].reacquire_fence()

    def _check(self, cycle: int) -> None:
        self.tracker.drain(cycle, self.violations)
        check_constraints(self.cluster, cycle, self.violations)
        # fleet-wide: gangs must land atomically no matter which
        # replica owned them (a no-op without gang labels)
        check_no_partial_gangs(self.cluster, cycle, self.violations)
        self._check_fleet_lost_pods(cycle)
        self.monotonic.observe(cycle, self.violations)

    def _check_fleet_lost_pods(self, cycle: int) -> None:
        """Fleet lost-pod accounting: every unbound pod some alive
        replica routes must be tracked by a queue / in-flight map /
        WaitingPods map somewhere, or sit in a pending handoff row."""
        # debug_state bypasses the down seam: mid-blackout the
        # (dead) hub's last-known handoff rows still count as
        # tracked — they replicate to the standby and re-surface
        tracked: set[str] = set(
            self.exchange.debug_state()["pending_handoffs"]
        )
        if self._fleet_drain:
            # mid-reassignment a returned drain lease's keys sit in no
            # replica's queue — the hub ledger tracks them until the
            # next claimant adopts (like an unclaimed handoff row)
            tracked |= set(self.exchange.drain_outstanding_keys())
        solver_names: set[str] = set()
        for rid, sched in self.schedulers.items():
            if not self.alive[rid]:
                continue
            tracked |= set(sched.queue.entries())
            tracked |= set(sched._in_flight)
            tracked |= set(sched._waiting)
            # resilience-quarantined pods are parked with a TTL'd
            # re-admit — tracked, not lost
            tracked |= set(sched._quarantine)
            solver_names |= set(sched.solvers)
        for pod in self.cluster.list_pods():
            if pod.node_name or pod.scheduler_name not in solver_names:
                continue
            if pod.key not in tracked:
                _record(
                    self.violations, "lost_pod", cycle,
                    f"pod {pod.key} is unbound but tracked by no alive "
                    "replica's queue/in-flight/waiting maps nor a "
                    "pending handoff row",
                )

    def _gang_summary(self) -> dict | None:
        if not self._gang_profile:
            return None
        from ..gang import GangTracker

        gang_bound: set[str] = set()
        gang_unbound: set[str] = set()
        for p in self.cluster.list_pods():
            gid = GangTracker.gang_of(p)
            if gid is not None:
                (gang_bound if p.node_name else gang_unbound).add(gid)
        return {
            "partial_gangs": len(gang_bound & gang_unbound),
            **{
                k: int(_counter_value(c) - self._gang_counters0[k])
                for k, c in _GANG_COUNTERS.items()
            },
        }

    def _settled(self) -> bool:
        if self.exchange.debug_state()["pending_handoffs"]:
            return False
        if self._fleet_drain:
            # not settled while the ledger can still grant work whose
            # pods sit in NO queue: unclaimed orphans, an in-flight
            # granted lease, or a residual cohort awaiting its
            # serialized grant (its keys were shed from every queue)
            st = self.exchange.drain_status()
            if st.get("active") and (
                st.get("orphans", 0)
                or st.get("granted", 0)
                or (
                    st.get("residual", 0)
                    and not st.get("residualGranted")
                )
            ):
                return False
        for rid, sched in self.schedulers.items():
            if not self.alive[rid]:
                continue
            if sched._waiting or sched._in_flight:
                return False
            live = set(sched.queue.entries().values())
            if live & {"active", "backoff"}:
                return False
        return True

    def run(self) -> FleetSimResult:
        try:
            return self._run()
        finally:
            for client in self._hub_clients:
                client.close()
            for server in self._hub_servers:
                server.stop(grace=None)

    def _run(self) -> FleetSimResult:
        for cycle in range(self.cycles):
            metrics.sim_cycles_total.inc()
            if cycle == self.profile.replica_loss_at and self.n > 1:
                self._kill_replica(self.universe[-1], cycle)
            if cycle == self.profile.hub_partition_at and self.n > 1:
                self._partition_hub(cycle)
            if (
                self._zombie is not None
                and cycle == self.profile.hub_partition_heal
            ):
                self._heal_hub(cycle)
            for ev in self.generator.generate(cycle):
                apply_event(self.cluster, ev)
                self._events_applied += 1
            self.clock.advance(1.0)
            if self.ha:
                # post-advance, pre-drive: the serving hub's lease
                # renewal covers this drive's ops
                self._ha_tick(cycle)
            if self._fleet_drain and cycle == 0:
                # after the backlog landed, before any replica drives:
                # the coordinator plans globally and installs the
                # drain-lease ledger at the hub
                self._init_fleet_drain()
            self._drive(cycle)
            self._check(cycle)
        settled = self._quiesce()
        if not settled:
            queues = {
                rid: self.schedulers[rid].queue.pending_counts()
                for rid in self.universe
                if self.alive[rid]
            }
            _record(
                self.violations, "progress",
                self.cycles + self.max_settle_rounds,
                "fleet failed to quiesce after churn stopped: "
                f"queues={queues} "
                f"handoffs="
                f"{sorted(self.exchange.debug_state()['pending_handoffs'])}",
            )
        return self._finish(settled)

    def _quiesce(self) -> bool:
        """Same settle ladder as the single harness: 11s rounds clear
        backoff, one 301s round forces the unschedulable-leftover
        flush (cross-shard-rejected pods park unschedulable and the
        flush is their guaranteed retry path once churn stops)."""
        advances = [11.0, 11.0, 301.0] + [11.0] * max(
            self.max_settle_rounds - 3, 0
        )
        flush_round = 2
        for i, adv in enumerate(advances):
            cycle = self.cycles + i
            self.clock.advance(adv)
            if self.ha:
                # post-advance like the main loop: the serving hub's
                # lease renewal covers this round's drive, and a kill
                # near the end of the driven cycles still promotes
                # during the settle ladder instead of deadlocking it
                self._ha_tick(cycle)
            self._drive(cycle)
            self._check(cycle)
            if i >= flush_round and self._settled():
                return True
        return False

    def _finish(self, settled: bool) -> FleetSimResult:
        # final journal ship: drain every alive replica's unshipped
        # segment tail to the hub's aggregation surface (segments are
        # bounded per call, so loop until empty), then flush the
        # remote adapters' write-behind buffers so the piggybacked
        # lines land before the hub is read
        for rid, sched in self.schedulers.items():
            if not self.alive[rid]:
                continue
            while sched.fleet.ship_journal_segment(sched) > 0:
                pass
        for client in self._hub_clients:
            try:
                client.flush()
            except Exception:
                pass  # partitioned teardown: the rows stay buffered
        hub_journal = self.exchange.journal_lines()
        check_fleet_journal_completeness(
            self.cluster,
            list(self.schedulers.values()),
            self.cycles + self.max_settle_rounds,
            self.violations,
            self._sched_bound,
        )
        if self.profile.hub_partition_at >= 0 and self.n > 1:
            zombie_sched = (
                self.schedulers[self._zombie]
                if self._zombie is not None
                else None
            )
            check_hub_partition(
                self.cycles + self.max_settle_rounds,
                self.violations,
                fenced_commits=(
                    zombie_sched._fenced_commits
                    if zombie_sched is not None
                    else 0
                ),
                zombie_binds_while_fenced=self._zombie_binds_while_fenced,
                stale_rejections=sum(
                    s.fleet.stale_rejections
                    for s in self.schedulers.values()
                ),
            )
        hub_ha = None
        if self.ha:
            # journal aggregation completeness after heal: every line
            # each replica's journal holds must be on the SERVING
            # hub's aggregation surface (pre-kill lines arrived via
            # replication, blackout lines via the clients' retained
            # sealed buffers re-flushed from the cursor)
            hub_lines = set(hub_journal)
            hub_journal_missing = sum(
                1
                for rid, sched in self.schedulers.items()
                if self.alive[rid]
                for line in sched.journal.lines
                if line not in hub_lines
            )
            hub_ha = {
                "promotions": self._promotions,
                "epoch": self.exchange.hub_epoch,
                "blackout_cycles": self._blackout_cycles,
                # the OLD primary's count is the stale-primary-fence
                # proof; the standby's own (pre-promotion writes that
                # rotated onto it during the blackout) is reported
                # separately — it is the failover client working, not
                # the fence under test
                "deposed_write_rejections": (
                    self.hub_primary.deposed_write_rejections
                ),
                "standby_write_rejections": (
                    self.hub_standby.deposed_write_rejections
                ),
                "flush_dedup_hits": (
                    self.hub_primary.flush_dedup_hits
                    + self.hub_standby.flush_dedup_hits
                ),
                "client_failovers": sum(
                    c.failovers for c in self._hub_clients
                ),
                "replication_ops": self._replicator.ops_applied,
                "replication_snapshots": (
                    self._replicator.snapshots_installed
                ),
                "old_primary_reads_ok": self._old_primary_reads_ok,
                "hub_journal_missing": hub_journal_missing,
            }
            check_hub_failover(
                self.cycles + self.max_settle_rounds,
                self.violations,
                promotions=self._promotions,
                epoch=self.exchange.hub_epoch,
                deposed_write_rejections=hub_ha[
                    "deposed_write_rejections"
                ],
                flush_dedup_hits=hub_ha["flush_dedup_hits"],
                stale_rejections=sum(
                    s.fleet.stale_rejections
                    for s in self.schedulers.values()
                ),
                hub_journal_missing=hub_journal_missing,
                old_primary_reads_ok=self._old_primary_reads_ok,
            )
        bindings = {
            p.key: p.node_name
            for p in sorted(self.cluster.list_pods(), key=lambda q: q.key)
            if p.node_name
        }
        fleet_drain = None
        if self._fleet_drain:
            st = self.exchange.drain_status()
            lost = sum(
                1 for k in self._backlog_keys if k not in bindings
            )
            double = sum(
                1 for v in self._drain_bound.values() if len(v) > 1
            )
            fleet_drain = {
                "pods": len(self._backlog_keys),
                "partitions": st.get("partitions", 0),
                "residual": st.get("residual", 0),
                "drained": st.get("done", 0),
                "leases": st.get("leases", 0),
                "leases_reassigned": st.get("reassigned", 0),
                "lost": lost,
                "double_bind": double,
            }
            check_fleet_drain(
                self.cycles + self.max_settle_rounds,
                self.violations,
                backlog=len(self._backlog_keys),
                drained=st.get("done", 0),
                double_binds=double,
                lost=lost,
                leases_reassigned=st.get("reassigned", 0),
                expect_reassign=self.profile.replica_loss_at >= 0,
            )
        unbound = sorted(
            p.key for p in self.cluster.list_pods() if not p.node_name
        )
        journals = {
            rid: list(s.journal.lines)
            for rid, s in self.schedulers.items()
        }
        digests = {rid: _digest(lines) for rid, lines in journals.items()}
        summary = {
            "replicas": self.n,
            "alive": sum(self.alive.values()),
            "lost_replica": self._lost_replica,
            "hub": "grpc" if self.grpc_hub else "in-process",
            "cas_conflicts": sum(
                s.fleet.cas_conflicts for s in self.schedulers.values()
            ),
            "pipelined": self.pipelined,
            "events": self._events_applied,
            "bound": len(bindings),
            "unbound": len(unbound),
            "settled": settled,
            "violations": len(self.violations),
            "binds_by_replica": dict(
                sorted(self._binds_by_replica.items())
            ),
            # partition-safety counters (hub_partition): who the zombie
            # was, per-replica fence rejections at the state service,
            # zombie binds that LANDED while fenced (must be 0), and
            # conservative-admission rejections under stale rows
            "zombie": self._zombie,
            "fenced_commits": {
                rid: s._fenced_commits
                for rid, s in sorted(self.schedulers.items())
            },
            "zombie_binds_while_fenced": self._zombie_binds_while_fenced,
            "stale_rejections": sum(
                s.fleet.stale_rejections
                for s in self.schedulers.values()
            ),
            "journal_digests": digests,
            "hub_journal_lines": len(hub_journal),
            "hub_journal_digest": _digest(hub_journal),
            # hub-HA counters (the hub_failover profile; None without)
            "hub_ha": hub_ha,
            # gang scheduling (gang profiles; None without): partial
            # gangs fleet-wide must be 0 — atomicity survives replica
            # loss because gangs route whole and commit through one
            # replica's fenced CAS round
            "gang": self._gang_summary(),
            # fleet backlog drain (fleet_drain profiles; None without):
            # lost counts backlog keys unbound fleet-wide at end — the
            # ledger's own done counter may legitimately trail it when
            # residual pods are handed off and bound by a peer's normal
            # drive, so the invariant anchors on bindings, not the ledger
            "fleet_drain": fleet_drain,
        }
        flight_dumps: dict[str, str] = {}
        if self.violations:
            # the invariant trigger, fleet-wide: dump every replica's
            # recent-history ring next to the violation report (the
            # single harness's contract; no-op without a configured
            # path — FlightRecorder.dump counts the trigger either way)
            for rid in sorted(self.schedulers):
                rec = self.schedulers[rid].flight
                if rec is None:
                    continue
                path = (
                    f"{self.flight_dump_path}.{rid}"
                    if self.flight_dump_path
                    else None
                )
                written = rec.dump(path=path, trigger="invariant")
                if written:
                    flight_dumps[written] = rid
        return FleetSimResult(
            profile=self.profile.name,
            seed=self.seed,
            cycles=self.cycles,
            replicas=self.n,
            bindings=bindings,
            unbound=unbound,
            violations=self.violations,
            settled=settled,
            summary=summary,
            journals=journals,
            journal_digests=digests,
            hub_journal_lines=hub_journal,
            flight_dumps=flight_dumps,
        )


def run_fleet_sim(
    profile: str,
    seed: int = 0,
    cycles: int = 10,
    replicas: int | None = None,
    *,
    pipelined: bool | None = None,
    streaming: bool | None = None,
    grpc_hub: bool = False,
    flight_dump: str | None = None,
    device=None,
) -> FleetSimResult:
    """One fresh seeded fleet run (library entry; CLI and tests).
    ``grpc_hub=True`` serves the occupancy hub behind a localhost bulk
    gRPC server (real wire framing + typed status mapping) instead of
    the shared in-process object — same invariants; byte-determinism
    holds run-to-run (--selfcheck), NOT across transports (the
    write-behind row buffer re-times hub version bumps). Every replica
    solves on ``device`` (None = the card)."""
    return FleetSimHarness(
        profile, seed=seed, cycles=cycles, replicas=replicas,
        pipelined=pipelined, streaming=streaming, grpc_hub=grpc_hub,
        flight_dump=flight_dump, device=device,
    ).run()
