"""Scenario profiles: named churn/fault mixes the simulator runs.

A profile is a declarative recipe — per-cycle event rates for the
generators plus fault-injection knobs — from which a seeded run derives
everything else. Rates are expected counts or probabilities consumed in
a fixed order by ``generators.ChurnGenerator``, so a profile + seed is
a complete description of a run.

Soundness constraint (enforced in ``validate``): a profile that delays
watch delivery must NOT also shrink node allocatable or perform
external competing binds. Under delayed delivery the scheduler's view
legitimately lags the cluster, and binding against a view that predates
a capacity *reduction* can transiently overcommit — exactly the
staleness the reference scheduler also accepts (kubelet admission is
the real-world backstop). The capacity invariant would flag it as a
scheduler bug when it is not one, so those knobs are mutually
exclusive per profile. Capacity-*increasing* churn (node adds, label
flaps, allocatable grows, pod deletes) is always safe to delay.

Copied from ``kubernetes_tpu/sim/profiles.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Profile:
    name: str
    # -- cluster shape / scheduler config --
    pipelined: bool = True
    # drive Scheduler.run_streaming (the streaming dispatcher's
    # device-resident solve loop) instead of run_pipelined. Orthogonal
    # to ``pipelined`` (which picks pipelined-vs-sync when streaming is
    # off); the CLI's --dispatcher flag overrides either.
    streaming: bool = False
    nodes: int = 6
    node_cpu: str = "8"
    node_mem: str = "32Gi"
    batch_size: int = 16
    group_size: int = 8
    # -- pod arrival process (uniform count per cycle, inclusive) --
    arrivals: tuple[int, int] = (2, 6)
    pod_cpu_choices: tuple[str, ...] = ("500m", "1", "2")
    pod_priorities: tuple[int, ...] = (0,)
    # hard-shape mix: P(an arrival carries the shape), drawn in order
    # spread -> anti -> ports (first hit wins; remainder is a plain fit
    # pod). Non-zero rates drive the pipelined loop's occupancy-carrying
    # path (ports/spread/interpod batches no longer drain to the
    # synchronous cycle) plus the constraint invariants that guard it.
    pod_spread_rate: float = 0.0  # zone topology spread, hard maxSkew=1
    pod_anti_rate: float = 0.0  # required hostname anti-affinity
    pod_ports_rate: float = 0.0  # hostPort from a 2-port pool
    zones: int = 3  # node zone labels: z{seq % zones}
    # -- churn rates (events per cycle; fractional = probability) --
    delete_pod_rate: float = 0.0
    node_add_rate: float = 0.0
    node_delete_rate: float = 0.0
    label_flap_rate: float = 0.0
    alloc_grow_rate: float = 0.0
    alloc_shrink_rate: float = 0.0
    external_bind_rate: float = 0.0
    # -- fault injection --
    bind_fault_rate: float = 0.0  # P(injected ApiError per scheduler bind)
    watch_delay: bool = False  # hold watch events for later delivery
    watch_dup_rate: float = 0.0  # P(an event is delivered twice)
    extender: bool = False  # configure a (faultable) HTTP extender
    extender_fault_rate: float = 0.0  # P(timeout/5xx per extender call)
    permit: bool = False  # register the stalling Permit plugin
    permit_stall_rate: float = 0.0  # P(first attempt of a pod WAITs)
    permit_timeout: float = 5.0
    # -- solver-boundary faults (kubernetes_tpu_torch/resilience) --
    # P(an injected device/runtime error per solve dispatch) — exempts
    # the pure-host ladder rung, so the fallback ladder always has a
    # working floor (a real accelerator outage can't break host python)
    solver_fault_rate: float = 0.0
    # restrict injected solver faults to a virtual-clock window
    # [start, end); () = always. A bounded window is what lets the
    # invariants assert the breaker RE-CLOSES after the fault clears.
    solver_fault_window: tuple = ()
    # P(an arrival is a poison pod): its presence in ANY batch breaks
    # the solve at EVERY tier (tensorize/solve-breaking data), driving
    # the bisection quarantine
    poison_rate: float = 0.0
    # breaker fault window for the harness's ResilienceConfig: short
    # enough that probes/re-closes happen within a sim run's virtual
    # timeline (production default is 30s)
    resilience_open_s: float = 3.0
    # -- fleet mode (sim/fleet.py multi-scheduler drive) --
    fleet_replicas: int = 0  # default replica count for --fleet runs
    # kill one replica at this cycle (replica_loss fault): its shard is
    # re-owned by the survivors and every orphaned pod must still reach
    # a terminal journal outcome fleet-wide. -1 = never.
    replica_loss_at: int = -1
    # -- process lifecycle (crash_restart / hub_partition) --
    # crash the scheduler at this cycle, mid-batch: the first batch of
    # that cycle dies AFTER its pods are assumed/approved and BEFORE
    # any bind commits (the _pre_commit_hook seam), and a FRESH
    # Scheduler incarnation is constructed on the same ClusterState —
    # the cold-start recovery pass re-adopts everything the crash
    # orphaned. -1 = never.
    crash_at: int = -1
    # fleet drive: partition the last replica from the occupancy hub
    # over virtual cycles [hub_partition_at, hub_partition_heal). Its
    # lease is observed stale at partition start (survivors mark it
    # dead and REVOKE its commit fence — it keeps driving as a zombie
    # whose binds must all reject with Conflict), and at heal it
    # re-acquires the fence + resyncs while the survivors re-admit it.
    hub_partition_at: int = -1
    hub_partition_heal: int = -1
    # occupancy-staleness bound the fleet drive passes to FleetConfig
    # (max_row_age_s): hub_partition shrinks it so peer-row aging
    # crosses the bound inside the window and conservative admission
    # actually engages.
    fleet_max_row_age_s: float = 30.0
    # -- hub HA (fleet/ha.py: replicated hub + epoch-fenced failover) --
    # kill the PRIMARY occupancy hub at this cycle: the fleet drive
    # runs a primary + standby hub pair (op-log replication, shared
    # HubLease), replicas reach them through RemoteOccupancyExchange's
    # endpoint-failover client, and the kill opens a blackout window —
    # conservative admission engages — until the standby's lease grant
    # promotes it at the next epoch. -1 = single hub (no HA).
    hub_failover_at: int = -1
    # resurrect the OLD primary's reachability at this cycle: it must
    # keep serving its debug/read surface while 100% of replica-facing
    # writes reject with the typed HubDeposed (the stale-primary fence
    # the invariant pins). -1 = never.
    hub_failover_heal: int = -1
    # hub lease duration (virtual seconds): the fencing window — the
    # standby can only promote after the dead primary's lease expires,
    # so this bounds the failover blackout from below.
    hub_lease_s: float = 2.0
    # -- continuous rebalancer (kubernetes_tpu/rebalance) --
    # enable the background defragmentation loop on the sim scheduler
    rebalance: bool = False
    rebalance_interval_s: float = 4.0  # virtual seconds between passes
    rebalance_budget: int = 4  # max-churn: evictions per pass
    # dominant-resource packed-utilization threshold (detector.py)
    rebalance_min_packing: float = 0.6
    # P(an arrival joins the PDB-guarded cohort): labeled pods matched
    # by a seeded PodDisruptionBudget with disruptionsAllowed=0, so the
    # rebalancer's PDB gate (and the eviction subresource's 429) are
    # exercised non-vacuously — the rebalance invariant asserts none
    # of them ever moved
    pdb_guard_rate: float = 0.0
    # -- backlog drain (Scheduler.drain_backlog) --
    # pods seeded at cycle 0 BEFORE any churn (same hard-shape mix as
    # arrivals, same event/trace machinery so replay works): cycle 0's
    # drive then drains them through drain_backlog — the HBM-budget-
    # planned, chunk-aligned streaming path — instead of a plain
    # run_streaming call. 0 = off.
    backlog: int = 0
    # starting chunk size for the drain's budget planner (0 = the
    # profile batch_size)
    backlog_chunk: int = 0
    # force the budget planner to auto-split: the harness computes the
    # base chunk's per-device estimate and hands the drain a budget one
    # byte BELOW it, so plan_chunk must halve at least once — the
    # budget_splits>=1 the CI smoke pins, robust to estimator formula
    # changes (an absolute byte figure here would not be)
    backlog_force_split: bool = False
    # -- fleet backlog drain (fleet/drain.py, ROADMAP #5a) --
    # drain the cycle-0 backlog through the hub's drain-lease ledger
    # instead of per-replica run_streaming: a full-view planner runs
    # the relax mega-plan once globally, the first replica installs
    # the partitioned ledger at the hub (drain_init), and every alive
    # replica claims/drains epoch-fenced leases per cycle
    # (Scheduler.fleet_drain_backlog). Combine with replica_loss_at to
    # kill a replica mid-lease — the reassignment path the
    # check_fleet_drain invariant pins. Requires backlog > 0,
    # fleet_replicas >= 2, and the streaming drive.
    fleet_drain: bool = False
    # -- convex-relaxation mega-planner (solver/relax.py) --
    # warm-start the cycle-0 backlog drain: one relaxed global solve
    # over the whole active queue ranks the backlog before the first
    # chunk pops (Scheduler.drain_backlog(warm_start=True)), and the
    # harness runs its deterministic megaplan probe — relax+repair vs
    # the exact anchor on the same frozen snapshot — whose plan
    # validity and objective ratio ride the footer for check_megaplan.
    backlog_warm_start: bool = False
    # -- closed-loop auto-tuning (kubernetes_tpu_torch/tuning) --
    # enable the tuning runtime on the sim scheduler (hill-climb
    # controllers over stream_depth / pipeline_split / drain chunk,
    # sim-sized evaluation windows — harness builds the TuningConfig)
    tuning: bool = False
    # mid-drive workload shift: from this cycle on, arrivals draw from
    # shift_arrivals instead of arrivals (the tuner must detect the
    # regime change, unsettle, and re-converge — the tuning invariant
    # asserts both). -1 = no shift. Events stay self-contained dicts,
    # so replay is unaffected.
    shift_at: int = -1
    shift_arrivals: tuple = ()
    # -- gang scheduling (kubernetes_tpu_torch/gang) --
    # P(a cycle spawns a pod group): all members arrive the same cycle
    # carrying the pod-group label + min-member annotation, and the
    # scheduler must bind the whole gang atomically or none of it
    # (check_no_partial_gangs asserts exactly that, every cycle).
    # 0 = no gangs (all gang knobs are inert — existing profiles'
    # event streams stay byte-identical).
    gang_rate: float = 0.0
    gang_sizes: tuple[int, ...] = (2, 3)
    # spawn one NEVER-SATISFIABLE gang at this cycle: min-member is set
    # one above the members actually created, so the quorum can never
    # assemble — the gang must ride gang_incomplete rounds into a
    # whole-gang quarantine (the CI smoke pins quarantined_gangs >= 1
    # off this). -1 = never.
    gang_short_at: int = -1
    # GangConfig knobs for the sim scheduler (harness._base_config):
    # sim-sized so assembly timeouts and the quarantine ladder resolve
    # within a run's virtual timeline (production defaults are longer)
    gang_min_member_timeout: float = 3.0
    gang_quarantine_after: int = 3
    # heterogeneity-aware placement: nodes get an accelerator-class
    # label (gang_accel_classes[seq % len], seq-based like zones so
    # node identity stays RNG-free), gang members a workload-class
    # label, and the harness derives a deterministic effective-
    # throughput table over the cross product (Gavel's objective,
    # folded into the solve as a score term). () / 0 = term off.
    gang_accel_classes: tuple[str, ...] = ()
    gang_workload_classes: tuple[str, ...] = ()
    gang_throughput_weight: int = 0
    # -- flight telemetry (kubernetes_tpu_torch/obs) --
    # enable the always-on telemetry stack on the sim scheduler:
    # continuous per-stage profiler + anomaly sentinel (sim-sized
    # windows, harness._base_config builds the SentinelConfig) +
    # capture-on-anomaly replay bundles (written when the run passes a
    # bundle_dir; capture EVENTS count either way, so --selfcheck's
    # dirless re-run stays byte-identical). The SLO engine rides along
    # as the sentinel's p99 source.
    telemetry: bool = False

    def validate(self) -> None:
        if self.watch_delay and (
            self.alloc_shrink_rate > 0 or self.external_bind_rate > 0
        ):
            raise ValueError(
                f"profile {self.name}: watch_delay cannot be combined with "
                "alloc_shrink_rate/external_bind_rate (delayed delivery of "
                "capacity reductions makes transient overcommit legitimate, "
                "so the capacity invariant would be unsound — see module "
                "docstring)"
            )
        if self.fleet_drain and (
            not self.backlog
            or self.fleet_replicas < 2
            or not self.streaming
        ):
            raise ValueError(
                f"profile {self.name}: fleet_drain needs a cycle-0 "
                "backlog, fleet_replicas >= 2, and the streaming drive "
                "(the drain leases feed Scheduler.drain_backlog's "
                "chunked streaming path)"
            )
        if (self.gang_rate > 0 or self.gang_short_at >= 0) and any(
            self.pod_priorities
        ):
            raise ValueError(
                f"profile {self.name}: gang arrivals cannot be combined "
                "with non-zero pod priorities (preemption can evict a "
                "bound gang member, and the gang gate cannot count "
                "already-bound members toward a re-assembly quorum — a "
                "documented design limit, see kubernetes_tpu_torch/gang)"
            )


PROFILES: dict[str, Profile] = {
    p.name: p
    for p in (
        # the flagship: everything that can churn does, delivery is
        # delayed and duplicated (at-least-once), binds fail randomly —
        # the scenario class every advisor-found concurrency bug
        # (fence livelock, stale sessions, unlocked in-flight maps)
        # lived in. No shrinks/external binds (see module docstring).
        Profile(
            name="churn_heavy",
            arrivals=(2, 6),
            # hard-shape arrivals (spread/anti/ports) drive the
            # occupancy-carrying pipelined path and its occ fence under
            # the same delete/label churn the fit fence already faces
            pod_spread_rate=0.25,
            pod_anti_rate=0.15,
            pod_ports_rate=0.2,
            delete_pod_rate=0.8,
            node_add_rate=0.3,
            node_delete_rate=0.25,
            label_flap_rate=2.5,
            alloc_grow_rate=0.4,
            bind_fault_rate=0.15,
            watch_delay=True,
            watch_dup_rate=0.2,
        ),
        # competing actors: an external binder races the scheduler for
        # the same pods/capacity while injected bind conflicts exercise
        # the forget/requeue protocol. Prompt delivery.
        Profile(
            name="bind_storms",
            arrivals=(3, 8),
            external_bind_rate=1.5,
            bind_fault_rate=0.35,
            alloc_shrink_rate=0.2,
            delete_pod_rate=0.3,
        ),
        # topology churn: nodes come, go, shrink, grow, flap labels;
        # snapshot slot remaps and SessionDrainRequired paths dominate.
        Profile(
            name="node_flaps",
            arrivals=(1, 4),
            node_add_rate=1.0,
            node_delete_rate=0.8,
            label_flap_rate=1.5,
            alloc_grow_rate=0.5,
            alloc_shrink_rate=0.5,
        ),
        # priority inversion pressure: low-priority filler keeps nodes
        # full, high-priority arrivals must preempt their way in.
        Profile(
            name="preemption_pressure",
            nodes=4,
            arrivals=(3, 6),
            pod_cpu_choices=("2", "4"),
            pod_priorities=(0, 0, 0, 1000),
            delete_pod_rate=0.2,
        ),
        # the extender boundary under latency/timeout/5xx: ignorable=False
        # so a failed call aborts the batch (the reference's error status),
        # exercising the mid-cycle-outage requeue path every few cycles.
        Profile(
            name="extender_flaky",
            # extenders pipeline now (the verdict fold is a pre-dispatch
            # host stage), but this profile stays on the sync drive: a
            # non-ignorable extender abort mid-run_pipelined loses the
            # completed batches' results, which would silently weaken
            # the double-bind tracker's accounting (harness._drive)
            pipelined=False,
            arrivals=(2, 5),
            extender=True,
            extender_fault_rate=0.3,
            bind_fault_rate=0.1,
        ),
        # Permit-point stalls: pods park in the WaitingPods map and are
        # later allowed or timed out on the virtual clock — driven
        # through the pipelined loop (waiting settlement drains the
        # pipeline and runs a synchronous cycle per tick).
        Profile(
            name="permit_stalls",
            arrivals=(2, 5),
            permit=True,
            permit_stall_rate=0.5,
            permit_timeout=5.0,
            delete_pod_rate=0.2,
        ),
        # solver-boundary chaos: every device-tier solve dispatch fails
        # during the fault window (a dead accelerator runtime), then
        # heals. The scheduler must trip the breaker, keep binding at a
        # degraded ladder tier (ultimately the pure-host greedy), and
        # probe back to the top tier once the window passes — asserted
        # by the resilience invariant (breaker re-closed, zero pods
        # lost). Window [2, 5): cycles advance the clock 1s each, so
        # cycles at t=2..4 fault and the later cycles' arrivals drive
        # the re-close probes with real work.
        Profile(
            name="solver_flaky",
            arrivals=(2, 6),
            delete_pod_rate=0.3,
            solver_fault_rate=1.0,
            solver_fault_window=(2.0, 5.0),
        ),
        # poison pods: a fraction of arrivals carry data that breaks
        # tensorize/solve at EVERY ladder tier. The bisection must
        # isolate exactly the poison pods into terminal quarantine
        # (TTL'd re-admit) while the rest of each batch proceeds —
        # including hard shapes riding the CARRY-mode chain. The
        # breaker trips en route (descend-before-bisect) and re-closes
        # once the poison is out of the batch stream.
        Profile(
            name="poison_pods",
            arrivals=(2, 6),
            pod_spread_rate=0.2,
            pod_ports_rate=0.15,
            poison_rate=0.12,
            delete_pod_rate=0.2,
        ),
        # fleet mode: two active replicas sharding one cluster through
        # the watch bus, with a hard-shape mix that exercises the
        # cross-shard occupancy exchange (spread skew is global) and
        # the handoff protocol. Node churn stays off so the ownership
        # half of the no-global-overcommit invariant is exact; pod
        # deletes churn occupancy rows. Also drivable single-scheduler
        # (the fleet≡single binding-equivalence test leans on the
        # event stream being identical either way: no external binds,
        # no shrinks).
        Profile(
            name="fleet_mixed",
            nodes=9,
            zones=3,
            arrivals=(2, 5),
            pod_spread_rate=0.3,
            pod_anti_rate=0.15,
            pod_ports_rate=0.15,
            delete_pod_rate=0.4,
            fleet_replicas=2,
        ),
        # fleet_handoff: the handoff-FORCING fleet shape (the obs
        # cross-replica explain smoke leans on it). Two replicas shard
        # two zones; a heavy hard-zone-spread cohort means pods routed
        # to the replica whose zone is already at the global max skew
        # get reconcile-rejected twice and release through the
        # exchange's handoff rows to the peer — whose journal then
        # continues the pod's journey trace. No delete churn: a
        # handed-off pod's history must survive to the end of the run
        # so `obs explain --fleet` can render the full
        # enqueue→handoff→re-admit→bind chain.
        Profile(
            name="fleet_handoff",
            nodes=6,
            zones=2,
            arrivals=(3, 6),
            pod_spread_rate=0.6,
            pod_anti_rate=0.2,
            delete_pod_rate=0.0,
            fleet_replicas=2,
        ),
        # crash_restart: the scheduler process dies mid-batch — after
        # its pods are assumed and approved, before any bind commits —
        # and a FRESH incarnation is constructed on the same
        # ClusterState. Every piece of incarnation-local state (assumed
        # pods, Permit-parked waiters, the nominated index, in-flight
        # maps) evaporates; the recovery pass must rebuild from truth,
        # re-adopt every orphan (terminal `recovered` journal records),
        # and the merged cross-incarnation journal must stay complete
        # with zero double-binds. Permit stalls guarantee parked
        # waiters exist at the crash; priority arrivals drive orphaned
        # nominations; delete churn exercises orphans vanishing before
        # re-adoption.
        Profile(
            name="crash_restart",
            nodes=5,
            arrivals=(2, 6),
            pod_spread_rate=0.2,
            pod_ports_rate=0.15,
            pod_cpu_choices=("1", "2"),
            pod_priorities=(0, 0, 0, 1000),
            delete_pod_rate=0.3,
            permit=True,
            permit_stall_rate=0.4,
            permit_timeout=5.0,
            crash_at=4,
        ),
        # hub_partition: fleet_mixed plus the last replica partitioned
        # from the occupancy hub, its lease observed stale (survivors
        # revoke its commit fence AND retire its exchange state — 100%
        # of the zombie's bind attempts must reject with Conflict),
        # while the ZOMBIE's own cached peer view ages past the
        # staleness bound so its admission turns conservative for
        # cross-shard-constrained shapes (the survivors handle the
        # detected-dead peer via membership + retire, not staleness —
        # the silent-peer aging path is unit-tested in
        # tests/test_fencing.py). Heals mid-run: the zombie
        # re-acquires its fence, resyncs, republishes — the fleet must
        # settle clean.
        Profile(
            name="hub_partition",
            nodes=9,
            zones=3,
            arrivals=(3, 6),
            # enough PLAIN arrivals that the zombie's fenced bind path
            # actually fires during the window (spread/anti arrivals
            # are stale-rejected by conservative admission BEFORE the
            # bind — both paths must engage, and the invariant asserts
            # each did)
            pod_spread_rate=0.2,
            pod_anti_rate=0.1,
            pod_ports_rate=0.1,
            delete_pod_rate=0.3,
            fleet_replicas=2,
            hub_partition_at=2,
            hub_partition_heal=6,
            fleet_max_row_age_s=2.0,
        ),
        # hub_failover: the hub HA chaos profile — a 2-replica fleet
        # drives against a REPLICATED hub (primary + standby, op-log
        # replication, shared lease) through the endpoint-failover
        # client, and the primary is KILLED mid-drive. The blackout
        # window (kill → standby's lease grant) must degrade to the
        # proven conservative-admission path (stale rejections >= 1,
        # zero overcommit), the promotion must heal everything without
        # operator action (replicas re-attach via epoch-advance
        # detection + forced wholesale republish; zero rows / handoffs
        # / journal lines lost; hard-spread contention spanning the
        # epoch boundary still decides exactly one CAS winner — the
        # constraint/overcommit invariants run every cycle), a
        # deterministic reply-loss injection must prove the idempotent
        # flush dedup (dedup_hits >= 1), and the resurrected OLD
        # primary must keep serving reads while 100% of its
        # replica-facing writes reject with the typed HubDeposed.
        # Asserted by the hub_failover invariant; byte-deterministic
        # under --selfcheck like every profile.
        Profile(
            name="hub_failover",
            nodes=9,
            zones=3,
            arrivals=(3, 6),
            pod_spread_rate=0.3,
            pod_anti_rate=0.1,
            pod_ports_rate=0.1,
            delete_pod_rate=0.3,
            fleet_replicas=2,
            hub_failover_at=3,
            hub_failover_heal=8,
            # a 3s lease makes the blackout span >= 3 driven cycles:
            # enough that some cross-shard-constrained admission
            # attempt lands inside it at any seed (the invariant's
            # conservative-admission clause must engage non-vacuously)
            hub_lease_s=3.0,
            fleet_max_row_age_s=2.0,
        ),
        # fragmentation: heavy plain arrivals + heavy deletes carve the
        # cluster into Swiss cheese (every node partly used, packed
        # utilization low), and the continuous rebalancer must
        # consolidate: detect fragmentation from the snapshot, plan
        # with the pack-objective auction, evict under the churn
        # budget with nominated hints, and the migrations complete
        # through the ordinary scheduling path. A PDB-guarded cohort
        # (disruptionsAllowed=0) rides along — those pods must NEVER
        # move. The rebalance invariant asserts: evictions <= budget
        # every pass, zero PDB overruns, packed utilization
        # non-decreasing across settle-phase passes, and >= 1
        # completed migration when anything was evicted. Byte-
        # deterministic under --selfcheck like every profile.
        Profile(
            name="fragmentation",
            nodes=8,
            node_cpu="8",
            node_mem="32Gi",
            arrivals=(3, 7),
            pod_cpu_choices=("500m", "1"),
            delete_pod_rate=2.5,
            rebalance=True,
            rebalance_interval_s=4.0,
            rebalance_budget=4,
            rebalance_min_packing=0.6,
            pdb_guard_rate=0.25,
        ),
        # sustained_stream: the streaming dispatcher's high-arrival
        # profile — enough arrivals per cycle that several batches pop
        # back-to-back and the bounded work ring actually fills, with a
        # hard-shape mix (spread/anti/ports) so cross-batch occupancy
        # chaining and the drain-then-retensorize fallback both
        # engage, plus delete churn and delayed/duplicated watch
        # delivery so per-slot fence epochs discard stream slots
        # mid-ring. Byte-deterministic under --selfcheck like every
        # profile (the completion thread only warms transfers — apply
        # order stays on the scheduling thread).
        Profile(
            name="sustained_stream",
            streaming=True,
            nodes=8,
            arrivals=(6, 12),
            batch_size=6,
            pod_spread_rate=0.2,
            pod_anti_rate=0.1,
            pod_ports_rate=0.15,
            delete_pod_rate=0.4,
            bind_fault_rate=0.1,
            watch_delay=True,
            watch_dup_rate=0.1,
        ),
        # backlog_drain: a seeded mega-backlog (relative to the sim's
        # scale) with a hard-shape mix, drained at cycle 0 through
        # Scheduler.drain_backlog — the HBM-budget-planned chunked
        # streaming path — then delete churn and fresh
        # arrivals over the drained cluster. backlog_force_split makes
        # the budget planner halve the chunk at least once, so the CI
        # smoke pins the auto-split path non-vacuously; the drain's
        # chunk/split/chain counters ride the footer (byte-
        # deterministic under --selfcheck like every profile). The
        # backstop must never engage during the drain (fallbacks=0
        # pinned by the smoke).
        Profile(
            name="backlog_drain",
            streaming=True,
            nodes=10,
            zones=3,
            batch_size=16,
            group_size=8,
            backlog=96,
            backlog_chunk=16,
            backlog_force_split=True,
            arrivals=(1, 3),
            pod_spread_rate=0.25,
            pod_ports_rate=0.2,
            delete_pod_rate=0.6,
        ),
        # fleet_backlog_drain: the fleet-tier drain acceptance profile
        # (fleet/drain.py, ROADMAP #5a). A seeded backlog lands at
        # cycle 0 across a 3-replica fleet; the coordinator seam runs
        # the relax mega-plan ONCE globally on a full-view planner,
        # partitions pods by planned-node shard owner (spread pods —
        # cross-shard-constrained — fall to the serialized residual
        # cohort), and installs the lease ledger at the hub. Replicas
        # drain concurrently, one chunk per cycle, through their own
        # drain_backlog slot rings; the LAST replica is killed at
        # cycle 1 — mid-lease — so its outstanding keys must return as
        # orphans and drain at a survivor (check_fleet_drain pins
        # reassigned >= 1, zero lost, zero double-binds; the CI smoke
        # greps the fleet_drain footer line). Capacity is sized so the
        # whole backlog binds (node_cpu=16 x 12 vs ~90 requested CPU);
        # no delete churn, so "every backlog pod ends bound" is exact.
        # Byte-deterministic under --selfcheck like every profile.
        Profile(
            name="fleet_backlog_drain",
            streaming=True,
            nodes=12,
            node_cpu="16",
            # one zone ON PURPOSE: hard-spread pods still carry a
            # DoNotSchedule constraint (cross-shard -> residual cohort)
            # but stay satisfiable from ANY shard. With 3 zones the
            # ring can hand a replica zero nodes in the underfilled
            # zone; after one handoff lap such pods legally park
            # unschedulable, and the drain gate here is lost==0.
            zones=1,
            batch_size=16,
            group_size=8,
            backlog=120,
            backlog_chunk=16,
            fleet_drain=True,
            fleet_replicas=3,
            replica_loss_at=1,
            arrivals=(1, 3),
            pod_cpu_choices=("500m", "1"),
            pod_spread_rate=0.2,
        ),
        # megaplan: the convex-relaxation mega-planner acceptance
        # profile. Same seeded-backlog drive as
        # backlog_drain, but the drain warm-starts: one relaxed global
        # solve ranks the whole active queue before the first chunk
        # pops, and the harness's megaplan probe runs relax+repair vs
        # the exact anchor on the frozen cycle-0 snapshot.
        # check_megaplan asserts the relaxation actually engaged
        # (iterations + ranked pods non-zero), the relaxed-then-
        # rounded plan is valid against the snapshot (no overcommit,
        # every placement schedulable), and the probe's objective
        # ratio clears the floor vs exact. Plain fit-scoped pods only
        # (no spread/ports) so the probe compares the two engines on
        # the scope both solve; mixed priorities exercise the
        # warm-start's within-priority-band reorder contract.
        # Byte-deterministic under --selfcheck like every profile.
        Profile(
            name="megaplan",
            streaming=True,
            nodes=12,
            zones=3,
            batch_size=16,
            group_size=8,
            backlog=120,
            backlog_chunk=16,
            backlog_warm_start=True,
            arrivals=(1, 3),
            pod_priorities=(0, 3, 7),
            delete_pod_rate=0.4,
        ),
        # tuning_convergence: the auto-tuning acceptance profile — a
        # sustained streaming drive long enough for the hill-climb
        # controllers (stream_depth / pipeline_split, sim-sized
        # evaluation windows) to probe both directions and settle, then
        # a MID-DRIVE WORKLOAD SHIFT (arrivals roughly double at
        # shift_at) the tuner must detect via the CounterWindow
        # signature, unsettle on, and re-settle from. The tuning
        # invariant asserts: controllers engaged (>= 1 probe), settled
        # at quiescence, zero guardrail breaches, bounded knob moves
        # (no thrash), and the shift actually detected. Byte-
        # deterministic under --selfcheck like every profile (the
        # controllers are pure host python over the virtual clock).
        Profile(
            name="tuning_convergence",
            streaming=True,
            tuning=True,
            # capacity headroom matters: the shift detector's signature
            # is the BIND rate, which only tracks the arrival rate while
            # the cluster absorbs the load — a saturating cluster's
            # decaying bind rate would read as an endless workload
            # drift and shift-storm the controllers. Sized to absorb
            # the post-shift rate through a 30-cycle soak.
            nodes=16,
            node_cpu="32",
            node_mem="128Gi",
            batch_size=16,
            arrivals=(4, 8),
            pod_spread_rate=0.15,
            pod_ports_rate=0.1,
            delete_pod_rate=0.4,
            # late enough that the controllers have settled AND the
            # baseline signature has frozen (one full window past the
            # settle point) before the regime changes
            shift_at=12,
            shift_arrivals=(12, 18),
        ),
        # replica_loss: fleet_mixed plus one replica killed mid-drive.
        # The survivors must re-own its shard (ring orphan
        # redistribution + resync) and every pod it owned — queued,
        # in-flight, or handed off — must still reach a terminal
        # journal outcome somewhere in the fleet.
        # gang: the DL-training workload profile (gang/). Most
        # arrivals are pod groups — all members land
        # the same cycle with the pod-group label + min-member
        # annotation — and the scheduler must solve each gang as one
        # chained sub-batch and bind it atomically (all members or
        # none; check_no_partial_gangs runs every cycle). Nodes carry
        # accelerator-class labels and gangs workload classes, so the
        # heterogeneity throughput term (Gavel's objective) scores
        # non-vacuously. One never-satisfiable gang (gang_short_at)
        # must ride gang_incomplete rounds into a whole-gang
        # quarantine — the CI smoke pins partial_gangs == 0 AND
        # quarantined_gangs >= 1. Delete churn hits bound and queued
        # members alike (a queued member's deletion strands its gang
        # short → quarantine is its only exit). Priority-0 only: see
        # validate(). Two replicas make the same profile drivable
        # --fleet, where gang members route by gang id so each gang
        # assembles whole on one replica and stages through the
        # fenced CAS member-by-member.
        Profile(
            name="gang",
            nodes=8,
            zones=2,
            arrivals=(1, 3),
            gang_rate=0.7,
            gang_sizes=(2, 3),
            gang_short_at=2,
            gang_min_member_timeout=2.0,
            gang_quarantine_after=1,
            gang_accel_classes=("tpu-v5e", "tpu-v4", "gpu-a100"),
            gang_workload_classes=("transformer", "resnet"),
            gang_throughput_weight=2,
            # pod-delete churn only: it wakes parked gang members each
            # cycle (assembly-timeout rounds need re-pops) AND keeps
            # node ownership static so the profile stays fleet-drivable
            # (the no-global-overcommit invariant's ownership half is
            # exact without node churn, like fleet_mixed)
            delete_pod_rate=0.4,
            fleet_replicas=2,
        ),
        # gang_crash: the gang profile with the scheduler killed
        # mid-batch at the commit point (pods assumed + approved,
        # nothing bound). The crash seam fires BEFORE any gang bind,
        # so no gang can be half-bound by the dying incarnation, and
        # the successor's recovery pass must roll back any half-staged
        # gang rounds (_rollback_partial_gangs) before re-adopting —
        # partial_gangs must stay 0 across the incarnation boundary.
        Profile(
            name="gang_crash",
            nodes=8,
            zones=2,
            arrivals=(1, 3),
            gang_rate=0.7,
            gang_sizes=(2, 3),
            gang_short_at=2,
            gang_min_member_timeout=2.0,
            gang_quarantine_after=1,
            gang_accel_classes=("tpu-v5e", "tpu-v4", "gpu-a100"),
            gang_workload_classes=("transformer", "resnet"),
            gang_throughput_weight=2,
            delete_pod_rate=0.4,
            node_add_rate=0.2,
            crash_at=4,
        ),
        # gang_replica_loss: the gang profile driven --fleet with one
        # replica killed mid-drive. Gangs route whole (by gang id) so
        # the dead replica takes entire gangs with it — the survivor
        # re-owns them via the ring and must still land each one
        # atomically or quarantine it; no partial gang may survive
        # the failover fleet-wide.
        Profile(
            name="gang_replica_loss",
            nodes=8,
            zones=2,
            arrivals=(1, 3),
            gang_rate=0.7,
            gang_sizes=(2, 3),
            gang_short_at=2,
            gang_min_member_timeout=2.0,
            gang_quarantine_after=1,
            gang_accel_classes=("tpu-v5e", "tpu-v4", "gpu-a100"),
            gang_workload_classes=("transformer", "resnet"),
            gang_throughput_weight=2,
            delete_pod_rate=0.4,
            fleet_replicas=2,
            replica_loss_at=4,
        ),
        Profile(
            name="replica_loss",
            nodes=9,
            zones=3,
            arrivals=(2, 5),
            pod_spread_rate=0.3,
            pod_anti_rate=0.15,
            pod_ports_rate=0.15,
            delete_pod_rate=0.4,
            fleet_replicas=2,
            replica_loss_at=4,
        ),
        # anomaly_storm: the flight-telemetry acceptance profile.
        # A healthy steady-state warmup, then the
        # solver_flaky fault window [2, 5) kills every device-tier
        # solve: the breaker trips (its edge anomaly fires at the next
        # applied batch) and throughput collapses against the warmup
        # baseline (the spike rule). The sentinel must fire >= 1
        # anomaly, each firing must journal a telemetry_anomaly record
        # and capture a replay bundle, and every WRITTEN bundle must
        # re-execute offline to bit-identical assignments — the
        # telemetry invariant asserts the whole loop. Sync drive
        # (pipelined=False): sync solves dispatch unsplit with
        # allow_heal=True, so every capture is carry-clean and the
        # replay contract holds by construction. Cycles 0-1 are
        # fault-free, guaranteeing a complete capture record exists
        # before the storm. Byte-deterministic under --selfcheck like
        # every profile (capture events count without a bundle dir).
        Profile(
            name="anomaly_storm",
            pipelined=False,
            telemetry=True,
            nodes=8,
            arrivals=(4, 8),
            delete_pod_rate=0.4,
            solver_fault_rate=1.0,
            solver_fault_window=(2.0, 5.0),
        ),
    )
}

for _p in PROFILES.values():
    _p.validate()
del _p


def get_profile(name: str) -> Profile:
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown profile {name!r}; available: {', '.join(sorted(PROFILES))}"
        ) from None
