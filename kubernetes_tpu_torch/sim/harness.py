"""SimHarness: drive the REAL Scheduler through the REAL ClusterState
under generated churn and injected faults, on virtual time, checking
invariants after every drive — the regression harness the pipelined
loop's concurrency story is validated against.

One harness = one deterministic run:

    seed + profile  ──►  churn events (gen RNG)  ─┐
                    ──►  fault decisions (fault RNG, journaled)  ─┤
                                                                  ▼
    FakeClock ── ClusterState ── DelayedWatchBus ── Scheduler.run_pipelined
                     ▲                                    │ post-dispatch hook
                     └── BindTransitionTracker (ground truth watch)

Everything that could vary between runs is pinned: a single-threaded
event loop, ``FakeClock`` virtual time threaded through scheduler /
queue / cache / cluster, ``tie_break="first"`` solves, sorted iteration
in generators/checkers, and RNG streams seeded from strings (immune to
PYTHONHASHSEED). Two runs with the same seed+profile produce
byte-identical traces; ``replay`` re-executes a recorded trace's events
and fault decisions literally and diffs the final bindings against its
footer.

Copied from ``kubernetes_tpu/sim/harness.py``, on the port's
``Scheduler``. ``SimHarness``, ``run_sim`` and ``replay_trace`` take
``device`` (None = the card, raising without CUDA), which the scheduler
config carries, and so the rebalancer's plans (``fragmentation``) and the
relax planner of the megaplan probe and warm start (``megaplan``). The
fleet profiles run here on one scheduler, as in the JAX package; their
multi-replica drive is ``sim/fleet.py`` (``run_fleet_sim``, ``--fleet N``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .. import device as device_mod
from .. import metrics
from ..config.types import Extender
from ..scheduler import Scheduler, SchedulerConfig
from ..server.extender_client import ExtenderError
from ..solver.exact import ExactSolverConfig
from ..state.cluster import ClusterState
from ..utils.clock import FakeClock
from .faults import (
    BindFaultInjector,
    CrashInjector,
    DecisionJournal,
    DelayedWatchBus,
    FlakyExtenderTransport,
    SimulatedCrash,
    SolverFaultInjector,
    StallingPermitPlugin,
)
from .generators import ChurnGenerator, apply_event
from ..obs import ObsConfig
from .invariants import (
    BindTransitionTracker,
    MonotonicCounters,
    RebalanceTracker,
    Violation,
    _record,
    check_capacity,
    check_constraints,
    check_journal_completeness,
    check_lost_pods,
    check_megaplan,
    check_no_partial_gangs,
    check_rebalance,
    check_recovery,
    check_resilience,
    check_telemetry,
    check_tuning,
    merged_last_outcomes,
    packed_utilization,
)
from .profiles import PROFILES, Profile, get_profile
from .trace import TraceReader, TraceWriter


@dataclass
class SimResult:
    profile: str
    seed: int
    cycles: int
    bindings: dict[str, str]  # pod key -> node (final, bound pods only)
    unbound: list[str]  # pod keys still pending at the end
    violations: list[Violation]
    settled: bool
    summary: dict
    trace: TraceWriter
    replay_divergence: str | None = None  # replay mode only
    # per-pod decision journal (kubernetes_tpu_torch/obs), canonical JSONL:
    # same seed+profile => byte-identical lines
    journal_lines: list[str] = None
    flight_dump: str | None = None  # written on invariant violation
    # --tuning runs: the converged knobs as a standard
    # KubeSchedulerConfiguration document (tuning/profile.py)
    tuned_profile: dict | None = None

    @property
    def ok(self) -> bool:
        return (
            not self.violations
            and self.settled
            and self.replay_divergence is None
        )


# counters whose within-run deltas go into the footer summary (reading
# absolutes would leak cross-run registry state into the trace)
_DELTA_COUNTERS = {
    "discards": metrics.solves_discarded_total,
    "pipeline_fallbacks": metrics.pipeline_fallback_total,
    "preemptions": metrics.preemption_attempts_total,
    # streaming dispatcher: slots killed by per-slot fence epochs —
    # scheduling-thread logic, so same-seed runs stay byte-identical
    "stream_discards": metrics.stream_slot_discard_total,
}


def _counter_value(c) -> float:
    return c._value.get()  # the registry's internal read (metrics/prom.py)


# the profiles whose scenario is the multi-replica drive (sim/fleet.py):
# the fleet's own mixes, a replica kill, a hub partition or failover, the
# fleet drain. Named, because no field tells ``fleet_mixed`` and
# ``fleet_handoff`` from ``gang``: all three set only ``fleet_replicas``,
# and ``gang``'s scenario runs on one scheduler.
FLEET_PROFILES = frozenset({
    "fleet_mixed", "fleet_handoff", "hub_partition", "hub_failover",
    "fleet_backlog_drain", "gang_replica_loss", "replica_loss",
})


def runnable_profiles() -> tuple[str, ...]:
    """The names of the shipped profiles the port runs, in ``PROFILES``
    order: all of them (the fleet profiles on one scheduler here, and
    across replicas through ``run_fleet_sim``)."""
    return tuple(PROFILES)


# gang footer block (gang profiles): within-run deltas of the gang
# counters. Deltas of GLOBAL metrics rather than scheduler-object
# state, so the numbers survive crash_restart incarnation swaps.
_GANG_COUNTERS = {
    "gang_commits": metrics.gang_commits_total,
    "gang_bound_pods": metrics.gang_bound_pods_total,
    "gang_incomplete_rounds": metrics.gang_incomplete_total,
    "quarantined_gangs": metrics.gang_quarantined_total,
}


def _gang_throughput_table(profile: Profile) -> dict:
    """Deterministic workload-class x accelerator-class effective-
    throughput table derived from the profile's class lists alone (no
    RNG: same profile => same table => byte-identical solves). Rows are
    rotations of a fixed ladder, so every workload class prefers a
    different accelerator class — real placement pressure for the
    heterogeneity term to resolve."""
    ladder = (1.0, 0.75, 0.5, 0.25)
    return {
        wc: {
            ac: ladder[(i + j) % len(ladder)]
            for j, ac in enumerate(profile.gang_accel_classes)
        }
        for i, wc in enumerate(profile.gang_workload_classes)
    }


class SimHarness:
    def __init__(
        self,
        profile: Profile | str,
        seed: int = 0,
        cycles: int = 10,
        *,
        pipelined: bool | None = None,
        streaming: bool | None = None,
        replay: TraceReader | None = None,
        max_settle_rounds: int = 12,
        spans: bool = False,
        flight_dump: str | None = None,
        mesh_devices: int = 1,
        tuning: bool | None = None,
        bundle_dir: str | None = None,
        device=None,
    ) -> None:
        self.profile = (
            get_profile(profile) if isinstance(profile, str) else profile
        )
        self.profile.validate()
        # every solve, dry-run and bundle replay of the run: the card
        # unless the caller asks for the CPU
        self.device = device_mod.resolve(device)
        self.seed = seed
        self.cycles = cycles
        self.pipelined = (
            self.profile.pipelined if pipelined is None else pipelined
        )
        # streaming dispatcher drive (Scheduler.run_streaming): profile
        # default, overridable per run (the CI smokes re-drive the
        # chaos/crash profiles through it)
        self.streaming = (
            self.profile.streaming if streaming is None else streaming
        )
        # closed-loop auto-tuning (kubernetes_tpu_torch/tuning): profile
        # default, overridable per run (the --tuning CLI flag enables
        # the runtime on ANY profile)
        self.tuning = self.profile.tuning if tuning is None else tuning
        self.max_settle_rounds = max_settle_rounds
        self._reader = replay

        self.trace = TraceWriter()
        self.trace.header(
            seed=seed,
            profile=self.profile.name,
            cycles=cycles,
            pipelined=self.pipelined,
            streaming=self.streaming,
            tuning=self.tuning,
        )
        self.journal = DecisionJournal(
            None if replay is not None else self.trace,
            replay.decisions if replay is not None else None,
        )
        # two independent RNG streams (string-seeded: hash-seed immune):
        # churn generation consumes gen, injectors consume fault — so
        # mid-run fault draws never shift what churn a cycle produces
        self._gen_rng = random.Random(f"{seed}/gen")
        self._fault_rng = random.Random(f"{seed}/fault")

        self.clock = FakeClock()
        self.cluster = ClusterState(clock=self.clock)
        self.generator = ChurnGenerator(
            self.profile, self._gen_rng, self.cluster
        )
        for node in self.generator.seed_nodes():
            self.cluster.create_node(node)

        plugins: tuple = ()
        self.permit_plugin: StallingPermitPlugin | None = None
        if self.profile.permit:
            self.permit_plugin = StallingPermitPlugin(
                self.journal,
                self._fault_rng,
                self.profile.permit_stall_rate,
                self.profile.permit_timeout,
            )
            plugins = (self.permit_plugin,)
        extenders: tuple = ()
        if self.profile.extender:
            extenders = (
                Extender(
                    url_prefix="http://sim-extender",
                    filter_verb="filter",
                    prioritize_verb="prioritize",
                    node_cache_capable=True,
                ),
            )
        self.flight_dump_path = flight_dump
        # capture-on-anomaly replay bundles (telemetry profiles): the
        # telemetry invariant replays every bundle written here
        self.bundle_dir = bundle_dir
        # continuous rebalancer (rebalance/): the
        # fragmentation profile's defragmentation loop, plus a seeded
        # PDB-guarded cohort the rebalancer must never move
        rebalance_cfg = None
        self.rebalance_tracker: RebalanceTracker | None = None
        if self.profile.rebalance:
            from ..rebalance.runtime import RebalanceConfig

            rebalance_cfg = RebalanceConfig(
                interval_s=self.profile.rebalance_interval_s,
                max_moves_per_cycle=self.profile.rebalance_budget,
                min_packing=self.profile.rebalance_min_packing,
            )
            if self.profile.pdb_guard_rate > 0:
                from ..api.labels import (
                    Selector,
                    requirements_from_match_labels,
                )
                from ..api.objects import PodDisruptionBudget
                from .generators import PDB_GUARD_LABEL

                self.cluster.create_pdb(
                    PodDisruptionBudget(
                        name="sim-pdb-guard",
                        namespace="default",
                        selector=Selector(
                            requirements=requirements_from_match_labels(
                                {PDB_GUARD_LABEL: "1"}
                            )
                        ),
                        disruptions_allowed=0,
                    )
                )
            # constructed AFTER the PDB so its allowance mirror seeds
            # from the original budgets
            self.rebalance_tracker = RebalanceTracker(self.cluster)
        from ..resilience import ResilienceConfig

        # sim-sized tuning windows: short enough that both directions
        # of every knob are probed AND settled within a run's batch
        # budget (the production defaults evaluate over longer
        # windows). Hysteresis is WIDE (50%): on virtual time a knob
        # cannot genuinely change throughput — the measured objective
        # is pure arrival noise — so the correct converged behavior is
        # "no direction improves, stay put and settle", and a
        # production-sized 5% margin would let that noise random-walk
        # the knobs forever instead.
        tuning_cfg = None
        if self.tuning:
            from ..tuning.runtime import TuningConfig

            tuning_cfg = TuningConfig(
                eval_batches=2, settle_after=1, hysteresis=0.5,
                # the tuning_convergence shift is a 1.5x rate change;
                # 0.7 clears the within-regime arrival noise (uniform
                # bands over a 4-sample window swing ~±0.4 relative)
                # while detecting the real shift with margin
                shift_threshold=0.7, max_probes=4,
            )
        gang_cfg = None
        self._gang_profile = (
            self.profile.gang_rate > 0 or self.profile.gang_short_at >= 0
        )
        resilience_kwargs: dict = {
            "open_seconds": self.profile.resilience_open_s
        }
        if self._gang_profile:
            from ..gang import GangConfig

            gang_cfg = GangConfig(
                min_member_timeout=self.profile.gang_min_member_timeout,
                quarantine_after=self.profile.gang_quarantine_after,
                throughput_weight=self.profile.gang_throughput_weight,
                class_throughput=_gang_throughput_table(self.profile),
            )
            # park the quarantined gang PAST the settle horizon: a TTL
            # re-admit landing in the settle tail would re-park the
            # gang `gang_incomplete` (non-terminal) with no waking
            # event left to drive it back to quarantine, misreading
            # "terminally quarantined" as "dropped" in the journal-
            # completeness invariant. The re-admit cycle itself is
            # unit-tested (tests/test_gang.py), not sim-driven.
            resilience_kwargs["quarantine_ttl"] = 3600.0
        self._base_config = SchedulerConfig(
            batch_size=self.profile.batch_size,
            # short breaker fault window so probes and re-closes
            # land inside the run's virtual timeline (the
            # resilience invariant asserts the re-close)
            resilience=ResilienceConfig(**resilience_kwargs),
            # gang scheduling (gang profiles): pod groups admitted,
            # queued, and bound atomically, with the heterogeneity
            # throughput table derived deterministically from the
            # profile's class lists
            gang=gang_cfg,
            # node-axis solve mesh: results are bit-exactly device-
            # count invariant, so a mesh_devices=N run's trace and
            # journal must be byte-identical to the single-device run
            # with the same seed (the multichip CI smoke leans on
            # this). Default 1: sim runs are usually single-device.
            mesh_devices=mesh_devices,
            device=self.device,
            solver=ExactSolverConfig(
                tie_break="first", group_size=self.profile.group_size
            ),
            extenders=extenders,
            out_of_tree_plugins=plugins,
            tuning=tuning_cfg,
            rebalance=rebalance_cfg,
            # every sim scheduler binds under a fence token so a
            # crash-restarted incarnation structurally supersedes its
            # predecessor (the commit-fencing layer rides every
            # profile; it only acts when a token goes stale)
            fence_role="sim-scheduler",
            # the decision journal is always on in the sim: the
            # trace-completeness invariant and the byte-identical-
            # journal determinism contract both ride on it. Spans
            # are opt-in (they multiply recorder traffic).
            obs=self._build_obs_config(spans, flight_dump, bundle_dir),
        )
        # process lifecycle (crash_restart): incarnations share one
        # virtual timeline; a crash retires the live scheduler's
        # journal here and a fresh incarnation takes over
        self.incarnations = 1
        self._dead_journals: list[list[str]] = []
        self._orphans_at_restart = 0
        self.crash_injector: CrashInjector | None = None
        if self.profile.crash_at >= 0:
            self.crash_injector = CrashInjector()
        self.scheduler = Scheduler(
            self.cluster, self._base_config, clock=self.clock
        )
        if self.crash_injector is not None:
            self.scheduler._pre_commit_hook = self.crash_injector
        self.ext_transport: FlakyExtenderTransport | None = None
        if self.profile.extender:
            self.ext_transport = FlakyExtenderTransport(
                self.journal, self._fault_rng, self.profile.extender_fault_rate
            )
            for cl in self.scheduler.extender_clients:
                cl.transport = self.ext_transport

        # interpose the delayed bus between cluster and scheduler; the
        # ground-truth tracker subscribes directly (no delay)
        self.cluster.unsubscribe(self.scheduler._on_event)
        self.bus = DelayedWatchBus(
            self.cluster,
            self.scheduler._on_event,
            self.journal,
            self._fault_rng,
            delaying=self.profile.watch_delay,
            dup_rate=self.profile.watch_dup_rate,
        )
        self.cluster.subscribe(self.bus.ingest)
        self.scheduler._post_dispatch_hook = self._on_dispatch

        self.bind_injector = BindFaultInjector(
            self.journal, self._fault_rng, self.profile.bind_fault_rate
        )
        self.cluster.bind_fault = self.bind_injector

        # solver-boundary faults (the one boundary below schedule_batch):
        # installed on the scheduler's _solve_fault seam, called before
        # every solve attempt at every fallback-ladder tier
        self.solver_injector: SolverFaultInjector | None = None
        if self.profile.solver_fault_rate > 0 or self.profile.poison_rate > 0:
            self.solver_injector = SolverFaultInjector(
                self.journal,
                self._fault_rng,
                self.clock,
                rate=self.profile.solver_fault_rate,
                window=self.profile.solver_fault_window,
            )
            self.scheduler._solve_fault = self.solver_injector

        self.tracker = BindTransitionTracker(self.cluster)
        self.monotonic = MonotonicCounters()
        self.violations: list[Violation] = []
        # binds THIS scheduler reported (vs external churn binds): the
        # journal-completeness invariant holds exactly these to a
        # terminal 'bound' record
        self._sched_bound: set[str] = set()
        self._events_applied = 0
        self._extender_aborts = 0
        # backlog drain (backlog_drain profiles): cycle 0's
        # drain_backlog report, surfaced in the footer summary
        self._backlog_report = None
        # mega-planner probe result (megaplan profiles): relax-vs-oracle
        # A/B on the pre-drain snapshot, counts and rounded ratios only so
        # --selfcheck stays byte-identical
        self._megaplan = None
        # was the tuner settled when the profile's workload shift
        # landed? Shift detection compares against the SETTLED
        # baseline signature, so a tuner still mid-convergence at the
        # shift structurally cannot detect it — the invariant's
        # shift-detected clause is only fair when this is True
        self._tuner_settled_at_shift = False
        self._counters0 = {
            k: _counter_value(c) for k, c in _DELTA_COUNTERS.items()
        }
        self._gang_counters0 = {
            k: _counter_value(c) for k, c in _GANG_COUNTERS.items()
        }

    def _build_obs_config(
        self,
        spans: bool,
        flight_dump: str | None,
        bundle_dir: str | None,
    ) -> ObsConfig:
        """The sim's ObsConfig: journal always on; flight telemetry
        (profiler + sentinel + capture) only on ``profile.telemetry``
        profiles, with sim-sized sentinel windows so a 12-cycle run has
        enough window samples for both spike and drift rules. All
        telemetry arithmetic rides the FakeClock, so same-seed runs
        stay byte-identical through the footer summary."""
        kwargs: dict = {
            "spans": spans, "journal": True, "dump_path": flight_dump
        }
        if self.profile.telemetry:
            from ..obs import SentinelConfig
            from ..obs.slo import SloConfig

            kwargs.update(
                profile=True,
                # a sync-drive cycle applies ~1 batch, so windows close
                # every 2 batches and the spike rule (1 fast vs 3 slow,
                # single-window hysteresis) can fire within the storm's
                # 3-cycle fault window. min_events=1: sim event volumes
                # are tiny.
                sentinel=SentinelConfig(
                    window_batches=2,
                    fast_windows=1,
                    slow_windows=3,
                    spike_ratio=2.0,
                    drift_ratio=1.5,
                    hysteresis=1,
                    cooldown_windows=4,
                    min_windows=3,
                    min_events=1.0,
                    recover_windows=2,
                ),
                # the sentinel's p99 source; export_interval_s=0 keeps
                # quantiles fresh every observe on the virtual clock
                slo=SloConfig(export_interval_s=0.0),
                bundle_dir=bundle_dir,
            )
        return ObsConfig(**kwargs)

    # -- fault delivery inside the dispatch→apply window --

    def _on_dispatch(self, flight) -> None:
        """Post-dispatch hook: while a solve is in flight (the one real
        window where another actor's events race a deferred solve),
        deliver some delayed watch events — this is what makes fence
        discards, session re-uploads, and the livelock backstop
        reachable from a single-threaded simulation."""
        if not self.bus.delaying or not self.bus.pending:
            return
        pending = len(self.bus.pending)

        def draw():
            if self._fault_rng.random() < 0.2:
                return 0
            return min(pending, 1 + self._fault_rng.randrange(2))

        self.bus.pump(self.journal.decide("midpump", draw))

    # -- drive + invariants --

    def _drive(self, cycle: int) -> None:
        try:
            self._drive_once(cycle)
        except SimulatedCrash:
            # the scheduler process died mid-batch (after assume,
            # before bind): every piece of incarnation-local state —
            # assumed pods, Permit waiters, in-flight maps, deferred
            # solves — evaporates with the object, and a fresh
            # incarnation recovers from cluster truth. Batches the
            # dying drive had already completed lose their result
            # accounting (acceptable: the ground-truth tracker still
            # watches the state service directly).
            self._restart(cycle)

    def _restart(self, cycle: int) -> None:
        """Construct the successor incarnation on the same ClusterState
        and re-wire the harness seams to it. The dead incarnation's
        journal is retained — the completeness invariant merges it with
        its successors' (its dangling non-terminal histories must be
        closed by the recovery pass's terminal ``recovered``
        records)."""
        import dataclasses

        dead = self.scheduler
        self._dead_journals.append(list(dead.journal.lines))
        self.incarnations += 1
        self._orphans_at_restart = sum(
            1 for p in self.cluster.list_pods() if not p.node_name
        )
        cfg = dataclasses.replace(
            self._base_config, incarnation=self.incarnations
        )
        new = Scheduler(self.cluster, cfg, clock=self.clock)
        # mirror the init wiring: the new incarnation's watch stream
        # routes through the (shared) delivery bus, not directly
        self.cluster.unsubscribe(new._on_event)
        self.bus._deliver = new._on_event
        new._post_dispatch_hook = self._on_dispatch
        if self.crash_injector is not None:
            new._pre_commit_hook = self.crash_injector
        if self.solver_injector is not None:
            new._solve_fault = self.solver_injector
        if self.ext_transport is not None:
            for cl in new.extender_clients:
                cl.transport = self.ext_transport
        self.scheduler = new
        # bounded recovery: the fresh incarnation must account for
        # EVERY unbound pod the moment its recovery pass finishes —
        # before any drive — or the crash lost work
        check_lost_pods(
            self.cluster, new, cycle, self.violations,
            undelivered=self.bus.pending_pod_adds,
        )

    def _megaplan_probe(self) -> None:
        """Mega-planner acceptance probe (megaplan profiles):
        on the FROZEN pre-drain cycle-0 snapshot, solve the whole
        backlog with the convex relaxation (dual ascent + deterministic
        rounding + auction tail repair — the exact engine the planner
        and warm-start use) and replay the plan against the sequential
        oracle:

        - **validity** — every placed pick must be in the oracle's
          feasible set at that step (``FullOracle.validate_feasible``:
          no overcommit, every filter honored — tie-set parity is
          deliberately NOT required of a global plan);
        - **quality** — placements vs the oracle's own greedy run on
          the identical snapshot; check_megaplan asserts the ratio
          floor.

        Everything is host python over frozen arrays — counts and
        rounded ratios only ride the footer, so same-seed runs stay
        byte-identical under --selfcheck. The relax solve runs on the
        run's device."""
        import dataclasses

        from ..ops.oracle.profile import FullOracle, make_oracle_nodes
        from ..solver.relax import RelaxConfig, RelaxSolver
        from ..solver.single_shot import SingleShotConfig
        from ..tensorize.plugins import build_static_tensors
        from ..tensorize.schema import build_pod_batch

        sched = self.scheduler
        with self.cluster.lock:
            batch = sched.snapshot.update(sched.cache)
            pods = sched.queue.active_pods()
            slot_nodes = []
            for name in sched.snapshot.names:
                info = sched.cache.nodes.get(name) if name else None
                slot_nodes.append(info.node if info is not None else None)
            bound: dict[str, list] = {}
            for p in self.cluster.list_pods():
                if p.node_name:
                    bound.setdefault(p.node_name, []).append(p)
        if not pods or batch.num_nodes == 0:
            return
        # the queue's own pop order: priority bands first, FIFO within
        pods = sorted(
            pods, key=lambda p: (-p.effective_priority, p.key)
        )
        pbatch = build_pod_batch(pods, batch.vocab)
        static = build_static_tensors(
            pods, pbatch, slot_nodes, batch.padded
        )
        plan_batch = dataclasses.replace(
            batch,
            allocatable=batch.allocatable.copy(),
            used=batch.used.copy(),
            nonzero_used=batch.used[:2].copy(),
            pod_count=batch.pod_count.copy(),
        )
        solver = RelaxSolver(
            RelaxConfig(), repair=SingleShotConfig(), device=self.device
        )
        assigned = solver.solve(plan_batch, pbatch, static)
        stats = solver.last
        picks = [int(a) for a in assigned]
        # a pick into the padding region is a validity failure in its
        # own right — mask it to unplaced for the replay, count it
        oob = [
            (p.key, a)
            for p, a in zip(pods, picks)
            if a >= batch.num_nodes
        ]
        picks = [a if a < batch.num_nodes else -1 for a in picks]
        names = [
            batch.names[a] if a >= 0 else None for a in picks
        ]
        real_nodes = [nd for nd in slot_nodes if nd is not None]
        errors = [
            f"pod {k}: pick {a} is a padding slot" for k, a in oob
        ] + FullOracle(
            make_oracle_nodes(real_nodes, bound)
        ).validate_feasible(pods, picks, names=names)
        exact_assigned, _ = FullOracle(
            make_oracle_nodes(real_nodes, bound)
        ).schedule(pods)
        relax_placed = int(sum(1 for a in picks if a >= 0))
        exact_placed = int(sum(1 for a in exact_assigned if a >= 0))
        self._megaplan = {
            "pods": len(pods),
            "relax_placed": relax_placed,
            "exact_placed": exact_placed,
            "objective_ratio": round(
                relax_placed / max(exact_placed, 1), 4
            ),
            "plan_valid": not errors,
            "plan_errors": len(errors),
            "iterations": int(stats.iterations),
            "residual": round(float(stats.residual), 4),
            "repaired": int(stats.repaired_pods),
        }

    def _drive_once(self, cycle: int) -> None:
        if self.profile.backlog and cycle == 0 and self.streaming:
            # the seeded mega-backlog drains through the HBM-budget-
            # planned chunked streaming path (Scheduler.drain_backlog).
            # backlog_force_split hands the planner a budget one byte
            # below the base chunk's own estimate, so the auto-split
            # path engages deterministically (the CI smoke pins
            # budget_splits >= 1 off this)
            from ..solver import budget as hbm

            chunk = self.profile.backlog_chunk or self.profile.batch_size
            budget_bytes = 0
            if self.profile.backlog_force_split:
                shape = self.scheduler.drain_shape(chunk)
                budget_bytes = hbm.estimate(shape).per_device_bytes - 1
            if self.profile.backlog_warm_start:
                # mega-planner probe on the FROZEN pre-drain snapshot:
                # relax+repair vs the sequential oracle anchor —
                # check_megaplan asserts validity + the ratio floor
                self._megaplan_probe()
            report = self.scheduler.drain_backlog(
                chunk_pods=chunk, budget_bytes=budget_bytes,
                warm_start=self.profile.backlog_warm_start or None,
            )
            self._backlog_report = report
            for r in report.results:
                self.tracker.record_results(r.scheduled)
                self._sched_bound.update(k for k, _ in r.scheduled)
            return
        if self.streaming:
            try:
                results = self.scheduler.run_streaming(max_batches=200)
            except ExtenderError:
                self._extender_aborts += 1
                return
            for r in results:
                self.tracker.record_results(r.scheduled)
                self._sched_bound.update(k for k, _ in r.scheduled)
            return
        if self.pipelined:
            try:
                results = self.scheduler.run_pipelined(max_batches=200)
            except ExtenderError:
                # extender configs pipeline now (the verdict fold is a
                # pre-dispatch host stage), so a non-ignorable extender
                # abort can surface here; completed batches' results are
                # lost with the raise — acceptable for this corner, and
                # why the extender_flaky profile defaults to the sync
                # drive (profiles.py)
                self._extender_aborts += 1
                return
            for r in results:
                self.tracker.record_results(r.scheduled)
                self._sched_bound.update(k for k, _ in r.scheduled)
            return
        # sync mode drives batch-by-batch (observationally identical to
        # run_until_settled) so an injected non-ignorable extender abort
        # ends the DRIVE without discarding earlier batches' results —
        # losing them would silently weaken the double-bind tracker
        # (review-caught). The scheduler's unhandled-requeue path owns
        # the aborted batch's pods; the lost-pod invariant verifies it.
        for _ in range(200):
            try:
                r = self.scheduler.schedule_batch()
            except ExtenderError:
                self._extender_aborts += 1
                return  # retry next cycle / settle round
            if not r.progressed:
                return
            self.tracker.record_results(r.scheduled)
            self._sched_bound.update(k for k, _ in r.scheduled)

    def _check(self, cycle: int) -> None:
        self.tracker.drain(cycle, self.violations)
        check_capacity(self.cluster, cycle, self.violations)
        check_constraints(self.cluster, cycle, self.violations)
        # every cycle, every profile: a no-op without gang labels, and
        # the gang tentpole's core contract when they exist
        check_no_partial_gangs(self.cluster, cycle, self.violations)
        check_lost_pods(
            self.cluster,
            self.scheduler,
            cycle,
            self.violations,
            undelivered=self.bus.pending_pod_adds,
        )
        self.monotonic.observe(cycle, self.violations)

    def _settled(self) -> bool:
        if self.scheduler._waiting or self.scheduler._in_flight:
            return False
        live = set(self.scheduler.queue.entries().values())
        return not (live & {"active", "backoff"})

    # -- the run --

    def run(self) -> SimResult:
        replaying = self._reader is not None
        for cycle in range(self.cycles):
            metrics.sim_cycles_total.inc()
            if replaying:
                events = [
                    {k: v for k, v in rec.items() if k not in ("k", "c")}
                    for rec in self._reader.events_by_cycle.get(cycle, [])
                ]
            else:
                events = self.generator.generate(cycle)
            self.bind_injector.suspended = True
            try:
                for ev in events:
                    if not replaying:
                        self.trace.event(cycle, **ev)
                    apply_event(self.cluster, ev)
                    self._events_applied += 1
            finally:
                self.bind_injector.suspended = False
            self.clock.advance(1.0)
            if self.bus.delaying and self.bus.pending:
                pending = len(self.bus.pending)
                self.bus.pump(
                    self.journal.decide(
                        "prepump",
                        lambda: self._fault_rng.randint(0, pending),
                    )
                )
            if (
                cycle == self.profile.shift_at
                and self.scheduler.tuner is not None
            ):
                self._tuner_settled_at_shift = (
                    self.scheduler.tuner.settled()
                )
            if (
                self.crash_injector is not None
                and cycle == self.profile.crash_at
            ):
                # kill the scheduler at this cycle's first commit
                # point: pods assumed + approved, nothing bound
                self.crash_injector.arm()
            self._drive(cycle)
            self._permit_verdicts()
            self._check(cycle)

        settled = self._quiesce()
        if not settled:
            _record(
                self.violations, "progress", self.cycles + self.max_settle_rounds,
                "scheduler failed to quiesce after churn stopped "
                f"({self.max_settle_rounds} settle rounds): "
                f"queue={self.scheduler.queue.pending_counts()} "
                f"waiting={len(self.scheduler._waiting)}",
            )
        return self._finish(settled)

    def _permit_verdicts(self) -> None:
        """Allow or abandon (→ virtual-clock timeout) parked WaitingPods,
        one journaled decision each."""
        if self.permit_plugin is None:
            return
        waiting = self.scheduler.waiting_pods()
        for key in sorted(waiting):
            wp = waiting[key]
            allow = self.journal.decide(
                "permit_verdict",
                lambda: int(self._fault_rng.random() < 0.5),
            )
            if allow:
                wp.allow(self.permit_plugin.name())
            # else: left to expire; the settle loop's clock advances
            # cross the deadline and the next cycle rejects + requeues

    def _quiesce(self) -> bool:
        """Churn has stopped: stop injecting, deliver every held event,
        and drain on an advancing virtual clock — through the backoff
        horizon and (once) the 5-minute unschedulable leftover flush —
        until the scheduler goes quiet."""
        self.bind_injector.settling = True
        if self.ext_transport is not None:
            self.ext_transport.settling = True
        if self.permit_plugin is not None:
            self.permit_plugin.settling = True
        if self.solver_injector is not None:
            # device-fault injection stops (transient outages end);
            # poison pods keep failing — they are data, not weather,
            # and must stay terminally quarantined through settle
            self.solver_injector.settling = True
        if self.scheduler.tuner is not None:
            # the draining tail is teardown, not a workload: freeze the
            # tuner so quiescence (batch sizes collapsing to the
            # leftovers) cannot read as a workload shift and unsettle
            # controllers with nothing left to re-converge on. The
            # tuning invariant therefore asserts the state AT churn
            # end: engaged, settled, shift-detected, zero breaches.
            self.scheduler.tuner.frozen = True
        self.bus.pump_all()
        # 11s rounds clear max backoff (10s) and permit timeouts; the
        # 301s round forces the unschedulable-leftover flush. The flush
        # round is MANDATORY before declaring quiescence: pods parked
        # unschedulable by injected faults (extender outages, bind
        # conflicts) see no waking cluster event once churn stops — the
        # 5-minute flush is the only path back, and skipping it would
        # misread "parked by a fault" as "settled" (sim-caught).
        advances = [11.0, 11.0, 301.0] + [11.0] * max(
            self.max_settle_rounds - 3, 0
        )
        flush_round = 2
        for i, adv in enumerate(advances):
            cycle = self.cycles + i
            self.clock.advance(adv)
            self._drive(cycle)
            self._permit_verdicts()
            self._check(cycle)
            if i >= flush_round and self._settled():
                return True
        return False

    def _finish(self, settled: bool) -> SimResult:
        # trace completeness (the obs tentpole's sim contract): every
        # pod this scheduler owned has a journal history ending in a
        # terminal outcome — merged ACROSS incarnations when a crash
        # retired one mid-run (the recovery pass's terminal 'recovered'
        # records must close every history the crash left dangling)
        journal = self.scheduler.journal
        journal_sets = self._dead_journals + [list(journal.lines)]
        check_journal_completeness(
            self.cluster,
            self.scheduler,
            self.cycles + self.max_settle_rounds,
            self.violations,
            merged_last_outcomes(journal_sets),
            self._sched_bound,
            undelivered=self.bus.pending_pod_adds(),
        )
        import json as _json

        recovered_records = sum(
            1
            for lines in journal_sets
            for line in lines
            if _json.loads(line)["outcome"] == "recovered"
        )
        if self.profile.crash_at >= 0:
            check_recovery(
                self.cycles + self.max_settle_rounds,
                self.violations,
                crash_expected=True,
                crashes=(
                    self.crash_injector.crashes
                    if self.crash_injector is not None
                    else 0
                ),
                incarnations=self.incarnations,
                orphans_at_restart=self._orphans_at_restart,
                recovered_records=recovered_records,
            )
        if self.solver_injector is not None:
            # solver-boundary chaos acceptance: fallback engaged,
            # breaker back at the top tier, poison isolated
            check_resilience(
                self.scheduler,
                self.cycles + self.max_settle_rounds,
                self.violations,
                device_faults=self.solver_injector.injected,
                poison_hits=self.solver_injector.poison_hits,
            )
        rebalance_summary = None
        if self.profile.rebalance:
            reb = self.scheduler.rebalancer
            if reb is not None:
                reb.reconcile(self.cluster)
            overruns = (
                self.rebalance_tracker.pdb_overruns
                if self.rebalance_tracker is not None
                else 0
            )
            final_packing = packed_utilization(self.cluster)
            check_rebalance(
                self.cycles + self.max_settle_rounds,
                self.violations,
                history=reb.history if reb is not None else [],
                budget=self.profile.rebalance_budget,
                pdb_overruns=overruns,
                migrations_completed=(
                    reb.migrations_completed if reb is not None else 0
                ),
                # the last churn cycle drives at t == cycles; only
                # passes strictly after it are churn-free, so the
                # monotonicity window opens at cycles + 1
                churn_end_t=float(self.cycles) + 1.0,
                final_packing=final_packing,
            )
            rebalance_summary = {
                **(reb.stats() if reb is not None else {}),
                "tracker_evictions": (
                    self.rebalance_tracker.evictions
                    if self.rebalance_tracker is not None
                    else 0
                ),
                "pdb_overruns": overruns,
                "final_packing": round(final_packing, 4),
            }
        gang_summary = None
        if self._gang_profile:
            from ..gang import GangTracker

            gang_bound: set[str] = set()
            gang_unbound: set[str] = set()
            for p in self.cluster.list_pods():
                gid = GangTracker.gang_of(p)
                if gid is not None:
                    (gang_bound if p.node_name else gang_unbound).add(gid)
            gang_summary = {
                # the headline number the CI smoke pins to 0: gangs
                # with both bound and unbound live members at the end
                "partial_gangs": len(gang_bound & gang_unbound),
                **{
                    k: int(_counter_value(c) - self._gang_counters0[k])
                    for k, c in _GANG_COUNTERS.items()
                },
            }
        tuning_summary = None
        tuned_doc = None
        if self.tuning and self.scheduler.tuner is not None:
            # all python-side counters over the virtual clock, so
            # same-seed runs stay byte-identical through the footer
            tuning_summary = self.scheduler.tuner.summary()
            from ..tuning.profile import tuned_profile

            tuned_doc = tuned_profile(self.scheduler)
            check_tuning(
                self.cycles + self.max_settle_rounds,
                self.violations,
                summary=tuning_summary,
                # only fair when the tuner had SETTLED before the
                # shift: detection compares against the settled
                # baseline, which a still-converging tuner doesn't
                # have yet
                expect_shift=self.profile.shift_at >= 0
                and self._tuner_settled_at_shift,
            )
        telemetry_summary = None
        if self.profile.telemetry and self.scheduler.telemetry is not None:
            tel = self.scheduler.telemetry
            bsnap = (
                tel.bundles.snapshot() if tel.bundles is not None else {}
            )
            # counts only — no paths, no wall timings — so the
            # --selfcheck re-run (which omits the bundle directory)
            # produces a byte-identical footer
            telemetry_summary = {
                "anomalies": len(tel.anomalies),
                "anomaly_signals": sorted(
                    {a.signal for a in tel.anomalies}
                ),
                "bundles_captured": int(bsnap.get("captures", 0)),
                "bundle_triggers": {
                    k: bsnap["by_trigger"][k]
                    for k in sorted(bsnap.get("by_trigger", {}))
                },
            }
            check_telemetry(
                self.cycles + self.max_settle_rounds,
                self.violations,
                summary=telemetry_summary,
                bundle_dir=self.bundle_dir,
                device=self.device,
            )
        megaplan_summary = None
        if self.profile.backlog_warm_start:
            # merge the pre-drain probe with the drain report's
            # warm-start counters (ranked pods, relax iterations) —
            # check_megaplan needs both sides to call the feature
            # engaged non-vacuously
            rep = self._backlog_report
            megaplan_summary = dict(self._megaplan or {})
            megaplan_summary["ranked"] = (
                rep.warm_start_ranked if rep is not None else 0
            )
            if not megaplan_summary.get("iterations"):
                megaplan_summary["iterations"] = (
                    rep.relax_iterations if rep is not None else 0
                )
            check_megaplan(
                self.cycles + self.max_settle_rounds,
                self.violations,
                summary=megaplan_summary if self._megaplan else None,
            )
        bindings = {
            p.key: p.node_name
            for p in sorted(self.cluster.list_pods(), key=lambda q: q.key)
            if p.node_name
        }
        unbound = sorted(
            p.key for p in self.cluster.list_pods() if not p.node_name
        )
        deltas = {
            k: _counter_value(c) - self._counters0[k]
            for k, c in _DELTA_COUNTERS.items()
        }
        import hashlib

        all_lines = [line for lines in journal_sets for line in lines]
        journal_digest = hashlib.sha256(
            ("\n".join(all_lines) + "\n").encode()
        ).hexdigest()
        summary = {
            "pipelined": self.pipelined,
            "streaming": self.streaming,
            "events": self._events_applied,
            "bound": len(bindings),
            "unbound": len(unbound),
            "settled": settled,
            "violations": len(self.violations),
            "bind_faults": self.bind_injector.injected,
            "watch_delivered": self.bus.delivered,
            "watch_duplicated": self.bus.duplicated,
            "extender_aborts": self._extender_aborts,
            "permit_stalls": (
                self.permit_plugin.stalls if self.permit_plugin else 0
            ),
            "solver_faults": (
                self.solver_injector.injected
                if self.solver_injector
                else 0
            ),
            "poison_hits": (
                self.solver_injector.poison_hits
                if self.solver_injector
                else 0
            ),
            # breaker-state footer (the resilience invariant's
            # assertion target): ladder, trips/recloses/probes, and
            # the current tier per profile — all python-side counters,
            # so same-seed runs stay byte-identical
            "resilience": self.scheduler.resilience.summary(),
            "quarantined": sorted(
                self.scheduler._quarantine_counts
            ),
            # process lifecycle (crash_restart): incarnations that ran,
            # crashes injected, terminal 'recovered' records the fresh
            # incarnation journaled for crash-orphaned pods
            "incarnations": self.incarnations,
            "crashes": (
                self.crash_injector.crashes
                if self.crash_injector is not None
                else 0
            ),
            "recovered_records": recovered_records,
            # continuous rebalancer (the fragmentation profile): pass
            # history, eviction counts from the independent tracker,
            # PDB overruns (must be 0), final packed utilization
            "rebalance": rebalance_summary,
            # closed-loop auto-tuning (tuning_convergence / --tuning):
            # probes/moves/settled/shifts/guardrail counters + final
            # knob values — the tuning invariant's assertion target
            "tuning": tuning_summary,
            # gang scheduling (gang profiles): partial_gangs must be 0
            # (the atomic-commit contract) and quarantined_gangs >= 1
            # when the profile seeds a never-satisfiable gang — both
            # pinned by the CI gang smoke
            "gang": gang_summary,
            # flight telemetry (telemetry profiles): anomaly + capture
            # counts — the telemetry invariant's assertion target; the
            # CI telemetry smoke greps these off the footer line
            "telemetry": telemetry_summary,
            # backlog drain (backlog_drain profiles): counts only —
            # all from the scheduling thread, deterministic: same-seed runs
            # stay byte-identical (wall timings deliberately excluded)
            "backlog": (
                {
                    "pods": self._backlog_report.pods,
                    "drained": self._backlog_report.drained,
                    "chunks": self._backlog_report.chunks,
                    "chunk_pods": self._backlog_report.chunk_pods,
                    "budget_splits": self._backlog_report.budget_splits,
                    "stream_chained": (
                        self._backlog_report.stream_chained_batches
                    ),
                }
                if self._backlog_report is not None
                else None
            ),
            # convex-relaxation mega-planner (megaplan profiles): the
            # pre-drain probe's validity/ratio verdict + warm-start
            # counters — check_megaplan's assertion target; counts and
            # rounded ratios only (byte-identical under --selfcheck)
            "megaplan": megaplan_summary,
            # the journal digest rides in the footer, so the trace
            # selfcheck also proves journal byte-identity across runs
            # (all incarnations' lines, in incarnation order)
            "journal_records": len(all_lines),
            "journal_digest": journal_digest,
            **deltas,
        }
        self.trace.footer(
            bindings=bindings,
            unbound=unbound,
            violations=[v.as_dict() for v in self.violations],
            summary=summary,
        )
        divergence = None
        if self._reader is not None:
            divergence = self._diff_replay(bindings)
        flight_dump = None
        if self.violations and self.scheduler.flight is not None:
            # the invariant trigger: dump the recent-history ring next
            # to the violation report (no-op without a configured path)
            flight_dump = self.scheduler.flight.dump(
                path=self.flight_dump_path, trigger="invariant"
            )
        return SimResult(
            profile=self.profile.name,
            seed=self.seed,
            cycles=self.cycles,
            bindings=bindings,
            unbound=unbound,
            violations=self.violations,
            settled=settled,
            summary=summary,
            trace=self.trace,
            replay_divergence=divergence,
            journal_lines=all_lines,
            flight_dump=flight_dump,
            tuned_profile=tuned_doc,
        )

    def _diff_replay(self, bindings: dict[str, str]) -> str | None:
        footer = self._reader.footer
        if footer is None:
            return "trace has no footer (recorded run died mid-write)"
        if self.journal.leftover():
            return (
                f"{self.journal.leftover()} recorded decisions were never "
                "consumed (the replayed run took a shorter path)"
            )
        recorded = footer.get("bindings") or {}
        if recorded != bindings:
            gone = sorted(set(recorded) - set(bindings))
            new = sorted(set(bindings) - set(recorded))
            moved = sorted(
                k
                for k in set(recorded) & set(bindings)
                if recorded[k] != bindings[k]
            )
            return (
                "final bindings diverged from the recorded footer: "
                f"missing={gone[:5]} extra={new[:5]} moved={moved[:5]} "
                f"(recorded {len(recorded)} vs replayed {len(bindings)})"
            )
        return None


def run_sim(
    profile: str,
    seed: int = 0,
    cycles: int = 10,
    *,
    pipelined: bool | None = None,
    streaming: bool | None = None,
    spans: bool = False,
    flight_dump: str | None = None,
    mesh_devices: int = 1,
    tuning: bool | None = None,
    bundle_dir: str | None = None,
    device=None,
) -> SimResult:
    """One fresh seeded run (library entry; the CLI and tests use this)
    on ``device`` (None = the card)."""
    return SimHarness(
        profile, seed=seed, cycles=cycles, pipelined=pipelined,
        streaming=streaming, spans=spans, flight_dump=flight_dump,
        mesh_devices=mesh_devices, tuning=tuning, bundle_dir=bundle_dir,
        device=device,
    ).run()


def replay_trace(path, device=None) -> SimResult:
    """Re-execute a recorded trace on ``device`` (None = the card):
    events and fault decisions replay literally; the result's
    ``replay_divergence`` reports any drift from the recorded footer."""
    reader = TraceReader.load(path)
    h = reader.header
    return SimHarness(
        h["profile"],
        seed=int(h["seed"]),
        cycles=int(h["cycles"]),
        pipelined=bool(h["pipelined"]),
        streaming=bool(h.get("streaming", False)),
        tuning=bool(h.get("tuning", False)),
        replay=reader,
        device=device,
    ).run()
