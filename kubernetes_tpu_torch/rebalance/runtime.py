"""The rebalancer runtime: the background defragmentation loop both
scheduler loops tick when they go idle.

One ``Rebalancer`` per Scheduler incarnation. ``maybe_run`` is called
from the scheduling loops at cycle boundaries and is a no-op unless ALL
of: the interval elapsed, the queues are idle (no active/backoff work,
no in-flight solves, no Permit waiters — rebalancing never competes
with real scheduling work), the incarnation still holds its commit
fence (a zombie rebalancer can never move anything — checked here for
cheap skip AND enforced authoritatively by the eviction subresource),
and the snapshot actually looks fragmented.

Execution is deliberately thin: the rebalancer only EVICTS (through
``ClusterState.evict`` — Conflict-on-stale, PDB-enforcing, fenced) with
a nominated-node hint toward the auction's target; the evicted pod
re-enters the ordinary scheduling queue and the existing solve/assume/
bind path performs the migration with every constraint and safety check
it always applies. A migration the hint can't satisfy (capacity raced
away, constraints) lands wherever the solver places it — strictly no
new commit path.

Fleet scope: a replica's cache IS its shard (shard-filtered informer),
so the snapshot, the movable set, and therefore every eviction are
naturally scoped to nodes this replica owns.

Copied from ``kubernetes_tpu/rebalance/runtime.py``; the plan solve runs
on the scheduler's device (``Scheduler.device``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .. import metrics
from ..state.cluster import ApiError
from .detector import detect
from .planner import plan_moves, select_moves


@dataclass(frozen=True)
class RebalanceConfig:
    # seconds between rebalance passes (checked on the scheduler clock,
    # so sim runs pace on virtual time)
    interval_s: float = 60.0
    # max-churn budget: evictions per rebalance cycle
    max_moves_per_cycle: int = 512
    # dominant-resource packed-utilization threshold below which the
    # in-use nodes count as fragmented (detector.py)
    min_packing: float = 0.7
    # minimum strict packing-score improvement (percent points) a move
    # must deliver; > 0 guarantees the cycle-over-cycle potential
    # argument that keeps repeated rebalancing from thrashing
    min_gain: int = 1
    # carry the auction target as a nominated-node hint on the evicted
    # pod (the solve then prefers it); off = plain requeue
    nominate: bool = True
    # planning engine: "auction" | "relax" | "auto" (route by shape —
    # see rebalance/planner.plan_engine; churn-budget-sized candidate
    # lists stay on the auction, mega shapes take the relaxation)
    plan_engine: str = "auto"


@dataclass(frozen=True)
class RunRecord:
    """One rebalance pass, for the sim invariants and the bench."""

    t: float  # clock.now() at the pass
    packing_before: float  # detector's packed utilization at the pass
    stranded_before: float
    planned: int  # raw auction diff size
    selected: int  # after budget/gain/feasibility/PDB bounding
    evicted: int  # evictions that actually landed
    pdb_blocked: int
    plan_solve_s: float  # the auction plan wall time


class Rebalancer:
    def __init__(self, config: RebalanceConfig | None, clock) -> None:
        self.config = config or RebalanceConfig()
        self.clock = clock
        self.history: list[RunRecord] = []
        # pod key -> target node of an executed eviction whose re-bind
        # has not been observed yet; reconcile() settles them
        self.pending_migrations: dict[str, str] = {}
        self.migrations_completed = 0
        self.migrations_to_target = 0
        self._last_run = float("-inf")

    # -- bookkeeping --

    def reconcile(self, cluster) -> None:
        """Settle pending migrations against cluster truth: an evicted
        pod that re-bound completes its migration (to the nominated
        target or elsewhere — both count; the hint is advisory); a pod
        deleted while migrating just drops out."""
        if not self.pending_migrations:
            return
        for key in sorted(self.pending_migrations):
            target = self.pending_migrations[key]
            ns, name = key.split("/", 1)
            try:
                pod = cluster.get_pod(ns, name)
            except ApiError:
                del self.pending_migrations[key]
                continue
            if pod.node_name:
                del self.pending_migrations[key]
                self.migrations_completed += 1
                to_target = pod.node_name == target
                if to_target:
                    self.migrations_to_target += 1
                metrics.rebalance_migrations_total.labels(
                    "target" if to_target else "elsewhere"
                ).inc()

    def stats(self) -> dict:
        cfg = self.config
        evicted = [r.evicted for r in self.history]
        return {
            "runs": len(self.history),
            "evicted": sum(evicted),
            "max_cycle_evictions": max(evicted, default=0),
            "over_budget": sum(
                1 for e in evicted if e > cfg.max_moves_per_cycle
            ),
            "budget": cfg.max_moves_per_cycle,
            "pdb_blocked": sum(r.pdb_blocked for r in self.history),
            "migrations_completed": self.migrations_completed,
            "migrations_to_target": self.migrations_to_target,
        }

    # -- the pass --

    @staticmethod
    def _movable(scheduler, pod) -> bool:
        """A bound pod the rebalancer may migrate: owned by one of this
        scheduler's profiles, bind confirmed (not mid-assume), and
        plain-shaped — ports/spread/interpod/volume/DRA pods are out of
        the auction's scoring scope (solver/single_shot.py), so their
        placements are never judged movable. Conservative by design:
        the rebalancer only touches pods whose improvement it can
        actually compute.

        Pod-group members are co-movable-or-not: migrating one member
        alone would break the gang's co-placement, and the auction
        re-places pods individually, so gang pods are conservatively
        never movable (the whole gang moves only via eviction + a fresh
        atomic gang solve, which the rebalancer does not drive)."""
        from ..gang import GANG_LABEL

        if GANG_LABEL in pod.labels:
            return False
        if pod.scheduler_name not in scheduler.solvers:
            return False
        if scheduler.cache.is_assumed(pod.key):
            return False
        if pod.host_ports() or pod.topology_spread_constraints:
            return False
        if pod.affinity is not None and (
            pod.affinity.pod_affinity is not None
            or pod.affinity.pod_anti_affinity is not None
        ):
            return False
        if pod.pvc_names:
            return False
        if pod.resource_claim_names or pod.claim_templates_unresolved:
            return False
        return True

    def _gather(self, scheduler, batch):
        """Drain-candidate selection: walk the in-use nodes EMPTIEST
        first (lowest dominant-resource fill) and collect their movable
        pods up to the churn budget — those are the pods the auction
        re-places this cycle, and their source slots are masked out of
        the plan so consolidation pushes off them. Within a partially
        drained source the least-important pods go first. The returned
        fixed load is the cluster's live usage minus the candidates'
        own requests. Runs under the cluster lock."""
        from .detector import packing_score

        vocab = batch.vocab
        sources: list[tuple[int, str, int, list]] = []
        for name in sorted(scheduler.cache.nodes):
            info = scheduler.cache.nodes[name]
            if info.node is None or not info.pods:
                continue
            try:
                slot = scheduler.snapshot.slot_of(name)
            except KeyError:
                continue
            pods_here = [
                info.pods[key]
                for key in sorted(info.pods)
                if self._movable(scheduler, info.pods[key])
            ]
            if not pods_here:
                continue
            sources.append(
                (packing_score(batch, slot), name, slot, pods_here)
            )
        sources.sort(key=lambda s: (s[0], s[1]))  # emptiest first

        budget = self.config.max_moves_per_cycle
        packing_bar = int(self.config.min_packing * 100)
        movable: list[tuple[object, int]] = []
        drain_slots: set[int] = set()
        fixed_used = batch.used.copy()
        fixed_cnt = batch.pod_count.copy()
        # never drain the FULLEST in-use node (the plan needs at least
        # one loaded consolidation target), and never drain a node
        # already at the packing bar — it is where pods should land
        for _fill, _name, slot, pods_here in sources[:-1]:
            if len(movable) >= budget or _fill >= packing_bar:
                break
            take = sorted(
                pods_here,
                key=lambda p: (
                    p.effective_priority, -p.start_time, p.key,
                ),
            )[: budget - len(movable)]
            drain_slots.add(slot)
            for pod in take:
                movable.append((pod, slot))
                req = np.asarray(
                    vocab.vectorize(pod.resource_request()),
                    dtype=np.int64,
                )
                fixed_used[:, slot] = np.maximum(
                    fixed_used[:, slot] - req, 0
                )
                fixed_cnt[slot] = max(int(fixed_cnt[slot]) - 1, 0)
        return movable, fixed_used, fixed_cnt, frozenset(drain_slots)

    def maybe_run(self, scheduler, res) -> int:
        """One conditional rebalance pass; returns evictions executed
        (0 = nothing happened). ``res`` is the cycle's BatchResult —
        evictions land in ``res.rebalance_evictions`` so drive loops
        count the pass as forward progress."""
        cfg = self.config
        now = self.clock.now()
        if now - self._last_run < cfg.interval_s:
            return 0
        cluster = scheduler.cluster
        with cluster.lock:
            self.reconcile(cluster)
            counts = scheduler.queue.pending_counts()
            if (
                counts["active"]
                or counts["backoff"]
                or scheduler._waiting
                or scheduler._in_flight
            ):
                return 0  # real work pending; retry next idle cycle
            self._last_run = now
            if (
                scheduler._fence_role is not None
                and not cluster.fence_valid(
                    scheduler._fence_role, scheduler._fence_token
                )
            ):
                # zombie incarnation: the eviction subresource would
                # reject each move anyway — skip the whole pass
                metrics.rebalance_runs_total.labels("fenced").inc()
                scheduler._log.warning(
                    "rebalance pass skipped: commit fence for role %r "
                    "is no longer valid (zombie incarnation)",
                    scheduler._fence_role,
                    extra={"step": scheduler._trace_step},
                )
                return 0
        step = scheduler._trace_step
        with scheduler.obs.span(
            "rebalance", trace_id=step, **scheduler._span_tags
        ) as rsp:
            with cluster.lock:
                batch = scheduler.snapshot.update(scheduler.cache)
                # cheap signal FIRST: on a healthy cluster the pass
                # ends here, before the node walk / pod scans /
                # request vectorizing the gather pays — the idle tick
                # is just the snapshot refresh plus host numpy
                report = detect(batch, min_packing=cfg.min_packing)
                if not report.fragmented:
                    movable = []
                else:
                    movable, fixed_used, fixed_cnt, drain_slots = (
                        self._gather(scheduler, batch)
                    )
                    slot_names = list(scheduler.snapshot.names)
                    # Node object per snapshot slot: the plan auction
                    # folds nodeSelector/affinity/taints through the
                    # production static builder so a constrained pod
                    # is never planned toward an infeasible target
                    slot_nodes = [
                        (
                            scheduler.cache.nodes[nm].node
                            if nm in scheduler.cache.nodes
                            else None
                        )
                        if nm
                        else None
                        for nm in slot_names
                    ]
                    pdbs = cluster.list_pdbs()
                    # advisory signal: pending pods more important
                    # than the LEAST important bound pod anywhere —
                    # re-packing could seat them. One pod walk, the
                    # baseline hoisted (this runs under the lock).
                    lowest_bound = None
                    pending_prios = []
                    for p in cluster.list_pods():
                        if p.node_name:
                            if (
                                lowest_bound is None
                                or p.effective_priority < lowest_bound
                            ):
                                lowest_bound = p.effective_priority
                        else:
                            pending_prios.append(p.effective_priority)
                    inversions = (
                        sum(
                            1
                            for pr in pending_prios
                            if pr > lowest_bound
                        )
                        if lowest_bound is not None
                        else 0
                    )
                    report = replace(
                        report, priority_inversions=inversions
                    )
                    metrics.rebalance_priority_inversions.set(
                        inversions
                    )
            metrics.rebalance_packing_utilization.set(
                report.packed_utilization
            )
            metrics.rebalance_stranded_fraction.set(
                report.stranded_fraction
            )
            rsp.set(
                packing=round(report.packed_utilization, 4),
                nodes_in_use=report.nodes_in_use,
                movable=len(movable),
                inversions=report.priority_inversions,
            )
            if not report.fragmented or not movable:
                metrics.rebalance_runs_total.labels(
                    "not_fragmented"
                ).inc()
                return 0
            # the plan solve runs OUTSIDE the cluster lock (same
            # discipline as the scheduling loops: the device never
            # blocks ingest); expect_rv at evict time catches anything
            # that moved meanwhile
            t0 = self.clock.perf()
            with scheduler.obs.span(
                "rebalance_plan", trace_id=step, pods=len(movable),
            ):
                raw = plan_moves(
                    batch, movable, fixed_used, fixed_cnt,
                    drain_slots, slot_nodes=slot_nodes,
                    engine=cfg.plan_engine, device=scheduler.device,
                )
            plan_solve_s = self.clock.perf() - t0
            metrics.rebalance_plan_seconds.observe(plan_solve_s)
            plan = select_moves(
                batch, slot_names, raw, pdbs,
                budget=cfg.max_moves_per_cycle,
                min_gain=cfg.min_gain,
            )
            if plan.pdb_blocked:
                metrics.rebalance_pdb_blocked_total.inc(
                    plan.pdb_blocked
                )
            evicted = 0
            if plan.moves:
                fence = (
                    (scheduler._fence_role, scheduler._fence_token)
                    if scheduler._fence_role is not None
                    else None
                )
                with cluster.lock, scheduler.obs.span(
                    "rebalance_evict", trace_id=step,
                    moves=len(plan.moves),
                ):
                    cycle = scheduler.queue.scheduling_cycle
                    for mv in plan.moves:
                        try:
                            cluster.evict(
                                mv.pod.namespace,
                                mv.pod.name,
                                expect_rv=mv.pod.resource_version,
                                fence=fence,
                                nominated_node=(
                                    mv.target if cfg.nominate else ""
                                ),
                            )
                        except ApiError as e:
                            if e.fenced:
                                # fenced mid-pass: the incarnation just
                                # lost its lease — stop moving anything
                                scheduler._log.warning(
                                    "rebalance pass fenced mid-"
                                    "execution after %d eviction(s)",
                                    evicted,
                                    extra={"step": step},
                                )
                                break
                            continue  # raced (rv/PDB/deleted): skip
                        evicted += 1
                        metrics.rebalance_evictions_total.inc()
                        self.pending_migrations[mv.pod.key] = mv.target
                        res.rebalance_evictions.append(
                            (mv.pod.key, mv.source, mv.target)
                        )
                        if scheduler.journal is not None:
                            scheduler.journal.record(
                                step, cycle, mv.pod,
                                "evicted_for_rebalance",
                                node=mv.source,
                                nominated=mv.target,
                                reason=(
                                    "rebalance: packing gain "
                                    f"+{mv.gain} (cluster packed "
                                    f"utilization "
                                    f"{report.packed_utilization:.2f})"
                                ),
                            )
            self.history.append(
                RunRecord(
                    t=now,
                    packing_before=report.packed_utilization,
                    stranded_before=report.stranded_fraction,
                    planned=plan.planned,
                    selected=len(plan.moves),
                    evicted=evicted,
                    pdb_blocked=plan.pdb_blocked,
                    plan_solve_s=plan_solve_s,
                )
            )
            metrics.rebalance_runs_total.labels(
                "planned" if evicted else "empty_plan"
            ).inc()
            rsp.set(
                planned=plan.planned,
                selected=len(plan.moves),
                evicted=evicted,
            )
        return evicted
