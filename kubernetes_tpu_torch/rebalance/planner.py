"""Rebalance planning: auction target assignment + bounded move diff.

``plan_moves`` runs the single-shot auction (solver/single_shot.py)
with the ``pack`` objective over the current cluster: the candidate
pods — the movable residents of the emptiest in-use nodes, chosen by
the runtime up to the churn budget — re-bid against the cluster's LIVE
load with their source nodes masked out of the plan. Planning against
live load is what makes packing work: the fullest nodes carry the
highest pack scores, so the narrow-window auction consolidates onto
them. (Re-placing *everything* from a zeroed cluster was tried first
and scatters — with every node empty the pack objective has no
gradient and round 1 admits the whole population anywhere.) The target
assignment is then diffed against the actual placement (source-masked,
so every planned pod diffs) and ``select_moves`` bounds the raw diff
into an executable migration plan:

- **churn budget** — at most ``budget`` moves per cycle;
- **priority order** — least-important pods first (the inverse of
  ``MoreImportantPod``), best packing gain first within a priority;
- **strict improvement** — a move is kept only when the target node's
  dominant-resource fill (current truth) strictly exceeds the source's
  fill without the pod, by at least ``min_gain`` points: pods the plan
  cannot strictly improve are never touched, and each executed move
  strictly increases the cluster's packing potential, so repeated
  cycles terminate instead of thrashing;
- **joint feasibility** — moves are admitted against a working copy of
  the CURRENT free capacity (not the plan's hypothetical one), so every
  selected move is immediately executable no matter how few of the
  plan's other moves run this cycle;
- **PDB gate** — the selected stream passes through
  ``classify_pdb_violations`` (ops/oracle/preemption.py) in selection
  order, decrementing allowances per candidate exactly like
  ``filterPodsWithPDBViolation``; violating pods drop out (counted, not
  backfilled — their budget slot retries next cycle).

Copied from ``kubernetes_tpu/rebalance/planner.py``; ``plan_moves`` takes
``device`` (None = the card) for the plan solve.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..api.objects import Pod
from ..ops.oracle.preemption import classify_pdb_violations
from ..solver.relax import RelaxConfig, RelaxSolver
from ..solver.single_shot import SingleShotConfig, SingleShotSolver
from ..tensorize.plugins import build_static_tensors, trivial_static_tensors
from ..tensorize.schema import NodeBatch, build_pod_batch
from .detector import packing_score


@dataclass(frozen=True)
class Move:
    pod: Pod
    source: str  # node name the pod is evicted from
    target: str  # node name the auction placed it on (nominated hint)
    source_slot: int
    target_slot: int
    gain: int  # packing-score improvement, percent points


@dataclass
class RebalancePlan:
    moves: list[Move] = field(default_factory=list)
    planned: int = 0  # raw target-vs-actual diff size before bounding
    pdb_blocked: int = 0  # selected moves dropped by the PDB gate


# the planner's auction posture: pack objective (fullest feasible nodes
# first) with a NARROW bid window — the round-robin fan-out spreads a
# class across its whole window, so a wide window would scatter instead
# of consolidate; 8 fullest nodes per round measured a good balance of
# rounds vs packing on the bench shapes
PLAN_TOP_T = 8


def plan_auction_config(base: SingleShotConfig | None = None) -> SingleShotConfig:
    base = base or SingleShotConfig()
    return SingleShotConfig(
        max_rounds=base.max_rounds,
        price_step=base.price_step,
        top_t=PLAN_TOP_T,
        # NO repair phase: full-width repair fans the unplaced tail out
        # across every feasible node — the wide-window scatter the
        # narrow top_t above exists to avoid. Work conservation is a
        # serving-solve property; for the consolidation plan an
        # unplaced candidate simply isn't moved this cycle.
        repair_rounds=0,
        objective="pack",
    )


# engine routing: below this pods x padded-nodes product the auction's
# sequential rounds are cheap and its narrow-window consolidation is
# the better plan; above it the relaxation's matmul iterations are
# expected to win the wall-clock race (the JAX package's threshold, kept
# so both packages route alike; PERF.md records the port's times)
RELAX_PLAN_CELLS = 1 << 24


def plan_engine(n_pods: int, n_nodes_padded: int, engine: str = "auto") -> str:
    """Resolve the planning engine for a shape: ``"auction"`` or
    ``"relax"`` force it; ``"auto"`` routes by the pods x nodes cell
    count — the quantity both engines' dominant terms scale with."""
    if engine in ("auction", "relax"):
        return engine
    if engine != "auto":
        raise ValueError(f"unknown plan engine: {engine!r}")
    return (
        "relax"
        if n_pods * n_nodes_padded >= RELAX_PLAN_CELLS
        else "auction"
    )


def plan_moves(
    batch: NodeBatch,
    movable: list[tuple[Pod, int]],
    fixed_used: np.ndarray,
    fixed_cnt: np.ndarray,
    drain_slots: frozenset[int] = frozenset(),
    *,
    slot_nodes=None,
    auction: SingleShotConfig | None = None,
    engine: str = "auto",
    relax: RelaxConfig | None = None,
    device=None,
) -> list[tuple[Pod, int, int]]:
    """Target assignment for the candidate pods: the auction re-places
    them against the cluster's live load minus their own usage
    (``fixed_used``/``fixed_cnt``), with the drain-source slots masked
    unschedulable so the plan pushes OFF them. Returns the raw diff
    [(pod, source_slot, target_slot)] — pods the auction left unplaced
    (nowhere strictly feasible) are absent and never touched. ``batch``
    is read-only here; the auction runs against a copy.

    ``slot_nodes`` (Node-or-None per snapshot slot): when given, the
    production static plugin builder folds nodeSelector / node
    affinity / taints / nodeName into per-class masks, so a
    constrained pod is only ever planned toward a node it can actually
    run on — an infeasible target would otherwise evict the pod just
    for the real solve to bounce it back, a perpetual churn loop the
    strict-gain selection alone cannot prevent (the gain math is
    packing-only). Without ``slot_nodes`` (synthetic tensor callers,
    e.g. the bench) the mask degrades to schedulable-only.

    ``engine``: ``"auction"`` (the narrow-window pack auction),
    ``"relax"`` (the convex-relaxation mega-planner, solver/relax.py —
    relaxed solve, deterministic rounding, auction tail repair at the
    plan posture), or ``"auto"`` (route by shape via ``plan_engine``;
    churn-budget-sized candidate lists stay on the auction).

    ``device``: where the plan solve runs (None = the card, raising
    without CUDA; ``"cpu"`` runs on the CPU)."""
    if not movable:
        return []
    import dataclasses

    # the candidates are still BOUND while we plan (eviction comes
    # after bounding): strip the placement fields, or the static
    # builder's nodeName fold would pin every pod's class mask to its
    # current node and the plan could never move anything
    pods = [
        dataclasses.replace(p, node_name="", nominated_node_name="")
        for p, _ in movable
    ]
    pbatch = build_pod_batch(pods, batch.vocab)
    schedulable = batch.schedulable.copy()
    for slot in drain_slots:
        schedulable[slot] = False
    plan_nodes = NodeBatch(
        vocab=batch.vocab,
        names=list(batch.names),
        num_nodes=batch.num_nodes,
        padded=batch.padded,
        allocatable=batch.allocatable.copy(),
        used=fixed_used.copy(),
        nonzero_used=fixed_used[:2].copy(),
        pod_count=fixed_cnt.copy(),
        max_pods=batch.max_pods.copy(),
        valid=batch.valid.copy(),
        schedulable=schedulable,
    )
    if slot_nodes is not None:
        static = build_static_tensors(
            pods, pbatch, slot_nodes, batch.padded
        )
        live = (batch.valid & schedulable)[: batch.padded]
        static.mask &= live[None, :]
    else:
        static = trivial_static_tensors(
            pbatch, batch.padded, batch.valid & schedulable
        )
    chosen = plan_engine(len(pods), batch.padded, engine)
    if chosen == "relax":
        # mega-plan posture: pack-objective relaxation, then the SAME
        # plan auction config repairs the integrality tail (narrow
        # window, no repair phase) so the end state keeps the
        # consolidation bias and the auction's feasibility guarantees
        cfg = relax or RelaxConfig()
        if cfg.objective != "pack":
            cfg = dataclasses.replace(cfg, objective="pack")
        assigned = RelaxSolver(
            cfg, repair=plan_auction_config(auction), device=device
        ).solve(plan_nodes, pbatch, static)
    else:
        assigned = SingleShotSolver(
            plan_auction_config(auction), device=device
        ).solve(plan_nodes, pbatch, static)
    out: list[tuple[Pod, int, int]] = []
    for i, (pod, src) in enumerate(movable):
        dst = int(assigned[i])
        if dst >= 0 and dst != src:
            out.append((pod, src, dst))
    return out


def select_moves(
    batch: NodeBatch,
    slot_names: list[str],
    raw: list[tuple[Pod, int, int]],
    pdbs: list,
    *,
    budget: int,
    min_gain: int = 1,
) -> RebalancePlan:
    """Bound a raw diff into the executable plan (see module doc)."""
    plan = RebalancePlan(planned=len(raw))
    if not raw or budget <= 0:
        return plan
    vocab = batch.vocab
    gains: list[int] = []
    reqs: list[np.ndarray] = []
    for pod, src, dst in raw:
        req = np.asarray(
            vocab.vectorize(pod.resource_request()), dtype=np.int64
        )
        reqs.append(req)
        gains.append(
            packing_score(batch, dst)
            - packing_score(batch, src, extra_used=-req)
        )
    # least-important first, best gain first within a priority class
    # (gain BEFORE recency — start_time is near-unique, so it would
    # otherwise decide everything and budget bounding could keep a
    # gain-1 move while dropping a gain-40 one), newest-started then
    # pod key as the deterministic tiebreaks
    order = sorted(
        range(len(raw)),
        key=lambda i: (
            raw[i][0].effective_priority,
            -gains[i],
            -raw[i][0].start_time,
            raw[i][0].key,
        ),
    )
    free = (batch.allocatable - batch.used).copy()
    cnt = batch.pod_count.copy().astype(np.int64)
    selected: list[tuple[Pod, int, int, int]] = []
    for i in order:
        if len(selected) >= budget:
            break
        pod, src, dst = raw[i]
        if gains[i] < min_gain:
            continue
        req = reqs[i]
        if np.any(req > free[:, dst]):
            continue  # not executable against current truth
        if cnt[dst] + 1 > int(batch.max_pods[dst]):
            continue
        free[:, dst] -= req
        cnt[dst] += 1
        free[:, src] += req
        cnt[src] -= 1
        selected.append((pod, src, dst, gains[i]))
    violating, safe = classify_pdb_violations(
        [s[0] for s in selected], pdbs
    )
    plan.pdb_blocked = len(violating)
    safe_keys = {p.key for p in safe}
    plan.moves = [
        Move(
            pod=pod,
            source=slot_names[src],
            target=slot_names[dst],
            source_slot=src,
            target_slot=dst,
            gain=gain,
        )
        for pod, src, dst, gain in selected
        if pod.key in safe_keys
    ]
    return plan
