"""Convex-relaxation mega-planner — fractional assignment by mirror
descent + dual ascent.

The single-shot auction prices capacity through SEQUENTIAL rounds:
top-T bids, segmented admission, price escalation on rejection. Each
round is dense, but the round chain is inherently serial and the top-T
window caps how much of the price surface one round can explore — at
1M+ pods the plan solve stops fitting a planning cycle. The CvxCluster
line of work (PAPERS.md) shows the road past it: RELAX the integral
assignment to a fractional one, solve the relaxation with first-order
iterations that are pure matmul + softmax, then round and repair the
integrality gap.

The relaxation, in request-class space (never [P, N] — the same memory
move that makes the auction fit, ``single_shot.request_classes``):

  maximize   sum_{rc,n} score[rc,n] * x[rc,n]  +  temp * H(x)
  s.t.       sum_rc x[rc,n] * req[rc,k] <= free[k,n]     (lam[k,n])
             sum_rc x[rc,n]             <= cnt_free[n]   (mu[n])
             sum_n  x[rc,n]              = mass[rc]
             x >= 0,  x[rc,n] = 0 where statically infeasible

H is the entropy regularizer that makes the primal step closed-form:
holding the duals fixed, the optimal x is a temperature-``temp``
softmax over (score - penalty) per class, scaled to the class mass —
one [RC,K]x[K,N] matmul for the penalty, one softmax. The duals then
take a projected ascent step on the normalized overcommit
(load/capacity - 1), until the residual falls to ``tol``.

Rounding is deterministic: per-class quotas (round-to-nearest of x,
clamped per node against remaining integer capacity by a loop over the
small RC axis, mass-clamped per class), then pods map to quota slots by
priority rank through one searchsorted over the flattened [RC*N] quota
prefix — higher-priority pods take the quota slots, the tail stays
unassigned. The tail then repairs through the single-shot auction, so end
states carry the auction's feasibility guarantees: the relaxation
proposes, the auction disposes.

The converged duals are exported as PRICES: ``lam[k, n]`` is the marginal
score cost of one normalized unit of resource k on node n (``mu`` the
pod-slot analog) — aggregated per node group by ``group_prices``.

Counterpart of ``kubernetes_tpu/solver/relax.py``, in torch on one
device. The iterations are float32 (a matmul, a softmax with ``exp``,
``floor(x + 0.5)``) whose summation order differs from XLA's, so the plan
agrees with the JAX package's within a tolerance, not bit for bit; the
matmuls run in full float32 (nothing here enables TF32). The rounding's
integer clamps, the ``searchsorted(right=True)`` and the int64 flat-cell
lane are exact. The dual-ascent loop reads its residual test once per
iteration.

On a mesh (``parallel/sharding.py``) the [RC, N] and [K, N] tables, the
duals and the node state are tuples of per-shard blocks; the softmax's
maximum and the residual are cross-shard maxima, its denominator a
cross-shard sum, and the rounding's per-class quota prefix along the node
axis a per-shard cumsum plus the earlier shards' totals (exact). The
denominator's float32 sum changes order with the shard count, so the
sharded plan agrees with the unsharded one within the tolerance
``tests/test_torch_relax.py`` states, not bit for bit (ROADMAP's parity
rules). The pods -> quota slots map needs the flat [RC * N] quota prefix
in class-major order: the quotas are gathered to the lead device for it
(the one named gather over nodes here).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..parallel import sharding as sh
from ..tensorize.plugins import StaticPluginTensors, trivial_static_tensors
from ..tensorize.schema import NodeBatch, PodBatch
from .single_shot import (
    SingleShotConfig,
    _blocks,
    _cumsum0,
    _join,
    _segment_sum,
    _segmented_prefix,
    _single_shot,
    headroom_score,
    request_classes,
    solve_args,
)

NEG_F = -1e30


@dataclass(frozen=True)
class RelaxConfig:
    # iteration budget for the dual-ascent loop; the residual early
    # exit means converged shapes pay only what they use
    max_iters: int = 128
    # convergence tolerance on the relative overcommit residual:
    # max over (k, n) of load/capacity - 1, clipped at 0
    tol: float = 0.01
    # softmax temperature in score points: lower = harder argmax,
    # higher = smoother mass spreading. Score range is 0..100.
    temp: float = 8.0
    # dual ascent step in score points per unit of relative overcommit
    step: float = 4.0
    # "spread" = prefer high-headroom nodes; "pack" = prefer full
    # nodes (the planner posture) — same integer base score as the
    # auction, so objectives are directly comparable
    objective: str = "spread"


def _relax(
    alloc,  # [K, N] int, or a tuple of per-shard [K, w] blocks
    used0,  # [K, N] int
    pod_count0,  # [N] int32
    max_pods,  # [N] int32
    node_valid,  # [N] bool
    static_mask,  # [C, N] bool
    rc_req,  # [RC, K] int — request per request-class
    rc_static,  # [RC] int32 — static-plugin class of the request-class
    rc_of,  # [P] int32
    priority,  # [P] int32
    pod_valid,  # [P] bool
    tol: float,
    temp: float,
    step: float,
    *,
    max_iters: int,
    pack: bool = False,
    reads: list | None = None,
):
    """Returns (assigned_to [P] int32, used, pod_count, placed_total, lam
    [K, N], mu [N], iterations, residual), the node-axis results joined on
    the lead device. The six node-resident inputs are tensors on one
    device or tuples of per-shard blocks (one mesh); the pod-axis inputs
    lie on the lead device. ``reads``, when given, gets one entry per
    device read the dual-ascent loop makes (its residual tests)."""
    alloc_b, used0_b, pc0_b, maxp_b, valid_b, smask_b = (
        _blocks(a) for a in (alloc, used0, pod_count0, max_pods, node_valid, static_mask))
    nsh = len(alloc_b)
    widths = [a.shape[1] for a in alloc_b]
    sdevs = [a.device for a in alloc_b]
    p = rc_of.shape[0]
    n = sum(widths)
    rc = rc_req.shape[0]
    dev = rc_of.device
    f32 = torch.float32
    rc_of_l = rc_of.long()

    def rep(x):
        return [x if d == x.device else x.to(d) for d in sdevs]

    def cmax(parts):
        return sh.c_max(parts)[0]

    mass = _segment_sum(pod_valid.to(f32), rc_of, rc)  # [RC] valid pods per class
    mass_b = rep(mass)
    rc_req_b = rep(rc_req)
    req_f_b = rep(rc_req.to(f32))  # [RC, K]
    rc_static_b = rep(rc_static.long())

    # capacities and the static feasibility mask, fixed across iterations
    # (the relaxation prices the SNAPSHOT, like one auction solve)
    free_i = [torch.clamp(a - u, min=0) for a, u in zip(alloc_b, used0_b)]  # [K, w] int64
    cnt_free_i = [torch.clamp((mp - pc).to(torch.int32), min=0)
                  for mp, pc in zip(maxp_b, pc0_b)]  # [w]
    free_f = [f.to(f32) for f in free_i]
    cnt_free_f = [c.to(f32) for c in cnt_free_i]

    # single-pod fit at snapshot free capacity + folded static masks: a
    # cell that cannot host even one pod of the class carries no mass
    ok = [
        torch.all(rr[:, :, None] <= fi[None, :, :], dim=1)
        & sm[rs] & nv[None, :] & (cf >= 1)[None, :]
        for rr, fi, sm, rs, nv, cf in zip(rc_req_b, free_i, smask_b, rc_static_b, valid_b,
                                          cnt_free_i)
    ]  # [RC, w]
    feas_any = sh.c_any([torch.any(o, dim=1) for o in ok])  # [RC]

    # same integer base score as the auction, so objectives compare
    score_f = [headroom_score(a, u, pack).to(f32) for a, u in zip(alloc_b, used0_b)]
    inv_free = [1.0 / torch.clamp(f, min=1.0) for f in free_f]  # [K, w]
    inv_cnt = [1.0 / torch.clamp(c, min=1.0) for c in cnt_free_f]  # [w]
    neg = [torch.full((), NEG_F, dtype=f32, device=d) for d in sdevs]
    zero = [torch.zeros((), dtype=f32, device=d) for d in sdevs]

    def primal(lam, mu):
        """Closed-form entropic primal: x = mass * softmax over the
        penalized score. Penalty = the duals paired with the NORMALIZED
        constraint coefficients req/free — one matmul."""
        logits = []
        for s in range(nsh):
            pen = req_f_b[s] @ (lam[s] * inv_free[s])  # [RC, w]
            lg = (score_f[s][None, :] - pen - (mu[s] * inv_cnt[s])[None, :]) / temp
            logits.append(torch.where(ok[s], lg, neg[s]))
        m = sh.c_max([torch.amax(lg, dim=1, keepdim=True) for lg in logits])
        z = [torch.where(ok[s], torch.exp(logits[s] - m[s]), zero[s]) for s in range(nsh)]
        denom = sh.c_sum([torch.sum(zz, dim=1, keepdim=True) for zz in z])
        return [torch.where(feas_any[s][:, None],
                            mass_b[s][:, None] * z[s] / torch.clamp(denom[s], min=1e-30),
                            zero[s]) for s in range(nsh)]

    def residual_of(x):
        over = []
        for s in range(nsh):
            load = req_f_b[s].T @ x[s]  # [K, w]
            over_res = torch.amax(torch.where(valid_b[s][None, :], load * inv_free[s] - 1.0,
                                              zero[s]))
            cnt_load = torch.sum(x[s], dim=0)
            over_cnt = torch.amax(torch.where(valid_b[s], cnt_load * inv_cnt[s] - 1.0,
                                              zero[s]))
            over.append(torch.maximum(over_res, over_cnt))
        return torch.clamp(cmax(over), min=0.0)

    k = alloc_b[0].shape[0]
    lam = [torch.zeros((k, w), dtype=f32, device=d) for w, d in zip(widths, sdevs)]
    mu = [torch.zeros(w, dtype=f32, device=d) for w, d in zip(widths, sdevs)]
    res = torch.full((), float("inf"), dtype=f32, device=dev)
    iters = 0
    # dual ascent with the residual early exit: one read per iteration
    # (the residual compares with tol in float32, as the JAX package's)
    going = max_iters > 0
    while going:
        x = primal(lam, mu)
        for s in range(nsh):
            load = req_f_b[s].T @ x[s]  # [K, w]
            cnt_load = torch.sum(x[s], dim=0)  # [w]
            # projected dual ascent on relative overcommit: prices rise
            # where the fractional plan overbooks, decay toward 0 where it
            # leaves slack — the converged lam/mu ARE the exported prices
            lam[s] = torch.clamp(lam[s] + step * (load * inv_free[s] - 1.0), min=0.0)
            mu[s] = torch.clamp(mu[s] + step * (cnt_load * inv_cnt[s] - 1.0), min=0.0)
        iters += 1
        res = residual_of(primal(lam, mu))
        going = iters < max_iters
        if going:
            # ktpu: ignore[TPU001]: the planner's convergence test, one card read per iteration, counted in reads; a card-side loop would remove it (ROADMAP speed levers)
            going = bool(res > tol)
            if reads is not None:
                reads.append(1)
    x = primal(lam, mu)

    # deterministic rounding: fractional mass -> integer per-class quotas,
    # clamped against remaining integer capacity (a loop over the small RC
    # axis — the only sequential chain, length RC not P)
    q_des = [torch.floor(xx + 0.5).to(torch.int32) for xx in x]  # [RC, w]
    mass_i = mass.to(torch.int32)
    free_c, cnt_c = list(free_i), list(cnt_free_i)
    quota_rows = [[] for _ in range(nsh)]
    for r in range(rc):
        m_rc = mass_i[r].to(torch.int64)
        qs = []
        for s in range(nsh):
            req_row = rc_req_b[s][r]  # [K]
            safe_req = torch.clamp(req_row, min=1)
            cap_k = torch.div(free_c[s], safe_req[:, None], rounding_mode="floor")  # [K, w]
            cap_k = torch.where(req_row[:, None] > 0, cap_k,
                                torch.full_like(cap_k, 1 << 31))
            # per-node admissible count for this class, bounded by the pod
            # axis (mass <= P < 2^31) so the narrowing below cannot wrap
            cap = torch.minimum(torch.amin(cap_k, dim=0), cnt_c[s].to(torch.int64))
            cap = torch.clamp(torch.clamp(cap, min=0), max=m_rc.to(cap.device)).to(torch.int32)
            qs.append(torch.where(ok[s][r], torch.minimum(q_des[s][r], cap),
                                  torch.zeros_like(cap)))
        # mass clamp: the cumulative quota along the node axis never
        # exceeds the class's pod count. The prefix accumulates in int64 —
        # N * quota passes 2^31 at mega shapes — then narrows (bounded by
        # q); across shards it is each shard's cumsum plus the earlier
        # shards' totals.
        q64 = [q.to(torch.int64) for q in qs]
        cq = [torch.cumsum(q, dim=0) for q in q64]
        before = sh.c_prefix([c[-1] for c in cq])
        for s in range(nsh):
            cqs = cq[s] + before[s][0]
            q = torch.minimum(torch.clamp(m_rc.to(cqs.device) - (cqs - q64[s]), min=0),
                              q64[s]).to(torch.int32)
            free_c[s] = free_c[s] - q.to(torch.int64)[None, :] * rc_req_b[s][r][:, None]
            cnt_c[s] = cnt_c[s] - q
            quota_rows[s].append(q)
    # [RC, N] int32, joined on the lead device (the named gather)
    quotas = _join([torch.stack(rows) if rows else torch.zeros(
        (0, w), dtype=torch.int32, device=d) for rows, w, d in zip(quota_rows, widths, sdevs)],
        dev)

    # pods -> quota slots by priority rank within their class
    inv_prio = ((1 << 31) - 1) - priority.to(torch.int64)
    key = torch.where(pod_valid, rc_of_l * (1 << 32) + inv_prio,
                      torch.full_like(inv_prio, 1 << 62))
    order = torch.argsort(key, stable=True)  # pod index is the final tiebreak
    rc_sorted = rc_of[order]
    # ranks only matter for valid pods (invalid all sort to the tail under
    # the 2^62 key and are masked out of `placed` below)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           rc_sorted[1:] != rc_sorted[:-1]])
    seg_id = _cumsum0(seg_start.to(torch.int32)) - 1
    rank_sorted = _segmented_prefix(
        torch.ones(p, dtype=torch.int32, device=dev), seg_start, seg_id, p
    ) - 1
    rank = torch.empty(p, dtype=torch.int32, device=dev)
    rank[order] = rank_sorted
    rank64 = rank.to(torch.int64)

    flat_q = quotas.reshape(-1).to(torch.int64)  # [RC * N]
    gcum = torch.cumsum(flat_q, dim=0)  # monotone quota prefix over flat cells
    gcum0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), gcum])
    # class offsets into the flat prefix: an int64 product — rc * N can pass
    # 2^31 at mega shapes (the audited relax flat-cell lane)
    cell_base = rc_of_l * n
    offs = gcum0[cell_base]
    tot = quotas.sum(dim=1, dtype=torch.int64)  # [RC] placed per class
    placed = pod_valid & (rank64 < tot[rc_of_l])
    g = torch.where(placed, offs + rank64, torch.zeros_like(offs))
    flat_cell = torch.searchsorted(gcum, g, right=True)
    # node id within the class's row: bounded by the node pad (< 2^31)
    node64 = flat_cell.to(torch.int64) - cell_base
    assigned_to = torch.where(placed, node64, torch.full_like(node64, -1)).to(torch.int32)

    req_of_pod = rc_req[rc_of_l]
    req_add = torch.where(placed[:, None], req_of_pod, torch.zeros_like(req_of_pod))
    park = torch.where(placed, assigned_to, torch.full_like(assigned_to, n))
    used0_j = _join(used0_b, dev)
    pc0_j = _join(pc0_b, dev)
    used = used0_j + _segment_sum(req_add, park, n + 1)[:n].T
    pod_count = pc0_j + _segment_sum(placed.to(torch.int32), park, n + 1)[:n]
    placed_total = placed.sum()
    return (assigned_to, used, pod_count, placed_total, _join(lam, dev), _join(mu, dev),
            iters, res)


@dataclass
class RelaxStats:
    """Host-side record of the last RelaxSolver.solve, the source for
    the ``scheduler_relax_*`` metric family and the sim footer."""

    iterations: int = 0
    residual: float = 0.0
    placed_relaxed: int = 0  # pods the rounded relaxation seated
    placed_total: int = 0  # after the auction tail repair
    repaired_pods: int = 0  # tail size handed to the auction
    repair_rounds: int = 0  # auction rounds the repair actually ran
    # per-node aggregate dual price (sum_k lam[k, n] + mu[n]), score
    # points per normalized capacity unit — 0 on uncontended nodes
    node_prices: np.ndarray | None = None


class RelaxSolver:
    """Host wrapper mirroring ``SingleShotSolver.solve``'s contract (fit +
    static mask scope, replaces nodes.used/pod_count, returns the per-pod
    assignment), with the relaxation as the engine and the auction as the
    integrality-tail repair. ``device``: where both run (None = the card,
    raising without CUDA; ``"cpu"`` runs on the CPU)."""

    def __init__(
        self,
        config: RelaxConfig | None = None,
        repair: SingleShotConfig | None = None,
        device=None,
    ):
        self.config = config or RelaxConfig()
        # the tail repair runs the auction at the same objective; None
        # disables (planning callers that simply drop the unplaced tail
        # pass repair=None and keep the narrow plan)
        self.repair = repair
        self.device = device_mod.resolve(device)
        self.last = RelaxStats()

    def solve(
        self,
        nodes: NodeBatch,
        pods: PodBatch,
        static: StaticPluginTensors | None = None,
        mesh=None,
    ) -> np.ndarray:
        """``mesh``: a NodeMesh whose shards split the node axis (the solve
        then runs on the mesh's devices); the plan agrees with the
        unsharded one within the planner's float32 tolerance, and the
        repair auction runs on the same shards."""
        if static is None:
            static = trivial_static_tensors(pods, nodes.padded, nodes.schedulable)
        from .budget import assert_index_headroom

        classes = request_classes(pods, static)
        # index-dtype audit including the relaxation's own flat-cell lane
        # (rc * node_pad quota prefix) — typed failure before dispatch
        assert_index_headroom(pods.padded, nodes.padded, rc_pad=classes[0].shape[0])
        if mesh is not None:
            mesh.width(nodes.padded)
        args = solve_args(nodes, pods, static, classes, self.device, mesh)
        cfg = self.config
        pod_valid = args[10]
        assigned, used, pod_count, placed, lam, mu, iters, res = _relax(
            *args,
            cfg.tol,
            cfg.temp,
            cfg.step,
            max_iters=cfg.max_iters,
            pack=cfg.objective == "pack",
        )
        stats = RelaxStats(
            iterations=int(iters),
            residual=float(res),
            placed_relaxed=int(placed),
            placed_total=int(placed),
            node_prices=(lam.sum(dim=0) + mu).cpu().numpy().astype(np.float32),
        )
        tail = pod_valid & (assigned < 0)
        n_tail = int(tail.sum())
        if self.repair is not None and n_tail > 0:
            # the integrality tail repairs through the auction against the
            # post-rounding occupancy: only the still-unassigned pods bid,
            # everything the rounding seated is fixed load
            rep = self.repair
            used_b, pc_b = (used, pod_count) if mesh is None else (
                mesh.split(used), mesh.split(pod_count))
            rep_assigned, used, pod_count, _, rounds = _single_shot(
                args[0], used_b, pc_b, *args[3:10], tail,
                max_rounds=rep.max_rounds,
                price_step=rep.price_step,
                top_t=rep.top_t,
                repair_rounds=rep.repair_rounds,
                pack=rep.objective == "pack",
            )
            assigned = torch.where(tail, rep_assigned, assigned)
            stats.repaired_pods = n_tail
            stats.repair_rounds = int(rounds)
            stats.placed_total = int(((assigned >= 0) & pod_valid).sum())
        self.last = stats
        nodes.used = used.cpu().numpy()
        nodes.pod_count = pod_count.cpu().numpy()
        return assigned.cpu().numpy()[: pods.num_pods]


def group_prices(
    stats: RelaxStats,
    node_groups: list[str],
    valid: np.ndarray | None = None,
) -> dict[str, float]:
    """Aggregate the per-node dual prices into per-node-group means — the
    autoscaler-facing cost signal: a group priced at 0 has slack at the
    converged plan; a rising price is demand the group cannot absorb.
    ``node_groups`` names a group per UNPADDED node slot (e.g. the zone
    label); padded slots never contribute."""
    if stats.node_prices is None:
        return {}
    out: dict[str, list[float]] = {}
    for i, grp in enumerate(node_groups):
        if valid is not None and not bool(valid[i]):
            continue
        out.setdefault(grp, []).append(float(stats.node_prices[i]))
    return {g: float(np.mean(v)) for g, v in sorted(out.items())}
