"""Single-shot assignment solver — SURVEY.md §8.4 mode 2, the engine for
the 50k-pods x 10k-nodes rebalance target (BASELINE.md north star).

The exact scan preserves pod-by-pod sequential semantics but pays one
scan-step of latency per pod; at 50k pods that serial chain dominates. The
single-shot mode trades sequential parity for parallelism (the documented
divergence from SURVEY §8.4): an auction-style capacity-constrained
assignment where every round is dense work over ALL pods at once:

  1. pods dedup into REQUEST CLASSES (static-plugin class + request
     vector); feasibility and scoring are [RC, N] tables, never [P, N] —
     the memory move that makes 50k x 10k fit in device memory;
  2. each class bids on its top-T feasible nodes by
     score - price (price = congestion penalty raised on rejection, the
     Bertsekas-auction analog); pods of a class fan out round-robin over
     the class's top-T so one round can fill many nodes in parallel;
  3. claimants are admitted per node in priority order under the node's
     remaining resources: sort by (node, -priority), per-resource segment
     prefix sums admit the largest feasible prefix — the dense equivalent
     of the reference's one-at-a-time assume loop;
  4. admitted pods commit via scatter-add; the rest re-bid next round.

After the top-T loop a FULL-WIDTH REPAIR phase closes the scarcity gap:
under contention the fullest nodes carry low headroom scores, fall outside
every class's top-T window, and their prices never escalate — so small
remaining gaps on them stay invisible and capacity strands. The repair
reruns the same auction round with the bid window widened to ALL nodes,
and keeps going while anyone still *bids* (placed OR rejected > 0),
bounded by ``repair_rounds``. Solves that already placed everything skip
the phase.

``objective`` flips the score sense: ``"spread"`` (default) prefers
high-headroom nodes — the serving posture; ``"pack"`` prefers FULL
nodes — the bin-packing posture the continuous rebalancer
(``rebalance/``) plans consolidation targets with.

Scope: NodeResourcesFit + the static per-class plugin mask (taints,
affinity, nodeName, unschedulable) + headroom scoring vs the snapshot.
Ports/spread/interpod route through the exact scan path instead.

Counterpart of ``kubernetes_tpu/solver/single_shot.py``, in torch on one
device. The auction is integer arithmetic over stable sorts; its one float
step, the headroom, is a correctly rounded float32 division. So the
assignments, the node state and the round counts equal the JAX package's
bit for bit. Three choices keep them so: the top-T bid window takes a
stable descending sort (``lax.top_k`` breaks ties toward the lower index,
``torch.topk`` does not promise an order), every ``argsort`` is stable (as
``jnp.argsort`` is), and the segment reductions are integer scatters. The
JAX package's two ``while_loop``s exit on a device-side test; here each
round's exit test is one read (``SingleShotSolver.last_reads``): a round
past the exit would escalate prices and change the result.

On a mesh (``parallel/sharding.py``) the node-resident inputs, the
prices and the node state are tuples of per-shard blocks; the claimants
(the pod axis) live on the lead device. The top-T sort over nodes is a
stable top-T per shard and a stable merge of the k*T candidates by score,
descending, in shard order -- (score descending, global index ascending),
the global stable sort's first T. The admission reads each target's free
capacity from its owning shard (the other shards add zero), and the
commit's segment sums write into the owning shards. Integer throughout,
so the sharded auction equals the unsharded one bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..tensorize.plugins import StaticPluginTensors, trivial_static_tensors
from ..tensorize.schema import CPU_IDX, MEM_IDX, NodeBatch, PodBatch

NEG = -(1 << 30)


def _cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Cumsum along axis 0, in x's dtype. The JAX package blocks it in two
    levels to keep a TPU reduce-window inside its scoped memory; an integer
    cumsum is the same either way. A [P, K] tensor is scanned column by
    column: torch's scan along the outer dimension of a narrow tensor runs
    one sequential scan per column on the card, which dominated the
    auction's device time at 512,000 pods; a 1-D scan is device-wide."""
    if x.dim() == 1:
        return torch.cumsum(x, dim=0, dtype=x.dtype)
    return torch.stack(
        [torch.cumsum(x[:, j], dim=0, dtype=x.dtype) for j in range(x.shape[1])], dim=1
    )


@dataclass(frozen=True)
class SingleShotConfig:
    max_rounds: int = 32
    # price escalation per rejection round, in score points
    price_step: int = 8
    # nodes each request-class fans out over per round (clamped to N);
    # wider = fewer rounds
    top_t: int = 1024
    # full-width repair rounds after the top-T loop (the scarcity
    # closer: nodes outside every top-T window become biddable). 0
    # disables — restoring the pre-repair early-exit behavior.
    repair_rounds: int = 16
    # "spread" = prefer high-headroom nodes (serving default);
    # "pack" = prefer full nodes (the rebalancer's consolidation plan)
    objective: str = "spread"


def _segmented_prefix(x, seg_start, seg_id, num_segments):
    """Inclusive prefix sum of ``x`` within segments of a sorted key.
    x: [P] or [P, K]; seg_start: [P] bool; seg_id: [P] int32."""
    csum = _cumsum0(x)
    start = seg_start if x.dim() == 1 else seg_start[:, None]
    base_at_start = torch.where(start, csum - x, torch.zeros_like(x))
    shape = (num_segments,) + tuple(x.shape[1:])
    idx = seg_id.long() if x.dim() == 1 else seg_id.long()[:, None].expand_as(x)
    # segment_max: segments that no element names keep 0 and are never read
    seg_base = torch.zeros(shape, dtype=x.dtype, device=x.device).scatter_reduce(
        0, idx, base_at_start, "amax", include_self=False
    )
    return csum - seg_base[seg_id.long()]


def _segment_sum(vals, seg, num_segments):
    """``jax.ops.segment_sum`` over axis 0 of ``vals`` ([P] or [P, K])."""
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def headroom_score(alloc, used0, pack: bool):
    """[N] int32 base score at the snapshot: the headroom, 100 * the mean
    of the cpu and memory free fractions, truncated — or 100 minus it for
    the pack objective. One float32 division, correctly rounded on every
    backend, so the integer score is the JAX package's."""
    alloc2 = alloc[: MEM_IDX + 1].to(torch.float32)
    used2 = used0[: MEM_IDX + 1].to(torch.float32)
    free_frac = torch.where(
        alloc2 > 0, (alloc2 - used2) / torch.clamp(alloc2, min=1.0),
        torch.zeros_like(alloc2),
    )
    headroom = (100.0 * (free_frac[CPU_IDX] + free_frac[MEM_IDX]) / 2.0).to(torch.int32)
    return (100 - headroom).to(torch.int32) if pack else headroom


def _blocks(x) -> tuple:
    """A node-resident input as a tuple of per-shard blocks (a tensor is
    one block)."""
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _single_shot(
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
    *,
    max_rounds: int,
    price_step: int,
    top_t: int,
    repair_rounds: int = 16,
    pack: bool = False,
    reads: list | None = None,
):
    """The auction on torch tensors. The six node-resident inputs are
    tensors on one device or tuples of per-shard blocks over the node axis
    (one mesh); the pod-axis inputs are on the lead device. Returns
    (assigned_to [P] int32, used [K, N], pod_count [N] int32, placed_total,
    rounds), the node state joined on the lead device. ``reads``, when
    given, gets one entry per device read the loops make (the exit
    tests)."""
    alloc_b, used0_b, pc0_b, maxp_b, valid_b, smask_b = (
        _blocks(a) for a in (alloc, used0, pod_count0, max_pods, node_valid, static_mask))
    nsh = len(alloc_b)
    widths = [a.shape[1] for a in alloc_b]
    los = [sum(widths[:i]) for i in range(nsh)]
    sdevs = [a.device for a in alloc_b]
    p = rc_of.shape[0]
    n = sum(widths)
    k = alloc_b[0].shape[0]
    t = min(top_t, n)
    dev = rc_of.device

    def rep(x):
        """A pod-axis or class-axis tensor on every shard's device."""
        return [x if d == x.device else x.to(d) for d in sdevs]

    base_b = [headroom_score(a, u, pack) for a, u in zip(alloc_b, used0_b)]
    pod_idx = torch.arange(p, dtype=torch.int64, device=dev)
    rc_of_l = rc_of.long()
    req_of_pod = rc_req[rc_of_l]  # [P, K]
    inv_prio = ((1 << 31) - 1) - priority.to(torch.int64)
    rc_req_b = rep(rc_req)
    rc_static_b = rep(rc_static.long())
    static_rows_b = [sm[rs] for sm, rs in zip(smask_b, rc_static_b)]  # [RC, w]
    park = torch.full((p,), n, dtype=torch.int32, device=dev)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)

    def top_nodes_of(score_b, t_r: int):
        """The top ``t_r`` (score, global node) per class: a stable
        descending sort per shard, then the stable merge of the shards'
        candidates in shard order -- the lower global index first among
        equal scores, as lax.top_k gives it."""
        cand_s, cand_n = [], []
        for sc, lo in zip(score_b, los):
            ts, tn = torch.sort(sc, dim=1, descending=True, stable=True)
            tk = min(t_r, sc.shape[1])
            cand_s.append(ts[:, :tk].to(dev))
            cand_n.append((tn[:, :tk] + lo).to(dev))
        cs, cn = torch.cat(cand_s, dim=1), torch.cat(cand_n, dim=1)
        ms, order = torch.sort(cs, dim=1, descending=True, stable=True)
        return ms[:, :t_r], torch.gather(cn, 1, order[:, :t_r])

    def at_targets(vals_b, t_sorted_l):
        """``vals[..., t]`` for global targets ``t`` (the park slot n reads
        0): each shard reads the targets it owns, the others add zero."""
        out = None
        for v, lo, w in zip(vals_b, los, widths):
            tl = t_sorted_l.to(v.device) - lo
            ownd = (tl >= 0) & (tl < w)
            got = torch.where(ownd, v[..., torch.clamp(tl, 0, w - 1)], 0).to(dev)
            out = got if out is None else out + got
        return out

    def seg_into_shards(vals, tgt):
        """``segment_sum(vals, tgt)`` over the node axis, each shard's
        block from the targets it owns (the rest go to its park slot)."""
        out = []
        for lo, w, d in zip(los, widths, sdevs):
            tl = tgt.to(d).long() - lo
            tl = torch.where((tl >= 0) & (tl < w), tl, w)
            out.append(_segment_sum(vals.to(d), tl, w + 1)[:w])
        return out

    def round_step(carry, t_r: int):
        """One auction round bidding over each class's top ``t_r``
        feasible nodes. The main loop uses t_r = top_t; the repair phase
        t_r = n (every node biddable)."""
        used_b, pc_b, price_b, assigned_to = carry
        unassigned = (assigned_to < 0) & pod_valid

        # 1. class-level feasibility on REMAINING capacity: [RC, N]
        free_b = [a - u for a, u in zip(alloc_b, used_b)]
        score_b = []
        for s in range(nsh):
            fit = torch.all(rc_req_b[s][:, :, None] <= free_b[s][None, :, :], dim=1)
            ok = (fit & static_rows_b[s] & valid_b[s][None, :]
                  & (pc_b[s] + 1 <= maxp_b[s])[None, :])
            score_b.append(torch.where(ok, (base_b[s] - price_b[s])[None, :],
                                       torch.full_like(price_b[s], NEG)[None, :]))

        # 2. top-T nodes per class: a stable descending sort keeps equal
        # scores in node order, the lower index first, as lax.top_k does
        top_scores, top_nodes = top_nodes_of(score_b, t_r)
        top_ok = top_scores > NEG
        n_ok = top_ok.sum(dim=1, dtype=torch.int32)  # [RC]

        # rank of each unassigned pod within its class (stable)
        key = torch.where(unassigned, rc_of_l * p + pod_idx,
                          torch.full_like(pod_idx, 1 << 62))
        order_rc = torch.argsort(key, stable=True)
        rc_sorted = rc_of[order_rc]
        seg_start_rc = torch.cat([true1, rc_sorted[1:] != rc_sorted[:-1]])
        seg_id_rc = _cumsum0(seg_start_rc.to(torch.int32)) - 1
        rank_sorted = _segmented_prefix(
            torch.ones(p, dtype=torch.int32, device=dev), seg_start_rc, seg_id_rc, p
        ) - 1
        rank = torch.empty(p, dtype=torch.int32, device=dev)
        rank[order_rc] = rank_sorted

        n_ok_pod = n_ok[rc_of_l]
        slot = rank % torch.clamp(n_ok_pod, min=1)
        target = top_nodes[rc_of_l, slot.long()].to(torch.int32)
        bidding = unassigned & (n_ok_pod > 0)
        target = torch.where(bidding, target, park)  # park at virtual node n

        # 3. admission: claimants sorted by (node, -priority), segmented
        # prefix sums against the node's remaining resources. The inverted
        # priority is biased into [0, 2^32) so the whole int32 priority
        # range packs below the node id.
        sort_key = target.to(torch.int64) * (1 << 32) + inv_prio
        order = torch.argsort(sort_key, stable=True)
        t_sorted = target[order]
        t_sorted_l = t_sorted.long()
        bidding_sorted = bidding[order]
        req_sorted = torch.where(bidding_sorted[:, None], req_of_pod[order],
                                 torch.zeros_like(req_of_pod))
        seg_start = torch.cat([true1, t_sorted[1:] != t_sorted[:-1]])
        seg_id = _cumsum0(seg_start.to(torch.int32)) - 1
        prefix = _segmented_prefix(req_sorted, seg_start, seg_id, p)
        cnt_prefix = _segmented_prefix(bidding_sorted.to(torch.int32), seg_start, seg_id, p)

        free_at = at_targets(free_b, t_sorted_l).T
        cnt_at = at_targets([(mp - pc).to(torch.int32) for mp, pc in zip(maxp_b, pc_b)],
                            t_sorted_l)
        fits_res = torch.all(prefix <= free_at, dim=1)
        fits_cnt = cnt_prefix <= cnt_at
        admit_sorted = bidding_sorted & fits_res & fits_cnt
        admit = torch.empty(p, dtype=torch.bool, device=dev)
        admit[order] = admit_sorted

        # 4. commit + price escalation on rejection
        assigned_to = torch.where(admit, target, assigned_to)
        tgt_or_park = torch.where(admit, target, park)
        rejected = bidding & ~admit
        add_req = torch.where(admit[:, None], req_of_pod, torch.zeros_like(req_of_pod))
        used_b = [u + d.T for u, d in zip(used_b, seg_into_shards(add_req, tgt_or_park))]
        pc_b = [c + d for c, d in zip(pc_b, seg_into_shards(admit.to(torch.int32), tgt_or_park))]
        rej_b = seg_into_shards(rejected.to(torch.int32), torch.where(rejected, target, park))
        price_b = [pr + torch.where(r > 0, price_step, 0).to(torch.int32)
                   for pr, r in zip(price_b, rej_b)]
        return (used_b, pc_b, price_b, assigned_to), admit.sum(), rejected.sum()

    def remaining_of(assigned_to):
        return torch.any((assigned_to < 0) & pod_valid)

    def read(x):
        if reads is not None:
            reads.append(1)
        # ktpu: ignore[TPU001]: the auction's per-round exit test and its final read, one card read per round, counted in last_reads (ROADMAP speed levers)
        return x.tolist()

    carry = (
        list(used0_b),
        list(pc0_b),
        [torch.zeros(w, dtype=torch.int32, device=d) for w, d in zip(widths, sdevs)],
        torch.full((p,), -1, dtype=torch.int32, device=dev),
    )
    # the main loop exits early: placed == 0 means no further progress at
    # this bid width. Each round's exit test also reads whether anyone is
    # left, which the repair phase's first test needs.
    rounds = 0
    remaining = None
    while rounds < max_rounds:
        carry, placed, _rejected = round_step(carry, t)
        rounds += 1
        placed_h, remaining = read(torch.stack([placed, remaining_of(carry[3]).long()]))
        if placed_h == 0:
            break

    if repair_rounds > 0 and p > 0:
        # full-width repair: every feasible node is biddable, and the loop
        # keeps going while anyone still BIDS — a round that placed nothing
        # but rejected someone escalated that node's price. Ends when no
        # unassigned pod has any feasible node left (nobody bids).
        if remaining is None:
            remaining = read(remaining_of(carry[3]))
        rep = 0
        while rep < repair_rounds and remaining:
            carry, placed, rejected = round_step(carry, n)
            rep += 1
            activity, remaining = read(
                torch.stack([placed + rejected, remaining_of(carry[3]).long()])
            )
            if activity == 0:
                break
        rounds += rep

    used_b, pc_b, _, assigned_to = carry
    placed_total = (assigned_to >= 0).sum()
    return (assigned_to, _join(used_b, dev), _join(pc_b, dev), placed_total, rounds)


def _join(blocks, dev) -> torch.Tensor:
    """Per-shard blocks joined over the node axis on ``dev``."""
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([b.to(dev) for b in blocks], dim=-1)


def request_classes(
    pods: PodBatch, static: StaticPluginTensors
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup (static class, request vector) -> (rc_req [RC, K],
    rc_static [RC], rc_of [Pp])."""
    keyed = np.concatenate(
        [static.class_of[:, None].astype(np.int64), pods.req], axis=1
    )
    uniq, inverse = np.unique(keyed, axis=0, return_inverse=True)
    rc_static = uniq[:, 0].astype(np.int32)
    rc_req = uniq[:, 1:].astype(pods.req.dtype)
    return rc_req, rc_static, inverse.reshape(-1).astype(np.int32)


def solve_args(nodes: NodeBatch, pods: PodBatch, static: StaticPluginTensors, classes, dev,
               mesh=None):
    """The auction's (and the relax planner's) 11 positional inputs as
    tensors on ``dev``; ``classes`` is ``request_classes(pods, static)``.
    With ``mesh`` the six node-resident inputs are tuples of per-shard
    blocks and the rest lie on the mesh's lead device."""
    rc_req, rc_static, rc_of = classes
    host = [
        nodes.allocatable,
        nodes.used,
        nodes.pod_count,
        nodes.max_pods,
        nodes.valid,
        static.mask,
        rc_req,
        rc_static,
        rc_of,
        pods.priority,
        pods.valid & pods.feasible_static,
    ]
    if mesh is not None:
        return [mesh.split(np.asarray(a)) for a in host[:6]] + [
            mesh.replicate(a)[0] for a in host[6:]]
    # ktpu: ignore[TPU003]: each argument is a typed host numpy array, whose dtype torch.tensor keeps; no literal default applies
    return [torch.tensor(np.ascontiguousarray(a), device=dev) for a in host]


class SingleShotSolver:
    """Host wrapper mirroring ExactSolver.solve's contract (fit + static
    mask scope). ``device``: where the auction runs (None = the card,
    raising without CUDA; ``"cpu"`` runs on the CPU). After each solve
    ``last_rounds`` holds the rounds run (main + repair) and ``last_reads``
    the device reads the rounds' exit tests made."""

    def __init__(self, config: SingleShotConfig | None = None, device=None):
        self.config = config or SingleShotConfig()
        self.device = device_mod.resolve(device)
        self.last_rounds = 0
        self.last_reads = 0

    def solve(
        self,
        nodes: NodeBatch,
        pods: PodBatch,
        static: StaticPluginTensors | None = None,
        mesh=None,
    ) -> np.ndarray:
        """Returns assignments [num_pods] (-1 = unplaced) and replaces
        ``nodes.used`` / ``nodes.pod_count`` with new arrays holding the
        placements (the caller's arrays are not written). ``mesh``: a
        NodeMesh whose shards split the node axis (the solve then runs on
        the mesh's devices); the result equals the unsharded one bit for
        bit."""
        if static is None:
            static = trivial_static_tensors(pods, nodes.padded, nodes.schedulable)
        # index-dtype audit (solver/budget.py): the admission sort key
        # (target << 32 + inv_prio) and the class-rank key (rc * P + idx)
        # must fit int64 at this shape
        from .budget import assert_index_headroom

        assert_index_headroom(pods.padded, nodes.padded)
        if mesh is not None:
            mesh.width(nodes.padded)
        args = solve_args(nodes, pods, static, request_classes(pods, static), self.device,
                          mesh)
        cfg = self.config
        reads: list = []
        assigned, used, pod_count, _, rounds = _single_shot(
            *args,
            max_rounds=cfg.max_rounds,
            price_step=cfg.price_step,
            top_t=cfg.top_t,
            repair_rounds=cfg.repair_rounds,
            pack=cfg.objective == "pack",
            reads=reads,
        )
        self.last_rounds = rounds
        self.last_reads = len(reads)
        nodes.used = used.cpu().numpy()
        nodes.pod_count = pod_count.cpu().numpy()
        return assigned.cpu().numpy()[: pods.num_pods]
