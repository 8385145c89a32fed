"""The grouped fast path: runs of identical pods placed in chunks.

Counterpart of ``kubernetes_tpu/solver/exact.py`` ``_solve_grouped``
(:434-627) and ``_chunk_kinds`` (:2409-2559); ``grouped_eligible`` (:146)
stays in ``solver/exact.py`` beside the config it reads.

The pod axis is cut into chunks of ``group`` consecutive pods and a host
classification (``chunk_kinds``) picks each chunk's branch:

  0  slow: the per-pod scan step over the chunk, bit-identical to the
     ungrouped solver (mixed chunks, anything unproven);
  1  plain: identical pods whose class is spread- and interpod-neutral --
     node-local frontier stepping;
  2  spread: identical pods with exactly one hard topology-spread
     constraint and zero preference rows -- domain-quota placement;
  3  anti: identical pods with exactly one required, self-selecting
     anti-affinity term and zero preference rows -- the same machinery
     with a quota of one pod per empty domain.

The kind is host data, so the JAX package's ``lax.switch`` is a host
branch. The JAX module note holds the proof that each fast branch is
sequentially valid.

``tie_break="first"`` places one pod per iteration by the lowest maximal
index, for the chunk's valid pods, whose number the host knows: no
iteration reads the device, and the result equals the per-pod scan bit for
bit. ``"random"`` places up to a chunk of distinct tie nodes per iteration
until the chunk is placed or proven infeasible; the loop's exit test
reads the count placed from the card, one device-to-host read per
iteration. Each iteration splits the solve's threefry stream once and
draws the JAX package's float64 ``uniform`` (plain mode, and again from
the same subkey for the water-fill) or its int32 ``randint(0, 1 << 20)``
node keys (quota modes) through the threefry kernel
(``ops/threefry.py``), so the placements equal the JAX package's bit for
bit. Its water-fill branch (spread mode) is a data-dependent choice in
the JAX package (``lax.cond``); here both branches run and
``torch.where`` keeps one, so the iteration still reads the card once.

On the card (one shard, random mode, LeastAllocated or MostAllocated
scoring) a spread chunk's whole random loop runs in one launch of the
fused kernel instead (``ops/grouped_spread.py``, ``_fused_spread``): the
same iterations on the same inputs, the exit test on the card, no read
per iteration; the CPU and every other chunk keep the loop below.

Each iteration of a spread or anti chunk aggregates the per-node counts
by domain through one launch of the ``domain_counts`` kernel: the counts
``base + m`` (spread) or ``base + (v_in + v_ex) * m`` (anti) are written
into one scratch row in place, and one prepared launch per chunk serves
every iteration (``ops/domain_counts.py`` ``Aggregation``). The random
mode's eligible-node count per domain is a plain ``index_add_``, and its
per-domain maximum key a ``scatter_reduce`` "amax".

On a mesh (``parallel/sharding.py``) ``fast_chunk`` is a generator per
shard, run in lockstep: argmax and max combine as in the scan step, the
domain counts add up across shards (one counts-only launch per shard per
evaluation), and the random keys are one draw over the whole node axis on
the lead device, sliced to the shards, so the stream is the unsharded one.
Four steps need a global order or prefix over nodes; each gathers its
[N] key vectors to the lead device in shard order and computes there (the
named gathers, counted in PERF.md): the plain mode's ``argsort`` and the
water-fill's ranking ``argsort``; ``_winner_accept``'s per-domain "amax"
and its ``cumsum`` need no gather (a per-domain max and a prefix of the
shard totals). The loop's exit test is one read of the lead's count.

Two JAX constructs have no torch counterpart: ``.at[...].set(...,
mode="drop")`` scatters into a buffer one slot longer whose last slot is
never read, and ``lax.associative_scan(jnp.maximum)`` is ``torch.cummax``.
The capacity per node uses exact int64 floor division where the JAX
package uses ``fastmath.floor_div_exact``; the result is clamped to
[0, group] either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import domain_counts as dc
from ..ops import grouped_spread as gs
from ..ops import noderesources as nr
from ..ops import plugins as pl
from ..parallel import sharding as sh
from ..tensorize.schema import MEM_IDX

INF_COUNT = 2**30

KIND_SLOW, KIND_PLAIN, KIND_SPREAD, KIND_ANTI = 0, 1, 2, 3


def chunk_kinds(pods, static, ports, spread, interpod, group: int,
                use_spread: bool, use_interpod: bool) -> np.ndarray:
    """[P // group] int32 chunk dispatch: 0 slow / 1 plain / 2 spread /
    3 anti (the JAX package's ``ExactSolver._chunk_kinds``, copied).

    A fast kind requires ``group`` consecutive identical valid pods
    (class, requests, port rows and, when active, the spread and interpod
    per-pod rows); kinds 2 and 3 also require the single-constraint,
    zero-preference-row shapes whose sequential validity the fast
    branches rely on. All-padding chunks are kind 1 and place nothing."""
    gn = pods.padded // group

    def same(arr: np.ndarray) -> np.ndarray:
        a = arr.reshape(gn, group, -1)
        return (a == a[:, :1]).all(axis=(1, 2))

    valid = pods.valid & pods.feasible_static
    vchunk = valid.reshape(gn, group)
    uniform = vchunk.all(axis=1)
    arrays = [
        np.asarray(static.class_of),
        pods.req,
        pods.req_mask,
        pods.nonzero_req,
        np.asarray(ports.pod_conflict),
        np.asarray(ports.pod_takes),
    ]
    if use_spread:
        arrays.append(np.asarray(spread.placed_match))
    if use_interpod:
        arrays += [
            np.asarray(interpod.in_match),
            np.asarray(interpod.ex_owned),
            np.asarray(interpod.m_anti),
            np.asarray(interpod.m_w),
            np.asarray(interpod.self_aff)[:, None],
        ]
    for arr in arrays:
        uniform &= same(arr)
    padding = ~vchunk.any(axis=1)

    kinds = np.zeros(gn, dtype=np.int32)
    kinds[padding] = KIND_PLAIN
    if not (use_spread or use_interpod):
        kinds[uniform] = KIND_PLAIN
        return kinds

    class_of = np.asarray(static.class_of)
    taint = np.asarray(static.taint_cnt)
    nodeaff = np.asarray(static.nodeaff_pref)
    if use_spread:
        spr_hard = np.asarray(spread.hard)
        spr_soft = np.asarray(spread.soft)
        spr_placed = np.asarray(spread.placed_match)
        spr_min_dom = np.asarray(spread.min_domains)
    if use_interpod:
        ipa_anti = np.asarray(interpod.cls_req_anti)
        ipa_aff = np.asarray(interpod.cls_req_aff)
        ipa_pref = np.asarray(interpod.cls_pref)
        ipa_in_m = np.asarray(interpod.in_match)
        ipa_ex_o = np.asarray(interpod.ex_owned)
        ipa_m_anti = np.asarray(interpod.m_anti)
        ipa_m_w = np.asarray(interpod.m_w)
        ipa_ex_anti = np.asarray(interpod.ex_anti)
        ipa_in_dom = np.asarray(interpod.in_dom)
        ipa_ex_dom = np.asarray(interpod.ex_dom)
    first = np.arange(gn) * group
    for g in np.nonzero(uniform & ~padding)[0]:
        i = int(first[g])
        c = int(class_of[i])
        no_pref_rows = not taint[c].any() and not nodeaff[c].any()

        if use_spread:
            hard_row = spr_hard[c]
            soft_row = spr_soft[c]
            placed_row = spr_placed[i]
            spr_neutral = (
                (hard_row < 0).all() and (soft_row < 0).all() and not placed_row.any()
            )
            j = int(hard_row[0])
            spr_fast = (
                j >= 0
                and (hard_row[1:] < 0).all()
                and (soft_row < 0).all()
                and no_pref_rows
                and bool(placed_row[j])
                and not placed_row[np.arange(len(placed_row)) != j].any()
                and int(spr_min_dom[j]) < 0
            )
        else:
            spr_neutral, spr_fast = True, False

        if use_interpod:
            anti_row = ipa_anti[c]
            aff_row = ipa_aff[c]
            pref_row = ipa_pref[c]
            in_m = ipa_in_m[i]
            ex_o = ipa_ex_o[i]
            m_anti = ipa_m_anti[i]
            m_w = ipa_m_w[i]
            ipa_neutral = (
                (anti_row < 0).all()
                and (aff_row < 0).all()
                and (pref_row < 0).all()
                and not in_m.any()
                and not ex_o.any()
                and not m_anti.any()
                and not m_w.any()
            )
            j = int(anti_row[0])
            ex_idx = np.nonzero(ex_o)[0]
            ipa_fast = (
                j >= 0
                and (anti_row[1:] < 0).all()
                and (aff_row < 0).all()
                and (pref_row < 0).all()
                and no_pref_rows
                and not m_w.any()
                and in_m[j] > 0
                and not in_m[np.arange(len(in_m)) != j].any()
                and len(ex_idx) == 1
                and bool(m_anti[ex_idx[0]])
                and m_anti.sum() == 1
                and bool(ipa_ex_anti[ex_idx[0]])
                and np.array_equal(ipa_in_dom[j], ipa_ex_dom[ex_idx[0]])
            )
        else:
            ipa_neutral, ipa_fast = True, False

        if spr_fast and ipa_neutral:
            kinds[g] = KIND_SPREAD
        elif ipa_fast and spr_neutral:
            kinds[g] = KIND_ANTI
        elif spr_neutral and ipa_neutral:
            kinds[g] = KIND_PLAIN
    return kinds


def _ex_term(h) -> int:
    """The anti pod's own symmetric ex term, from its host row (a host
    precondition of the kind: exactly one, on the same topology and domain
    row as its constraint)."""
    # ktpu: ignore[TPU001]: ipa_ex_owned is the pod's host numpy row; no card value is read
    return int(np.argmax(h["ipa_ex_owned"] > 0))


def _anti_terms(tables, cls: int, h) -> tuple[int, int]:
    """An anti chunk's constraint row ``j`` and the weight ``v`` of one
    placed pod in the counts (its in and ex terms), from the chunk's class
    and its pod's host rows."""
    # ktpu: ignore[TPU001]: cls_req_anti is a host numpy class table; no card value is read
    j = max(int(tables["ipa"]["cls_req_anti"][cls, 0]), 0)
    # ktpu: ignore[TPU001]: the pod's host numpy rows; no card value is read
    return j, int(h["ipa_in_match"][j] + h["ipa_ex_owned"][_ex_term(h)])


def iteration_key(mode: str, tables, cls: int, h) -> tuple:
    """What an iteration of a spread or anti chunk's random loop branches
    on in host code, besides the chunk's valid count and the stream's key
    slot: the mode, the class (its constraint row, ``maxSkew > 1``, the
    present domains) and an anti pod's weight in the counts. Chunks of
    one key share a kept loop (``solver/graphs.py``)."""
    return mode, cls, (_anti_terms(tables, cls, h)[1] if mode == "anti" else 1)


class _DomainModel:
    """The domain bookkeeping of one spread or anti chunk on one shard: the
    constraint's rows, resolved on the host from the chunk's class, and one
    prepared ``domain_counts`` launch over a scratch row that each
    iteration rewrites in place (counts-only on a mesh of more than one
    shard, whose sums combine before the per-node gather). ``load`` points
    it at a chunk's carried counts."""

    def __init__(self, mode: str, tables, h, group: int):
        self.mode = mode
        self.sharded = tables["shards"] > 1
        cls = int(h["class_of"])
        if mode == "spread":
            spr = tables["spr"]
            j = max(int(spr["hard"][cls, 0]), 0)
            dom = spr["dom"][j : j + 1]
            counted_dom = spr["counted_dom"][j : j + 1]
            self.hk = spr["hk"][j]
            self.charged = counted_dom[0] >= 0  # counted: elig & has_key
            self.base = None  # the carried counts' row, set by load
            self.v = 1
            self.skew_lim = int(spr["max_skew"][j])
            self.present = spr["present"][j]
            present_host = spr["present_host"][j]
            d_pad = spr["present"].shape[1]
            agg_dom, gather_dom = counted_dom, dom
        else:
            ipa = tables["ipa"]
            j, self.v = _anti_terms(tables, cls, h)
            dom = ipa["in_dom"][j : j + 1]
            self.hk = ipa["in_hk"][j]
            self.charged = self.hk
            # the in and ex counts' sum, written by load
            self.base = torch.empty(dom.shape[1], dtype=torch.int32, device=dom.device)
            d_pad = tables["ipa_d_pad"]
            agg_dom, gather_dom = dom, None
        self.j = j
        self.dd = torch.clamp(dom[0], min=0).to(torch.int64)
        self.gather_dom = dom
        self.d_pad = d_pad
        self.group = group
        self.buf = torch.empty_like(dom)
        if self.sharded:
            self.agg = dc.Aggregation([(agg_dom, self.buf, None)], d_pad, gather=False)
        else:
            self.agg = dc.Aggregation([(agg_dom, self.buf, gather_dom)], d_pad)
        if mode == "spread":
            # the water-fill's domain ranks: present domains in index order
            self.d_present = int(present_host.sum())
            self.d_rank = torch.as_tensor(
                np.cumsum(present_host.astype(np.int64)) - 1, device=dom.device
            )

    def load(self, st, h) -> None:
        """The chunk's carried counts: the spread row in place, or the anti
        term's in and ex rows summed into ``base``."""
        if self.mode == "spread":
            self.base = st["spr_cnt"][self.j]
        else:
            torch.add(st["ipa_in"][self.j], st["ipa_ex"][_ex_term(h)], out=self.base)

    def eval(self, m, quota: bool = True):
        """(extra feasibility mask [N], quota per domain [d_pad], domain
        counts [d_pad]) with ``m`` more pods placed per node; without
        ``quota`` (first mode) only the mask. A generator of the shard
        protocol (the domain sum combines)."""
        if self.v == 1:
            torch.add(self.base, m, out=self.buf[0])
        else:
            torch.add(self.base, m, alpha=self.v, out=self.buf[0])
        ((counts, node_dc),) = self.agg()
        if self.sharded:
            counts = yield sh.c_sum, counts
            node_dc = dc.gather_plain(counts, self.gather_dom)
        counts, node_dc = counts[0], node_dc[0]
        if self.mode == "spread":
            mn = torch.min(torch.where(self.present, counts, INF_COUNT))
            ok = self.hk & (node_dc + 1 - mn <= self.skew_lim)
            if not quota:
                return ok, None, None
            return ok, torch.clamp(mn + self.skew_lim - counts, 0, self.group), counts
        ok = ~self.hk | (node_dc == 0)
        if not quota:
            return ok, None, None
        return ok, (counts == 0).to(torch.int32), counts


def _read_placed(parts):
    """The random loop's exit test: one read of the lead's exit row,
    whatever the shard count. The row is the count placed, or in spread
    mode ``[count placed, 1 if the iteration kept the water-fill]``;
    every shard gets the value read (an int, or that list)."""
    return [parts[0].tolist()] * len(parts)


def _global_order(group: int):
    """The plain random mode's ``argsort`` over the whole node axis: a
    named [N] gather of the shards' keys to the lead device; every shard
    gets the first ``group`` global node ids."""

    def fn(keys):
        lead = keys[0].device
        full = keys[0] if len(keys) == 1 else torch.cat([k.to(lead) for k in keys])
        order = torch.argsort(full, stable=True)[:group]
        return [order if k.device == lead else order.to(k.device) for k in keys]

    return fn


def _static_row(tables, cls: int, w_image: int, use_extra: bool):
    """The class's static score row (ImageLocality and the extra scores,
    int32 [N]) that every frontier score adds, or None."""
    static_row = None
    if w_image:
        static_row = w_image * tables["image_score"][cls]
    if use_extra:
        extra = tables["extra_score"][cls]
        static_row = extra if static_row is None else static_row + extra
    return static_row


class _Loop:
    """One fast chunk's loop on one shard: the buffers it reads and writes,
    and its iterations. A chunk runs on a loop of its own, which takes the
    chunk's inputs as they are; or, in a graph pass (``solver/graphs.py``),
    on a loop *kept* for every spread or anti chunk of one
    ``iteration_key`` in the epoch, whose ``load`` copies each chunk's
    inputs into the same buffers and starts its counts anew, so that a
    CUDA graph of an iteration reads and writes what the next chunk's
    iterations do. ``iteration`` touches nothing else but the carried
    state's rows and the stream.

    ``m_ext`` / ``asg_ext``: one slot longer than their use, the slot that
    the JAX package's mode="drop" scatters leave out (and that the shards
    that do not own a pick add to). ``placed``: the count placed, advanced
    in place."""

    def __init__(self, mode, tables, h, group: int, tie_break: str, *, fit_scorer, fdtype,
                 w_fit: int, w_balanced: int, w_taint: int, w_nodeaff: int, w_image: int,
                 use_extra: bool, kept: bool = False):
        alloc = tables["alloc"]
        self.alloc2 = alloc[: MEM_IDX + 1]
        n = self.n = alloc.shape[1]
        self.lo = tables["lo"]
        self.n_all = n * tables["shards"]
        self.lead = self.lo == 0
        dev = self.dev = alloc.device
        self.mode, self.tables, self.group, self.kept = mode, tables, group, kept
        self.fit_scorer, self.fdtype = fit_scorer, fdtype
        self.w_fit, self.w_balanced, self.w_taint, self.w_nodeaff = (
            w_fit, w_balanced, w_taint, w_nodeaff)
        cls = int(h["class_of"])
        self.static_row = _static_row(tables, cls, w_image, use_extra)
        self.taint_row = tables["taint_cnt"][cls]
        self.nodeaff_row = tables["nodeaff_pref"][cls]
        self.model = _DomainModel(mode, tables, h, group) if mode is not None else None
        self.m_ext = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        self.m = self.m_ext[:n]
        self.asg_ext = torch.full((group + 1,), -1, dtype=torch.int64, device=dev)
        self.asg = self.asg_ext[:group]
        self.alloc_g = {1: self.alloc2}
        random = tie_break == "random"
        # the random loop reads the next frontier row too, but in anti mode
        self.rows = 1 if mode == "anti" or not random else 2
        if random:
            self.iota_n = torch.arange(n, dtype=torch.int64, device=dev)
            self.iota_g = torch.arange(group, dtype=torch.int64, device=dev)
            self.ones_g = torch.ones(group, dtype=torch.int32, device=dev)
            self.placed = torch.zeros((), dtype=torch.int64, device=dev)
        if kept:
            self.cap = torch.empty(n, dtype=torch.int32, device=dev)
            self.nz = torch.empty(2, dtype=torch.int64, device=dev)
            if self.rows == 2:
                self.alloc_g[2] = torch.empty((2, 2 * n), dtype=torch.int64, device=dev)

    def load(self, st, x, h, cap) -> None:
        """The chunk's inputs: its capacity per node ``cap``, its pod's
        device row ``x`` and host row ``h``, and the carried state ``st``
        (a kept loop's graphs read the state where the graph pass keeps
        it)."""
        self.nonzero_used = st["nonzero_used"]
        if self.model is not None:
            self.model.load(st, h)
        # the scoring's allocatable, one copy per frontier row: a node
        # table, which a session's heal rewrites in place
        rows2 = self.alloc2[:, None, :].expand(2, 2, self.n)
        if not self.kept:
            self.cap, self.nz = cap, x["nonzero_req"]
            if self.rows == 2:
                self.alloc_g[2] = rows2.reshape(2, 2 * self.n)
            return
        self.cap.copy_(cap)
        self.nz.copy_(x["nonzero_req"])
        if self.rows == 2:
            self.alloc_g[2].view(2, 2, self.n).copy_(rows2)
        self.m_ext.zero_()
        self.asg_ext.fill_(-1)
        self.placed.zero_()

    def frontier_rows(self, m, rows: int):
        """fit + balanced (+ static rows) score of placing the (m+1)-th ..
        (m+rows)-th identical pod on each node: [rows, N] int32."""
        n = self.n
        if rows == 1:
            jj = (m + 1).to(torch.int64)[None]
        else:
            jj = torch.stack([m + 1 + i for i in range(rows)]).to(torch.int64)
        req_g = (self.nonzero_used[:, None, :] + self.nz[:, None, None] * jj[None]
                 ).reshape(2, rows * n)
        alloc_g = self.alloc_g[rows]
        s = self.w_fit * self.fit_scorer(req_g, alloc_g, self.tables["fit_weights"])
        s = s + self.w_balanced * nr.balanced_allocation_score(req_g, alloc_g, fdtype=self.fdtype)
        s = s.to(torch.int32).reshape(rows, n)
        return s if self.static_row is None else s + self.static_row

    def scores_at(self, m, extra_ok, f):
        mask_t = m < self.cap
        if extra_ok is not None:
            mask_t = mask_t & extra_ok
        total = f
        # in the quota modes the preference rows are all zero (a host
        # precondition of the kind): a constant cannot move the argmax
        if self.mode is None:
            if self.w_taint:
                total = total + self.w_taint * (
                    yield from pl.normalize_score_g(self.taint_row, mask_t, reverse=True))
            if self.w_nodeaff:
                total = total + self.w_nodeaff * (
                    yield from pl.normalize_score_g(self.nodeaff_row, mask_t, reverse=False))
        return torch.where(mask_t, total, -1), mask_t

    def own(self, idx, ok):
        """(local index, or the drop slot n, and whether this shard owns
        the global index ``idx`` where ``ok``)."""
        n = self.n
        if self.tables["shards"] == 1:
            return torch.where(ok, idx, n), ok
        local = idx - self.lo
        hit = ok & (local >= 0) & (local < n)
        return torch.where(hit, local, n), hit

    def draw(self, fn):
        return sh.c_draw, (fn, self.lo, self.n, self.dev)

    def scatter_takes(self, parts):
        # every shard's taken nodes into the lead's assignments, in shard order
        for idx, val in parts:
            self.asg_ext.scatter_(0, idx.to(self.dev), val.to(self.dev))
        return [None] * len(parts)

    def first(self, vcnt: int):
        """"first" mode: one pod an iteration at the lowest maximal index,
        for the chunk's ``vcnt`` valid pods; no iteration reads the card."""
        model, m, lo = self.model, self.m, self.lo
        for t in range(vcnt):
            extra_ok = (yield from model.eval(m, quota=False))[0] if model is not None else None
            total, _ = yield from self.scores_at(m, extra_ok, self.frontier_rows(m, 1)[0])
            best, pick = yield sh.c_first_max, (*torch.max(total, dim=0), lo)
            feasible = best >= 0
            idx, hit = self.own(pick, feasible)
            self.m_ext.index_add_(0, idx.view(1), hit.to(torch.int32).view(1))
            if self.lead:
                self.asg[t] = torch.where(feasible, pick, -1)

    def iteration(self, vcnt: int, stream):
        """One iteration of the random loop for a chunk of ``vcnt`` valid
        pods, up to its exit row, which the caller reads: the count placed,
        or in spread mode ``[count placed, 1 if the water-fill was kept]``.
        A generator of the shard protocol."""
        mode, model, m, cap = self.mode, self.model, self.m, self.cap
        lo, n, n_all, group = self.lo, self.n, self.n_all, self.group
        placed = self.placed
        if model is not None:
            extra_ok, quota_d, dc_now = yield from model.eval(m)
        else:
            extra_ok = quota_d = dc_now = None
        fr = self.frontier_rows(m, self.rows)
        f_now, next_f = fr[0], fr[self.rows - 1]
        total, mask_t = yield from self.scores_at(m, extra_ok, f_now)
        best = yield sh.c_max, torch.max(total)
        feasible = best >= 0
        tie = (total == best) & mask_t
        if mode is None:
            eligible = tie & ((m + 1) < cap) & (next_f <= f_now)
        elif mode == "spread":
            eligible = tie & (next_f <= f_now)
        else:
            eligible = tie
        remaining = vcnt - placed

        if mode is None:
            # k, s1 = split(k); uniform(s1, (n_all,)) in float64
            r = yield self.draw(lambda: stream.uniform(0, n_all))
            keyed = torch.where(tie, r, 2.0)
            _, pick = yield sh.c_first_min, (torch.min(keyed), torch.argmin(keyed), lo)
            order = yield sh.c_apply, (_global_order(group), torch.where(eligible, r, 2.0))
            q = torch.minimum((yield sh.c_sum, torch.sum(eligible.to(torch.int64))), remaining)
        else:
            ec = eligible & model.charged
            # unique per-node random keys (one draw over the whole node axis):
            # k, s1 = split(k); randint(s1, (n_all,), 0, 1 << 20) * n_all + iota
            rb = yield self.draw(lambda: stream.node_keys(0, n_all, n_all))
            accept, pos_iter = yield from _winner_accept(model, m, cap, extra_ok, quota_d,
                                                         f_now, best, eligible, ec, rb)
            if mode == "spread":
                wf_acc, wf_pos, waterfill = yield from _waterfill_accept(
                    model, m, cap, extra_ok, dc_now, f_now, best, ec, remaining, n_all,
                    self.draw, stream,
                )
                accept = torch.where(waterfill, wf_acc, accept)
                pos_iter = torch.where(waterfill, wf_pos, pos_iter)
            q = torch.minimum((yield sh.c_sum, torch.sum(accept.to(torch.int64))), remaining)
            keyed = torch.where(tie, rb, -1)
            _, pick = yield sh.c_first_max, (torch.max(keyed), torch.argmax(keyed), lo)

        multi = q > 0
        if mode is None:
            chosen = torch.where(
                multi,
                torch.where(self.iota_g < q, order[:group], -1),
                torch.where(self.iota_g < 1, pick, -1),
            )
            chosen = torch.where(feasible, chosen, -1)
            if self.lead:
                self.asg_ext.scatter_(0, torch.where(chosen >= 0, placed + self.iota_g, group),
                                      chosen)
            idx, _ = self.own(chosen, chosen >= 0)
            self.m_ext.index_add_(0, idx, self.ones_g)
        else:
            take = accept & (pos_iter < q) & multi & feasible
            yield sh.c_apply, (self.scatter_takes,
                               (torch.where(take, placed + pos_iter, group), self.iota_n + lo))
            single = ~multi & feasible
            if self.lead:
                self.asg_ext.scatter_(0, torch.where(single, placed, group).view(1),
                                      pick.view(1))
            self.m_ext[:n] += take.to(torch.int32)
            idx, hit = self.own(pick, single)
            self.m_ext.index_add_(0, idx.view(1), hit.to(torch.int32).view(1))
        # q pods placed (one where no node takes several), or the chunk
        # proven infeasible: placed + remaining, all of it
        placed.add_(torch.where(feasible, torch.where(multi, q, 1), remaining))
        if mode == "spread":
            # the same read brings back whether the water-fill was kept
            return torch.stack((placed, waterfill.to(torch.int64)))
        return placed


def fast_chunk(mode, tables, st, x, h, vcnt: int, *, group: int, tie_break: str,
               stream, fit_scorer, fdtype, w_fit: int, w_balanced: int,
               w_taint: int, w_nodeaff: int, w_image: int, use_extra: bool,
               read_placed, graphs=None, fused=None):
    """Places ``vcnt`` identical pods (the chunk's representative rows:
    ``x`` on the device, ``h`` on the host) and returns (assignments
    [group] int64, per-node placements ``m`` [N] int32). ``mode``: None
    (plain), "spread" or "anti". The caller adds ``m`` times the pod's
    rows into the carried state. A generator of the shard protocol over
    one shard's block (``tables["lo"]`` its first global column); the
    lead shard's assignments are the chunk's. ``read_placed``: the
    random loop's exit-test combine, ``_read_placed`` timed by the
    solver, which returns the count placed (and counts a spread
    iteration's water-fill flag). ``graphs``: the call's graph pass on one
    card (``solver/graphs.py``), or None; a spread or anti chunk's random
    loop then runs on the pass's kept loop, and its iterations replay
    CUDA graphs where they engage. ``fused``: the call's device row of
    the fused spread loops' counts where they engage
    (``ops/grouped_spread.py`` ``engages``), or None; a spread chunk then
    runs its whole random loop in one launch of that kernel."""
    alloc = tables["alloc"]
    req = x["req"]
    # ktpu: ignore[TPU001]: h is the pod's host row (_PodRows.host_row); no card value is read
    cls = int(h["class_of"])

    # how many more identical pods each node can take
    free = torch.clamp(alloc - st["used"], min=0)
    cap_res = torch.where(
        x["req_mask"][:, None],
        torch.div(free, torch.clamp(req, min=1)[:, None], rounding_mode="floor"),
        group,
    )
    cap = torch.minimum(
        torch.min(cap_res, dim=0).values,
        (tables["max_pods"] - st["pod_count"]).to(torch.int64),
    )
    takes = h["pod_takes"]
    conflict = h["pod_conflict"]
    # ktpu: ignore[TPU002]: conflict is the pod's host numpy port row; no card value is read
    if conflict.any():  # else the pod conflicts with nothing
        conflict_now = pl.ports_conflict_mask(x["pod_conflict"], st["port_used"])
        # ktpu: ignore[TPU002]: takes is the pod's host numpy port row; no card value is read
        if (takes > 0).any():
            cap = torch.where(conflict_now, 0, cap)
        # ktpu: ignore[TPU002]: host numpy port rows; no card value is read
        if ((takes > 0) & conflict).any():
            cap = torch.where(~conflict_now, torch.clamp(cap, max=1), cap)
    base_mask = tables["static_mask"][cls] & tables["node_valid"]
    cap = torch.clamp(torch.where(base_mask, cap, 0), 0, group).to(torch.int32)

    score = dict(fit_scorer=fit_scorer, fdtype=fdtype, w_fit=w_fit, w_balanced=w_balanced,
                 w_taint=w_taint, w_nodeaff=w_nodeaff, w_image=w_image, use_extra=use_extra)
    if mode == "spread" and fused is not None:
        return _fused_spread(tables, st, x, cls, cap, vcnt, group, stream, fused,
                             fit_scorer=fit_scorer, fdtype=fdtype, w_fit=w_fit,
                             w_balanced=w_balanced, w_image=w_image, use_extra=use_extra)
    kept = graphs is not None and tie_break == "random" and mode is not None
    if kept:
        key = iteration_key(mode, tables, cls, h)
        loop = graphs.loop(key, lambda: _Loop(mode, tables, h, group, tie_break, kept=True,
                                              **score))
    else:
        loop = _Loop(mode, tables, h, group, tie_break, **score)
    loop.load(st, x, h, cap)
    if tie_break != "random":
        yield from loop.first(vcnt)
        return loop.asg, loop.m
    placed_h = 0
    while placed_h < vcnt:
        exit_row = graphs.iteration(loop, key, vcnt) if kept else None
        if exit_row is None:
            exit_row = yield from loop.iteration(vcnt, stream)
        # the loop's exit test: one read per iteration
        placed_h = yield read_placed, exit_row
    return loop.asg, loop.m


def _fused_spread(tables, st, x, cls: int, cap, vcnt: int, group: int, stream, counts, *,
                  fit_scorer, fdtype, w_fit: int, w_balanced: int, w_image: int,
                  use_extra: bool):
    """A spread chunk (of class ``cls``) placed by its random loop in one
    launch of the fused kernel (``ops/grouped_spread.py``): (assignments
    [group] int64, per-node placements ``m`` [N] int32), as the eager loop
    returns them; the chunk's iterations and kept water-fills go to the
    device row ``counts``."""
    spr = tables["spr"]
    # the constraint row and its maxSkew and present domains: host numpy
    j = max(spr["hard"][cls, 0], 0)
    n = cap.shape[0]
    m = torch.empty(n, dtype=torch.int32, device=cap.device)
    asg = torch.empty(group, dtype=torch.int64, device=cap.device)
    gs.spread_loop(
        stream, vcnt=vcnt, group=group, skew=spr["max_skew"][j],
        d_present=spr["present_host"][j].sum(), cap=cap, base=st["spr_cnt"][j],
        counted_dom=spr["counted_dom"][j], dom=spr["dom"][j],
        hk=spr["hk"][j], present=spr["present"][j], alloc=tables["alloc"],
        nonzero_used=st["nonzero_used"], nz=x["nonzero_req"], fit_weights=tables["fit_weights"],
        static_row=_static_row(tables, cls, w_image, use_extra), fit_scorer=fit_scorer,
        fdtype=fdtype, w_fit=w_fit, w_balanced=w_balanced, m=m, asg=asg, counts=counts,
    )
    return asg, m


def _winner_accept(model, m, cap, extra_ok, quota_d, f_now, best, eligible, ec, rb):
    """Single-round selection: one winner per domain with quota (the
    highest random key among its eligible charged nodes), plus every
    eligible uncharged node; positions in index order. A generator of the
    shard protocol: the per-domain maximum and the positions' prefix
    combine across shards."""
    seg_key = torch.full((model.d_pad,), torch.iinfo(torch.int64).min,
                         dtype=torch.int64, device=rb.device)
    seg_key.scatter_reduce_(0, model.dd, torch.where(ec, rb, -1), "amax")
    seg_key = yield sh.c_max, seg_key
    quota_eff = quota_d
    if model.mode == "spread" and model.skew_lim > 1:
        # re-entry gate for maxSkew > 1 (the minimum may rise mid-iteration)
        blocked_high = yield sh.c_any, torch.any(
            (m < cap) & model.hk & ~extra_ok & (f_now >= best))
        quota_eff = torch.where(blocked_high, 0, quota_d)
    win = ec & (rb == seg_key[model.dd]) & (quota_eff[model.dd] >= 1)
    acc = win | (eligible & ~model.charged)
    csum = torch.cumsum(acc.to(torch.int64), dim=0)
    before, _ = yield sh.c_prefix, csum[-1]
    return acc, csum - 1 + before


def _waterfill_ranking(group: int):
    """The water-fill's ranking of eligible nodes within their domain by a
    random key: a named [N] gather of the shards' keys, eligibility and
    domains to the lead device, where the stable ``argsort`` and the
    segment starts run; every shard gets its columns of (accept, rank)."""

    def fn(parts):
        lead = parts[0][0].device

        def cat(i):
            if len(parts) == 1:
                return parts[0][i]
            return torch.cat([p[i].to(lead) for p in parts])

        keyf, ec, dd = cat(0), cat(1), cat(2)
        kk = parts[0][3]
        iota = torch.arange(keyf.shape[0], dtype=torch.int64, device=lead)
        si = torch.argsort(keyf, stable=True)
        sd = dd[si]
        elig_s = ec[si]
        is_start = elig_s & ((iota == 0) | (sd != torch.roll(sd, 1)))
        start_pos = torch.cummax(torch.where(is_start, iota, -1), dim=0).values
        rank = iota - start_pos
        accept = torch.zeros_like(ec).scatter_(0, si, elig_s & (rank < kk))
        # the rank is clamped to `group` before the position product
        # (accepted ranks are below it; solver/budget.py
        # assert_index_headroom polices the clamped bound)
        rank_n = torch.zeros_like(iota).scatter_(0, si, torch.clamp(rank, max=group))
        if len(parts) == 1:
            return [(accept, rank_n)]
        out, lo = [], 0
        for p in parts:
            w = p[0].shape[0]
            d = p[0].device
            out.append((accept[lo : lo + w].to(d), rank_n[lo : lo + w].to(d)))
            lo += w
        return out

    return fn


def _waterfill_accept(model, m, cap, extra_ok, dc_now, f_now, best, ec, remaining,
                      n_all, draw, stream):
    """The water-fill: when every present domain sits at one count and no
    skew-blocked node could out-score today's best, k full rounds place at
    once, interleaved round-robin across domains. Returns (accept, pos,
    whether the water-fill applies). A generator of the shard protocol."""
    present, dd, group = model.present, model.dd, model.group
    seg_elig = torch.zeros(model.d_pad, dtype=torch.int64, device=dd.device)
    seg_elig.index_add_(0, dd, ec.to(torch.int64))
    seg_elig = yield sh.c_sum, seg_elig
    mx_dc = torch.max(torch.where(present, dc_now, -1))
    mn_dc = torch.min(torch.where(present, dc_now, INF_COUNT))
    blocked_over = yield sh.c_any, torch.any((m < cap) & model.hk & ~extra_ok & (f_now > best))
    kk = torch.minimum(
        torch.min(torch.where(present, seg_elig, INF_COUNT)),
        torch.div(remaining, max(model.d_present, 1), rounding_mode="floor"),
    )
    waterfill = (mx_dc == mn_dc) & ~blocked_over & (kk >= 1)

    # rank eligible nodes within their domain by a random key: a float64
    # uniform from the iteration's subkey, drawn again (no split)
    u = yield draw(lambda: stream.uniform(0, n_all, split=False))
    keyf = torch.where(ec, dd.to(torch.float64) * 2.0 + u, float("inf"))
    accept, rank_n = yield sh.c_apply, (_waterfill_ranking(group), (keyf, ec, dd, kk))
    pos = rank_n * model.d_present + model.d_rank[dd]
    return accept, pos, waterfill
