"""Torch functions for PodTopologySpread (the in-scan pieces).

Counterpart of ``kubernetes_tpu/ops/spread.py``. The domain bookkeeping the
reference keeps in hash maps (podtopologyspread/filtering.go:
TpPairToMatchNum, TpKeyToCriticalPaths) is recomputed per scan step as
segment reductions over the node axis: per constraint, one launch of the
``domain_counts`` kernel sums the match counts per domain and gathers each
node's domain total. The reference's second segment sum, domain presence,
depends only on the static tables, so ``static_tables`` builds it once per
solve.

Table layout: ``spr`` holds the per-node rows ``dom``, ``counted_dom``
[J, N] int32, ``hk`` [J, N] bool, ``present`` [J, d_pad] bool and
``n_dom`` [J] int32 as tensors on the device, ``n_dom_host`` and the
small per-class and per-instance tables (``hard``, ``soft``,
``max_skew``, ``min_domains``, ``self_match``, ``is_hostname``) as host
numpy arrays, and optionally ``launch``, a dict in which each
constraint's prepared aggregation over the carried counts is kept from one
step to the next (the solver gives one per solve). The pod's class is a
host int, so the constraint slots it uses resolve on the host: an empty slot
costs nothing on the device, and nothing here reads the device.

Sentinel: INF_COUNT stands in for the reference's math.MaxInt32 initial
criticalPaths value -- an empty domain set means the constraint cannot be
violated, matching filtering.go#minMatchNum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import sharding as sh
from . import domain_counts as dc

MAX_NODE_SCORE = 100
INF_COUNT = 2**30


def static_tables(dom, elig, d_pad: int) -> dict:
    """The per-constraint pieces that depend only on the static tables,
    built once per solve on the host (the JAX package recomputes them every
    step). dom: [J, N] int32 (-1 missing), elig: [J, N] bool, numpy.

    Returns numpy arrays: ``hk`` [J, N] bool (has_key), ``counted_dom``
    [J, N] int32 (dom where ``elig & hk``, else -1: the lanes the counts
    sum), ``present`` [J, d_pad] bool (a counted lane lies in the domain)
    and ``n_dom`` [J] int32 (registered domains)."""
    dom = np.asarray(dom, np.int32)
    hk = dom >= 0
    counted = np.asarray(elig, bool) & hk
    present = np.zeros((dom.shape[0], d_pad), bool)
    rows, lanes = np.nonzero(counted & (dom < d_pad))  # as segment_sum drops them
    present[rows, dom[rows, lanes]] = True
    return {
        "hk": hk,
        "counted_dom": np.where(counted, dom, -1).astype(np.int32),
        "present": present,
        "n_dom": present.sum(axis=1).astype(np.int32),
    }


def _domain_aggregate_g(spr, j: int, cnt, d_pad: int):
    """Returns (per-node domain count, #registered domains, min over
    registered domains, has_key) of constraint ``j``; cnt: [J, N] int32
    carried per-node match counts. A generator of the shard protocol
    (``parallel/sharding.py``): on a mesh of more than one shard it yields
    the domain sum.

    Unsharded, one launch of the kernel sums ``cnt[j]`` per domain over the
    counted lanes (``counted_dom``) and gathers each node's domain total by
    its own domain (``dom``), equal to the reference's segment sum and
    gather. Sharded (``spr["shards"] > 1``), each shard launches the kernel
    counts-only over its own block, the shards' [1, d_pad] sums add up on
    the lead device in shard order, and each shard gathers its nodes'
    totals from the global sum (the fused gather would need the global
    histogram). Presence and the domain count come from ``static_tables``.
    The prepared launch and the constraint's static rows are kept in
    ``spr["launch"]`` from one step to the next."""
    sharded = spr.get("shards", 1) > 1
    _, agg, present, n_dom, hk = prepared(spr, j, cnt, d_pad)
    ((dom_counts, node_cnt),) = agg()
    if sharded:
        dom_counts = yield sh.c_sum, dom_counts
        node_cnt = dc.gather_plain(dom_counts, spr["dom"][j : j + 1])
    min_match = torch.min(torch.where(present, dom_counts[0], INF_COUNT))
    return node_cnt[0], n_dom, min_match, hk


def prepared(spr, j: int, cnt, d_pad: int) -> tuple:
    """(cnt, the prepared aggregation, presence row, domain count, has_key
    row) of constraint ``j`` over the carried counts ``cnt``, kept in
    ``spr["launch"]`` from one step to the next (prepared anew for another
    ``cnt``). Sharded, the aggregation is counts-only."""
    sharded = spr.get("shards", 1) > 1
    cache = spr.get("launch", {})
    hit = cache.get(j)
    if hit is None or hit[0] is not cnt:
        agg = dc.Aggregation(
            [(spr["counted_dom"][j : j + 1], cnt[j : j + 1],
              None if sharded else spr["dom"][j : j + 1])],
            d_pad, gather=not sharded,
        )
        hit = cache[j] = (cnt, agg, spr["present"][j], spr["n_dom"][j], spr["hk"][j])
    return hit


def _domain_aggregate(spr, j: int, cnt, d_pad: int):
    """``_domain_aggregate_g`` on one shard."""
    return sh.run_local(_domain_aggregate_g(spr, j, cnt, d_pad))


def aggregate_rows(spr, cnt, d_pad: int):
    """(per-node domain count [J, N], min over registered domains [J]) of
    every constraint row at once: ``_domain_aggregate`` over all J rows in
    one launch of the kernel (the batched evaluator's state-only part)."""
    ((dom_counts, node_cnt),) = dc.aggregate(
        [(spr["counted_dom"], cnt, spr["dom"])], d_pad
    )
    min_match = torch.amin(torch.where(spr["present"], dom_counts, INF_COUNT), dim=1)
    return node_cnt, min_match


def hard_violations(spr, cnt, cls: int, d_pad: int):
    """``hard_violations_g`` on one shard."""
    return sh.run_local(hard_violations_g(spr, cnt, cls, d_pad))


# device-scope op, called per step by the solver: ktpu: hot
def hard_violations_g(spr, cnt, cls: int, d_pad: int):
    """[N] bool -- any hard spread constraint of class ``cls`` violated.
    A generator of the shard protocol: the domain sums combine; the rest
    is local once they are global.

    spr: spread tables (see the module note); cnt: [J, N] int32 carried
    per-node match counts."""
    n = spr["dom"].shape[1]
    viol = torch.zeros(n, dtype=torch.bool, device=spr["dom"].device)
    for j in spr["hard"][cls]:
        j = int(j)
        if j < 0:
            continue
        node_cnt, _, min_match, hk = yield from _domain_aggregate_g(spr, j, cnt, d_pad)
        md = int(spr["min_domains"][j])
        if md >= 0 and spr["n_dom_host"][j] < md:
            min_match = 0
        skew = node_cnt + int(spr["self_match"][j]) - min_match
        viol = viol | (~hk) | (skew > int(spr["max_skew"][j]))
    return viol


def soft_scores(spr, cnt, cls: int, mask, d_pad: int, fdtype=torch.float32):
    """``soft_scores_g`` on one shard."""
    return sh.run_local(soft_scores_g(spr, cnt, cls, mask, d_pad, fdtype))


# device-scope op, called per step by the solver: ktpu: hot
def soft_scores_g(spr, cnt, cls: int, mask, d_pad: int, fdtype=torch.float32):
    """[N] int32 -- normalized 0-100 PodTopologySpread score over the
    feasible set ``mask`` (scoring.go#Score + #NormalizeScore). A
    generator of the shard protocol: the feasible count is a cross-shard
    sum, the domain sums combine, and the normalization's maximum and
    minimum are cross-shard.

    ``fdtype`` mirrors the solver's balanced_fdtype: float64 matches the
    oracle's Go float64 math."""
    dev = spr["dom"].device
    n = spr["dom"].shape[1]
    if spr["soft"][cls, 0] < 0:  # the class has no soft constraint
        return torch.zeros(n, dtype=torch.int32, device=dev)
    slots = [int(j) for j in spr["soft"][cls] if j >= 0]
    raw = torch.zeros(n, dtype=fdtype, device=dev)
    ignored = torch.zeros(n, dtype=torch.bool, device=dev)
    n_feasible = yield sh.c_sum, torch.sum(mask.to(torch.int32))
    for j in slots:
        node_cnt, n_dom, _, hk = yield from _domain_aggregate_g(spr, j, cnt, d_pad)
        if spr["is_hostname"][j]:
            c, size = cnt[j].to(fdtype), n_feasible.to(fdtype)
        else:
            c, size = node_cnt.to(fdtype), n_dom.to(fdtype)
        contrib = c * torch.log(size + 2.0) + (float(spr["max_skew"][j]) - 1.0)
        raw = raw + torch.where(hk, contrib, 0.0)
        ignored = ignored | ~hk
    raw_i = torch.round(raw).to(torch.int32)

    considered = mask & ~ignored
    mx = yield sh.c_max, torch.max(torch.where(considered, raw_i, -INF_COUNT))
    mn = yield sh.c_min, torch.min(torch.where(considered, raw_i, INF_COUNT))
    any_considered = yield sh.c_any, torch.any(considered)
    norm = torch.div(
        MAX_NODE_SCORE * (mx + mn - raw_i), torch.clamp(mx, min=1),
        rounding_mode="floor",
    )
    norm = torch.where(mx == 0, MAX_NODE_SCORE, norm)
    return torch.where(considered & any_considered, norm, 0)
