"""Torch functions for InterPodAffinity (the in-scan pieces).

Counterpart of ``kubernetes_tpu/ops/interpod.py``. The reference's
topologyToMatchedTermCount hash maps (interpodaffinity/filtering.go) become
one (term, domain) aggregation per step of the per-node owner/match counts
[T, N] into [T, D] domain totals, gathered back per node: one launch of the
``domain_counts`` kernel covers both the ``in`` and the ``ex`` table. All
four directions (incoming aff/anti, existing-anti symmetry, scored
preferred/hard symmetry) read those two aggregates.

Table layout: ``ipa`` holds ``in_dom``/``ex_dom`` [T, N] int32, their
has_key masks ``in_hk``/``ex_hk`` (``static_tables``, built once per solve)
and ``ex_anti`` [Te] bool as tensors on the device, and optionally
``launch``, a dict in which the prepared aggregation over the carried
counts is kept from one step to the next (the solver gives one per solve); and the class slot tables
(``cls_req_aff``, ``cls_req_anti``, ``cls_pref``) and ``in_pref_w`` as host
numpy arrays; the pod's class is a host int, so its term slots resolve on
the host. The per-pod rows in ``x`` (``ipa_m_anti``, ``ipa_m_w``,
``ipa_self_aff``) are tensors on the device.
"""

from __future__ import annotations

import torch

from ..parallel import sharding as sh
from . import domain_counts as dc

MAX_NODE_SCORE = 100
INF = 2**30


def node_totals(ipa, in_cnt, ex_cnt, d_pad: int, ident: bool = False):
    """``node_totals_g`` on one shard."""
    return sh.run_local(node_totals_g(ipa, in_cnt, ex_cnt, d_pad, ident))


# device-scope op, called per step by the solver: ktpu: hot
def node_totals_g(ipa, in_cnt, ex_cnt, d_pad: int, ident: bool = False):
    """(in totals [Ti, N], ex totals [Te, N]): the per-node domain totals
    of both tables -- the JAX package's ``domain_counts`` of each -- from
    one launch of the kernel over both row sets. A generator of the shard
    protocol: on a mesh of more than one shard (``ipa["shards"] > 1``)
    each shard launches counts-only over its block, the [Ti + Te, d_pad]
    sums add up on the lead device in shard order, and each shard gathers
    its nodes' totals from the global sums.

    ``ident=True``: every valid node has a unique domain in every row (the
    hostname-topology case, verified by the tensorizer), so the per-node
    total is the per-node count (masked by has_key) and no aggregation
    runs, sharded or not."""
    if ident:
        return (torch.where(ipa["in_hk"], in_cnt, 0),
                torch.where(ipa["ex_hk"], ex_cnt, 0))
    sharded = ipa.get("shards", 1) > 1
    agg = prepared_totals(ipa, in_cnt, ex_cnt, d_pad)
    (in_out, in_tot), (ex_out, ex_tot) = agg()
    if sharded:
        ti = in_out.shape[0]
        # the two sets' counts are one [Ti + Te, d_pad] allocation
        out = agg.out if agg.out is not None else torch.cat([in_out, ex_out])
        out = yield sh.c_sum, out
        in_tot = dc.gather_plain(out[:ti], ipa["in_dom"])
        ex_tot = dc.gather_plain(out[ti:], ipa["ex_dom"])
    return in_tot, ex_tot


def prepared_totals(ipa, in_cnt, ex_cnt, d_pad: int):
    """The aggregation of both tables over the carried counts, kept in
    ``ipa["launch"]`` from one step to the next (prepared anew for other
    count tensors): gathered unsharded, counts-only sharded."""
    sharded = ipa.get("shards", 1) > 1
    cache = ipa.get("launch", {})
    agg = cache.get("totals")
    if agg is None or agg.sets[0][1] is not in_cnt or agg.sets[1][1] is not ex_cnt:
        agg = cache["totals"] = dc.Aggregation(
            [(ipa["in_dom"], in_cnt, None), (ipa["ex_dom"], ex_cnt, None)],
            d_pad, counts=sharded, gather=not sharded,
        )
    return agg


def static_tables(in_dom, ex_dom) -> dict:
    """The per-solve pieces of the tables that no step changes: has_key
    of both tables (the JAX package recomputes it every step)."""
    return {"in_hk": in_dom >= 0, "ex_hk": ex_dom >= 0}


def filter_and_score(
    ipa, in_cnt, ex_cnt, cls: int, x, d_pad: int, node_valid,
    ident: bool = False, score: bool = True,
):
    """``filter_and_score_g`` on one shard."""
    return sh.run_local(filter_and_score_g(ipa, in_cnt, ex_cnt, cls, x, d_pad, node_valid,
                                           ident, score))


# device-scope op, called per step by the solver: ktpu: hot
def filter_and_score_g(
    ipa, in_cnt, ex_cnt, cls: int, x, d_pad: int, node_valid,
    ident: bool = False, score: bool = True,
):
    """Returns (allowed [N] bool, raw_score [N] int32). A generator of the
    shard protocol: the domain sums combine (``node_totals_g``) and the
    first-pod test's ``total_any`` is a cross-shard sum.

    ipa: tables (see the module note); in_cnt/ex_cnt: carried [T, N] int32
    counts; cls: the pod's class (host int); x: the pod's rows. Raw scores
    are unnormalized -- normalization runs over the final feasible mask.
    ``score=False``: the batch has no preferred terms and no symmetry
    weights, so the scoring section is skipped (raw is all-zero)."""
    in_counts, ex_counts = yield from node_totals_g(ipa, in_cnt, ex_cnt, d_pad, ident)
    in_hk, ex_hk = ipa["in_hk"], ipa["ex_hk"]
    n = in_counts.shape[1]
    dev = in_counts.device

    # 1. existing pods' required anti-affinity vs this pod (symmetry)
    concerns = ipa["ex_anti"] & x["ipa_m_anti"]  # [Te]
    blocked = torch.any(concerns[:, None] & ex_hk & (ex_counts > 0), dim=0)

    # 2. incoming required anti-affinity (missing key -> passes)
    viol = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in ipa["cls_req_anti"][cls]:
        if j >= 0:
            viol = viol | (in_hk[j] & (in_counts[j] > 0))

    allowed = ~blocked & ~viol
    # 3. incoming required affinity + first-pod special case
    if ipa["cls_req_aff"][cls, 0] >= 0:
        all_ok = torch.ones(n, dtype=torch.bool, device=dev)
        has_all_keys = torch.ones(n, dtype=torch.bool, device=dev)
        total_any = torch.zeros((), dtype=torch.int32, device=dev)
        for j in ipa["cls_req_aff"][cls]:
            if j < 0:
                continue
            all_ok = all_ok & in_hk[j] & (in_counts[j] > 0)
            has_all_keys = has_all_keys & in_hk[j]
            total_any = total_any + torch.sum(
                torch.where(in_hk[j] & node_valid, in_cnt[j], 0)
            )
        total_any = yield sh.c_sum, total_any
        # the first-pod special case never admits a node missing a topology
        # key (filtering.go#satisfyPodAffinity)
        first_pod = (total_any == 0) & x["ipa_self_aff"] & has_all_keys
        allowed = allowed & (all_ok | first_pod)

    # score: incoming preferred terms + existing-side symmetry
    raw = torch.zeros(n, dtype=torch.int32, device=dev)
    if score:
        for j in ipa["cls_pref"][cls]:
            if j >= 0:
                w = int(ipa["in_pref_w"][j])
                raw = raw + torch.where(in_hk[j], w * in_counts[j], 0)
        # the JAX package's int32 matvec m_w @ counts; CUDA has no integer
        # matrix product, so it is an elementwise product and a column sum
        # (int64 sum cast back to int32: the same value modulo 2^32)
        sym = torch.where(ex_hk, ex_counts, 0) * x["ipa_m_w"][:, None]
        raw = raw + torch.sum(sym, dim=0).to(torch.int32)
    return allowed, raw


def normalize(raw, mask):
    """``normalize_g`` on one shard."""
    return sh.run_local(normalize_g(raw, mask))


# device-scope op, called per step by the solver: ktpu: hot
def normalize_g(raw, mask):
    """scoring.go#NormalizeScore: 100*(s-min)/(max-min) over the feasible
    set; all-equal -> 0. raw, mask: [..., N]; each row on its own. A
    generator of the shard protocol: the maximum and minimum are
    cross-shard."""
    mx = yield sh.c_max, torch.amax(torch.where(mask, raw, -INF), dim=-1, keepdim=True)
    mn = yield sh.c_min, torch.amin(torch.where(mask, raw, INF), dim=-1, keepdim=True)
    diff = mx - mn
    norm = torch.div(
        MAX_NODE_SCORE * (raw - mn), torch.clamp(diff, min=1), rounding_mode="floor"
    )
    return torch.where(mask & (diff > 0), norm, 0)
