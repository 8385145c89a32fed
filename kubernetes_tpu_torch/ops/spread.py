"""Torch functions for PodTopologySpread (the in-scan pieces).

Counterpart of ``kubernetes_tpu/ops/spread.py``. The domain bookkeeping the
reference keeps in hash maps (podtopologyspread/filtering.go:
TpPairToMatchNum, TpKeyToCriticalPaths) is recomputed per scan step as
segment reductions over the node axis. Both per-row segment sums run
through the ``domain_counts`` kernel with one term row.

Table layout: ``spr`` holds the per-node rows ``dom`` [J, N] int32 and
``elig`` [J, N] bool as tensors on the device, and the small per-class and
per-instance tables (``hard``, ``soft``, ``max_skew``, ``min_domains``,
``self_match``, ``is_hostname``) as host numpy arrays. The pod's class is a
host int, so the constraint slots it uses resolve on the host: an empty slot
costs nothing on the device, and nothing here reads the device.

Sentinel: INF_COUNT stands in for the reference's math.MaxInt32 initial
criticalPaths value -- an empty domain set means the constraint cannot be
violated, matching filtering.go#minMatchNum.
"""

from __future__ import annotations

import torch

from . import domain_counts as dc

MAX_NODE_SCORE = 100
INF_COUNT = 2**30


def _domain_aggregate(dom_row, elig_row, cnt_row, d_pad: int):
    """Returns (per-node domain count, #registered domains, min over
    registered domains, has_key). dom_row: [N] int32 (-1 missing),
    elig_row: [N] bool, cnt_row: [N] int32 per-node match counts.

    Lanes outside ``elig & has_key`` get domain -1, which the kernel
    excludes; the counts are the kernel's sum of ``cnt`` per domain and the
    presence its sum of ones per domain, both equal to the reference's two
    segment sums."""
    hk = dom_row >= 0
    dd = torch.where(hk, dom_row, 0)
    counted_dom = torch.where(elig_row & hk, dom_row, -1)[None]
    dom_counts = dc.domain_counts(counted_dom, cnt_row[None].contiguous(), d_pad)[0]
    dom_present = (
        dc.domain_counts(counted_dom, torch.ones_like(counted_dom), d_pad)[0] > 0
    )
    n_dom = torch.sum(dom_present.to(torch.int32))
    min_match = torch.min(torch.where(dom_present, dom_counts, INF_COUNT))
    node_cnt = dom_counts[dd.to(torch.int64)]  # [N]
    return node_cnt, n_dom, min_match, hk


def hard_violations(spr, cnt, cls: int, d_pad: int):
    """[N] bool -- any hard spread constraint of class ``cls`` violated.

    spr: spread tables (see the module note); cnt: [J, N] int32 carried
    per-node match counts."""
    n = spr["dom"].shape[1]
    viol = torch.zeros(n, dtype=torch.bool, device=spr["dom"].device)
    for j in spr["hard"][cls]:
        j = int(j)
        if j < 0:
            continue
        node_cnt, n_dom, min_match, hk = _domain_aggregate(
            spr["dom"][j], spr["elig"][j], cnt[j], d_pad
        )
        md = int(spr["min_domains"][j])
        if md >= 0:
            min_match = torch.where(n_dom < md, 0, min_match)
        skew = node_cnt + int(spr["self_match"][j]) - min_match
        viol = viol | (~hk) | (skew > int(spr["max_skew"][j]))
    return viol


def soft_scores(spr, cnt, cls: int, mask, d_pad: int, fdtype=torch.float32):
    """[N] int32 -- normalized 0-100 PodTopologySpread score over the
    feasible set ``mask`` (scoring.go#Score + #NormalizeScore).

    ``fdtype`` mirrors the solver's balanced_fdtype: float64 matches the
    oracle's Go float64 math."""
    dev = spr["dom"].device
    n = spr["dom"].shape[1]
    if spr["soft"][cls, 0] < 0:  # the class has no soft constraint
        return torch.zeros(n, dtype=torch.int32, device=dev)
    slots = [int(j) for j in spr["soft"][cls] if j >= 0]
    raw = torch.zeros(n, dtype=fdtype, device=dev)
    ignored = torch.zeros(n, dtype=torch.bool, device=dev)
    n_feasible = torch.sum(mask.to(torch.int32))
    for j in slots:
        node_cnt, n_dom, _, hk = _domain_aggregate(
            spr["dom"][j], spr["elig"][j], cnt[j], d_pad
        )
        if spr["is_hostname"][j]:
            c, size = cnt[j].to(fdtype), n_feasible.to(fdtype)
        else:
            c, size = node_cnt.to(fdtype), n_dom.to(fdtype)
        contrib = c * torch.log(size + 2.0) + (float(spr["max_skew"][j]) - 1.0)
        raw = raw + torch.where(hk, contrib, 0.0)
        ignored = ignored | ~hk
    raw_i = torch.round(raw).to(torch.int32)

    considered = mask & ~ignored
    mx = torch.max(torch.where(considered, raw_i, -INF_COUNT))
    mn = torch.min(torch.where(considered, raw_i, INF_COUNT))
    any_considered = torch.any(considered)
    norm = torch.div(
        MAX_NODE_SCORE * (mx + mn - raw_i), torch.clamp(mx, min=1),
        rounding_mode="floor",
    )
    norm = torch.where(mx == 0, MAX_NODE_SCORE, norm)
    return torch.where(considered & any_considered, norm, 0)
