"""Torch functions for the noderesources plugins: Fit (filter), the scoring
strategies (LeastAllocated / MostAllocated / RequestedToCapacityRatio) and
BalancedAllocation.

Counterpart of ``kubernetes_tpu/ops/noderesources.py``; the semantics are
the oracle's (``ops/oracle/noderesources.py`` in the JAX package):
- fit.go#fitsRequest             -> fit_mask
- least_allocated.go             -> least_allocated_score
- most_allocated.go              -> most_allocated_score
- requested_to_capacity_ratio.go -> rtc_score
- balanced_allocation.go         -> balanced_allocation_score

Integer score arithmetic is int64 with exact floor division
(``torch.div(..., rounding_mode="floor")``). The JAX package's
``floor_div_exact`` is a workaround for the TPU's missing integer divide and
is exact only for quotients below 2^23; it has no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch

MAX_NODE_SCORE = 100


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


# device-scope op, called per step by the solver: ktpu: hot
def fit_mask(
    req: torch.Tensor,  # [K] int64
    req_mask: torch.Tensor,  # [K] bool -- resources the pod requests (>0)
    alloc: torch.Tensor,  # [K, N] int64
    used: torch.Tensor,  # [K, N] int64
    pod_count: torch.Tensor,  # [N] int32
    max_pods: torch.Tensor,  # [N] int32
) -> torch.Tensor:  # [N] bool
    """NodeResourcesFit Filter: every requested resource fits, and the node
    has a free pod slot."""
    res_ok = (used + req[:, None] <= alloc) | (~req_mask[:, None])
    count_ok = pod_count + 1 <= max_pods
    return torch.all(res_ok, dim=0) & count_ok


def scoring_requested(
    nonzero_req: torch.Tensor,  # [2] int64 -- pod (cpu, mem), non-zero defaults
    nonzero_used: torch.Tensor,  # [2, N] int64
) -> torch.Tensor:  # [2, N] int64
    """calculateResourceAllocatableRequest for the default cpu/memory
    scoring resources: scoring uses NonZeroRequested, not Requested."""
    return nonzero_used + nonzero_req[:, None]


def _weighted_mean(per_res, weights):
    wsum = torch.sum(weights)
    return _floor_div(
        torch.sum(per_res * weights[:, None], dim=0), torch.clamp(wsum, min=1)
    )


# device-scope op, called per step by the solver: ktpu: hot
def least_allocated_score(
    requested: torch.Tensor,  # [R, N] int64 -- per scoring resource
    alloc: torch.Tensor,  # [R, N] int64
    weights: torch.Tensor,  # [R] int64
) -> torch.Tensor:  # [N] int64 -- 0..100
    """(alloc - requested) * 100 // alloc per resource, weighted int mean."""
    ok = (alloc > 0) & (requested <= alloc)
    per_res = torch.where(
        ok,
        _floor_div((alloc - requested) * MAX_NODE_SCORE, torch.clamp(alloc, min=1)),
        0,
    )
    return _weighted_mean(per_res, weights)


# device-scope op, called per step by the solver: ktpu: hot
def most_allocated_score(
    requested: torch.Tensor, alloc: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    ok = (alloc > 0) & (requested <= alloc)
    per_res = torch.where(
        ok,
        _floor_div(requested * MAX_NODE_SCORE, torch.clamp(alloc, min=1)),
        0,
    )
    return _weighted_mean(per_res, weights)


# device-scope op, called per step by the solver: ktpu: hot
def rtc_score(
    requested: torch.Tensor,  # [R, N] int64
    alloc: torch.Tensor,  # [R, N] int64
    weights: torch.Tensor,  # [R] int64
    shape_x: Sequence[int],  # [S] utilization breakpoints, ascending 0..100
    shape_y: Sequence[int],  # [S] scores 0..10 at the breakpoints
) -> torch.Tensor:
    """RequestedToCapacityRatio: piecewise-linear over integer utilization,
    scaled by MaxNodeScore/10. The shape is host ints (config), so the
    breakpoint loop unrolls in Python."""
    sx = [int(v) for v in shape_x]
    sy = [int(v) for v in shape_y]
    util = torch.where(
        alloc > 0,
        torch.clamp(_floor_div(requested * 100, torch.clamp(alloc, min=1)), max=100),
        0,
    )  # [R, N]

    def trunc_div(a, b: int):
        # Go int64 division truncates toward zero; floor division differs
        # where a decreasing segment makes the numerator negative
        q = _floor_div(torch.abs(a), max(abs(b), 1))
        return torch.where((a >= 0) == (b >= 0), q, -q)

    y = torch.full_like(util, sy[0])
    for i in range(1, len(sx)):
        x0, y0, x1, y1 = sx[i - 1], sy[i - 1], sx[i], sy[i]
        seg = y0 + trunc_div((y1 - y0) * (util - x0), x1 - x0)
        y = torch.where((util >= x0) & (util < x1), seg, y)
    y = torch.where(util >= sx[-1], sy[-1], y)

    per_res = torch.where(alloc > 0, y * (MAX_NODE_SCORE // 10), 0)
    return _weighted_mean(per_res, weights)


# device-scope op, called per step by the solver: ktpu: hot
def balanced_allocation_score(
    requested: torch.Tensor,  # [R, N] int64 -- scoring resources (cpu, mem)
    alloc: torch.Tensor,  # [R, N] int64
    fdtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # [N] int32 -- 0..100
    """(1 - std(fractions)) * 100, truncated toward zero to int32.

    Exactly two resources use |f0 - f1| / 2 (the reference's special case);
    more use the population standard deviation."""
    f = torch.where(
        alloc > 0,
        requested.to(fdtype) / torch.clamp(alloc, min=1).to(fdtype),
        torch.ones((), dtype=fdtype, device=alloc.device),
    )
    f = torch.clamp(f, max=1.0)
    r = requested.shape[0]
    if r == 2:
        std = torch.abs(f[0] - f[1]) / 2.0
    elif r > 2:
        mean = torch.mean(f, dim=0)
        std = torch.sqrt(torch.mean((f - mean) ** 2, dim=0))
    else:
        std = torch.zeros(requested.shape[1], dtype=fdtype, device=alloc.device)
    return ((1.0 - std) * MAX_NODE_SCORE).to(torch.int32)
