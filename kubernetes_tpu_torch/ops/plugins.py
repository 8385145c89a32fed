"""Torch functions for the static plugins' in-scan pieces.

Counterpart of ``kubernetes_tpu/ops/plugins.py``. The static plugin
semantics are precompiled on the host into per-class tables
(``tensorize/plugins.py``); what runs on the device per scan step is a row
gather, DefaultNormalizeScore over the feasible set (``normalize_score``)
and the NodePorts occupancy test (``ports_conflict_mask``).
"""

from __future__ import annotations

import torch

MAX_NODE_SCORE = 100


def normalize_score(raw: torch.Tensor, mask: torch.Tensor, reverse: bool) -> torch.Tensor:
    """DefaultNormalizeScore over the feasible (masked) set.

    raw: [..., N] int32 non-negative, mask: [..., N] bool; each row (one
    pod's nodes) normalizes on its own. Returns [..., N] int32; values on
    masked-out lanes are unspecified (the caller masks the total)."""
    s = torch.where(mask, raw, 0).to(torch.int32)
    max_count = torch.amax(s, dim=-1, keepdim=True)
    scaled = torch.div(
        MAX_NODE_SCORE * s, torch.clamp(max_count, min=1), rounding_mode="floor"
    )
    if reverse:
        # maxCount == 0 => all scores become maxPriority
        return torch.where(max_count > 0, MAX_NODE_SCORE - scaled, MAX_NODE_SCORE)
    return torch.where(max_count > 0, scaled, 0)


def ports_conflict_mask(pod_conflict_row: torch.Tensor, port_used: torch.Tensor) -> torch.Tensor:
    """True where the node has an occupied port slot conflicting with the pod.

    pod_conflict_row: [V] bool, port_used: [V, N] int32 occupancy counts.
    The JAX package takes an int32 matvec here and tests it for > 0; CUDA
    has no integer matrix product, and a sum of 0/1 terms is positive
    exactly when one term is set, so this is the same result as a masked
    ``any`` over the vocabulary axis."""
    return torch.any(pod_conflict_row[:, None] & (port_used > 0), dim=0)
