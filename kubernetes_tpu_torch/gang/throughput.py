"""Heterogeneity-aware scoring: Gavel's per-accelerator-class
effective-throughput objective, folded into the batched score
pipeline.

Nodes advertise an accelerator class via the
``scheduling.x-k8s.io/accelerator-class`` label (``tpu-v4``,
``tpu-v5e``, ``gpu-a100``, ...); pods advertise a workload class via
``scheduling.x-k8s.io/workload-class`` (``resnet``, ``transformer``,
...). The configured matrix maps (workload class, accelerator class)
to a relative effective throughput, and ``fold_throughput`` converts
it into integer score points accumulated into the static tensors'
``extra_score`` table — the same generic donor every solver path
(fused and grouped) already adds to the score when present
(``use_extra_score``), so the objective costs ZERO new kernel surface:
a gang lands on the class where its throughput-per-chip is highest,
not merely where it fits.

The fold is pure per (class representative, node) — the contract the
out-of-tree/extender folds already obey — so it composes with the
fold cache (which replaces ``extra_score`` BEFORE this fold runs) and
rides the pipelined/streaming overlap untouched.

Copied from ``kubernetes_tpu/gang/throughput.py``.
"""

from __future__ import annotations

import json

import numpy as np

ACCEL_CLASS_LABEL = "scheduling.x-k8s.io/accelerator-class"
WORKLOAD_CLASS_LABEL = "scheduling.x-k8s.io/workload-class"


def load_throughput_table(path: str) -> dict:
    """Load a class-throughput matrix from a JSON file:
    ``{"resnet": {"tpu-v4": 1.0, "tpu-v5e": 0.62}, ...}``. Validation
    mirrors the inline-table rules in config/types.py."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(
            f"gang.classThroughputPath {path}: top level must be an "
            "object of workload classes"
        )
    return raw


def fold_throughput(static, slot_nodes, config) -> None:
    """Accumulate weighted throughput points into
    ``static.extra_score`` (created on first contribution, accumulated
    in place otherwise — the extender fold's discipline)."""
    table = config.class_throughput
    weight = config.throughput_weight
    if not table or weight <= 0:
        return
    node_cls: list[str | None] = [
        n.labels.get(ACCEL_CLASS_LABEL) if n is not None else None
        for n in slot_nodes
    ]
    if not any(node_cls):
        return  # homogeneous / unlabeled cluster: nothing to prefer
    extra = static.extra_score
    for ci, rep in enumerate(static.reps):
        wl = rep.labels.get(WORKLOAD_CLASS_LABEL)
        if not wl:
            continue
        per = table.get(wl)
        if not per:
            continue
        for j, nc in enumerate(node_cls):
            if nc is None:
                continue
            rel = per.get(nc)
            if not rel:
                continue
            if extra is None:
                extra = np.zeros(static.mask.shape, dtype=np.int32)
            extra[ci, j] += int(round(weight * float(rel)))
    if extra is not None and extra is not static.extra_score:
        if extra.any():
            static.extra_score = extra
