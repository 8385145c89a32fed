"""Shipped analyzer configuration: the audited whitelists, device roots
and path scopes for the kubernetes_tpu_torch package.

SANCTIONED_SYNC_POINTS is the contract at the heart of the pipelined
solver: the hot path may read device values through EXACTLY these three
points —

- ``DeferredAssignments.get`` (solver/session.py): the deferred
  assignment download, whose ``non_blocking`` copy into pinned host
  memory and CUDA event were issued at dispatch, so the blocking read
  lands after the host work in between has been overlapped.
- ``DeferredAssignments.wait`` (solver/session.py): the streaming
  dispatcher's completion thread parks here (on that event), so the wait
  is paid OFF the scheduling thread — it never converts the value; the
  apply path's ``get`` stays the one read.
- ``_InFlightSolve.assignments`` (scheduler.py): the scheduler-side
  wrapper the apply path calls once per batch.

Adding an entry is a design decision, not a lint tweak: it must come
with the same overlap analysis these carry.

DEVICE_ROOTS are the port's counterparts of the JAX package's seven
``jax.jit`` roots: the host functions that issue the card's launches
(the port runs eagerly, so nothing marks them but this list). Every
function in their scope runs on the host once per launch, so a sync
there costs one card round trip per step.

Copied from ``kubernetes_tpu/analysis/registry.py``, with the port's
paths.
"""

from __future__ import annotations

from .core import PACKAGE, AnalysisContext

SANCTIONED_SYNC_POINTS = frozenset(
    {
        (f"{PACKAGE}/solver/session.py", "DeferredAssignments.get"),
        (f"{PACKAGE}/solver/session.py", "DeferredAssignments.wait"),
        (f"{PACKAGE}/scheduler.py", "_InFlightSolve.assignments"),
    }
)

DEVICE_ROOTS = frozenset(
    {
        # the JAX package's _run_packed: one solve's scan or grouped
        # chunks, the per-pod step and its filter + score pipeline
        (f"{PACKAGE}/solver/exact.py", "_Run.__call__"),
        (f"{PACKAGE}/solver/exact.py", "_make_step"),
        (f"{PACKAGE}/solver/exact.py", "_mask_and_score"),
        (f"{PACKAGE}/solver/grouped.py", "fast_chunk"),
        # _heal: the session's dirty-column heal
        (f"{PACKAGE}/solver/session.py", "_heal"),
        # _preempt_scan, _relax, _single_shot: the other device programs
        (f"{PACKAGE}/solver/preemption.py", "_preempt_scan"),
        (f"{PACKAGE}/solver/relax.py", "_relax"),
        (f"{PACKAGE}/solver/single_shot.py", "_single_shot"),
        # _eval_jit: the extender's batched [P, N] evaluation
        (f"{PACKAGE}/solver/evaluate.py", "BatchEvaluator.evaluate_tensors"),
        # domain_counts_pallas: the kernel's wrappers and its launch
        (f"{PACKAGE}/ops/domain_counts.py", "aggregate"),
        (f"{PACKAGE}/ops/domain_counts.py", "domain_counts"),
        (f"{PACKAGE}/ops/domain_counts.py", "Aggregation.__call__"),
        # jax.random inside those programs: the threefry kernel's draws
        (f"{PACKAGE}/ops/threefry.py", "Stream.rank"),
        (f"{PACKAGE}/ops/threefry.py", "Stream._grouped"),
    }
)

# TPU003 dtype discipline applies where tensors feed the solve pipeline:
# torch defaults a float literal to float32 and an int to int64, while the
# JAX package runs x64, so a constructor without a dtype breaks bit
# parity. The solver/ prefix covers every engine.
DTYPE_PATHS = (
    f"{PACKAGE}/ops/",
    f"{PACKAGE}/solver/",
)

# MET001 scans these for metric usage against metrics/__init__.py.
METRIC_SCAN_PATHS = (
    f"{PACKAGE}/scheduler.py",
    f"{PACKAGE}/resilience.py",
    f"{PACKAGE}/server/",
    f"{PACKAGE}/solver/",
    f"{PACKAGE}/sim/",
    f"{PACKAGE}/obs/",
    f"{PACKAGE}/fleet/",
    f"{PACKAGE}/rebalance/",
    f"{PACKAGE}/tuning/",
)


def default_context() -> AnalysisContext:
    return AnalysisContext(
        sanctioned_sync=SANCTIONED_SYNC_POINTS,
        device_roots=DEVICE_ROOTS,
        dtype_paths=DTYPE_PATHS,
        metric_scan_paths=METRIC_SCAN_PATHS,
        metric_attrs=None,  # resolved lazily from kubernetes_tpu_torch/metrics
    )
