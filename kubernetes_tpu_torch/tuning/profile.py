"""Tuned config in, standard config out (the ROADMAP item-5 discipline).

A scheduler that converged under the tuning runtime can pin the result:
``tuned_profile`` emits a standard ``KubeSchedulerConfiguration``-shaped
document whose ``tpuSolver`` (and, for fleet replicas, ``fleet``) keys
carry the tuned knob values — alongside the live solver settings the
knobs were tuned UNDER (batchSize, groupSize, meshDevices, tieBreak,
pallas: a tuned chunk size chosen for group 512 on an 8-way mesh is
meaningless under different ones) — with the ``tuning`` section
disabled. The document round-trips through ``config.types.load`` +
``scheduler_config`` into the same tuned hot path with zero tuning
machinery at runtime (tested in tests/test_tuning.py). Scope: this is
the SOLVER surface; profiles/extenders/rebalance sections are the
operator's own and should be merged from their deployment config. No
new config dialect: every value lands on exactly the key an operator
would hand-set.

Copied from ``kubernetes_tpu/tuning/profile.py``, without the ``fleet``
section and the ``pallas`` key (the port has neither) and without
``dump_yaml``: the document is a mapping, which ``config.types.load``
takes as it is.
"""

from __future__ import annotations

from .runtime import KNOB_CHUNK, KNOB_SPLIT, KNOB_STREAM_DEPTH

API_VERSION = "kubescheduler.config.k8s.io/v1"


def tuned_profile(scheduler) -> dict:
    """The standard-config document pinning ``scheduler``'s tuned knob
    values. Untuned knobs fall back to the scheduler's live config (the
    document is complete either way — loading it reproduces the running
    configuration, tuned or not)."""
    tuner = scheduler.tuner
    knobs = tuner.knob_values() if tuner is not None else {}
    cfg = scheduler.config
    doc: dict = {
        "apiVersion": API_VERSION,
        "kind": "KubeSchedulerConfiguration",
        "tpuSolver": {
            # the live solver settings the knobs were tuned under —
            # without them the pinned knob values describe a hot path
            # that no longer exists
            "batchSize": cfg.batch_size,
            "groupSize": scheduler.solver.config.group_size,
            "meshDevices": cfg.mesh_devices,
            "tieBreak": scheduler.solver.config.tie_break,
            "enablePreemption": cfg.enable_preemption,
            # the tuned knobs (live config where untuned)
            "streamDepth": int(
                knobs.get(KNOB_STREAM_DEPTH, cfg.stream_depth)
            ),
            "pipelineSplit": int(
                knobs.get(KNOB_SPLIT, cfg.pipeline_split)
            ),
            "backlogChunkPods": int(
                knobs.get(KNOB_CHUNK, cfg.backlog_chunk_pods)
            ),
        },
        # the emitted document is the STATIC pin: a scheduler loading
        # it runs the tuned values with the tuner off
        "tuning": {"enabled": False},
    }
    return doc
