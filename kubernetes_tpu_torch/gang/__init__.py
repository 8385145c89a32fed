"""Gang scheduling + heterogeneity-aware placement (the DL-training
workload layer).

Pod groups are declared on the existing API objects — no new kinds:

- ``scheduling.x-k8s.io/pod-group`` (label): the group name; the gang
  id is ``namespace/name`` (a gang never spans namespaces);
- ``scheduling.x-k8s.io/pod-group-min-member`` (annotation): the
  all-or-nothing quorum. The gang is solved only once at least this
  many members are known to the queue, and either every solved member
  binds in ONE atomic commit (``ClusterState.bind_gang``) or every
  placement is released and the gang requeues with a
  ``gang_incomplete`` journal outcome. A partial gang is never bound.
- ``scheduling.x-k8s.io/workload-class`` (pod label) +
  ``scheduling.x-k8s.io/accelerator-class`` (node label): the
  heterogeneity axis. ``fold_throughput`` folds the configured
  per-(workload, accelerator-class) effective-throughput matrix into
  the score pipeline's extra-score table (Gavel's objective: land the
  gang where throughput-per-chip is highest, not merely where it
  fits).

The tracker (``GangTracker``) is pure host-side bookkeeping: gang
membership readiness, assembly timestamps, and the
consecutive-incomplete count that eventually quarantines a gang no
placement will ever satisfy.

Copied from ``kubernetes_tpu/gang/__init__.py``.
"""

from .tracker import (
    GANG_LABEL,
    MIN_MEMBER_ANNOTATION,
    GangConfig,
    GangTracker,
    GangUnsatisfiableError,
)
from .throughput import (
    ACCEL_CLASS_LABEL,
    WORKLOAD_CLASS_LABEL,
    fold_throughput,
    load_throughput_table,
)

__all__ = [
    "GANG_LABEL",
    "MIN_MEMBER_ANNOTATION",
    "ACCEL_CLASS_LABEL",
    "WORKLOAD_CLASS_LABEL",
    "GangConfig",
    "GangTracker",
    "GangUnsatisfiableError",
    "fold_throughput",
    "load_throughput_table",
]
