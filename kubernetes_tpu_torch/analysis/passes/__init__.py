"""The analyzer's rule set.

Two tiers:

- **ALL_PASSES** — per-module passes (one file at a time): cheap
  scoping passes first, cross-file MET001 last.
- **ALL_PROJECT_PASSES** — project passes, run ONCE over the whole
  analyzed set against the cross-module call graph
  (:mod:`..project`): lock-order deadlock detection, fence and retry
  discipline, cross-module host-sync escape, metrics-doc drift.

Copied from ``kubernetes_tpu/analysis/passes/__init__.py``.
"""

from __future__ import annotations

from .hostsync import HostSyncPass
from .tracedbranch import TracedBranchPass
from .dtypes import DtypeDisciplinePass
from .locks import LockDisciplinePass
from .metricnames import MetricNamePass
from .lockorder import LockOrderPass
from .fence import FencePass
from .retry import RetryPass
from .xsync import CrossModuleSyncPass
from .metricsdoc import MetricsDocPass

ALL_PASSES = (
    HostSyncPass,
    TracedBranchPass,
    DtypeDisciplinePass,
    LockDisciplinePass,
    MetricNamePass,
)

ALL_PROJECT_PASSES = (
    LockOrderPass,
    FencePass,
    RetryPass,
    CrossModuleSyncPass,
    MetricsDocPass,
)

__all__ = [
    "ALL_PASSES",
    "ALL_PROJECT_PASSES",
    "HostSyncPass",
    "TracedBranchPass",
    "DtypeDisciplinePass",
    "LockDisciplinePass",
    "MetricNamePass",
    "LockOrderPass",
    "FencePass",
    "RetryPass",
    "CrossModuleSyncPass",
    "MetricsDocPass",
]
