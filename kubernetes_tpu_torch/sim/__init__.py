"""Deterministic cluster simulator + fault-injection harness.

Drives the real :class:`~kubernetes_tpu_torch.scheduler.Scheduler` (both the
synchronous and pipelined loops) through the real
:class:`~kubernetes_tpu_torch.state.cluster.ClusterState` under seeded churn
and injected faults, on ``FakeClock`` virtual time, checking
correctness invariants after every drive and recording a replayable
trace. See ``kubernetes_tpu/sim/README.md`` for profiles, fault points,
and the replay workflow; CLI: ``python -m kubernetes_tpu_torch.sim --help``.

Copied from ``kubernetes_tpu/sim/__init__.py``.
"""

from .harness import SimHarness, SimResult, replay_trace, run_sim
from .invariants import Violation
from .profiles import PROFILES, Profile, get_profile
from .trace import TraceError, TraceReader, TraceWriter

__all__ = [
    "SimHarness",
    "SimResult",
    "run_sim",
    "replay_trace",
    "Violation",
    "Profile",
    "PROFILES",
    "get_profile",
    "TraceWriter",
    "TraceReader",
    "TraceError",
]
