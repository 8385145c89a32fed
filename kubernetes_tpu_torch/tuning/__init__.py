"""Closed-loop hot-path auto-tuning.

The engine exports a rich measurement surface — chain fraction,
unhidden reads per batch, h2d/d2h byte counters, per-chunk solve time,
slot discards, CAS conflicts — but the knobs that govern the hot path
were static: ``drain_backlog`` chunked by the byte model alone,
``stream_depth`` was a constant, ``pipeline_split`` used a one-off
EWMA rule, and the fleet write-behind flush size was hard-coded. This
package closes the loop from the live metrics back to those knobs:

- :mod:`window` — ``CounterWindow``: a bounded host-side sampler of
  the counters the loops already tick (no new device syncs), and the
  ONE home of the RTT / per-pod-solve estimators the pipeline-split
  rule reads — so the adaptive split rule and the split controller can
  never fight over the knob from two private estimates.
- :mod:`controllers` — ``HillClimber``: bounded hill-climbing with
  hysteresis (a move must beat the incumbent by a margin), revert on
  regression, and settle detection (stop probing once neither
  direction improves). An accepted A->B move requires
  ``obj(B) > obj(A) * (1 + hysteresis)``, so an A<->B oscillation is
  impossible by construction.
- :mod:`runtime` — ``TuningRuntime``: the per-knob controllers (drain
  chunk size, ``stream_depth``, ``pipeline_split``, fleet write-behind
  flush batch) under hard guardrails: a proposed chunk shape must pass
  ``solver/budget.py``'s HBM assertion BEFORE it is ever applied,
  stream-depth changes only take effect at ring-drain boundaries, and
  every adjustment is journaled (decision, trigger counters, old->new)
  through the ``scheduler_tuning_*`` metric family and ``tuning``
  spans.
- :mod:`profile` — tuned values persist as a standard
  ``KubeSchedulerConfiguration``-shaped document (tuned config in,
  standard config out): a cluster that converged once can pin the
  result statically with ``tuning.enabled: false``.

To pin a knob statically, set its config value (e.g.
``tpuSolver.streamDepth``) and drop it from ``tuning.knobs``.

Copied from ``kubernetes_tpu/tuning/__init__.py``.
"""

from .controllers import Decision, HillClimber
from .runtime import TuningConfig, TuningRuntime
from .window import CounterWindow

__all__ = [
    "CounterWindow",
    "Decision",
    "HillClimber",
    "TuningConfig",
    "TuningRuntime",
]
