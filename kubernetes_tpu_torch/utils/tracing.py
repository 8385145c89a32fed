"""Profiling traces around the scheduling batches: a ``torch.profiler``
session (CPU and, on the card, CUDA activity) with one
``record_function`` range per batch of every loop (``schedule_batch``,
``run_pipelined``, ``run_streaming``) and one per solve sub-stage
(``solver/timing.py``: prepare, upload, issue, card_read, capture), plus
the per-stage wall-time histograms the metrics module already exports
under the reference's names.

Enable programmatically with ``enable(dir)`` (the same switch as the JAX
package's ``utils/tracing.py``): the first annotated batch starts the
session, and ``stop()`` writes it to ``DIR/trace.json`` as a Chrome trace
(chrome://tracing or Perfetto). Tracing is off by default — the
profiler's overhead belongs in a debugging session, not the hot path.

Ported from ``kubernetes_tpu/utils/tracing.py`` (``jax.profiler`` there).
"""

from __future__ import annotations

import contextlib
import os

_trace_dir: str | None = None
_profiler = None


def enable(trace_dir: str) -> None:
    global _trace_dir
    _trace_dir = trace_dir


def enabled() -> bool:
    return _trace_dir is not None


_OFF = contextlib.nullcontext()


def step(name: str, step_num: int = 0):
    """Annotate one scheduling batch; starts the session lazily on first
    use so importing this module never touches the profiler. With no
    session, a shared no-op context."""
    if _trace_dir is None:
        return _OFF
    return _step(name, step_num)


def stage(name: str):
    """A range around one sub-stage of a batch, inside its ``step``; with
    no session, a shared no-op context."""
    if _trace_dir is None:
        return _OFF
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _step(name: str, step_num: int):
    global _profiler
    import torch

    if _profiler is None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _profiler = torch.profiler.profile(activities=acts)
        _profiler.start()
    with torch.profiler.record_function(f"{name}#{step_num}"):
        yield


def stop() -> str | None:
    """End the session and write its trace; returns the file written
    (None when no session was started)."""
    global _profiler
    if _profiler is None:
        return None
    prof, _profiler = _profiler, None
    prof.stop()
    os.makedirs(_trace_dir, exist_ok=True)
    path = os.path.join(_trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
