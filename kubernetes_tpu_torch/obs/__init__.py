"""kubernetes_tpu.obs — the end-to-end scheduling trace layer.

Three cooperating pieces, all zero-dep and virtual-time-clean:

- **spans** (``span.py``): OTel-shaped host-side spans threaded through
  both scheduler loops (enqueue → snapshot → tensorize → fold/extender
  → dispatch → fence → apply → bind) and the extender server's
  micro-batcher; exported as JSONL and into the flight recorder.
- **per-pod decision journal** (``journal.py``): one record per pod per
  solved batch — outcome plus per-plugin filter attribution pulled from
  the host-materialized solve tensors, so "why is pod X pending" has a
  concrete answer ("NodeResourcesFit rejected 14/16 nodes, ...").
- **flight recorder** (``recorder.py``): bounded ring of recent spans +
  decisions, dumped on crash, on sim invariant violation, and on demand
  via ``GET /debug/flightrecorder`` / ``/debug/spans``.

``python -m kubernetes_tpu.obs explain <pod> [--trace FILE | --url U]``
reconstructs a pod's history from any of those sources (``explain.py``).

Everything is OFF by default: ``build_obs(None, clock)`` returns a
disabled tracer and no journal/recorder, and the scheduler's hot path
then pays one attribute check per would-be span — no allocation, no
host↔device syncs (TPU001 stays clean; verified by the analyzer gate).

Copied from ``kubernetes_tpu/obs/__init__.py``, less the anomaly sentinel
and the bundle capturer (the port's scheduler refuses both until its
solver has a capture hook, ROADMAP queue 1 item 8); ``obs/bundle.py``
keeps the load and replay of a bundle the JAX package captured.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.clock import Clock
from .explain import (
    Explanation,
    explain_pod,
    merge_fleet_records,
    parse_stream,
)
from .journal import (
    OUTCOMES,
    TERMINAL_OUTCOMES,
    PodDecisionJournal,
    attribute_failure,
    fleet_merge_key,
    summarize_plugins,
    validate_line,
    validate_lines,
)
from .bundle import load_bundle, replay_bundle
from .profile import StageProfiler
from .recorder import FlightRecorder, canonical
from .slo import SloConfig, SloEngine
from .span import Span, Tracer

__all__ = [
    "ObsConfig",
    "build_obs",
    "build_telemetry",
    "Telemetry",
    "Tracer",
    "Span",
    "PodDecisionJournal",
    "FlightRecorder",
    "Explanation",
    "SloConfig",
    "SloEngine",
    "StageProfiler",
    "load_bundle",
    "replay_bundle",
    "explain_pod",
    "merge_fleet_records",
    "parse_stream",
    "attribute_failure",
    "fleet_merge_key",
    "summarize_plugins",
    "validate_line",
    "validate_lines",
    "canonical",
    "OUTCOMES",
    "TERMINAL_OUTCOMES",
]


@dataclass
class ObsConfig:
    """Observability knobs carried on SchedulerConfig.obs (None = all
    off, the production default)."""

    spans: bool = False  # emit spans from the scheduler loops
    journal: bool = False  # per-pod decision journal
    span_capacity: int = 4096  # flight-recorder ring sizes
    decision_capacity: int = 8192
    # in-memory journal line retention: None = unbounded (the sim needs
    # the full history); serve passes a bound and streams to
    # journal_path for durability
    journal_capacity: int | None = None
    # streaming JSONL sinks (append-mode files); None = in-memory only
    spans_path: str | None = None
    journal_path: str | None = None
    # crash / invariant-violation dump target for the flight recorder
    dump_path: str | None = None
    # live SLO engine (obs/slo.py): an SloConfig enabling the sliding-
    # window p50/p99 latency, bind throughput, and multi-window error-
    # budget burn computation (scheduler_slo_* metrics + GET
    # /debug/slo + the degraded-health signal). None = off. Independent
    # of spans/journal — the engine reads only BatchResult numbers the
    # loops already compute.
    slo: SloConfig | None = None
    # deterministic 1-in-N sampling for the PER-WATCH-EVENT enqueue
    # span — the one span family whose volume scales with event rate
    # (tens of thousands/s at sustained-stream scale) rather than with
    # batches. The first event is always sampled and the counter is
    # deterministic, so same-seed sim runs stay byte-identical. 1 =
    # span every event (the PR 3 behavior). Batch-level spans
    # (schedule_batch/dispatch/apply/bind/...) are never sampled: they
    # are the trace's structure. The shipped default keeps the whole
    # obs layer inside the <= 5% sustained-throughput budget bench
    # ladder #13 asserts.
    enqueue_span_sample_n: int = 64
    # deterministic 1-in-N sampling for the PER-POD bind span (the
    # other per-pod-volume family). The decision JOURNAL stays
    # complete — one record per pod per batch, never sampled; the bind
    # span only adds the commit's wall duration, which N-sampling
    # preserves statistically. First bind always sampled; 1 = every
    # bind (PR 3 behavior).
    bind_span_sample_n: int = 8
    # -- flight telemetry (profile -> detect -> capture -> replay) --
    # continuous per-stage profiler (obs/profile.py): the bounded
    # per-batch stage ledger + scheduler_profile_stage_seconds{stage}
    profile: bool = False
    # the anomaly sentinel and capture-on-anomaly replay bundles are
    # not ported: the Scheduler refuses either one set (its ExactSolver
    # has no capture_hook yet, ROADMAP queue 1 item 8)
    sentinel: object | None = None
    bundle_dir: str | None = None


class _FileSink:
    """Append-mode JSONL line writer (flushed per line: a crash must
    not lose the records explaining it)."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "a")

    def __call__(self, rec: dict) -> None:
        self._f.write(canonical(rec) + "\n")
        self._f.flush()


def build_obs(
    cfg: ObsConfig | None, clock: Clock | None = None
) -> tuple[Tracer, PodDecisionJournal | None, FlightRecorder | None]:
    """(tracer, journal, flight recorder) for one Scheduler. With cfg
    None or everything disabled: a disabled Tracer and two Nones."""
    if cfg is None or not (cfg.spans or cfg.journal):
        return Tracer(clock=clock, enabled=False), None, None
    recorder = FlightRecorder(
        span_capacity=cfg.span_capacity,
        decision_capacity=cfg.decision_capacity,
        dump_path=cfg.dump_path,
    )
    tracer = Tracer(
        clock=clock,
        enabled=cfg.spans,
        recorder=recorder,
        sink=_FileSink(cfg.spans_path) if cfg.spans_path else None,
    )
    journal = None
    if cfg.journal:
        journal = PodDecisionJournal(
            clock=clock,
            recorder=recorder,
            sink=_FileSink(cfg.journal_path) if cfg.journal_path else None,
            capacity=cfg.journal_capacity,
        )
    return tracer, journal, recorder


class Telemetry:
    """The flight-telemetry coordinator: one object on the scheduler
    holding the per-stage profiler, driven from the commit seam.

    The scheduler's hot path pays one ``is not None`` check when
    telemetry is off; when on, every write here is host-side arithmetic
    over numbers the loops already computed. The JAX package's
    coordinator also holds the anomaly sentinel and the bundle capturer,
    which the port does not have yet (ROADMAP queue 1 item 8)."""

    def __init__(
        self,
        *,
        clock: Clock | None = None,
        profiler: StageProfiler | None = None,
    ) -> None:
        self.clock = clock or Clock()
        self.profiler = profiler

    # -- stage attribution passthrough (scheduler seams) --

    def add_stage(self, stage: str, seconds: float) -> None:
        if self.profiler is not None:
            self.profiler.add(stage, seconds)

    # -- the per-batch tick (commit seam, next to the SLO engine) --

    def observe_batch(self, scheduler, *, step: int, pods: int) -> None:
        """Close the batch's profile ledger entry."""
        if self.profiler is not None:
            self.profiler.observe_batch(step=step, pods=pods)


def build_telemetry(
    cfg: ObsConfig | None, clock: Clock | None = None
) -> Telemetry | None:
    """The telemetry stack for one Scheduler, or None when it is off (the
    production default — the hot path then pays a single attribute
    check)."""
    if cfg is None or not cfg.profile:
        return None
    return Telemetry(clock=clock, profiler=StageProfiler(clock=clock))
