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

Copied from ``kubernetes_tpu/obs/__init__.py``: the flight telemetry
(``Telemetry``: the per-stage profiler, the anomaly sentinel and the
capture-on-anomaly bundle capturer) drives the port's Scheduler, whose
``ExactSolver.capture_hook`` hands each armed solve's inputs to the
capturer; ``obs/bundle.py`` replays a bundle through the port's solver.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import metrics
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
from .bundle import BundleCapturer, load_bundle, replay_bundle
from .profile import StageProfiler
from .recorder import FlightRecorder, canonical
from .sentinel import AnomalySentinel, SentinelConfig, SyntheticPod
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
    "AnomalySentinel",
    "SentinelConfig",
    "SyntheticPod",
    "BundleCapturer",
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
    # anomaly sentinel over the windowed health ring (obs/sentinel.py);
    # a SentinelConfig enables it (sentinel implies the profiler's
    # batch tick: the sentinel windows ride the same commit seam)
    sentinel: "SentinelConfig | None" = None
    # capture-on-anomaly replay bundles (obs/bundle.py): directory the
    # bundles are written to. None with sentinel set = captures COUNT
    # (and the in-memory record ring runs) but nothing hits disk —
    # what the sim's determinism selfcheck re-run uses.
    bundle_dir: str | None = None
    # complete solve records retained in memory (the capture ring)
    bundle_keep: int = 4
    # bundle directories one process may write (forensics, not a log)
    bundle_max: int = 8


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
    holding the profiler, the sentinel (+ its health ring), and the
    bundle capturer, driven from the commit seam both loops share.

    The scheduler's hot path pays one ``is not None`` check when
    telemetry is off; when on, every write here is host-side arithmetic
    over numbers the loops already computed (TPU001-clean — the whole
    layer rides inside bench ladder #13's <= 5% obs budget)."""

    def __init__(
        self,
        *,
        clock: Clock | None = None,
        profiler: StageProfiler | None = None,
        sentinel: AnomalySentinel | None = None,
        bundles: BundleCapturer | None = None,
        journal: PodDecisionJournal | None = None,
        recorder: FlightRecorder | None = None,
    ) -> None:
        self.clock = clock or Clock()
        self.profiler = profiler
        self.sentinel = sentinel
        self.bundles = bundles
        self.journal = journal
        self.recorder = recorder
        self.anomalies: list = []  # every Anomaly fired, for surfaces
        # window accumulation state (driver thread only)
        self._win_batches = 0
        self._win_pods = 0
        self._win_t0: float | None = None
        self._last = {
            "chained": 0.0,
            "discards": 0.0,
            "cas": 0.0,
            "gang": 0.0,
            "trips": 0.0,
        }

    # -- stage attribution passthrough (scheduler seams) --

    def add_stage(self, stage: str, seconds: float) -> None:
        if self.profiler is not None:
            self.profiler.add(stage, seconds)

    def add_solve(self, times) -> None:
        """One solve call's sub-stages and counts (solver/timing.py)."""
        if self.profiler is not None:
            self.profiler.add_solve(times)

    # -- the per-batch tick (commit seam, next to the SLO engine) --

    def observe_batch(self, scheduler, *, step: int, pods: int) -> None:
        """Close the batch's profile ledger entry; every
        ``sentinel.config.window_batches`` batches, aggregate a window
        sample and run the sentinel's regression rules."""
        if self.profiler is not None:
            self.profiler.observe_batch(step=step, pods=pods)
        if self.sentinel is None:
            return
        now = self.clock.perf()
        if self._win_t0 is None:
            self._win_t0 = now
        self._win_batches += 1
        self._win_pods += pods
        if self._win_batches < self.sentinel.config.window_batches:
            return
        wall = max(now - self._win_t0, 1e-9)
        signals = self._window_signals(scheduler, wall)
        sample = self.sentinel.ring.append(
            t=now,
            batches=self._win_batches,
            pods=self._win_pods,
            signals=signals,
        )
        self._win_batches = 0
        self._win_pods = 0
        self._win_t0 = now
        # PR 13's rate-signature discipline: a probing tuner moves
        # knobs on purpose — its self-inflicted swings must not fire
        tuner = getattr(scheduler, "tuner", None)
        suppress = (
            tuner is not None
            and not getattr(tuner, "frozen", False)
            and not tuner.settled()
        )
        fired = self.sentinel.observe_window(sample, suppress=suppress)
        for a in fired:
            self.anomalies.append(a)
            if self.journal is not None:
                self.journal.record(
                    step,
                    getattr(scheduler.queue, "scheduling_cycle", 0),
                    SyntheticPod(key=f"telemetry/{a.signal}"),
                    "telemetry_anomaly",
                    reason=a.describe(),
                )
            self.capture("sentinel", note=a.describe())

    def _window_signals(self, scheduler, wall: float) -> dict:
        """One window's health-signal values, every one a host-side
        delta or an SLO-engine read (the CounterWindow discipline).
        The event-rate signals are raw per-window event counts — the
        sentinel's ``min_events`` floor is defined over them."""
        from .profile import _cell, _labeled_total

        chained = 0.0
        for s in getattr(scheduler, "solvers", {}).values():
            chained += s.dispatch_counts.get("stream_chained", 0)
        discards = _cell(metrics.solves_discarded_total) + _cell(
            metrics.stream_slot_discard_total
        )
        cas = _labeled_total(metrics.fleet_admit_cas_conflict_total)
        gang = _cell(metrics.gang_incomplete_total)
        resilience = getattr(scheduler, "resilience", None)
        trips = (
            float(resilience.summary().get("trips", 0))
            if resilience is not None
            else 0.0
        )
        deltas = {}
        for key, cur in (
            ("chained", chained),
            ("discards", discards),
            ("cas", cas),
            ("gang", gang),
            ("trips", trips),
        ):
            deltas[key] = max(cur - self._last[key], 0.0)
            self._last[key] = cur
        slo = getattr(scheduler, "slo", None)
        p99 = slo.latency_quantiles()[1] if slo is not None else 0.0
        n = max(self._win_batches, 1)
        return {
            "pods_per_sec": self._win_pods / wall,
            "p99_latency_s": float(p99 or 0.0),
            "chain_fraction": min(deltas["chained"] / n, 1.0),
            "discard_rate": deltas["discards"],
            "cas_conflict_rate": deltas["cas"],
            "gang_incomplete_rate": deltas["gang"],
            "breaker": 1.0 if deltas["trips"] > 0 else 0.0,
        }

    # -- the capture trigger (any telemetry-relevant event funnels here) --

    def capture(self, trigger: str, note: str = "") -> str | None:
        """Snapshot the newest complete solve record into a bundle.
        Safe no-op without a capturer; the journal tail, flight slice,
        and metrics snapshot ride along when available."""
        if self.bundles is None:
            return None
        tail: list[str] = []
        if self.journal is not None:
            tail = list(self.journal.lines)[-200:]
        flight: list[str] = []
        if self.recorder is not None:
            flight = self.recorder.lines()
        return self.bundles.capture(
            trigger.split(":", 1)[0] if ":" in trigger else trigger,
            note=note or trigger,
            journal_tail=tail,
            flight_lines=flight,
            metrics_text=metrics.render(),
        )

    @property
    def degraded(self) -> bool:
        return self.sentinel is not None and self.sentinel.degraded

    def snapshot(self) -> dict:
        """The ``GET /debug/profile`` body: profile + sentinel + bundle
        state, one JSON-ready dict (each piece locks internally)."""
        out: dict = {"enabled": True}
        if self.profiler is not None:
            out["profile"] = self.profiler.snapshot()
        if self.sentinel is not None:
            out["sentinel"] = self.sentinel.snapshot()
        if self.bundles is not None:
            out["bundles"] = self.bundles.snapshot()
        return out


def build_telemetry(
    cfg: ObsConfig | None,
    clock: Clock | None = None,
    *,
    journal: PodDecisionJournal | None = None,
    recorder: FlightRecorder | None = None,
) -> Telemetry | None:
    """The telemetry stack for one Scheduler, or None when every piece
    is off (the production default — the hot path then pays a single
    attribute check)."""
    if cfg is None or not (
        cfg.profile or cfg.sentinel is not None or cfg.bundle_dir
    ):
        return None
    profiler = (
        StageProfiler(clock=clock)
        if (cfg.profile or cfg.sentinel is not None)
        else None
    )
    sentinel = (
        AnomalySentinel(cfg.sentinel) if cfg.sentinel is not None else None
    )
    bundles = None
    if cfg.bundle_dir is not None or cfg.sentinel is not None:
        bundles = BundleCapturer(
            cfg.bundle_dir, keep=cfg.bundle_keep, max_bundles=cfg.bundle_max
        )
    return Telemetry(
        clock=clock,
        profiler=profiler,
        sentinel=sentinel,
        bundles=bundles,
        journal=journal,
        recorder=recorder,
    )
