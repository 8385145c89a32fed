"""Anomaly sentinel: multi-window regression rules over the health ring.

Watches the windowed samples the telemetry layer appends to the
:class:`~.timeseries.TimeSeriesRing` — sustained
pods/s, p99 via the SLO engine, stream chain fraction, slot/fence
discard rate, CAS-conflict rate, gang incomplete-round rate, breaker
state — and fires a typed :class:`Anomaly` when a signal regresses:

- **spike** — the fast window (``fast_windows`` samples) regresses
  against the slow baseline (the ``slow_windows`` samples before it)
  by ``spike_ratio`` for ``hysteresis`` consecutive windows;
- **drift** — the trailing slow window regresses against the slow
  window before it by ``drift_ratio`` (slow degradations a fast/slow
  ratio never catches because the baseline drifts along);
- **edge** — a discrete health event inside the window (a breaker
  trip) fires immediately: the breaker already applied hysteresis.

Hysteresis, per-signal cooldowns, a min-window warmup, and absolute
floors on the near-zero-baseline rates keep the sentinel quiet on
noise; evaluation is suppressed entirely while the auto-tuner is
mid-convergence — a probing tuner moves knobs ON PURPOSE, and PR 13's
rate-signature discipline says its self-inflicted rate swings must
never read as anomalies.

Firing journals a ``telemetry_anomaly`` record (a synthetic
``telemetry/<signal>`` pod key — pod-shaped for the schema, never a
cluster pod, so the completeness invariants ignore it), ticks
``scheduler_anomaly_total{signal}``, and flips :attr:`degraded` — the
hint the scheduler folds into the same degraded flag the fleet
exchange and the resilience breaker already publish.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import metrics
from .timeseries import TimeSeriesRing

# signal -> direction ("up" = rising is bad, "down" = falling is bad)
SIGNALS = {
    "pods_per_sec": "down",
    "p99_latency_s": "up",
    "chain_fraction": "down",
    "discard_rate": "up",
    "cas_conflict_rate": "up",
    "gang_incomplete_rate": "up",
    "breaker": "edge",
}

# near-zero-baseline rates: a spike/drift ratio over ~0 is noise, so
# these additionally need an absolute per-window event floor to fire
_EVENT_FLOOR = ("discard_rate", "cas_conflict_rate", "gang_incomplete_rate")


@dataclass(frozen=True)
class Anomaly:
    signal: str
    kind: str  # spike | drift | edge
    value: float
    baseline: float
    window_seq: int

    def describe(self) -> str:
        return (
            f"{self.signal} {self.kind}: value={self.value:.4f} "
            f"baseline={self.baseline:.4f} window={self.window_seq}"
        )


@dataclass
class SentinelConfig:
    # batches aggregated per window sample (the ring's granularity)
    window_batches: int = 8
    # fast/slow window widths, in samples
    fast_windows: int = 3
    slow_windows: int = 24
    # fast-vs-slow regression ratio that arms the spike rule
    spike_ratio: float = 2.0
    # slow-vs-previous-slow ratio that fires the drift rule
    drift_ratio: float = 1.5
    # consecutive regressed windows before a spike fires (hysteresis)
    hysteresis: int = 2
    # windows a fired signal stays silent before it can fire again
    cooldown_windows: int = 12
    # ring warmup: no rule evaluates before this many samples exist
    min_windows: int = 6
    # absolute per-window event floor for the near-zero-baseline rates
    min_events: float = 3.0
    # windows of clean samples before the degraded hint clears
    recover_windows: int = 6
    ring_capacity: int = 256

    def validate(self) -> None:
        if self.window_batches < 1:
            raise ValueError("sentinel.window_batches must be >= 1")
        if self.fast_windows < 1 or self.slow_windows < self.fast_windows:
            raise ValueError(
                "sentinel windows must satisfy 1 <= fast <= slow"
            )
        if self.spike_ratio <= 1.0 or self.drift_ratio <= 1.0:
            raise ValueError("sentinel ratios must be > 1.0")


class AnomalySentinel:
    """Evaluates the regression rules each time a window sample lands.

    Driver-thread only (rides the same commit seam as the SLO engine);
    ``snapshot`` is safe from any thread (the ring locks internally,
    the scalars are read racily but atomically).
    """

    def __init__(self, config: SentinelConfig | None = None) -> None:
        self.config = config or SentinelConfig()
        self.config.validate()
        self.ring = TimeSeriesRing(self.config.ring_capacity)
        # consecutive regressed windows per signal (the hysteresis arm)
        self._streak: dict[str, int] = {}
        # window seq until which a fired signal stays silent
        self._cooldown_until: dict[str, int] = {}
        self._clean_since_fire = 0
        self.fired: list[Anomaly] = []
        self.fired_total = 0
        self.degraded = False
        self.suppressed_windows = 0

    # -- the per-window evaluation --

    def observe_window(
        self, sample, *, suppress: bool = False
    ) -> list[Anomaly]:
        """Evaluate every rule against the ring (``sample`` is the
        window just appended). ``suppress`` skips the regression rules
        (tuner mid-probe) — edges still fire: a breaker trip is never
        the tuner's doing."""
        cfg = self.config
        out: list[Anomaly] = []
        seq = sample.seq
        # edge signals first: discrete events, no baseline needed
        if sample.signals.get("breaker", 0.0) > 0.0 and self._armed(
            "breaker", seq
        ):
            out.append(
                Anomaly(
                    signal="breaker", kind="edge",
                    value=sample.signals["breaker"], baseline=0.0,
                    window_seq=seq,
                )
            )
        if suppress:
            self.suppressed_windows += 1
            self._streak.clear()
        elif len(self.ring) >= cfg.min_windows:
            for signal, direction in SIGNALS.items():
                if direction == "edge":
                    continue
                a = self._evaluate(signal, direction, sample, seq)
                if a is not None:
                    out.append(a)
        for a in out:
            self._cooldown_until[a.signal] = seq + cfg.cooldown_windows
            self._streak.pop(a.signal, None)
            self.fired.append(a)
            self.fired_total += 1
            metrics.anomaly_total.labels(a.signal).inc()
        if len(self.fired) > 64:
            del self.fired[:-64]
        if out:
            self.degraded = True
            self._clean_since_fire = 0
        elif self.degraded:
            self._clean_since_fire += 1
            if self._clean_since_fire >= cfg.recover_windows:
                self.degraded = False
        return out

    def _armed(self, signal: str, seq: int) -> bool:
        return seq >= self._cooldown_until.get(signal, 0)

    def _regressed(self, direction: str, value: float, base: float,
                   ratio: float) -> bool:
        if direction == "up":
            return value >= base * ratio and value > 0.0
        # "down": a collapse against a meaningful baseline
        return base > 0.0 and value * ratio <= base

    def _evaluate(self, signal, direction, sample, seq) -> Anomaly | None:
        cfg = self.config
        if not self._armed(signal, seq):
            return None
        value = sample.signals.get(signal, 0.0)
        if signal in _EVENT_FLOOR and value < cfg.min_events:
            self._streak.pop(signal, None)
            return None
        fast = self.ring.mean(signal, cfg.fast_windows)
        slow_base = self.ring.mean_prev(
            signal, cfg.slow_windows, skip=cfg.fast_windows
        )
        if self._regressed(direction, fast, slow_base, cfg.spike_ratio):
            streak = self._streak.get(signal, 0) + 1
            self._streak[signal] = streak
            if streak >= cfg.hysteresis:
                return Anomaly(
                    signal=signal, kind="spike", value=fast,
                    baseline=slow_base, window_seq=seq,
                )
            return None
        self._streak.pop(signal, None)
        # drift: two adjacent slow windows (needs 2x slow of history)
        if len(self.ring) >= 2 * cfg.slow_windows:
            slow = self.ring.mean(signal, cfg.slow_windows)
            prev = self.ring.mean_prev(
                signal, cfg.slow_windows, skip=cfg.slow_windows
            )
            if self._regressed(direction, slow, prev, cfg.drift_ratio):
                return Anomaly(
                    signal=signal, kind="drift", value=slow,
                    baseline=prev, window_seq=seq,
                )
        return None

    # -- surfaces --

    def snapshot(self) -> dict:
        return {
            "degraded": self.degraded,
            "fired_total": self.fired_total,
            "suppressed_windows": self.suppressed_windows,
            "recent_anomalies": [
                {
                    "signal": a.signal,
                    "kind": a.kind,
                    "value": round(a.value, 6),
                    "baseline": round(a.baseline, 6),
                    "window": a.window_seq,
                }
                for a in self.fired[-16:]
            ],
            "windows": self.ring.snapshot(16),
        }


@dataclass(frozen=True)
class SyntheticPod:
    """Pod-shaped carrier for non-pod journal records: the
    ``telemetry_anomaly`` outcome attaches to ``telemetry/<signal>``,
    a key no cluster pod can have (pod names can't contain ``/`` twice
    under the ``ns/name`` convention), so journal-completeness
    invariants — which iterate real cluster pods — never see it."""

    key: str
    uid: str = ""
    name: str = ""
    namespace: str = ""
