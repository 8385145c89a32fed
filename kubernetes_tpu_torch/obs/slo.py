"""Live SLO engine: are we meeting latency SLOs *right now*, answered
from counters the scheduling loops already tick — no bench ladder run,
no new device syncs (the PR 13 ``CounterWindow`` sampling discipline:
host-side reads of numbers the apply path already materialized).

One ``SloEngine`` per Scheduler, ticked from ``_record_metrics`` (the
chokepoint every dispatch loop — sync, pipelined, streaming, drain —
funnels applied batches through):

- **sliding-window pod latency** — p50/p99 of first-enqueue→bind (the
  ladder's sustained-latency definition, ``BatchResult.e2e_latencies``,
  already computed per batch) over a bounded sample pool;
- **bind throughput** — pods bound per wall second over the window;
- **multi-window error-budget burn rate** — the SRE burn-rate form:
  (observed bad fraction) / (allowed bad fraction), where an event is
  *bad* when a bound pod missed the latency objective or a binding
  failed. A burn of 1.0 consumes the budget exactly at the sustainable
  rate; the short window catches fast burns, the long window slow ones;
- **degraded-health signal** — ``healthy`` flips false while the short
  window burns faster than ``degraded_burn`` (with a minimum event
  count so an idle scheduler's first hiccup cannot flip it). Consumers:
  the fleet tier publishes it through the occupancy exchange so handoff
  chains route refugees to healthy replicas (the breaker's degraded
  flag discipline), and the resilience layer defers half-open breaker
  probes while it is set (don't re-probe a suspect top tier while the
  error budget is already burning).

Exported as the ``scheduler_slo_*`` metric family and served as one
JSON document at ``GET /debug/slo``.

Everything is driver-thread-only host arithmetic off the injectable
``Clock`` — a FakeClock sim drive produces deterministic SLO output.

Copied from ``kubernetes_tpu/obs/slo.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .. import metrics


@dataclass
class SloConfig:
    """Carried on ``ObsConfig.slo`` (None = engine off)."""

    # per-pod latency objective, first queue entry -> bind commit
    latency_objective_s: float = 30.0
    # target fraction of events meeting the objective; the error budget
    # is (1 - target)
    availability_target: float = 0.99
    # sliding window backing p50/p99 + throughput
    window_s: float = 300.0
    # multi-window burn rates, shortest first (the shortest also drives
    # the degraded-health signal)
    burn_windows: tuple = (60.0, 300.0, 3600.0)
    # short-window burn rate beyond which health reads degraded
    degraded_burn: float = 2.0
    # minimum events in the short window before health may flip (an
    # idle scheduler's only pod failing must not read as an outage)
    min_events: int = 20
    # bounded latency sample pool (memory cap; the window prune usually
    # bounds it first)
    sample_capacity: int = 4096
    # minimum seconds between quantile/throughput gauge recomputations:
    # the percentile sort over the sample pool is the engine's one
    # non-O(1) step, and re-sorting per batch at sustained-stream batch
    # rates is measurable against the obs-overhead budget. Health/burn
    # still evaluate every observe (cheap bucket loop). 0 = every
    # observe (tests).
    export_interval_s: float = 1.0

    def validate(self) -> None:
        if self.latency_objective_s <= 0:
            raise ValueError("slo.latency_objective_s must be > 0")
        if not 0.0 < self.availability_target < 1.0:
            raise ValueError("slo.availability_target must be in (0, 1)")
        if not self.burn_windows or any(
            w <= 0 for w in self.burn_windows
        ):
            raise ValueError("slo.burn_windows must be positive")


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile over an already-sorted list (the ladder's
    p99 formula: index 0.99 * (n - 1))."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


@dataclass
class _Bucket:
    """One observed batch: timestamp + good/bad event counts + bound
    pods (throughput numerator)."""

    t: float
    good: int
    bad: int
    bound: int


class SloEngine:
    """Driver-thread-only; every mutation happens inside the scheduler's
    metrics-recording chokepoint."""

    def __init__(self, config: SloConfig | None, clock) -> None:
        self.config = config or SloConfig()
        self.config.validate()
        self.clock = clock
        # (t, latency) samples inside the sliding window
        self._latencies: deque = deque(
            maxlen=self.config.sample_capacity
        )
        # per-batch event buckets, pruned to the LONGEST burn window
        self._buckets: deque[_Bucket] = deque()
        # incremental short-window accounting (the per-observe health
        # check must be O(1), not a bucket scan — an hour-long horizon
        # holds ~1e5 buckets at sustained-stream batch rates): a
        # second deque over the SHORT window only, with running sums
        self._short: deque[_Bucket] = deque()
        self._short_good = 0
        self._short_bad = 0
        self.healthy = True
        self.degraded_flips = 0  # python-side counter (sim footers)
        self._last_export = float("-inf")
        # callbacks fired with the new health bool on every flip (the
        # scheduler wires the fleet degraded flag + resilience here)
        self.on_health_change: list = []
        self._burn_gauges = {
            w: metrics.slo_error_budget_burn.labels(f"{int(w)}s")
            for w in self.config.burn_windows
        }
        metrics.slo_healthy.set(1)

    # -- ingest --

    def observe_batch(self, res) -> None:
        """Fold one applied ``BatchResult`` in: bound pods' e2e
        latencies, bind failures as budget-burning events."""
        now = self.clock.now()
        cfg = self.config
        bad = sum(
            1 for x in res.e2e_latencies if x > cfg.latency_objective_s
        )
        bad += len(res.bind_failures)
        good = len(res.e2e_latencies) - (bad - len(res.bind_failures))
        bound = len(res.scheduled)
        for x in res.e2e_latencies:
            self._latencies.append((now, x))
        if good or bad or bound:
            bucket = _Bucket(now, good, bad, bound)
            self._buckets.append(bucket)
            self._short.append(bucket)
            self._short_good += good
            self._short_bad += bad
        self._prune(now)
        self._export(now)

    def _prune(self, now: float) -> None:
        w = self.config.window_s
        while self._latencies and now - self._latencies[0][0] > w:
            self._latencies.popleft()
        horizon = max(self.config.burn_windows)
        while self._buckets and now - self._buckets[0].t > horizon:
            self._buckets.popleft()
        short = self.config.burn_windows[0]
        while self._short and now - self._short[0].t > short:
            b = self._short.popleft()
            self._short_good -= b.good
            self._short_bad -= b.bad

    # -- the numbers --

    def latency_quantiles(self) -> tuple[float, float]:
        vals = sorted(x for _, x in self._latencies)
        return _quantile(vals, 0.5), _quantile(vals, 0.99)

    def throughput(self, now: float | None = None) -> float:
        """Pods bound per second over the sliding window (ratio of
        sums — the CounterWindow.rate discipline). 0.0 until the
        window spans any time at all: the first batch's bucket is
        stamped with the same clock reading `now` carries, and
        dividing by that near-zero span would export an absurd
        pods/nanosecond gauge (review-caught)."""
        now = self.clock.now() if now is None else now
        w = self.config.window_s
        bound = sum(b.bound for b in self._buckets if now - b.t <= w)
        if not bound:
            return 0.0
        ts = [b.t for b in self._buckets if now - b.t <= w]
        span = now - min(ts)
        if span <= 1e-3:
            return 0.0  # one instant is not a rate
        return bound / span

    def burn_rate(self, window_s: float, now: float | None = None) -> float:
        """Error-budget burn over the trailing ``window_s``: observed
        bad fraction / allowed bad fraction. 0.0 with no events."""
        now = self.clock.now() if now is None else now
        good = bad = 0
        for b in self._buckets:
            if now - b.t <= window_s:
                good += b.good
                bad += b.bad
        total = good + bad
        if not total:
            return 0.0
        budget = 1.0 - self.config.availability_target
        return (bad / total) / max(budget, 1e-9)

    def window_events(self, window_s: float, now: float | None = None) -> int:
        now = self.clock.now() if now is None else now
        return sum(
            b.good + b.bad for b in self._buckets if now - b.t <= window_s
        )

    # -- export + health --

    def _export(self, now: float) -> None:
        if now - self._last_export >= self.config.export_interval_s:
            self._last_export = now
            p50, p99 = self.latency_quantiles()
            metrics.slo_p50_pod_latency_seconds.set(p50)
            metrics.slo_p99_pod_latency_seconds.set(p99)
            metrics.slo_bind_throughput.set(self.throughput(now))
            for w, gauge in self._burn_gauges.items():
                gauge.set(self.burn_rate(w, now))
        self._eval_health()

    def _eval_health(self) -> None:
        # O(1) health check off the incremental short-window sums
        short_events = self._short_good + self._short_bad
        budget = 1.0 - self.config.availability_target
        short_burn = (
            (self._short_bad / short_events) / max(budget, 1e-9)
            if short_events
            else 0.0
        )
        healthy = not (
            short_events >= self.config.min_events
            and short_burn > self.config.degraded_burn
        )
        if healthy != self.healthy:
            self.healthy = healthy
            self.degraded_flips += 1
            metrics.slo_healthy.set(1 if healthy else 0)
            for cb in self.on_health_change:
                cb(healthy)

    def tick(self) -> None:
        """Time-only re-evaluation: prune aged buckets and re-check
        health WITHOUT a new batch. Without this, a degraded flip
        would latch forever once traffic stops — the bad events age
        out of the short window arithmetically, but observe_batch
        (the only other evaluation point) never runs on an idle
        scheduler, and the degraded flag routing work away can make
        the idleness self-sustaining (review-caught). Called from
        ``snapshot`` (any /debug read heals) and the scheduler's
        ``pending`` poll (the serve drain loop's idle heartbeat)."""
        self._prune(self.clock.now())
        self._eval_health()

    def snapshot(self) -> dict:
        """The ``GET /debug/slo`` body: one consistent host-side cut
        (also a time-only health re-evaluation point — see tick)."""
        self.tick()
        now = self.clock.now()
        p50, p99 = self.latency_quantiles()
        return {
            "healthy": self.healthy,
            "latency_objective_s": self.config.latency_objective_s,
            "availability_target": self.config.availability_target,
            "window_s": self.config.window_s,
            "p50_pod_latency_s": round(p50, 6),
            "p99_pod_latency_s": round(p99, 6),
            "bind_throughput_pods_per_sec": round(
                self.throughput(now), 3
            ),
            "burn_rates": {
                f"{int(w)}s": round(self.burn_rate(w, now), 4)
                for w in self.config.burn_windows
            },
            "window_events": self.window_events(
                max(self.config.burn_windows), now
            ),
            "degraded_flips": self.degraded_flips,
        }
