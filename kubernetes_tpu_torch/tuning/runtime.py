"""TuningRuntime: the per-knob controllers wired to the scheduler.

One runtime per Scheduler (``SchedulerConfig.tuning``). Every applied
batch funnels through ``observe_batch`` (called from the scheduler's
metrics-recording chokepoint, which all four dispatch paths — sync,
pipelined, streaming, backlog drain — already share): it takes one
``CounterWindow`` sample, feeds the active controllers the throughput
objective, applies any accepted/reverted value, and journals the move.

Knobs and their application discipline:

- ``stream_depth`` — writes ``SchedulerConfig.stream_depth``; the
  streaming loop re-reads it ONLY at ring-drain boundaries (an
  in-flight ring keeps the depth it was dispatched under), so a depth
  change can never strand or orphan a dispatched slot.
- ``pipeline_split`` — the runtime owns the split value;
  ``Scheduler._choose_split`` consults it (and falls back to the
  window's EWMA rule when tuning is off — both read the SAME
  ``CounterWindow``, the satellite's anti-fighting contract).
- ``backlog_chunk`` — active only inside a ``drain_backlog`` pass;
  every candidate passes the HBM budget model
  (``solver/budget.estimate`` + the index-headroom audit) BEFORE it is
  applied, so a tuner-proposed chunk can never raise ``BudgetExceeded``
  from the dispatch path — that is the "guardrail breach" the metrics
  and the bench ladder pin at zero.
- ``fleet_flush`` — the write-behind flush batch of the fleet's remote
  occupancy exchange (``RemoteOccupancyExchange``); applied through
  ``FleetRuntime.set_flush_batch``, a no-op for in-process hubs.

Every adjustment is journaled three ways: the ``scheduler_tuning_*``
metric family (adjustments by knob+action, live knob values, settled
flags, guardrail rejections), a ``tuning`` obs span carrying
decision/trigger/old->new (so ``obs explain``-style attribution works
for knob moves too), and an in-memory decision history the sim footer
and the tuned-profile emitter read.

Copied from ``kubernetes_tpu/tuning/runtime.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import metrics
from .controllers import Decision, HillClimber
from .window import CounterWindow

KNOB_STREAM_DEPTH = "stream_depth"
KNOB_SPLIT = "pipeline_split"
KNOB_CHUNK = "backlog_chunk"
KNOB_FLUSH = "fleet_flush"
ALL_KNOBS = (KNOB_CHUNK, KNOB_STREAM_DEPTH, KNOB_SPLIT, KNOB_FLUSH)


@dataclass(frozen=True)
class TuningConfig:
    """Knob-independent controller tuning. ``knobs`` lists what the
    runtime may touch — to pin a knob statically, set its config value
    and drop it from this tuple (README "Auto-tuning")."""

    # batches per evaluation window (scored as the window's ratio of
    # sums — pods over wall seconds, i.e. true window throughput)
    eval_batches: int = 6
    # a probe must beat the incumbent by this relative margin
    hysteresis: float = 0.05
    # consecutive both-directions-failed rounds before a knob settles
    settle_after: int = 2
    # probe budget per episode (construction/unsettle -> settle): the
    # hard termination bound a noisy objective cannot defeat
    max_probes: int = 16
    # relative change in the window's arrival-rate signature (pods per
    # wall-second — CounterWindow.rate; or an absolute change in the
    # hard-shape fraction above 0.35) that re-opens settled controllers
    shift_threshold: float = 0.75
    knobs: tuple = ALL_KNOBS
    # bounds per knob (lo, hi); chunk's upper bound additionally obeys
    # the HBM guardrail, and its lower bound the group alignment
    stream_depth_bounds: tuple = (1, 16)
    split_bounds: tuple = (1, 8)
    flush_bounds: tuple = (16, 4096)
    chunk_growth_cap: int = 16  # chunk hi = initial chunk * cap

    def validate(self) -> None:
        # the range checks live in ONE place — config/types.py's pure
        # validate_tuning_params — shared with the YAML loader so a
        # bound change cannot land in one and not the other
        from ..config.types import validate_tuning_params

        validate_tuning_params(
            self.eval_batches,
            self.hysteresis,
            self.settle_after,
            self.max_probes,
            self.shift_threshold,
            self.knobs,
        )


class TuningRuntime:
    def __init__(
        self, config: TuningConfig, window: CounterWindow, clock
    ) -> None:
        config.validate()
        self.config = config
        self.window = window
        self.clock = clock
        import logging

        self._log = logging.getLogger("kubernetes_tpu_torch.tuning")
        self.controllers: dict[str, HillClimber] = {}
        self.decisions: list[Decision] = []
        # guardrail BREACHES: a tuner-applied value failing its guard at
        # apply time. Proposals are guarded BEFORE application, so this
        # stays 0 — the counter exists to prove it (the bench ladder and
        # the sim invariant both pin it).
        self.guardrail_breaches = 0
        self.shifts = 0
        # window.batches when every active controller first settled
        # (re-recorded after each unsettle; the bench ladder hoists the
        # first value as tuning_convergence_batches)
        self.convergence_batches: int | None = None
        # frozen: ticks become no-ops. The sim harness sets this at
        # quiescence — once churn stops, the draining tail is teardown,
        # not a workload, and letting shift detection fire on it would
        # unsettle controllers with no batches left to re-converge on.
        # Production never freezes (there is no "end of workload").
        self.frozen = False
        # the always-on controllers are attached on the first tick (the
        # scheduler's config is final by then); a flag, not a
        # controllers-empty check — the drain-chunk controller can
        # register FIRST via on_drain_start, and an emptiness check
        # would then silently skip the others forever
        self._attached = False
        self._settled_signature: tuple | None = None
        # while the signature window still contains samples from before
        # the settle point, keep refreshing the baseline instead of
        # comparing against it (the transition's own residual drift is
        # not a NEW shift) — frozen once the window has fully turned
        # over past this batch count
        self._signature_fresh_until = 0
        # consecutive over-threshold observations before a shift fires:
        # one window's rate can spike transiently (a burst of requeued
        # pods popping intra-cycle inflates pods/wall), but a real
        # regime change PERSISTS — requiring the signal on consecutive
        # ticks filters the burst without dulling genuine detection
        self._shift_streak = 0
        # window.batches at the most recent unsettle (0 = construction):
        # "still unsettled" is only a convergence FAILURE when the tuner
        # has since been given at least its structural settle bound of
        # batches — a shift detected near the end of a drive leaves it
        # legitimately mid-convergence (the sim invariant reads both)
        self._last_unsettle_batches = 0
        self._drain_budget_bytes = 0
        self._final_chunk: int | None = None
        # controllers retired from active duty (the drain-chunk climber
        # at drain end): their probe/move/guard counters must survive
        # into summary(), or a drain's guardrail activity vanishes from
        # the very report that pins it
        self._retired: list[HillClimber] = []

    # -- controller construction --

    def _add(self, climber: HillClimber) -> None:
        self.controllers[climber.knob] = climber
        metrics.tuning_knob_value.labels(climber.knob).set(climber.value)
        metrics.tuning_settled.labels(climber.knob).set(0)

    def attach(self, scheduler) -> None:
        """Build the always-on controllers from the scheduler's current
        config (the tuned arm starts exactly where the static arm is, so
        revert-on-regression makes 'tuned >= static' structural)."""
        c = self.config
        if KNOB_STREAM_DEPTH in c.knobs:
            lo, hi = c.stream_depth_bounds
            self._add(
                HillClimber(
                    KNOB_STREAM_DEPTH,
                    min(max(scheduler.config.stream_depth, lo), hi),
                    lo,
                    hi,
                    hysteresis=c.hysteresis,
                    settle_after=c.settle_after,
                    eval_batches=c.eval_batches,
                    max_probes=c.max_probes,
                )
            )
        if KNOB_SPLIT in c.knobs and scheduler.config.pipeline_split == 0:
            # a fixed config split (>= 1) is a static pin: adaptive and
            # tuned split both yield to it in _choose_split. Until the
            # controller's first probe, split_override() TRACKS the
            # adaptive window rule — the governed scheduler dispatches
            # exactly as the static arm would, so "tuned starts where
            # static is" holds for this knob too; the initial value
            # here is only the pre-first-batch placeholder.
            lo, hi = c.split_bounds
            self._add(
                HillClimber(
                    KNOB_SPLIT,
                    lo,
                    lo,
                    hi,
                    hysteresis=c.hysteresis,
                    settle_after=c.settle_after,
                    eval_batches=c.eval_batches,
                    max_probes=c.max_probes,
                )
            )
        if (
            KNOB_FLUSH in c.knobs
            and scheduler.fleet is not None
            and scheduler.fleet.flush_batch() is not None
        ):
            lo, hi = c.flush_bounds
            self._add(
                HillClimber(
                    KNOB_FLUSH,
                    min(max(scheduler.fleet.flush_batch(), lo), hi),
                    lo,
                    hi,
                    hysteresis=c.hysteresis,
                    settle_after=c.settle_after,
                    eval_batches=c.eval_batches,
                    max_probes=c.max_probes,
                )
            )

    # -- drain-chunk lifecycle (drain_backlog brackets a pass) --

    def on_drain_start(
        self, scheduler, chunk: int, budget_bytes: int
    ) -> None:
        """Arm the chunk controller for one backlog drain. The guard is
        the HBM budget model: a candidate chunk's per-device estimate
        (with the index-headroom audit) must fit ``budget_bytes`` or the
        candidate is never applied."""
        if KNOB_CHUNK not in self.config.knobs:
            return
        from ..solver import budget as hbm

        group = max(scheduler.solver.config.group_size, 1)
        self._drain_budget_bytes = budget_bytes

        def guard(candidate: int) -> bool:
            shape = scheduler.drain_shape(candidate)
            est = hbm.estimate(shape)
            ok = est.per_device_bytes <= budget_bytes
            if ok:
                try:
                    hbm.assert_index_headroom(
                        est.pod_pad, est.node_pad, d_pad=shape.d_pad,
                        group=group,
                    )
                except hbm.IndexWidthError:
                    ok = False
            if not ok:
                # BOTH rejection kinds (budget excess and index-width)
                # tick the counter, matching the climber's own
                # guard_rejections tally in the run summary
                metrics.tuning_guardrail_rejections_total.labels(
                    KNOB_CHUNK
                ).inc()
            return ok

        lo = min(group, chunk)
        hi = max(chunk * self.config.chunk_growth_cap, chunk)
        # group alignment keeps the grouped fast path's exact pod-axis
        # bucket — but only meaningful once the chunk spans whole
        # groups; below that every aligned candidate would snap to the
        # floor and the controller could never probe at all
        align = group if chunk >= group and chunk % group == 0 else 1
        self._add(
            HillClimber(
                KNOB_CHUNK,
                chunk,
                lo,
                hi,
                align=align,
                hysteresis=self.config.hysteresis,
                settle_after=self.config.settle_after,
                eval_batches=self.config.eval_batches,
                guard=guard,
                max_probes=self.config.max_probes,
            )
        )
        self._final_chunk = chunk

    def on_drain_end(self, scheduler) -> None:
        climber = self.controllers.pop(KNOB_CHUNK, None)
        if climber is not None:
            self._retired.append(climber)
            self._final_chunk = climber._incumbent
            metrics.tuning_knob_value.labels(KNOB_CHUNK).set(
                self._final_chunk
            )

    # -- the per-batch tick --

    def _active(self, scheduler, knob: str) -> bool:
        if knob == KNOB_CHUNK:
            return scheduler._backlog_drain_active
        if knob == KNOB_STREAM_DEPTH:
            return scheduler._streaming_active
        return True

    def observe_batch(
        self, scheduler, res, n_pods: int, occ_sensitive: bool = False
    ) -> None:
        """One applied batch: sample the window, drive the active
        controllers, apply + journal any decision. Driver thread only
        (the one thread every dispatch loop applies on)."""
        if self.frozen:
            return
        chained_total = float(
            sum(
                s.dispatch_counts.get("stream_chained", 0)
                for s in scheduler.solvers.values()
            )
        )
        sample = self.window.note_batch(
            pods=n_pods,
            solve_s=res.solve_seconds,
            chained_total=chained_total,
            occ_sensitive=occ_sensitive,
        )
        if not self._attached:
            self._attached = True
            self.attach(scheduler)
            # WARM batch: this first sample's wall delta spans from
            # scheduler construction — setup plus the first solve's
            # JIT compile — so its pods/wall score is garbage (a
            # deflated incumbent baseline would let the first probe
            # win unconditionally). The sample re-anchored the window
            # clock and counter baselines; feed no controller.
            return
        trigger = {
            "pods": n_pods,
            "unhidden_reads": sample.deltas.get("unhidden_reads", 0),
            "slot_discards": sample.deltas.get("slot_discards", 0),
            "chained": sample.chained,
            "h2d_bytes": int(sample.deltas.get("h2d_bytes", 0)),
            "cas_conflicts": sample.deltas.get("cas_conflicts", 0),
        }
        self._maybe_shift(scheduler, trigger)
        for knob, climber in list(self.controllers.items()):
            if not self._active(scheduler, knob):
                continue
            decision = climber.observe(
                n_pods, sample.wall_s, trigger
            )
            if decision is not None:
                self._apply(scheduler, climber, decision)
        if self.settled() and self._settled_signature is None:
            self._settled_signature = self.window.signature(
                self._signature_window()
            )
            self._signature_fresh_until = (
                self.window.batches + self._signature_window()
            )
            if self.convergence_batches is None:
                self.convergence_batches = self.window.batches

    def _signature_window(self) -> int:
        """Samples the workload fingerprint averages over: wider than
        one evaluation window so pop-boundary noise washes out, but
        short enough that a real regime change dominates it within a
        few cycles (a long window both lags detection and stretches the
        post-settle grace period during which shifts are absorbed as
        transition residue)."""
        return max(2 * self.config.eval_batches, 4)

    def _maybe_shift(self, scheduler, trigger: dict) -> None:
        """Workload-shift detection: when every controller is settled,
        a large move in the window signature re-opens tuning (the
        settled point was chosen for a workload that no longer
        exists)."""
        if self._settled_signature is None:
            return
        cur = self.window.signature(self._signature_window())
        if self.window.batches <= self._signature_fresh_until:
            # the window still spans the settle transition: its drift
            # is the old regime washing out, not a new shift — track it
            # as the baseline until the window has fully turned over
            self._settled_signature = cur
            return
        base_pods, base_hard = self._settled_signature
        cur_pods, cur_hard = cur
        rel = abs(cur_pods - base_pods) / max(base_pods, 1.0)
        if rel <= self.config.shift_threshold and abs(
            cur_hard - base_hard
        ) <= 0.35:
            self._shift_streak = 0
            return
        self._shift_streak += 1
        if self._shift_streak < 2:
            return  # a one-tick spike is a burst, not a regime
        self._shift_streak = 0
        self.shifts += 1
        self._settled_signature = None
        self._last_unsettle_batches = self.window.batches
        metrics.tuning_workload_shifts_total.inc()
        shift_trigger = dict(
            trigger,
            shift_rate=round(cur_pods, 3),
            settled_rate=round(base_pods, 3),
        )
        for climber in self.controllers.values():
            if climber.settled:
                d = climber.unsettle(shift_trigger)
                self._journal(scheduler, climber, d)
        self._log.info(
            "tuning: workload shift detected (rate %0.1f -> %0.1f "
            "pods/s); controllers re-opened",
            base_pods, cur_pods, extra={"step": scheduler._trace_step},
        )

    # -- application + journaling --

    def _apply(self, scheduler, climber: HillClimber, d: Decision) -> None:
        knob, value = climber.knob, climber.value
        if knob == KNOB_STREAM_DEPTH:
            # the streaming loop re-reads config.stream_depth ONLY at
            # ring-drain boundaries (run_streaming): an in-flight ring
            # keeps the depth it was dispatched under
            scheduler.config.stream_depth = value
        elif knob == KNOB_CHUNK:
            # apply-time guardrail re-check for NEWLY-proposed values
            # (probe transitions): the proposal already passed the
            # budget model in the same tick, so a failure here is a
            # genuine breach — counted, never applied. Accepts keep the
            # probe's value (live since the probe applied it) and
            # reverts/settles restore the incumbent the drain is
            # already running — re-checking either would count the
            # estimate's own mid-drain drift (vocab growth, queue
            # shape) as a breach of a shape that is live regardless.
            if (
                d.action == "probe"
                and climber.guard is not None
                and not climber.guard(value)
            ):
                self.guardrail_breaches += 1
                # the candidate was never applied: the climber must not
                # keep holding it (its next windows would score the
                # still-running incumbent under the candidate's name,
                # and an accept would install the rejected value past
                # the guard)
                climber.abort_probe()
                return
            scheduler.config.batch_size = value
            self._final_chunk = value
        elif knob == KNOB_FLUSH:
            scheduler.fleet.set_flush_batch(value)
        # KNOB_SPLIT needs no push: _choose_split pulls split_override()
        self._journal(scheduler, climber, d)

    def _journal(self, scheduler, climber: HillClimber, d: Decision) -> None:
        metrics.tuning_adjustments_total.labels(d.knob, d.action).inc()
        metrics.tuning_knob_value.labels(d.knob).set(climber.value)
        metrics.tuning_settled.labels(d.knob).set(
            1 if climber.settled else 0
        )
        self.decisions.append(d)
        with scheduler.obs.span(
            "tuning",
            trace_id=scheduler._trace_step,
            knob=d.knob,
            action=d.action,
            old=d.old,
            new=d.new,
            objective=round(d.objective, 6),
            baseline=round(d.baseline, 6),
            **{
                k: v
                for k, v in d.trigger.items()
                if k in ("pods", "unhidden_reads", "slot_discards")
            },
        ):
            pass
        if d.action in ("accept", "settle", "unsettle"):
            self._log.info(
                "tuning: %s %s %d -> %d (objective %0.3f vs baseline "
                "%0.3f)",
                d.knob, d.action, d.old, d.new, d.objective, d.baseline,
                extra={"step": scheduler._trace_step},
            )

    # -- the scheduler-facing knob reads --

    def split_override(self, n_pods: int = 0) -> int | None:
        """The split controller's current value, or None when the knob
        is not governed (the adaptive window rule applies then).
        Until the controller's FIRST probe, it TRACKS the adaptive
        rule's pick for this batch — the governed scheduler dispatches
        exactly as the static arm would, and the baseline the climb
        later compares against was measured at that same value (the
        "tuned starts where static is" guarantee: a
        floor-seeded controller silently overrode a warmed adaptive
        rule on high-RTT workloads)."""
        climber = self.controllers.get(KNOB_SPLIT)
        if climber is None:
            return None
        from .controllers import _MEASURE

        if (
            climber.probes == 0
            and not climber.settled
            and climber._phase == _MEASURE
            and n_pods > 0
        ):
            est = min(
                max(
                    self.window.split_estimate(n_pods, climber.hi),
                    climber.lo,
                ),
                climber.hi,
            )
            climber.value = est
            climber._incumbent = est
            return est
        return climber.value

    # -- reporting --

    def knob_values(self) -> dict:
        out = {
            knob: climber.value
            for knob, climber in sorted(self.controllers.items())
        }
        if self._final_chunk is not None and KNOB_CHUNK not in out:
            out[KNOB_CHUNK] = self._final_chunk
        return out

    def settled(self) -> bool:
        """Every controller that ever RAN has settled. Never-ticked
        controllers (a knob whose dispatch mode never engaged — e.g.
        stream_depth on a pipelined drive) are excluded: they were
        never given a batch to evaluate, which is idleness, not a
        convergence failure."""
        engaged = [
            c for c in self.controllers.values() if c.ticks > 0
        ]
        return bool(engaged) and all(c.settled for c in engaged)

    def summary(self) -> dict:
        """Deterministic run summary (the sim footer / bench row): all
        python-side counters, so same-seed sim runs stay
        byte-identical. Retired climbers (a finished drain's chunk
        controller) keep contributing their counters; ``settled``
        reflects the ACTIVE controllers only."""
        climbers = list(self.controllers.values()) + self._retired
        return {
            "adjustments": sum(len(c.history) for c in climbers),
            "probes": sum(c.probes for c in climbers),
            "moves": sum(c.moves for c in climbers),
            "max_knob_moves": max(
                (c.moves for c in climbers), default=0
            ),
            "guardrail_rejections": sum(
                c.guard_rejections for c in climbers
            ),
            "guardrail_breaches": self.guardrail_breaches,
            "shifts": self.shifts,
            "settled": 1 if self.settled() else 0,
            "convergence_batches": self.convergence_batches,
            # convergence-opportunity accounting: how many batches the
            # tuner has seen since its last unsettle, vs the structural
            # bound an episode needs (probe budget x windows + slack) —
            # "unsettled" is only a failure when opportunity >= bound
            "batches_since_unsettle": (
                self.window.batches - self._last_unsettle_batches
            ),
            "settle_bound": self.config.eval_batches
            * (2 * self.config.max_probes + 4),
            "knobs": self.knob_values(),
        }
