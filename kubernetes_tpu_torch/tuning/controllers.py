"""HillClimber: the bounded per-knob controller.

One integer knob, one objective to maximize. The climber alternates
between MEASURING the incumbent value and PROBING a neighbor (value *
step up, value // step down — geometric because every governed knob is
a size/depth whose useful range spans octaves). The machine is built
around three safety properties the convergence tests pin:

- **hysteresis**: a probe is accepted only when its objective beats the
  incumbent's by a strict margin (``obj > baseline * (1 + hysteresis)``).
  An A->B acceptance therefore implies obj(B) > obj(A) by the margin,
  and a later B->A acceptance would need obj(A) > obj(B) by the margin
  within the same regime — so A<->B oscillation requires the objective
  itself to move, which is the workload-shift case the runtime handles
  by explicit ``unsettle``.
- **revert on regression**: a rejected probe restores the incumbent
  value immediately. The knob never stays at a measured-worse setting
  longer than one evaluation window, which is what makes the tuned
  bench arm ">= static" by construction rather than by luck.
- **settle detection**: after both directions fail to improve
  ``settle_after`` times, the climber stops proposing entirely (zero
  steady-state overhead). ``unsettle`` re-opens it.

Guardrails are the ``guard`` callable: a candidate failing it is never
applied — not "applied then rolled back", never applied — and the
rejection is counted. This is how the drain-chunk controller keeps the
HBM budget assertion (solver/budget.py) BETWEEN the proposal and the
dispatch path.

Pure python, no clocks, no randomness: a seeded objective trace drives
the controller to a deterministic decision sequence (the property-test
contract).

Copied from ``kubernetes_tpu/tuning/controllers.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Decision:
    """One journaled controller action. ``action`` is probe (try a
    neighbor), accept (probe won, it is the new incumbent), revert
    (probe lost, incumbent restored), settle (stop proposing),
    unsettle (workload shift re-opened tuning)."""

    knob: str
    action: str
    old: int
    new: int
    objective: float
    baseline: float
    trigger: dict = field(default_factory=dict)


# state-machine phases
_MEASURE = "measure"  # accumulating objective at the incumbent value
_PROBE = "probe"  # accumulating objective at a candidate value


class HillClimber:
    def __init__(
        self,
        knob: str,
        value: int,
        lo: int,
        hi: int,
        *,
        step: int = 2,
        hysteresis: float = 0.05,
        settle_after: int = 2,
        eval_batches: int = 6,
        guard=None,
        align: int = 1,
        max_probes: int = 16,
    ) -> None:
        if not lo <= value <= hi:
            raise ValueError(
                f"{knob}: initial value {value} outside [{lo}, {hi}]"
            )
        if step < 2:
            raise ValueError(f"{knob}: step must be >= 2 (got {step})")
        self.knob = knob
        self.value = int(value)
        self.lo, self.hi = int(lo), int(hi)
        self.step = step
        self.hysteresis = hysteresis
        self.settle_after = settle_after
        self.eval_batches = max(eval_batches, 1)
        self.guard = guard
        # candidates snap to multiples of ``align`` (the drain chunk
        # must stay group-aligned or the grouped fast path degrades)
        self.align = max(align, 1)
        # bounded experimentation: after this many probes within one
        # episode (construction/unsettle -> settle) the climber settles
        # at its incumbent regardless — a noisy objective whose spurious
        # accepts keep resetting the no-improve streak must still
        # terminate, and a knob that genuinely keeps improving for 16
        # octaves has outgrown its bounds anyway
        self.max_probes = max(max_probes, 1)
        self._probes_episode = 0

        self._phase = _MEASURE
        self._obj: list[tuple[float, float]] = []  # (num, den) pairs
        self._baseline = 0.0
        self._incumbent = self.value  # value to restore on revert
        self._dir = +1  # probe up first (all governed knobs start low)
        self._tried_flip = False
        self._no_improve = 0
        self.settled = False
        self.moves = 0  # accepted moves
        self.probes = 0
        # observations ever received: a controller whose dispatch mode
        # never ran (stream_depth on a pipelined drive) has ticks == 0
        # and must not count against the runtime's settled state — it
        # was never given a chance, which is not a convergence failure
        self.ticks = 0
        self.guard_rejections = 0
        self.unsettles = 0
        self.history: list[Decision] = []

    # -- candidate generation --

    def _snap(self, v: int) -> int:
        v = (v // self.align) * self.align
        return min(max(v, self.lo), self.hi)

    def _candidate(self, direction: int) -> int | None:
        """Next value in ``direction``, aligned and bounded; None when
        the move is a no-op or the guardrail rejects it (the rejection
        is counted — the candidate is never applied)."""
        if direction > 0:
            cand = self._snap(self.value * self.step)
        else:
            cand = self._snap(self.value // self.step)
        if cand == self.value:
            return None
        if self.guard is not None and not self.guard(cand):
            self.guard_rejections += 1
            return None
        return cand

    # -- the drive --

    def observe(
        self,
        num: float,
        den: float = 1.0,
        trigger: dict | None = None,
    ):
        """Feed one batch's objective as a (numerator, denominator)
        pair — pods and wall seconds for the throughput knobs; pass
        ``den=1`` to drive with a plain scalar (then the window score
        is the mean). The window score is the ratio of sums, i.e. true
        window throughput: robust to the bimodal per-batch wall deltas
        a virtual clock produces (intra-cycle batches take 0 s, the
        cycle boundary takes the whole advance — a per-batch-rate
        median would whipsaw across that, a ratio of sums cannot).
        Returns a Decision when an evaluation window completed and the
        controller acted (the runtime applies ``self.value`` after
        every non-None return), else None. A settled controller is
        inert."""
        self.ticks += 1
        if self.settled:
            return None
        self._obj.append((num, den))
        if len(self._obj) < self.eval_batches:
            return None
        score = sum(n for n, _ in self._obj) / max(
            sum(d for _, d in self._obj), 1e-6
        )
        self._obj = []
        trigger = dict(trigger or {})
        trigger["objective"] = round(score, 6)
        if self._phase == _MEASURE:
            self._baseline = score
            return self._start_probe(score, trigger)
        # PROBE window complete: accept or revert
        if score > self._baseline * (1.0 + self.hysteresis):
            old = self._incumbent
            self._incumbent = self.value
            self._baseline = score
            self.moves += 1
            self._no_improve = 0
            self._tried_flip = False
            d = self._decide("accept", old, self.value, score, trigger)
            # keep climbing the winning direction next window
            self._phase = _MEASURE
            return d
        # regression (or no margin): restore the incumbent NOW
        old = self.value
        self.value = self._incumbent
        self._phase = _MEASURE
        if not self._tried_flip:
            self._dir = -self._dir
            self._tried_flip = True
        else:
            self._tried_flip = False
            self._no_improve += 1
            if self._no_improve >= self.settle_after:
                self.settled = True
                return self._decide(
                    "settle", old, self.value, score, trigger
                )
        return self._decide("revert", old, self.value, score, trigger)

    def _start_probe(self, score: float, trigger: dict):
        if self._probes_episode >= self.max_probes:
            # probe budget exhausted: terminate the episode at the
            # incumbent (already restored by the revert path)
            self.settled = True
            return self._decide(
                "settle", self.value, self.value, score, trigger
            )
        cand = self._candidate(self._dir)
        if cand is None:
            self._dir = -self._dir
            cand = self._candidate(self._dir)
        if cand is None:
            # neither direction has a legal candidate (bounds or
            # guardrail): nothing to try — settle immediately
            self._no_improve += 1
            if self._no_improve >= self.settle_after:
                self.settled = True
                return self._decide(
                    "settle", self.value, self.value, score, trigger
                )
            return None
        old = self.value
        self.value = cand
        self._phase = _PROBE
        self.probes += 1
        self._probes_episode += 1
        return self._decide("probe", old, cand, score, trigger)

    def _decide(
        self, action: str, old: int, new: int, objective: float, trigger: dict
    ) -> Decision:
        d = Decision(
            knob=self.knob,
            action=action,
            old=old,
            new=new,
            objective=objective,
            baseline=self._baseline,
            trigger=trigger,
        )
        self.history.append(d)
        return d

    def abort_probe(self) -> None:
        """The runtime could not apply the current probe value (an
        apply-time guard breach): restore the incumbent and return to
        measuring it. Without this the climber would keep attributing
        the incumbent's scores to the never-applied candidate — and a
        noise accept would then install the rejected value through the
        accept path, which deliberately skips the guard."""
        self.value = self._incumbent
        self._phase = _MEASURE
        self._obj = []

    def unsettle(self, trigger: dict | None = None) -> Decision:
        """A workload shift invalidated the settled point: re-open
        tuning from the current value (the best known for the OLD
        regime — still the sanest starting point for the new one)."""
        self.settled = False
        self._phase = _MEASURE
        self._obj = []
        self._baseline = 0.0
        self._incumbent = self.value
        self._dir = +1
        self._tried_flip = False
        self._no_improve = 0
        self._probes_episode = 0
        self.unsettles += 1
        return self._decide(
            "unsettle", self.value, self.value, 0.0, dict(trigger or {})
        )
