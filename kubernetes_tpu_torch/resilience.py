"""Degraded-mode solve resilience: the fallback ladder, the per-profile
circuit breaker, and pre-apply output validation.

The batched device solve is the scheduler's single point of failure: a
device/runtime error, a poison pod that breaks tensorize/solve, or a
silently-corrupt result would otherwise kill the whole batch — and in
fleet mode blackhole a replica's entire shard. This module makes the
scheduler *always make forward progress*, at the best tier the hardware
currently allows:

- **Fallback ladder** (``build_ladder``): the exact solve on the
  scheduler's device → the same exact solve on the CPU → pure-host
  serial greedy (``host_greedy_assign``, reusing the ``ops/oracle``
  pipeline).
  The last rung is plain Python over host state and cannot be taken
  down by the accelerator, which is what makes "always forward
  progress" a guarantee instead of a hope. The CPU rung exists only when
  the scheduler's device is the card (on the CPU it would repeat the
  top rung).
- **Circuit breaker** (``SolveResilience``): each device tier carries a
  breaker. A solve failure triggers ONE session rebuild and a retry at
  the same tier (device-session loss heals without descending); a
  failure of the rebuilt retry is a deterministic episode that trips
  the breaker — the scheduler descends one rung and keeps serving.
  Tripped breakers re-open for a single PROBE solve after their fault
  window (exponential backoff on repeated trips); a probe success
  re-closes the breaker and the scheduler climbs back up.
- **Pre-apply output validation** (``validate_assignments``): the
  already-materialized host tensors are enough to prove an assignment
  vector sane — integer dtype, node ids in range, only live snapshot
  slots, and no per-node overcommit against the batch's tensorize-time
  capacity (accumulated across a chained sub-batch split). A corrupt
  solve is treated as a solve FAILURE feeding the breaker; it is never
  applied.

Failures that survive the whole ladder (the host rung fails too, or
tensorize itself dies) are data-shaped, not hardware-shaped: the
scheduler bisects the batch to the offending pod(s) and quarantines
them (``Scheduler._bisect_or_quarantine``) with a terminal
``quarantined`` journal outcome and a TTL'd backoff re-admit, while the
rest of the batch proceeds.

Determinism contract: all timing comes off the injectable ``Clock``,
state transitions are pure functions of the (deterministic) failure
sequence, and the host greedy rung breaks ties by lowest node index —
two same-seed simulator runs stay byte-identical
(``sim/README.md``, the ``solver_flaky`` / ``poison_pods`` profiles).

Ported from ``kubernetes_tpu/resilience.py``: the ladder's rungs are
torch devices here (``build_ladder``, ``tier_device``), where the JAX
package has a ``jax.default_device`` context; the mesh rung (TIER_MESH)
heads the ladder when a node-axis mesh is configured, as there.

Copied from ``kubernetes_tpu/resilience.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import metrics

# ladder tiers, best first (build_ladder trims to what exists)
TIER_MESH = "mesh"  # the exact solver sharded over the configured NodeMesh
TIER_SINGLE = "single"  # the exact solver on the scheduler's device
TIER_CPU = "cpu"  # same exact solver, on the CPU
TIER_HOST = "host"  # pure-host serial greedy (ops/oracle), no torch

# breaker states for the scheduler_tpu_breaker_state gauge
STATE_CLOSED = 0
STATE_OPEN = 1
STATE_HALF_OPEN = 2

# actions on_failure hands back to the scheduler's resilient solve loop
ACT_REBUILD = "rebuild"  # reset the device session, retry the same tier
ACT_RETRY = "retry"  # episode recorded, threshold not reached: same tier
ACT_DESCEND = "descend"  # breaker tripped: re-acquire (one rung lower)
ACT_BISECT = "bisect"  # the last rung failed: data-shaped, bisect


class SolverFaultError(Exception):
    """A solve-boundary failure the resilience layer owns: injected sim
    faults, read failures, and corrupt outputs all subclass or raise
    this family so the scheduler can distinguish them from plugin /
    binding exceptions (which keep their existing semantics)."""


class SolveCorruptError(SolverFaultError):
    """Pre-apply validation rejected the solve's output: the result is
    treated as a failed solve (feeding the breaker), never applied."""


class SolverReadError(SolverFaultError):
    """The deferred device→host assignment read itself died (session /
    transfer loss after dispatch)."""


def card_fault(e: BaseException) -> bool:
    """True for a failure of the card or of a kernel of the port: a kernel
    that did not build, load or launch (``build.KernelError``), the card's
    memory exhausted, or an error the CUDA runtime raised. The scheduler
    re-raises these instead of handing them to the ladder, whose CPU and
    host rungs serve the faults the JAX package's ladder owns (injected
    ``SolverFaultError``s, outputs that fail validation): a scheduler whose
    device is the card never serves its pods from the CPU because the card
    broke."""
    import torch

    from .build import KernelError

    if isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


def build_ladder(device, have_mesh: bool = False) -> tuple[str, ...]:
    """The fallback tiers for a scheduler on ``device`` (a torch.device),
    best first: the sharded mesh solve when a mesh is configured, then the
    unsharded one. ``TIER_CPU`` is only a distinct rung when ``device`` is
    the card (on the CPU, single == CPU and a duplicate rung would just
    slow the descent)."""
    tiers = [TIER_MESH] if have_mesh else []
    tiers.append(TIER_SINGLE)
    if device.type != "cpu":
        tiers.append(TIER_CPU)
    tiers.append(TIER_HOST)
    return tuple(tiers)


def tier_device(tier: str, device):
    """The torch device a solve at ``tier`` runs on: the CPU for the
    TIER_CPU rung (the card is sick but the host still computes the same
    exact solve), the scheduler's ``device`` otherwise."""
    import torch

    return torch.device("cpu") if tier == TIER_CPU else device


@dataclass
class ResilienceConfig:
    """SchedulerConfig.resilience: knobs for the fallback ladder, the
    per-profile circuit breaker, and the poison-batch quarantine."""

    # breaker: deterministic failure EPISODES (fail → session rebuild →
    # fail again) at one tier before its breaker trips
    trip_after: int = 1
    # fault window: how long a tripped breaker stays open before it
    # half-opens for a single probe solve
    open_seconds: float = 30.0
    # repeated trips of the same tier back off the window exponentially
    open_backoff: float = 2.0
    max_open_seconds: float = 600.0
    # quarantine: how long a poison pod sits out before re-admission,
    # with exponential backoff on repeated quarantines
    quarantine_ttl: float = 60.0
    quarantine_backoff: float = 2.0
    max_quarantine_ttl: float = 900.0
    # pin the ladder to one tier (bench ladder #9's forced host-greedy
    # arm; tests). The breaker machinery is bypassed entirely.
    force_tier: str | None = None
    # master switch for pre-apply output validation (the ladder itself
    # has no switch: with no failures it is zero-cost)
    validate: bool = True


class _ProfileState:
    """Per-profile breaker ladder state (driver thread only)."""

    __slots__ = (
        "rebuilt", "episode_fails", "open_until", "open_count",
        "probing", "async_fail",
    )

    def __init__(self) -> None:
        self.rebuilt = False  # session rebuild already spent this episode
        self.episode_fails: dict[int, int] = {}  # tier idx -> episodes
        self.open_until: dict[int, float] = {}  # tier idx -> half-open at
        self.open_count: dict[int, int] = {}  # tier idx -> trips (backoff)
        self.probing: int | None = None  # tier idx under probe
        self.async_fail = False  # a deferred solve failed post-dispatch


class SolveResilience:
    """The fallback ladder + circuit breaker state machine, one ladder
    per scheduler profile. Driver-thread only (both scheduling loops are
    single-driver); the scheduler consults it around every dispatch.

    State machine per device tier (host has no breaker):

        closed ──(trip_after deterministic episodes)──► open
        open   ──(fault window elapses; next acquire)──► half-open (probe)
        half-open ──(probe succeeds)──► closed
        half-open ──(probe fails)────► open (window × backoff)

    The CURRENT tier is always the best rung without an open breaker;
    probes temporarily run one failed rung for a single solve.
    """

    def __init__(
        self,
        config: ResilienceConfig | None,
        clock,
        ladder: tuple[str, ...],
        on_degraded=None,
    ) -> None:
        self.config = config or ResilienceConfig()
        self.clock = clock
        self.ladder = ladder
        # fleet hook: called with True when the first breaker trips and
        # False when the last one re-closes (the occupancy exchange's
        # degraded flag, so peers route refugees elsewhere)
        self.on_degraded = on_degraded
        # SLO health signal (obs/slo.py, wired by the Scheduler): while
        # the error budget burns past the degraded threshold, half-open
        # breaker probes are DEFERRED — the rung under probe already
        # failed once, and re-probing it while users are actively
        # missing their SLO risks another failed batch exactly when it
        # hurts most. The currently-working rung keeps serving; probes
        # resume (and re-close can complete) once health returns.
        self.slo_degraded = False
        self._state: dict[str, _ProfileState] = {}
        # python-side counters: the sim footer reads these (reading the
        # shared metrics registry would leak cross-run state)
        self.trips = 0
        self.recloses = 0
        self.probes = 0
        self.probes_deferred = 0  # probes skipped while SLO-degraded
        self.rebuilds = 0
        if self.config.force_tier is not None and (
            self.config.force_tier not in ladder
        ):
            raise ValueError(
                f"force_tier {self.config.force_tier!r} is not in the "
                f"ladder {ladder}"
            )

    def _st(self, profile: str) -> _ProfileState:
        st = self._state.get(profile)
        if st is None:
            st = self._state[profile] = _ProfileState()
            metrics.solve_tier.labels(profile).set(0)
            metrics.breaker_state.labels(profile).set(STATE_CLOSED)
        return st

    # -- tier selection --

    def acquire(self, profile: str) -> tuple[int, str]:
        """The (tier index, tier name) the next solve attempt should
        run at: the best rung without an open breaker, or — when a
        tripped rung's fault window has elapsed — that rung as a
        single half-open probe."""
        if self.config.force_tier is not None:
            idx = self.ladder.index(self.config.force_tier)
            return idx, self.config.force_tier
        st = self._st(profile)
        now = self.clock.now()
        for idx in range(len(self.ladder)):
            until = st.open_until.get(idx)
            if until is None:
                metrics.solve_tier.labels(profile).set(idx)
                return idx, self.ladder[idx]
            if now >= until:
                if self.slo_degraded:
                    # SLO consumption: the fault window elapsed, but
                    # the error budget is burning — keep serving at
                    # the rung that works and defer the probe until
                    # health returns
                    self.probes_deferred += 1
                    continue
                # half-open: one probe at the failed rung
                st.probing = idx
                self.probes += 1
                metrics.breaker_state.labels(profile).set(STATE_HALF_OPEN)
                metrics.breaker_transitions_total.labels("probe").inc()
                metrics.solve_tier.labels(profile).set(idx)
                return idx, self.ladder[idx]
        # unreachable: the host rung never opens a breaker
        idx = len(self.ladder) - 1  # pragma: no cover
        return idx, self.ladder[idx]  # pragma: no cover

    def on_success(self, profile: str, tier_idx: int) -> None:
        """A solve at ``tier_idx`` completed and validated: close its
        breaker if it was probing, and reset the episode bookkeeping.
        Success at a LOWER rung says nothing about the rungs above —
        their windows keep counting down toward their own probes."""
        st = self._st(profile)
        st.rebuilt = False
        st.async_fail = False
        st.episode_fails.pop(tier_idx, None)
        was_degraded = bool(st.open_until)
        if st.probing == tier_idx or tier_idx in st.open_until:
            st.open_until.pop(tier_idx, None)
            st.open_count.pop(tier_idx, None)
            self.recloses += 1
            metrics.breaker_transitions_total.labels("reclose").inc()
        st.probing = None
        metrics.breaker_state.labels(profile).set(
            STATE_OPEN if st.open_until else STATE_CLOSED
        )
        if was_degraded and not st.open_until and self.on_degraded:
            self.on_degraded(False)

    def on_failure(self, profile: str, tier_idx: int) -> str:
        """A solve at ``tier_idx`` failed. Returns the action for the
        scheduler's resilient solve loop (ACT_*)."""
        st = self._st(profile)
        if self.ladder[tier_idx] == TIER_HOST:
            # the last rung failed: this is not a hardware problem
            st.rebuilt = False
            return ACT_BISECT
        if self.config.force_tier is not None:
            # the ladder is pinned: there is no rung to descend to, and
            # looping REBUILD/DESCEND back into the same forced tier
            # would livelock on a deterministic failure. One session
            # rebuild, then treat it as data-shaped (bisect/quarantine
            # terminates).
            if not st.rebuilt:
                st.rebuilt = True
                self.rebuilds += 1
                metrics.breaker_transitions_total.labels("rebuild").inc()
                return ACT_REBUILD
            st.rebuilt = False
            return ACT_BISECT
        if st.probing == tier_idx:
            # probe failed: re-open with backoff, fall back down
            st.probing = None
            self._open(profile, st, tier_idx)
            return ACT_DESCEND
        if not st.rebuilt:
            # device-session loss heals with one rebuild before the
            # breaker is charged
            st.rebuilt = True
            self.rebuilds += 1
            metrics.breaker_transitions_total.labels("rebuild").inc()
            return ACT_REBUILD
        # the rebuilt retry failed too: a deterministic episode
        st.rebuilt = False
        fails = st.episode_fails.get(tier_idx, 0) + 1
        st.episode_fails[tier_idx] = fails
        if fails < self.config.trip_after:
            return ACT_RETRY
        st.episode_fails.pop(tier_idx, None)
        self._open(profile, st, tier_idx)
        return ACT_DESCEND

    def _open(self, profile: str, st: _ProfileState, tier_idx: int) -> None:
        was_degraded = bool(st.open_until)
        trips = st.open_count.get(tier_idx, 0) + 1
        st.open_count[tier_idx] = trips
        window = min(
            self.config.open_seconds
            * self.config.open_backoff ** (trips - 1),
            self.config.max_open_seconds,
        )
        st.open_until[tier_idx] = self.clock.now() + window
        self.trips += 1
        metrics.breaker_state.labels(profile).set(STATE_OPEN)
        metrics.breaker_transitions_total.labels("trip").inc()
        if not was_degraded and self.on_degraded:
            self.on_degraded(True)

    # -- pipelined-loop integration --

    def note_async_failure(self, profile: str) -> None:
        """A deferred solve failed after dispatch (read error / corrupt
        output): route the retry through the synchronous resilient path
        (``should_sync``), where the ladder can handle it."""
        self._st(profile).async_fail = True

    def should_sync(self) -> bool:
        """True when the pipelined and streaming loops must route popped
        batches through the synchronous resilient cycle: a tier is
        degraded or probing, an async failure is pending, or the ladder
        is pinned."""
        if self.config.force_tier is not None:
            return True
        return any(
            st.async_fail or st.open_until
            for st in self._state.values()
        )

    # -- introspection (sim footer / metrics / tests) --

    def tier_index(self, profile: str) -> int:
        """The rung the NEXT solve will run at: the best tier whose
        breaker is closed or whose fault window has already elapsed
        (the next solve probes it — from the caller's perspective the
        scheduler is back at that tier)."""
        if self.config.force_tier is not None:
            return self.ladder.index(self.config.force_tier)
        st = self._st(profile)
        now = self.clock.now()
        for idx in range(len(self.ladder)):
            until = st.open_until.get(idx)
            if until is None or now >= until:
                return idx
        return len(self.ladder) - 1  # pragma: no cover

    def summary(self) -> dict:
        """Deterministic state snapshot for the sim's trace footer.
        The current tier reports as ``"top"`` at depth 0 rather than by
        name: the ladder's SHAPE depends on the environment (mesh
        devices, backend), and naming the healthy top tier would break
        the sim's trace device-count-invariance contract — a fault-free
        run's footer must be byte-identical at any mesh size."""
        per_profile = {}
        for name, st in sorted(self._state.items()):
            depth = self.tier_index(name)
            per_profile[name] = {
                "tier": "top" if depth == 0 else self.ladder[depth],
                "open": sorted(self.ladder[i] for i in st.open_until),
            }
        return {
            "trips": self.trips,
            "recloses": self.recloses,
            "probes": self.probes,
            "probes_deferred": self.probes_deferred,
            "rebuilds": self.rebuilds,
            "profiles": per_profile,
        }

    # -- SLO health consumption (obs/slo.py, wired by the Scheduler) --

    def set_slo_degraded(self, degraded: bool) -> None:
        """While set, ``acquire`` defers half-open probes: don't re-try
        the rung that already failed while the error budget is
        actively burning — the working rung keeps serving, the probe
        (and its re-close) runs once health returns."""
        self.slo_degraded = bool(degraded)


# -- pre-apply output validation --


def validate_assignments(
    prep, lo: int, assignments, disabled: frozenset = frozenset()
) -> str | None:
    """Validate one flight's assignment vector against the group's
    already-materialized host tensors BEFORE any of it is applied.
    Returns a reason string (→ the solve is treated as failed and feeds
    the breaker) or None.

    Checks: integer dtype and shape, node ids in [-1, padded), assigned
    slots live in the snapshot (named + valid), and no per-node
    overcommit against tensorize-time capacity — accumulated across the
    chained sub-flights of one prepared group via
    ``prep.validated_usage``, mirroring the device-side
    ``BatchCarriedUsage`` carry. The capacity check is conservative in
    the lenient direction only: events between tensorize and apply can
    FREE capacity (assigned-pod deletes), never consume it unseen
    (capacity-consuming events bump the conflict fence and discard the
    flight first), so a flagged overcommit is always a corrupt solve.
    ``disabled``: the profile's disabled Filter plugins — with
    "NodeResourcesFit" disabled, overcommit is LEGAL solver output and
    the capacity half is skipped (the structural checks still run).

    Gang note: a pod group solved as one chained sub-batch flows
    through here one sub-flight at a time like any other chain —
    ``prep.validated_usage`` already carries usage across the gang's
    sub-flights, so a corrupt solve for a later member is caught
    against the load of earlier members the same gang round staged.
    """
    a = np.asarray(assignments)
    if a.ndim != 1:
        return f"assignment vector has {a.ndim} dims, expected 1"
    if not np.issubdtype(a.dtype, np.integer):
        return f"assignment dtype {a.dtype} is not an integer type"
    if a.size == 0:
        return None
    batch = prep.batch
    lo_v = int(a.min())
    hi_v = int(a.max())
    if lo_v < -1 or hi_v >= batch.padded:
        return (
            f"node id out of range: [{lo_v}, {hi_v}] vs "
            f"[-1, {batch.padded})"
        )
    assigned = np.nonzero(a >= 0)[0]
    if assigned.size == 0:
        return None
    slots = a[assigned].astype(np.int64)
    # per-node overcommit across this prep's flights (chained sub-
    # batches share one tensorize; the accumulator is the host mirror
    # of the device-resident carry). The named-slot table is built once
    # per prep alongside it.
    acc = prep.validated_usage
    if acc is None:
        named = np.zeros(batch.padded, dtype=bool)
        for si, name in enumerate(prep.names[: batch.padded]):
            named[si] = bool(name)
        acc = prep.validated_usage = {
            "used": np.zeros_like(batch.used),
            "count": np.zeros_like(batch.pod_count),
            "named": named,
        }
    if not bool(batch.valid[slots].all()):
        bad = int(slots[~batch.valid[slots]][0])
        return f"assignment targets invalid snapshot slot {bad}"
    if not bool(acc["named"][slots].all()):
        bad = int(slots[~acc["named"][slots]][0])
        return f"assignment targets unnamed snapshot slot {bad}"
    if "NodeResourcesFit" in disabled:
        # the profile legalized overcommit: only structural checks apply
        return None
    req = np.maximum(prep.pbatch.req[lo + assigned], 0)  # [m, K]
    # deltas are checked BEFORE merging into the accumulator: a failed
    # validation must not pollute the ladder-rung retry of the same
    # prep with phantom usage (the retry's correct output would then
    # falsely flag overcommit at every rung)
    uniq, inv = np.unique(slots, return_inverse=True)
    d_used = np.zeros((batch.used.shape[0], uniq.size), batch.used.dtype)
    np.add.at(d_used.T, inv, req)
    d_count = np.bincount(inv, minlength=uniq.size).astype(
        batch.pod_count.dtype
    )
    total = batch.used[:, uniq] + acc["used"][:, uniq] + d_used
    if bool((total > batch.allocatable[:, uniq]).any()):
        over = uniq[
            (total > batch.allocatable[:, uniq]).any(axis=0)
        ]
        return (
            "per-node overcommit on snapshot slot(s) "
            f"{[int(s) for s in over[:4]]}"
        )
    counts = batch.pod_count[uniq] + acc["count"][uniq] + d_count
    if bool((counts > batch.max_pods[uniq]).any()):
        return "per-node pod-count overcommit"
    acc["used"][:, uniq] += d_used
    acc["count"][uniq] += d_count
    return None


# -- the pure-host last rung --


def host_greedy_assign(prep, placed_by_slot, solver_config) -> np.ndarray:
    """The ladder's last rung: the reference's sequential scheduleOne
    loop in plain Python (``ops/oracle/profile.FullOracle``) over the
    group's already-materialized host state — zero accelerator surface.

    Filters: the full scalar oracle pipeline (fit, ports, spread,
    interpod, volumes, taints/affinity/selectors) AND the group's
    folded static class mask, so out-of-tree plugin / extender / DRA
    verdicts folded at tensorize time still hold. Scoring: the default
    profile weights with first-index tie-break (deterministic).
    Nominated-pod load is not modeled — this is the emergency rung;
    placements are valid, not nomination-optimal. Returns snapshot-slot
    assignments shaped exactly like the device solve's, so the apply
    path downstream is identical."""
    from .ops.oracle.profile import FullOracle, make_oracle_nodes

    live = [
        (slot, node)
        for slot, node in enumerate(prep.slot_nodes)
        if node is not None
    ]
    by_name = {
        node.name: list(placed_by_slot.get(slot, ()))
        for slot, node in live
    }
    oracle = FullOracle(
        make_oracle_nodes([node for _, node in live], by_name),
        volume_ctx=prep.volume_ctx,
        services=prep.services,
        spread_defaulting=solver_config.spread_defaulting,
        disabled=frozenset(solver_config.disabled_filters),
    )
    mask = np.asarray(prep.static.mask)
    class_of = np.asarray(prep.static.class_of)
    slot_of = [slot for slot, _ in live]
    out = np.full(len(prep.pods), -1, dtype=np.int32)
    for i, pod in enumerate(prep.pods):
        row = mask[int(class_of[i])]
        feasible = [
            j for j in oracle.feasible_set(pod) if row[slot_of[j]]
        ]
        if not feasible:
            continue
        totals = oracle.score_totals(pod, feasible)
        best = max(totals[j] for j in feasible)
        pick = next(j for j in feasible if totals[j] == best)
        oracle.nodes[pick].add_pod(pod)
        out[i] = slot_of[pick]
    return out
