"""Exact-parity solver: pods in queue order, each placed against the node
state its predecessors left.

Counterpart of ``kubernetes_tpu/solver/exact.py``. Each per-pod step is a
dense filter mask + score over all nodes at once, then a tie-break argmax,
then the assume scatter into the carried node state, so the next step sees
the updated state -- the reference's strict pod-by-pod semantics
(schedule_one.go#schedulePod -> findNodesThatFitPod -> prioritizeNodes ->
selectHost, then cache.AssumePod).

Filter pipeline per step: NodeResourcesFit, the static class mask
(NodeName, NodeUnschedulable, TaintToleration, NodeAffinity, precompiled
per pod class), NodePorts, PodTopologySpread hard constraints and
InterPodAffinity, with the load of nominated pods folded into the monotone
filters (RunFilterPluginsWithNominatedPods). Score pipeline: the fit
strategy, BalancedAllocation, TaintToleration, NodeAffinity,
ImageLocality, PodTopologySpread and InterPodAffinity, normalized and
weighted as the default profile does.

Two executables, as in the JAX package (``_solve_scan`` and
``_solve_grouped`` under ``_run_packed``): the per-pod scan of
``_make_step`` and the grouped path (``solver/grouped.py``), which places
runs of identical pods in chunks and replays every other chunk through the
scan's step; ``_Run`` runs either over a range of pods, and
``grouped_eligible`` chooses. The loops are Python whose state stays on
the device: what it branches on (the pod's
class, its constraint slots, its nomination, whether it is valid) is host
data from the tensorizers, and only the grouped random mode reads the
device inside the loop (``solver/grouped.py``).

Modes of ``solve``: standalone (everything uploaded, the node state
written back into the NodeBatch with one read), session (``col_versions``:
the node tables and the carried fit state stay on the card between
batches, ``solver/session.py``), deferred reads, sub-batches chained on
the carried state (``split``) and the streaming carry across batches
(``stream_carry_out`` / ``chain_occupancy``). Only ``mesh`` raises: the
port runs on one device.

selectHost tie-break: "first" takes the lowest node index among the
max-score ties and is bit-identical to the JAX package. "random" draws
from a ``torch.Generator`` seeded with ``seed + solve count`` (a chained
sub-batch folds its index into that seed); it cannot reproduce the JAX
package's threefry stream, and is held to the oracle's tie set.

``capture_hook`` (set by the Scheduler's flight telemetry) receives each
solve's resolved inputs before the generator's seed is derived from the
solve count, as the JAX package's does, so a replay bundle re-runs the
exact solve. The host-to-device and device-to-host bytes go to the
registry's ``scheduler_tpu_{h2d,d2h}_bytes_total``.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from .. import metrics
from ..ops import interpod as ip
from ..ops import noderesources as nr
from ..ops import plugins as pl
from ..ops import spread as sp
from ..tensorize.interpod import InterpodTensors, trivial_interpod_tensors
from ..tensorize.plugins import (
    PortTensors,
    StaticPluginTensors,
    trivial_port_tensors,
    trivial_static_tensors,
)
from ..tensorize.schema import MEM_IDX, NodeBatch, PodBatch
from ..tensorize.spread import SpreadTensors, trivial_spread_tensors
from . import grouped as gp
from .budget import assert_index_headroom
from .session import (
    BatchCarriedUsage,
    DeferredAssignments,
    SessionDrainRequired,  # noqa: F401  (raised by sync; part of this module's API)
    _class_table_arrays,
    _class_table_digest,
    _DeviceSession,
    _node_bytes,
    _node_tables,
    _place_class_tables,
    to_dev,
)

TIE_RANDOM = "random"
TIE_FIRST = "first"


@dataclass(frozen=True)
class ExactSolverConfig:
    """The JAX package's ExactSolverConfig, field for field, without its
    TPU-only ``pallas`` switch: the domain_counts kernel is what runs on the
    card, with no flag. ``group_size`` is the grouped path's chunk (0 or 1
    disables it) and ``compact_wire`` its one-row-per-chunk upload; with
    ``tie_break="random"`` the grouped path places distinct tie nodes
    without replacement, so its placement distribution differs from the
    scan's for one seed, while "first" is bit-identical either way."""

    tie_break: str = TIE_RANDOM
    seed: int = 0
    # score-plugin weights of the default profile
    # (apis/config/v1/default_plugins.go)
    fit_weight: int = 1
    balanced_weight: int = 1
    # NodeResourcesFitArgs.scoringStrategy: LeastAllocated (default) |
    # MostAllocated | RequestedToCapacityRatio
    scoring_strategy: str = "LeastAllocated"
    cpu_weight: int = 1
    mem_weight: int = 1
    # RequestedToCapacityRatio shape: ((utilization, score), ...) ascending
    rtc_shape: tuple = ()
    taint_weight: int = 3
    node_affinity_weight: int = 2
    image_weight: int = 1
    spread_weight: int = 2
    interpod_weight: int = 2
    # InterPodAffinityArgs.hardPodAffinityWeight (read by the tensorizer)
    hard_pod_affinity_weight: int = 1
    balanced_fdtype: str = "float32"  # float64 matches the Go float64 oracle
    group_size: int = 64
    compact_wire: bool = True
    # plugins.filter.disabled: names whose in-scan Filter is skipped
    disabled_filters: tuple = ()
    # NodeAffinityArgs.addedAffinity (read by the tensorizer)
    added_affinity: object = None
    # PodTopologySpreadArgs.defaultingType (read by the tensorizer)
    spread_defaulting: str = "System"


def grouped_eligible(
    cfg: "ExactSolverConfig",
    pod_pad: int,
    node_pad: int,
    use_spread: bool,
    use_interpod: bool,
    use_nominated: bool = False,
    spread_groupable: bool = False,
    interpod_groupable: bool = False,
) -> bool:
    """Single source of truth for the grouped fast path's dispatch
    condition — the scheduler consults it when choosing the pod-axis
    padding bucket, and ExactSolver.solve when picking the executable, so
    the two can never drift into padding-without-grouping. Nominated-pod
    load (rare, preemption aftermath) routes through the per-pod scan.

    ``spread_groupable``/``interpod_groupable``: the batch-level facts
    that make the kind-2/3 quota chunks possible (hard-only spread with no
    soft constraints; anti-affinity-only interpod). Solve derives them
    from the tensors; the scheduler mirrors them from the pods for its
    padding decision — a mismatch degrades to padded-slow, never to a
    wrong result (unqualified chunks replay the full pipeline)."""
    return (
        cfg.group_size > 1
        and not cfg.disabled_filters
        and (not use_spread or spread_groupable)
        and (not use_interpod or interpod_groupable)
        and not use_nominated
        and pod_pad % cfg.group_size == 0
        and node_pad >= cfg.group_size  # order[:group] gather needs N >= G
    )


def _fit_scorer(scoring_strategy: str, rtc_shape: tuple):
    """Scoring-strategy dispatch (resource_allocation.go scorer selection)."""
    if scoring_strategy == "RequestedToCapacityRatio" and rtc_shape:
        sx = [int(p[0]) for p in rtc_shape]
        sy = [int(p[1]) for p in rtc_shape]
        return lambda requested, alloc, w: nr.rtc_score(requested, alloc, w, sx, sy)
    if scoring_strategy == "MostAllocated":
        return nr.most_allocated_score
    return nr.least_allocated_score


def _mask_and_score(
    tables,
    st,
    x,
    *,
    scoring_strategy: str,
    rtc_shape: tuple,
    disabled: tuple,
    w_fit: int,
    w_balanced: int,
    w_taint: int,
    w_nodeaff: int,
    w_image: int,
    w_spread: int,
    w_interpod: int,
    use_spread: bool,
    use_interpod: bool,
    d_pad: int,
    ipa_d_pad: int,
    fdtype: torch.dtype,
    spread_soft: bool = True,
    ipa_ident: bool = False,
    ipa_score: bool = True,
    use_nominated: bool = False,
    use_nominated_ports: bool = False,
    use_extra_score: bool = False,
):
    """One pod's filter + score pipeline over all nodes against node state
    ``st``. Returns ``score`` [N] int32, -1 on infeasible lanes.

    ``x`` holds the pod's rows as device tensors, plus host values: its
    class ``class_of``, ``has_port_conflicts`` (False when no port slot
    can conflict, which makes NodePorts a no-op for this pod, nominated
    hostPorts included) and, with nominated pods, its level row
    ``nom_level`` and its own nominated slot ``nominated_slot``."""
    alloc = tables["alloc"]
    alloc2 = alloc[: MEM_IDX + 1]  # cpu, memory rows for scoring
    fit_scorer = _fit_scorer(scoring_strategy, rtc_shape)
    cls = x["class_of"]

    mask = tables["static_mask"][cls] & tables["node_valid"]
    used = st["used"]
    pod_count = st["pod_count"]
    port_used = st["port_used"]
    if use_nominated:
        # addNominatedPods: nominated pods with priority >= this pod's count
        # as placed for the monotone filters, less those already placed by
        # earlier steps (the correction rows) and less the pod's own
        # nomination. Row 0 of every level table is zero, so a pod that
        # outranks every nomination and carries none adds nothing.
        lvl = x["nom_level"]
        s = x["nominated_slot"]
        if lvl > 0 or s >= 0:
            extra_u = tables["nom_used"][lvl] - st["nom_corr_used"][lvl]
            extra_c = tables["nom_cnt"][lvl] - st["nom_corr_cnt"][lvl]
            if s >= 0:
                extra_u[:, s] -= x["req"]
                extra_c[s] -= 1
            used = used + extra_u
            pod_count = pod_count + extra_c
            if use_nominated_ports and x["has_port_conflicts"]:
                # NodePorts is as monotone as resources
                extra_p = tables["nom_ports"][lvl] - st["nom_corr_ports"][lvl]
                if s >= 0:
                    extra_p[:, s] -= x["pod_takes"]
                port_used = port_used + extra_p
    if "NodeResourcesFit" not in disabled:
        mask = mask & nr.fit_mask(
            x["req"], x["req_mask"], alloc, used, pod_count, tables["max_pods"],
        )
    if "NodePorts" not in disabled and x["has_port_conflicts"]:
        mask = mask & ~pl.ports_conflict_mask(x["pod_conflict"], port_used)
    if use_spread and "PodTopologySpread" not in disabled:
        mask = mask & ~sp.hard_violations(tables["spr"], st["spr_cnt"], cls, d_pad)
    if use_interpod:
        ipa_allowed, ipa_raw = ip.filter_and_score(
            tables["ipa"], st["ipa_in"], st["ipa_ex"], cls, x, ipa_d_pad,
            tables["node_valid"],
            ident=ipa_ident, score=ipa_score and w_interpod > 0,
        )
        if "InterPodAffinity" not in disabled:
            mask = mask & ipa_allowed

    requested = nr.scoring_requested(x["nonzero_req"], st["nonzero_used"])
    score = w_fit * fit_scorer(requested, alloc2, tables["fit_weights"])
    score = score + w_balanced * nr.balanced_allocation_score(
        requested, alloc2, fdtype=fdtype
    )
    score = score.to(torch.int32)
    if w_taint:
        score = score + w_taint * pl.normalize_score(
            tables["taint_cnt"][cls], mask, reverse=True
        )
    if w_nodeaff:
        score = score + w_nodeaff * pl.normalize_score(
            tables["nodeaff_pref"][cls], mask, reverse=False
        )
    if w_image:
        score = score + w_image * tables["image_score"][cls]
    if use_extra_score:
        score = score + tables["extra_score"][cls]
    if use_spread and w_spread and spread_soft:
        score = score + w_spread * sp.soft_scores(
            tables["spr"], st["spr_cnt"], cls, mask, d_pad, fdtype=fdtype
        )
    if use_interpod and w_interpod and ipa_score:
        score = score + w_interpod * ip.normalize(ipa_raw, mask)
    return torch.where(mask, score, -1)


def _make_step(tables, *, tie_break: str, generator: torch.Generator | None, **pipe_kw):
    """The per-pod scan step: the full filter + score pipeline, the
    tie-break pick and the assume scatter. ``step(st, packed, x)`` updates
    the packed carried state in place (the JAX scan returns a new carry;
    updating in place saves a copy of the node state per pod) and returns
    the pod's assignment as a 0-d device tensor (-1: unschedulable)."""
    use_nominated = pipe_kw.get("use_nominated", False)
    use_nominated_ports = pipe_kw.get("use_nominated_ports", False)

    def step(st, packed, x):
        score = _mask_and_score(tables, st, x, **pipe_kw)
        if tie_break == TIE_RANDOM:
            best = torch.max(score)
            ties = (score == best) & (score >= 0)
            csum = torch.cumsum(ties.to(torch.int32), dim=0)
            m = torch.clamp(csum[-1], min=1).to(torch.int64)
            u = torch.rand(
                (), generator=generator, dtype=torch.float64, device=score.device
            )
            rank = torch.minimum(torch.floor(u * m).to(torch.int64), m - 1)
            # torch.argmax takes no bool: the first index with csum > rank
            pick = torch.argmax((csum > rank).to(torch.int32))
        else:
            # the first maximal index, as jnp.argmax gives it
            best, pick = torch.max(score, dim=0)
        s_nom = x["nominated_slot"] if use_nominated else -1
        if s_nom >= 0:
            # schedule_one.go#evaluateNominatedNode: a pod carrying a
            # nomination takes that node if it is feasible, before any
            # scoring of alternatives
            pick = torch.where(score[s_nom] >= 0, s_nom, pick)
        found = best >= 0
        idx = pick.view(1)
        packed["i64"].index_add_(1, idx, (x["take64"] * found.to(torch.int64))[:, None])
        packed["i32"].index_add_(1, idx, (x["take32"] * found.to(torch.int32))[:, None])
        if s_nom >= 0:
            # a placed nominated pod leaves the nominator map: its load, at
            # its nominated slot where the level tables counted it, goes
            # into every correction row its priority contributed to
            lvl = x["nom_level"]
            st["nom_corr_used"][lvl:, :, s_nom] += (x["req"] * found)[None, :]
            st["nom_corr_cnt"][lvl:, s_nom] += found.to(torch.int32)
            if use_nominated_ports:
                st["nom_corr_ports"][lvl:, :, s_nom] += (
                    x["pod_takes"] * found.to(torch.int32)
                )[None, :]
        return torch.where(found, pick, -1)

    return step


def _fold_seed(seed: int, i: int) -> int:
    """The seed of chained sub-batch ``i``: the solve's seed with the
    index folded in (``jax.random.fold_in(key, i)`` in the JAX package)."""
    return (seed * 0x9E3779B97F4A7C15 + i + 1) % (1 << 63)


class _PodRows:
    """The per-pod inputs of one solve: host numpy arrays, their device
    copies, and row access for the scan step and the fast chunks. In
    compact mode each array holds one representative row per chunk."""

    def __init__(self, host: dict, dev):
        self.host = host
        self.dev = {k: to_dev(host[k], dev) for k in _DEV_NAMES}
        k = host["req_mask"].shape[1]
        self.dev["req"] = self.dev["take64"][:, :k]
        self.dev["nonzero_req"] = self.dev["take64"][:, k:]
        b = host["pod_takes"].shape[1]
        self.dev["pod_takes"] = self.dev["take32"][:, 1 : 1 + b]
        self.host_names = tuple(
            n for n in ("class_of", "has_port_conflicts", "nom_level", "nominated_slot")
            if n in host
        )

    def nbytes(self) -> int:
        return sum(self.host[k].nbytes for k in self.dev if k in self.host)

    def row(self, i: int) -> dict:
        """The pod rows the scan step reads: device row views plus host
        ints."""
        x = {name: a[i] for name, a in self.dev.items()}
        for name in self.host_names:
            v = self.host[name][i]
            x[name] = bool(v) if v.dtype == bool else int(v)
        return x

    def host_row(self, i: int) -> dict:
        return {name: a[i] for name, a in self.host.items()}


def _pod_inputs(pods, static, ports, spread, interpod, nominated, nominated_slot,
                use_nominated):
    """The per-pod host arrays: what one placement adds to each packed
    state row (``take64``, ``take32``) and the rows the pipeline reads."""
    pp = pods.padded
    pod_takes = np.asarray(ports.pod_takes, np.int32)
    in_match = np.asarray(interpod.in_match, np.int32)
    ex_owned = np.asarray(interpod.ex_owned, np.int32)
    pod_conflict = np.asarray(ports.pod_conflict, bool)
    host = {
        "take64": np.concatenate([pods.req, pods.nonzero_req], axis=1).astype(np.int64),
        "take32": np.concatenate(
            [np.ones((pp, 1), np.int32), pod_takes,
             np.asarray(spread.placed_match, np.int32), in_match, ex_owned],
            axis=1,
        ),
        "req_mask": np.asarray(pods.req_mask, bool),
        "pod_conflict": pod_conflict,
        "ipa_m_anti": np.asarray(interpod.m_anti, bool),
        "ipa_m_w": np.asarray(interpod.m_w, np.int32),
        "ipa_self_aff": np.asarray(interpod.self_aff, bool),
        "class_of": np.asarray(static.class_of).astype(np.int64),
        "has_port_conflicts": pod_conflict.any(axis=1),
        "pod_takes": pod_takes,
        "ipa_in_match": in_match,
        "ipa_ex_owned": ex_owned,
    }
    if use_nominated:
        slots = np.full(pp, -1, dtype=np.int64)
        if nominated_slot is not None:
            slots[: len(nominated_slot)] = nominated_slot
        host["nominated_slot"] = slots
        host["nom_level"] = nominated.level_of(
            np.asarray(pods.priority, dtype=np.int32)
        ).astype(np.int64)
    return host


# the per-pod arrays that go to the device (the rest are read on the host)
_DEV_NAMES = ("take64", "take32", "req_mask", "pod_conflict", "ipa_m_anti", "ipa_m_w",
              "ipa_self_aff")
# the arrays that must be uniform within a chunk for the compact wire (the
# JAX package checks its packed per-dtype uploads, which hold these)
_UNIFORM_NAMES = _DEV_NAMES + ("class_of",)


def _compact_rows(host: dict, valid: np.ndarray, group: int):
    """The compact wire's precondition and rows: within every chunk the
    validity is a prefix and the valid rows are identical. Returns (one
    row per chunk of every array, valid count per chunk) or None."""
    c = valid.shape[0] // group
    pvc = valid.reshape(c, group)
    vc = pvc.sum(axis=1).astype(np.int64)
    if not (pvc == (np.arange(group)[None, :] < vc[:, None])).all():
        return None
    for name in _UNIFORM_NAMES:
        a = host[name].reshape(c, group, -1)
        if not ((a == a[:, :1]) | ~pvc[:, :, None]).all():
            return None
    rows = {name: np.ascontiguousarray(a.reshape((c, group) + a.shape[1:])[:, 0])
            for name, a in host.items()}
    return rows, vc


def _capture_config_fingerprint(cfg: "ExactSolverConfig") -> dict:
    """JSON-safe config snapshot for the telemetry capture hook (lazy
    import: the solver must not pull the obs layer in at module load)."""
    from ..obs.bundle import config_fingerprint

    return config_fingerprint(cfg)


class ExactSolver:
    """Host-facing wrapper: NodeBatch/PodBatch (+ plugin tensors) in,
    assignments out, node state written back (the device-side assume)."""

    def __init__(self, config: ExactSolverConfig | None = None):
        self.config = config or ExactSolverConfig()
        self._step_count = 0
        self._session = _DeviceSession()
        # flight-telemetry input snapshot hook (obs/bundle.py): when set,
        # solve() hands over its resolved inputs -- before the seed is
        # derived and before the trivial tensors are filled in -- so a
        # replay bundle can re-run the exact solve offline. A host-side
        # callable; it never touches device state.
        self.capture_hook = None
        # executable-dispatch histogram, as the JAX package keeps it:
        # "scan" counts per-pod-scan solves, "kindK" grouped chunks by kind,
        # "compact_batches" compact-wire solves, "chained_subbatches" and
        # "stream_chained" the chained dispatches
        self.dispatch_counts: Counter = Counter()

    def _transferred(self, direction: str, nbytes: int) -> None:
        """Count a solve's host-to-device or device-to-host bytes into the
        metrics registry's transfer counters, as the JAX package does."""
        counter = metrics.h2d_bytes_total if direction == "h2d" else metrics.d2h_bytes_total
        counter.inc(int(nbytes))

    def reset_session(self) -> None:
        """Drop the card-resident session so the next solve uploads node
        tables and carried state anew from the host snapshot (a deferred
        solve was discarded: its placements advanced the carried state on
        the card). The class-table cache is content-addressed and cannot
        be stale, so it survives."""
        fresh = _DeviceSession()
        fresh.class_cache = self._session.class_cache
        self._session = fresh

    # -- cross-batch occupancy chaining (the streaming dispatcher) --

    def stream_chain_key(
        self,
        nodes: NodeBatch,
        pods: PodBatch,
        static: StaticPluginTensors,
        ports: PortTensors | None = None,
        spread: SpreadTensors | None = None,
        interpod: InterpodTensors | None = None,
        mesh=None,
    ) -> tuple:
        """Fingerprint of everything that makes one batch's carried
        occupancy state shape- and meaning-compatible with the next
        batch's dispatch: the class-table content, the ordered port
        vocabulary, the packed row layout, the node padding and resource
        width, and the domain paddings (the JAX package's key; its mesh
        component is None here). Two consecutive batches with equal keys
        may chain."""
        if mesh is not None:
            raise NotImplementedError("mesh is not ported; the port runs on one device")
        if ports is None:
            ports = trivial_port_tensors(pods, nodes.padded)
        if spread is None:
            spread = trivial_spread_tensors(pods, nodes.padded, static.c_pad)
        if interpod is None:
            interpod = trivial_interpod_tensors(pods, nodes.padded, static.c_pad)
        return (
            _class_table_digest(static, spread, interpod),
            hashlib.blake2b(repr(ports.vocab).encode(), digest_size=16).digest(),
            None,
            nodes.padded,
            nodes.allocatable.shape[0],
            ports.used.shape[0],
            spread.cnt0.shape[0],
            interpod.in_cnt0.shape[0],
            interpod.ex_cnt0.shape[0],
            spread.d_pad,
            interpod.d_pad,
        )

    def can_chain(self, key: tuple, col_versions: np.ndarray) -> bool:
        """True when the next solve may consume the resident stream carry:
        a carry exists, its key matches, and no snapshot column went dirty
        past the carry's own baseline (``stream_versions``)."""
        s = self._session
        if s.stream_carry is None or s.stream_key != key:
            return False
        if s.padded == -1 or s.stream_versions is None:
            return False
        if col_versions is None or s.padded > len(col_versions):
            return False
        return not bool(np.any(col_versions[: s.padded] > s.stream_versions))

    def note_stream_applied(self, col_versions: np.ndarray) -> None:
        """Advance the stream carry's column baseline after the caller
        applied a solve cleanly: the apply wrote the usage the session had
        assumed, so host truth catching up is not drift."""
        s = self._session
        if s.stream_carry is None or s.padded == -1:
            return
        if col_versions is None or s.padded > len(col_versions):
            return
        s.stream_versions = col_versions[: s.padded].copy()

    def invalidate_stream_carry(self) -> None:
        """Drop the resident stream carry (an unclean apply: the carried
        state may hold a phantom placement)."""
        self._session.drop_stream_carry()

    def solve(
        self,
        nodes: NodeBatch,
        pods: PodBatch,
        static: StaticPluginTensors | None = None,
        ports: PortTensors | None = None,
        spread: SpreadTensors | None = None,
        interpod: InterpodTensors | None = None,
        col_versions: np.ndarray | None = None,
        nominated=None,
        nominated_slot: np.ndarray | None = None,
        defer_read: bool = False,
        allow_heal: bool = True,
        split: int = 1,
        mesh=None,
        chain_occupancy: bool = False,
        stream_carry_out: bool = False,
        chain_key: tuple | None = None,
        device: str | torch.device | None = None,
    ):
        """Returns assignments [num_pods] of node indices (-1 =
        unschedulable), a DeferredAssignments, or a list of them.

        Standalone mode (``col_versions`` None): uploads everything, and
        writes the updated ``used``, ``nonzero_used`` and ``pod_count`` back
        into ``nodes`` in place with one read.

        Session mode (``col_versions`` from a snapshot): node tables and
        the carried fit state stay on the card between calls; only columns
        whose version advanced upload again, only the assignments come
        back, and ``nodes`` is not written back. ``allow_heal=False``
        defers the dirty-column heal (SessionDrainRequired on a shape
        change).

        ``defer_read`` (session mode): return a DeferredAssignments instead
        of reading the card. ``split`` (session + defer_read): up to
        ``split`` sub-batches, each placed on the state the previous left,
        one handle each (always a list when ``split > 1``).
        ``stream_carry_out`` keeps the full carried state on the card as
        the session's stream carry, tagged with ``chain_key``
        (``stream_chain_key``); a later solve with ``chain_occupancy``
        starts from it instead of the host's occupancy rows. Nominated
        batches never split or stream.

        ``device``: where the solve runs; None is the card (and raises when
        CUDA is absent). ``mesh`` raises NotImplementedError. Without
        ``static``/``ports``/``spread``/``interpod`` tensors, trivial ones
        reproduce the resources-only pipeline."""
        if mesh is not None:
            raise NotImplementedError("mesh is not ported; the port runs on one device")
        dev = device_mod.resolve(device)
        cfg = self.config
        if self.capture_hook is not None:
            # step_count is exactly what a replay must restore, and None
            # containers stay None (the replayed solve fills in the same
            # trivial tensors); raw references, which the hook copies
            self.capture_hook(
                nodes=nodes,
                pods=pods,
                static=static,
                ports=ports,
                spread=spread,
                interpod=interpod,
                nominated=nominated,
                nominated_slot=nominated_slot,
                step_count=self._step_count,
                split=split,
                defer_read=defer_read,
                session=col_versions is not None,
                allow_heal=allow_heal,
                chain_occupancy=chain_occupancy,
                config=_capture_config_fingerprint(cfg),
            )
        fdtype = torch.float64 if cfg.balanced_fdtype == "float64" else torch.float32
        seed = cfg.seed + self._step_count
        self._step_count += 1
        if static is None:
            static = trivial_static_tensors(pods, nodes.padded, nodes.schedulable)
        if ports is None:
            ports = trivial_port_tensors(pods, nodes.padded)
        if spread is None:
            spread = trivial_spread_tensors(pods, nodes.padded, static.c_pad)
        if interpod is None:
            interpod = trivial_interpod_tensors(pods, nodes.padded, static.c_pad)
        use_spread = not spread.empty
        use_interpod = not interpod.empty
        use_nominated = nominated is not None and not nominated.empty
        use_nominated_ports = use_nominated and nominated.port_takes is not None
        session = col_versions is not None

        # the flattened-index products of this dispatch fit their dtypes
        assert_index_headroom(
            pods.padded,
            nodes.padded,
            d_pad=max(spread.d_pad, interpod.d_pad),
            group=max(cfg.group_size, 1),
        )

        h2d = 0
        if session:
            h2d += self._session.sync(nodes, col_versions, dev, allow_heal=allow_heal)
            nt, persist = self._session.nt, self._session.persist
            ct, ct_bytes = self._session.class_tables(
                static, spread, interpod,
                digest=chain_key[0] if chain_key is not None else None,
            )
            h2d += ct_bytes
        else:
            nt, persist = _node_tables(nodes, dev)
            ct = _place_class_tables(static, spread, interpod, dev)
            h2d += _node_bytes(nodes) + sum(
                np.asarray(a).nbytes for a in _class_table_arrays(static, spread, interpod)
            )

        # per-batch node-state rows: ports, spread counts, interpod counts
        bstate = np.concatenate(
            [ports.used, spread.cnt0, interpod.in_cnt0, interpod.ex_cnt0], axis=0
        ).astype(np.int32)
        layout = (ports.used.shape[0], spread.cnt0.shape[0], interpod.in_cnt0.shape[0],
                  interpod.ex_cnt0.shape[0])

        tables = {
            **nt,
            **ct,
            "fit_weights": torch.tensor([cfg.cpu_weight, cfg.mem_weight],
                                        dtype=torch.int64, device=dev),
            # each solve keeps its own prepared kernel launches
            "spr": {**ct["spr"], "launch": {}},
            "ipa": {**ct["ipa"], "launch": {}},
            "ipa_d_pad": interpod.d_pad,
        }
        nom_state = {}
        if use_nominated:
            tables["nom_used"] = to_dev(nominated.used, dev, torch.int64)
            tables["nom_cnt"] = to_dev(nominated.count, dev, torch.int32)
            h2d += nominated.used.nbytes + nominated.count.nbytes
            # the placed-nominated correction carry starts empty each batch
            nom_state["nom_corr_used"] = torch.zeros_like(tables["nom_used"])
            nom_state["nom_corr_cnt"] = torch.zeros_like(tables["nom_cnt"])
            if use_nominated_ports:
                tables["nom_ports"] = to_dev(nominated.port_takes, dev, torch.int32)
                h2d += nominated.port_takes.nbytes
                nom_state["nom_corr_ports"] = torch.zeros_like(tables["nom_ports"])

        host = _pod_inputs(pods, static, ports, spread, interpod, nominated,
                           nominated_slot, use_nominated)
        valid = np.asarray(pods.valid & pods.feasible_static, bool)

        kw = dict(
            scoring_strategy=cfg.scoring_strategy,
            rtc_shape=tuple(tuple(p) for p in cfg.rtc_shape),
            disabled=tuple(sorted(cfg.disabled_filters)),
            w_fit=cfg.fit_weight,
            w_balanced=cfg.balanced_weight,
            # an all-zero preference row normalizes to one value on every
            # feasible node, and a constant cannot move the argmax or its
            # tie set, so the plugin's weight is dropped (as the JAX
            # package drops it at trace time)
            w_taint=cfg.taint_weight if np.any(static.taint_cnt) else 0,
            w_nodeaff=cfg.node_affinity_weight if np.any(static.nodeaff_pref) else 0,
            w_image=cfg.image_weight if np.any(static.image_score) else 0,
            w_spread=cfg.spread_weight,
            w_interpod=cfg.interpod_weight,
            use_spread=use_spread,
            use_interpod=use_interpod,
            d_pad=spread.d_pad,
            ipa_d_pad=interpod.d_pad,
            fdtype=fdtype,
            spread_soft=spread.has_soft,
            ipa_ident=interpod.ident,
            ipa_score=interpod.has_score,
            use_nominated=use_nominated,
            use_nominated_ports=use_nominated_ports,
            use_extra_score=static.extra_score is not None,
        )
        group = cfg.group_size
        grouped = grouped_eligible(
            cfg, pods.padded, nodes.padded, use_spread, use_interpod, use_nominated,
            spread_groupable=not spread.has_soft,
            interpod_groupable=interpod.anti_only,
        )
        kinds = vcnt = None
        compact = False
        if grouped:
            kinds = self._chunk_kinds(pods, static, ports, spread, interpod, group,
                                      use_spread, use_interpod)
            for v, cnt in zip(*np.unique(kinds, return_counts=True)):
                self.dispatch_counts[f"kind{int(v)}"] += int(cnt)
            vcnt = valid.reshape(-1, group).sum(axis=1)
            packed_rows = _compact_rows(host, valid, group) if cfg.compact_wire else None
            if packed_rows is not None:
                compact = True
                host, vcnt = packed_rows
                self.dispatch_counts["compact_batches"] += 1
        else:
            group = 1
            self.dispatch_counts["scan"] += 1
        xs = _PodRows(host, dev)

        stream = (
            session and defer_read and not use_nominated
            and (chain_occupancy or stream_carry_out)
        )
        chain_occupancy = chain_occupancy and stream
        if chain_occupancy and not self.can_chain(chain_key, col_versions):
            raise ValueError(
                "chain_occupancy requested but the session carry does not match "
                "(stale key or dirty columns)"
            )
        h2d += (0 if chain_occupancy else bstate.nbytes) + xs.nbytes()
        self._transferred("h2d", h2d)

        run = _Run(tables, nom_state, xs, valid, layout, kinds, vcnt, group, compact,
                   cfg.tie_break, kw, dev)
        want_chain = split > 1 and session and defer_read
        if (want_chain or stream) and not use_nominated:
            k_split = self._feasible_split(max(split, 1), pods.padded, grouped, group)
            if k_split > 1 or stream:
                # stream solves go through the chain dispatcher even unsplit:
                # it is the one path that consumes and keeps the carry
                handles = self._solve_chain(
                    k_split, run, persist, bstate, pods, seed,
                    chain_start=self._session.stream_carry if chain_occupancy else None,
                    carry_out=stream_carry_out, chain_key=chain_key,
                )
                if self._session.stream_carry is not None:
                    self._session.stream_versions = col_versions[: self._session.padded].copy()
                return handles

        if session:
            # this solve writes persist in place, and the stream carry shares
            # persist's tensors: the carry cannot survive it
            self._session.drop_stream_carry()
        packed = run.packed(persist, to_dev(bstate, dev))
        run(packed, 0, pods.padded, seed)
        if session:
            persist["pod_count"] = packed["i32"][0]
            self._transferred("d2h", pods.padded * 8)
            if defer_read:
                handle = DeferredAssignments(run.assignments, pods.num_pods)
                # split asked for but clamped to one: still a list
                return [handle] if want_chain else handle
            return run.assignments.cpu().numpy()[: pods.num_pods].astype(np.int32)

        # standalone: one device-to-host read, node state and assignments
        flat = torch.cat(
            [packed["i64"].reshape(-1), packed["i32"][0].to(torch.int64), run.assignments]
        ).cpu().numpy()
        self._transferred("d2h", flat.nbytes)
        k = nodes.allocatable.shape[0]
        npad = nodes.padded
        nodes.used = flat[: k * npad].reshape(k, npad)
        nodes.nonzero_used = flat[k * npad : (k + 2) * npad].reshape(2, npad)
        o = (k + 2) * npad
        nodes.pod_count = flat[o : o + npad].astype(np.int32)
        o += npad
        return flat[o:].astype(np.int32)[: pods.num_pods]

    @staticmethod
    def _feasible_split(split: int, pod_pad: int, grouped: bool, group: int) -> int:
        """Largest K <= split such that the padded pod axis cuts into K
        equal sub-batches, each a whole number of chunks when the grouped
        path engages."""
        for k in range(min(split, pod_pad), 1, -1):
            if pod_pad % k:
                continue
            if grouped and (pod_pad // k) % group:
                continue
            return k
        return 1

    def _solve_chain(self, k_split: int, run, persist, bstate, pods: PodBatch, seed: int, *,
                     chain_start: dict | None = None, carry_out: bool = False,
                     chain_key: tuple | None = None) -> list[DeferredAssignments]:
        """One tensorized batch as ``k_split`` sub-solves, each placed on
        the packed state the previous one left (BatchCarriedUsage), one
        DeferredAssignments each. Trailing all-padding sub-batches are not
        run. ``chain_start``: the previous batch's full carried state (the
        stream carry), which the first sub-solve starts from instead of the
        host's occupancy rows; ``carry_out`` keeps the final state as the
        session's stream carry under ``chain_key``."""
        sub = pods.padded // k_split
        handles: list[DeferredAssignments] = []
        if chain_start is not None:
            self.dispatch_counts["stream_chained"] += 1
            carry = BatchCarriedUsage(chain_start)
        else:
            carry = BatchCarriedUsage(run.packed(persist, to_dev(bstate, run.dev)))
        # the carry is consumed here, or the chain writes the tensors it shares
        self._session.drop_stream_carry()
        try:
            for i in range(k_split):
                lo = i * sub
                if lo >= pods.num_pods:
                    break
                run(carry.state, lo, lo + sub, _fold_seed(seed, i))
                handles.append(DeferredAssignments(
                    run.assignments[lo : lo + sub], min(sub, pods.num_pods - lo), lo=lo
                ))
        except Exception:
            # the chain wrote the session's state in place before dying: the
            # resident state is unusable, so the next solve uploads anew
            self.reset_session()
            raise
        persist["pod_count"] = carry.state["i32"][0]
        self._transferred("d2h", pods.padded * 8)
        if carry_out and chain_key is not None:
            self._session.stream_carry = carry.state
            self._session.stream_key = chain_key
        self.dispatch_counts["chained_subbatches"] += len(handles)
        return handles

    _chunk_kinds = staticmethod(gp.chunk_kinds)


class _Run:
    """One solve's executable over its prepared inputs: ``packed`` builds
    the carried state, and a call runs the per-pod scan, or the grouped
    path chunk by chunk, over the pods [lo, hi) into ``assignments``."""

    def __init__(self, tables, nom_state, xs, valid, layout, kinds, vcnt, group, compact,
                 tie_break, kw, dev):
        self.tables, self.nom_state, self.xs, self.valid = tables, nom_state, xs, valid
        self.layout, self.kinds, self.vcnt = layout, kinds, vcnt
        self.group, self.compact, self.tie_break, self.kw, self.dev = (
            group, compact, tie_break, kw, dev,
        )
        self.assignments = torch.full((valid.shape[0],), -1, dtype=torch.int64, device=dev)

    def packed(self, persist, bstate_dev) -> dict:
        """The carried state of a solve: the fit rows (the session's
        resident tensor, or the standalone upload) and the batch's int32
        rows behind the pod count."""
        return {"i64": persist["i64"],
                "i32": torch.cat([persist["pod_count"][None], bstate_dev])}

    def state_views(self, packed) -> dict:
        k = packed["i64"].shape[0] - 2
        i32 = packed["i32"]
        st = {"used": packed["i64"][:k], "nonzero_used": packed["i64"][k:], "pod_count": i32[0]}
        off = 1
        for name, rows in zip(("port_used", "spr_cnt", "ipa_in", "ipa_ex"), self.layout):
            st[name] = i32[off : off + rows]
            off += rows
        st.update(self.nom_state)
        return st

    def __call__(self, packed, lo: int, hi: int, seed: int) -> None:
        generator = None
        if self.tie_break == TIE_RANDOM:
            generator = torch.Generator(device=self.dev)
            generator.manual_seed(seed)
        st = self.state_views(packed)
        step = _make_step(self.tables, tie_break=self.tie_break, generator=generator,
                          **self.kw)
        asg = self.assignments
        if self.kinds is None:
            for i in range(lo, hi):
                if self.valid[i]:
                    asg[i] = step(st, packed, self.xs.row(i))
            return
        group, kw = self.group, self.kw
        fast_kw = dict(
            group=group, tie_break=self.tie_break, generator=generator,
            fit_scorer=_fit_scorer(kw["scoring_strategy"], kw["rtc_shape"]),
            fdtype=kw["fdtype"], w_fit=kw["w_fit"], w_balanced=kw["w_balanced"],
            w_taint=kw["w_taint"], w_nodeaff=kw["w_nodeaff"], w_image=kw["w_image"],
            use_extra=kw["use_extra_score"],
        )
        for c in range(lo // group, hi // group):
            base = c * group
            kind = int(self.kinds[c])
            if kind == gp.KIND_SLOW:
                for t in range(group):
                    if self.valid[base + t]:
                        r = c if self.compact else base + t
                        asg[base + t] = step(st, packed, self.xs.row(r))
                continue
            vc = int(self.vcnt[c])
            if vc == 0:
                continue  # an all-padding chunk places nothing
            mode = {gp.KIND_PLAIN: None, gp.KIND_SPREAD: "spread", gp.KIND_ANTI: "anti"}[kind]
            r = c if self.compact else base
            x = self.xs.row(r)
            chunk_asg, m = gp.fast_chunk(mode, self.tables, st, x, self.xs.host_row(r), vc,
                                         **fast_kw)
            asg[base : base + group] = chunk_asg
            packed["i64"] += x["take64"][:, None] * m.to(torch.int64)[None, :]
            packed["i32"] += x["take32"][:, None] * m[None, :]
