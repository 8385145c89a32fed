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
(``stream_carry_out`` / ``chain_occupancy``), each on one device or on a
node-axis mesh (``mesh=``, ``parallel/sharding.py``): the step and the
fast chunks then run as one generator per shard in lockstep, and the
result equals the unsharded one bit for bit.

selectHost tie-break: "first" takes the lowest node index among the
max-score ties. "random" draws from the JAX package's own stream
(``ops/threefry.py``): the threefry key ``PRNGKey(seed + solve count)``,
``fold_in`` of the sub-batch index for a chained sub-batch, one split per
scan row (invalid rows included) and one per grouped-loop iteration, in
chunk order, drawn on the card by the threefry kernel. The draws are the
JAX package's bit for bit, so random mode gives its assignments as first
mode does (the paired tests hold both with ``balanced_fdtype="float64"``).

On the card, unsharded and with no nominated pods, the scan's steps replay
CUDA graphs of the step, one graph launch a pod; with LeastAllocated or
MostAllocated scoring the step, eager or captured, is its domain_counts
launches and one launch of the fused step kernel (``ops/scan_step.py``),
whose plain version ``_make_step`` is. In random mode the
iterations of a spread or anti chunk's loop replay graphs of the iteration
(``solver/graphs.py``); everywhere else, and for a signature too rare to
repay a capture, the step or iteration runs eagerly as written here. A
spread chunk's whole random loop there (LeastAllocated or MostAllocated
scoring) is one launch of the fused kernel instead
(``ops/grouped_spread.py``), whose iteration counts the call reads when
the card has written them (``timing.SolveTimes.deferred``).

``capture_hook`` (set by the Scheduler's flight telemetry) receives each
solve's resolved inputs before the key is derived from the solve count,
as the JAX package's does, so a replay bundle re-runs the exact solve.
The host-to-device and device-to-host bytes go to the registry's
``scheduler_tpu_{h2d,d2h}_bytes_total``.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import metrics
from ..ops import grouped_spread as gs
from ..ops import interpod as ip
from ..ops import noderesources as nr
from ..ops import plugins as pl
from ..ops import prng
from ..ops import scan_step as ss
from ..ops import spread as sp
from ..ops import threefry as tf
from ..parallel import sharding as sh
from ..tensorize.interpod import InterpodTensors, trivial_interpod_tensors
from ..tensorize.plugins import (
    PortTensors,
    StaticPluginTensors,
    trivial_port_tensors,
    trivial_static_tensors,
)
from ..tensorize.schema import MEM_IDX, NodeBatch, PodBatch
from ..tensorize.spread import SpreadTensors, trivial_spread_tensors
from . import graphs as sg
from . import grouped as gp
from .budget import assert_index_headroom
from .timing import CHUNK_KINDS, KERNELS, SolveTimes, launch_counts
from .session import (
    BatchCarriedUsage,
    DeferredAssignments,
    SessionDrainRequired,  # noqa: F401  (raised by sync; part of this module's API)
    _class_table_arrays,
    _class_table_digest,
    _DeviceSession,
    _node_bytes,
    _shard_class_tables,
    _shard_node_tables,
    shard_view,
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
        # ktpu: ignore[TPU001]: rtc_shape is the config's host tuple of Python ints; no card value is read
        sx = [int(p[0]) for p in rtc_shape]
        # ktpu: ignore[TPU001]: rtc_shape is the config's host tuple of Python ints; no card value is read
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
    """One pod's filter + score pipeline over one shard's nodes against
    node state ``st``. Returns ``score`` [w] int32, -1 on infeasible
    lanes. A generator of the shard protocol (``parallel/sharding.py``):
    the per-shard part computes the mask and the raw scores, and yields
    its partials (domain counts, maxima, minima, counts) where the
    normalizations and the domain aggregations need the whole node axis;
    the finish runs on the combined values. ``tables["lo"]`` is the
    shard's first global column.

    ``x`` holds the pod's rows as device tensors, plus host values: its
    class ``class_of``, ``has_port_conflicts`` (False when no port slot
    can conflict, which makes NodePorts a no-op for this pod, nominated
    hostPorts included) and, with nominated pods, its level row
    ``nom_level`` and its own nominated slot ``nominated_slot`` (a global
    index: only its owning shard subtracts the pod's own load)."""
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
        w = tables["node_valid"].shape[0]
        own = 0 <= s - tables["lo"] < w  # this shard holds the nominated slot
        s = s - tables["lo"]
        if lvl > 0 or x["nominated_slot"] >= 0:
            extra_u = tables["nom_used"][lvl] - st["nom_corr_used"][lvl]
            extra_c = tables["nom_cnt"][lvl] - st["nom_corr_cnt"][lvl]
            if own:
                extra_u[:, s] -= x["req"]
                extra_c[s] -= 1
            used = used + extra_u
            pod_count = pod_count + extra_c
            if use_nominated_ports and x["has_port_conflicts"]:
                # NodePorts is as monotone as resources
                extra_p = tables["nom_ports"][lvl] - st["nom_corr_ports"][lvl]
                if own:
                    extra_p[:, s] -= x["pod_takes"]
                port_used = port_used + extra_p
    if "NodeResourcesFit" not in disabled:
        mask = mask & nr.fit_mask(
            x["req"], x["req_mask"], alloc, used, pod_count, tables["max_pods"],
        )
    if "NodePorts" not in disabled and x["has_port_conflicts"]:
        mask = mask & ~pl.ports_conflict_mask(x["pod_conflict"], port_used)
    if use_spread and "PodTopologySpread" not in disabled:
        viol = yield from sp.hard_violations_g(tables["spr"], st["spr_cnt"], cls, d_pad)
        mask = mask & ~viol
    if use_interpod:
        ipa_allowed, ipa_raw = yield from ip.filter_and_score_g(
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
        score = score + w_taint * (yield from pl.normalize_score_g(
            tables["taint_cnt"][cls], mask, reverse=True
        ))
    if w_nodeaff:
        score = score + w_nodeaff * (yield from pl.normalize_score_g(
            tables["nodeaff_pref"][cls], mask, reverse=False
        ))
    if w_image:
        score = score + w_image * tables["image_score"][cls]
    if use_extra_score:
        score = score + tables["extra_score"][cls]
    if use_spread and w_spread and spread_soft:
        score = score + w_spread * (yield from sp.soft_scores_g(
            tables["spr"], st["spr_cnt"], cls, mask, d_pad, fdtype=fdtype
        ))
    if use_interpod and w_interpod and ipa_score:
        score = score + w_interpod * (yield from ip.normalize_g(ipa_raw, mask))
    return torch.where(mask, score, -1)


def _make_step(tables, *, tie_break: str, stream: tf.Stream | None, **pipe_kw):
    """The per-pod scan step of one shard: the full filter + score
    pipeline, the tie-break pick and the assume scatter. ``step(st,
    packed, x)`` is a generator of the shard protocol that updates the
    shard's packed carried state in place (the JAX scan returns a new
    carry; updating in place saves a copy of the node state per pod) and
    returns the pod's assignment as a 0-d device tensor (-1:
    unschedulable), a global node index.

    Sharded, "first" takes each shard's maximum and first local index and
    picks the lowest global index among the shards that hold the global
    maximum. "random" draws the pick's rank among the ties once per step
    from the one stream on the lead device, whatever the shard count,
    counts the ties per shard and finds the pick's shard from the prefix
    of the shard totals: the unsharded draw and pick, bit for bit. Only
    the owning shard's assume adds anything (the others add zero at a
    clamped index, which keeps the loop free of device reads)."""
    use_nominated = pipe_kw.get("use_nominated", False)
    use_nominated_ports = pipe_kw.get("use_nominated_ports", False)
    lo = tables["lo"]
    sharded = tables["shards"] > 1

    def step(st, packed, x):
        score = yield from _mask_and_score(tables, st, x, **pipe_kw)
        w = score.shape[0]
        if tie_break == TIE_RANDOM:
            best = yield sh.c_max, torch.max(score)
            ties = (score == best) & (score >= 0)
            csum = torch.cumsum(ties.to(torch.int32), dim=0)
            before, total = yield sh.c_prefix, csum[-1]
            # randint(sub, (), 0, max(n_ties, 1)), the tie count read on the card
            rank = yield sh.c_draw, (lambda: stream.rank(total), None, None, score.device)
            if sharded:
                local = rank - before
                own = (local >= 0) & (local < csum[-1])
                # torch.argmax takes no bool: the first index with csum > rank
                lpick = torch.argmax((csum > local).to(torch.int32))
                pick = yield sh.c_sum, torch.where(own, lpick + lo, 0)
            else:
                # torch.argmax takes no bool: the first index with csum > rank
                pick = torch.argmax((csum > rank).to(torch.int32))
        else:
            # the first maximal index, as jnp.argmax gives it
            best, pick = yield sh.c_first_max, (*torch.max(score, dim=0), lo)
        s_nom = x["nominated_slot"] if use_nominated else -1
        own_nom = 0 <= s_nom - lo < w
        if s_nom >= 0:
            # schedule_one.go#evaluateNominatedNode: a pod carrying a
            # nomination takes that node if it is feasible, before any
            # scoring of alternatives (its score read on its owning shard)
            nom_ok = yield sh.c_sum, (
                (score[s_nom - lo] >= 0).to(torch.int32) if own_nom
                else torch.zeros((), dtype=torch.int32, device=score.device)
            )
            pick = torch.where(nom_ok > 0, s_nom, pick)
        found = best >= 0
        if sharded:
            local = pick - lo
            hit = found & (local >= 0) & (local < w)
            idx = torch.clamp(local, 0, w - 1).view(1)
        else:
            hit, idx = found, pick.view(1)
        packed["i64"].index_add_(1, idx, (x["take64"] * hit.to(torch.int64))[:, None])
        packed["i32"].index_add_(1, idx, (x["take32"] * hit.to(torch.int32))[:, None])
        if own_nom:
            # a placed nominated pod leaves the nominator map: its load, at
            # its nominated slot where the level tables counted it, goes
            # into every correction row its priority contributed to
            lvl = x["nom_level"]
            ls = s_nom - lo
            st["nom_corr_used"][lvl:, :, ls] += (x["req"] * found)[None, :]
            st["nom_corr_cnt"][lvl:, ls] += found.to(torch.int32)
            if use_nominated_ports:
                st["nom_corr_ports"][lvl:, :, ls] += (
                    x["pod_takes"] * found.to(torch.int32)
                )[None, :]
        return torch.where(found, pick, -1)

    return step


class _PodRows:
    """The per-pod inputs of one solve: host numpy arrays, their device
    copies (one per distinct device of the mesh: the per-pod rows are
    replicated), and row access for the scan step and the fast chunks. In
    compact mode each array holds one representative row per chunk."""

    def __init__(self, host: dict, mesh):
        self.host = host
        self.devices = mesh.devices
        k = host["req_mask"].shape[1]
        b = host["pod_takes"].shape[1]
        self.by_dev = {}
        for dev in mesh.distinct:
            d = {name: to_dev(host[name], dev) for name in _DEV_NAMES}
            d["req"] = d["take64"][:, :k]
            d["nonzero_req"] = d["take64"][:, k:]
            d["pod_takes"] = d["take32"][:, 1 : 1 + b]
            self.by_dev[dev] = d
        self.host_names = tuple(
            n for n in ("class_of", "has_port_conflicts", "nom_level", "nominated_slot")
            if n in host
        )

    def nbytes(self) -> int:
        return sum(self.host[k].nbytes for k in _DEV_NAMES + ("pod_takes",) if k in self.host)

    def row(self, i: int) -> list:
        """The pod rows the scan step reads, per shard: device row views
        plus host ints (shards on one device share one dict)."""
        hostv = {}
        for name in self.host_names:
            v = self.host[name][i]
            hostv[name] = bool(v) if v.dtype == bool else int(v)
        rows = {}
        for dev, d in self.by_dev.items():
            x = {name: a[i] for name, a in d.items()}
            x.update(hostv)
            rows[dev] = x
        return [rows[dev] for dev in self.devices]

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

    def __init__(self, config: ExactSolverConfig | None = None, mesh=None):
        self.config = config or ExactSolverConfig()
        # the node-axis mesh solves run on by default (a NodeMesh;
        # solve(mesh=...) overrides per call). None = unsharded
        self.mesh = mesh
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
        # the last solve call's sub-stage seconds and counts (timing.py),
        # which the Scheduler hands to its StageProfiler after each call
        self.times = SolveTimes()
        # the scan step's CUDA graphs (graphs.py), made at the first solve
        # they engage in, and the scoring weights' device copies per mesh,
        # which keep their address from solve to solve for those graphs
        self.graphs: sg.StepGraphs | None = None
        self._fit_weights: dict[tuple, tuple] = {}
        # the kernel build directory is the solver's one durable warm
        # state: a restart loads the libraries instead of running nvcc
        from ..utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()

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
        width, the domain paddings, and the mesh's fingerprint (the JAX
        package's key; None unsharded). Two consecutive batches with equal
        keys may chain. ``mesh`` defaults to the constructor's."""
        if mesh is None:
            mesh = self.mesh
        if ports is None:
            ports = trivial_port_tensors(pods, nodes.padded)
        if spread is None:
            spread = trivial_spread_tensors(pods, nodes.padded, static.c_pad)
        if interpod is None:
            interpod = trivial_interpod_tensors(pods, nodes.padded, static.c_pad)
        return (
            _class_table_digest(static, spread, interpod),
            hashlib.blake2b(repr(ports.vocab).encode(), digest_size=16).digest(),
            sh.mesh_fingerprint(mesh),
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
        CUDA is absent). ``mesh`` (default: the constructor's): a NodeMesh
        whose shards split the node axis (``parallel/sharding.py``); the
        solve then runs on the mesh's devices, ``device`` aside, and equals
        the unsharded solve bit for bit. Without
        ``static``/``ports``/``spread``/``interpod`` tensors, trivial ones
        reproduce the resources-only pipeline."""
        tm = self.times
        tm.begin()
        with tm.stage("prepare"):
            if mesh is None:
                mesh = self.mesh
            dev = mesh.lead if mesh is not None else device_mod.resolve(device)
            shards = mesh if mesh is not None else sh.single(dev)
            w = shards.width(nodes.padded)
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
            key = prng.prng_key(cfg.seed + self._step_count)
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

            # per-batch node-state rows: ports, spread counts, interpod counts
            bstate = np.concatenate(
                [ports.used, spread.cnt0, interpod.in_cnt0, interpod.ex_cnt0], axis=0
            ).astype(np.int32)
            layout = (ports.used.shape[0], spread.cnt0.shape[0], interpod.in_cnt0.shape[0],
                      interpod.ex_cnt0.shape[0])

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
            stream = (
                session and defer_read and not use_nominated
                and (chain_occupancy or stream_carry_out)
            )
            chain_occupancy = chain_occupancy and stream

        with tm.stage("upload"):
            h2d = 0
            if session:
                h2d += self._session.sync(nodes, col_versions, dev, allow_heal=allow_heal,
                                          mesh=mesh)
                nt, persist = self._session.nt, self._session.persist
                ct, ct_bytes = self._session.class_tables(
                    static, spread, interpod,
                    digest=chain_key[0] if chain_key is not None else None,
                )
                h2d += ct_bytes
            else:
                nt, persist = _shard_node_tables(nodes, shards)
                ct = _shard_class_tables(static, spread, interpod, shards)
                h2d += _node_bytes(nodes) + sum(
                    np.asarray(a).nbytes for a in _class_table_arrays(static, spread, interpod)
                )
            wkey = (sh.mesh_fingerprint(shards), cfg.cpu_weight, cfg.mem_weight)
            if wkey not in self._fit_weights:
                self._fit_weights[wkey] = shards.replicate(
                    np.array([cfg.cpu_weight, cfg.mem_weight], np.int64))
            placed = {**nt, **ct, "fit_weights": self._fit_weights[wkey]}
            if use_nominated:
                placed["nom_used"] = shards.split(nominated.used, torch.int64)
                placed["nom_cnt"] = shards.split(nominated.count, torch.int32)
                h2d += nominated.used.nbytes + nominated.count.nbytes
                if use_nominated_ports:
                    placed["nom_ports"] = shards.split(nominated.port_takes, torch.int32)
                    h2d += nominated.port_takes.nbytes
            # one table view per shard; each solve keeps its own prepared
            # kernel launches
            tables, nom_state = [], []
            for s_i in range(shards.size):
                t = shard_view(placed, s_i)
                t["spr"]["launch"] = {}
                t["ipa"]["launch"] = {}
                t.update(ipa_d_pad=interpod.d_pad, lo=s_i * w, shards=shards.size)
                tables.append(t)
                ns = {}
                if use_nominated:
                    # the placed-nominated correction carry starts empty each batch
                    ns["nom_corr_used"] = torch.zeros_like(t["nom_used"])
                    ns["nom_corr_cnt"] = torch.zeros_like(t["nom_cnt"])
                    if use_nominated_ports:
                        ns["nom_corr_ports"] = torch.zeros_like(t["nom_ports"])
                nom_state.append(ns)
            xs = _PodRows(host, shards)
            # a chained solve starts from the resident carry, not these rows
            bstate_dev = None if chain_occupancy else shards.split(bstate)
            h2d += (0 if chain_occupancy else bstate.nbytes) + xs.nbytes()
            self._transferred("h2d", h2d)

        handles = None
        with tm.stage("issue") as st:
            if chain_occupancy and not self.can_chain(chain_key, col_versions):
                raise ValueError(
                    "chain_occupancy requested but the session carry does not match "
                    "(stale key or dirty columns)"
                )
            launches0 = launch_counts() if st.traced else None
            graphs = None
            if sg.engages(dev, shards.size, use_nominated):
                graphs = self.graphs = self.graphs or sg.StepGraphs()
            run = _Run(tables, nom_state, xs, valid, layout, kinds, vcnt, group, compact,
                       cfg.tie_break, kw, shards, tm, graphs)
            want_chain = split > 1 and session and defer_read
            if (want_chain or stream) and not use_nominated:
                k_split = self._feasible_split(max(split, 1), pods.padded, grouped, group)
                if k_split > 1 or stream:
                    # stream solves go through the chain dispatcher even unsplit:
                    # it is the one path that consumes and keeps the carry
                    handles = self._solve_chain(
                        k_split, run, persist, bstate_dev, pods, key,
                        chain_start=self._session.stream_carry if chain_occupancy else None,
                        carry_out=stream_carry_out, chain_key=chain_key,
                    )
            if handles is None:
                if session:
                    # this solve writes persist in place, and the stream carry
                    # shares persist's tensors: the carry cannot survive it
                    self._session.drop_stream_carry()
                packed = run.packed(persist, bstate_dev)
                run(packed, run.plan(0, pods.padded), key)
            if launches0 is not None:
                st.set(**tm.counts, card_reads=tm.card_reads,
                       launches=dict(zip(KERNELS, (b - a for a, b in zip(launches0,
                                                                         launch_counts())))))
        if handles is not None:
            if self._session.stream_carry is not None:
                self._session.stream_versions = col_versions[: self._session.padded].copy()
            return handles

        if session:
            persist["pod_count"] = tuple(p[0] for p in packed["i32"])
            self._transferred("d2h", pods.padded * 8)
            if defer_read:
                handle = DeferredAssignments(run.assignments, pods.num_pods)
                # split asked for but clamped to one: still a list
                return [handle] if want_chain else handle
            return run.assignments.cpu().numpy()[: pods.num_pods].astype(np.int32)

        # standalone: one device-to-host read, node state and assignments
        # (the shards' columns joined on the lead device first)
        lead = shards.lead
        i64 = torch.cat([t.to(lead) for t in packed["i64"]], dim=1)
        pod_count = torch.cat([t[0].to(lead) for t in packed["i32"]])
        flat = torch.cat(
            [i64.reshape(-1), pod_count.to(torch.int64), run.assignments]
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

    def _solve_chain(self, k_split: int, run, persist, bstate_dev, pods: PodBatch, key, *,
                     chain_start: dict | None = None, carry_out: bool = False,
                     chain_key: tuple | None = None) -> list[DeferredAssignments]:
        """One tensorized batch as ``k_split`` sub-solves, each placed on
        the packed state the previous one left (BatchCarriedUsage), one
        DeferredAssignments each. Trailing all-padding sub-batches are not
        run. ``chain_start``: the previous batch's full carried state (the
        stream carry), which the first sub-solve starts from instead of the
        host's occupancy rows; ``carry_out`` keeps the final state as the
        session's stream carry under ``chain_key``. In random mode sub-batch
        ``i`` draws from ``fold_in(key, i)``, as the JAX package's does."""
        sub = pods.padded // k_split
        handles: list[DeferredAssignments] = []
        if chain_start is not None:
            self.dispatch_counts["stream_chained"] += 1
            carry = BatchCarriedUsage(chain_start)
        else:
            carry = BatchCarriedUsage(run.packed(persist, bstate_dev))
        # the carry is consumed here, or the chain writes the tensors it shares
        self._session.drop_stream_carry()
        try:
            for i in range(k_split):
                lo = i * sub
                if lo >= pods.num_pods:
                    break
                run(carry.state, run.plan(lo, lo + sub), prng.fold_in(key, i))
                handles.append(DeferredAssignments(
                    run.assignments[lo : lo + sub], min(sub, pods.num_pods - lo), lo=lo
                ))
        except Exception:
            # the chain wrote the session's state in place before dying: the
            # resident state is unusable, so the next solve uploads anew
            self.reset_session()
            raise
        persist["pod_count"] = tuple(p[0] for p in carry.state["i32"])
        self._transferred("d2h", pods.padded * 8)
        if carry_out and chain_key is not None:
            self._session.stream_carry = carry.state
            self._session.stream_key = chain_key
        self.dispatch_counts["chained_subbatches"] += len(handles)
        return handles

    _chunk_kinds = staticmethod(gp.chunk_kinds)


class _Plan(NamedTuple):
    """One call's walk over pods [lo, hi) (``_Run.plan``), which the eager
    steps and both graph passes read. ``items`` in order: a scan step
    ``(KIND_SLOW, pod, row, owed, n)``, ``n`` its column of ``steps`` (rows,
    pods, owed), or a fast chunk with a valid pod ``(kind, first pod, row,
    owed, valid count)``; ``owed`` the stream's splits its draw pays, ``tail``
    those owed at the end. ``counts``: keyed as ``SolveTimes.counts``;
    ``quota``: whether a spread or anti chunk holds a valid pod."""

    lo: int
    hi: int
    items: list
    steps: np.ndarray
    tail: int
    counts: dict
    quota: bool


class _Run:
    """One solve's executable over its prepared inputs: ``packed`` builds
    the carried state, ``plan`` the walk of a call over the pods [lo, hi),
    and a call runs it, the per-pod scan or the grouped path chunk by
    chunk, into ``assignments``.
    ``tables`` and ``nom_state`` hold one view per shard of ``mesh``; the
    packed state is a dict of tuples of per-shard tensors, and each step
    or chunk runs one generator per shard in lockstep
    (``parallel/sharding.py``). The assignments live on the lead device.
    ``times``: the solver's SolveTimes, which counts the calls. ``graphs``
    (the solver's StepGraphs, or None): the scan's steps and the quota
    chunks' iterations replay its CUDA graphs where a call's signatures
    engage them (``graphs.py``)."""

    def __init__(self, tables, nom_state, xs, valid, layout, kinds, vcnt, group, compact,
                 tie_break, kw, mesh, times, graphs=None):
        self.tables, self.nom_state, self.xs, self.valid = tables, nom_state, xs, valid
        self.layout, self.kinds, self.vcnt = layout, kinds, vcnt
        self.group, self.compact, self.tie_break, self.kw, self.mesh = (
            group, compact, tie_break, kw, mesh,
        )
        self.times = times
        self.graphs = graphs
        # the graphs' epoch key of these tables, and whether the pod rows
        # are in the graphs' buffer (graphs.py), set at the first graph pass
        self.graph_epoch = None
        self.graph_rows = False
        self.dev = mesh.lead
        self.assignments = torch.full((valid.shape[0],), -1, dtype=torch.int64,
                                      device=self.dev)
        self.fit_scorer = _fit_scorer(kw["scoring_strategy"], kw["rtc_shape"])
        # whether the scan steps run in the fused step kernel (ops/scan_step.py)
        self.fused = ss.engages(self.dev, mesh.size, kw["use_nominated"], self.fit_scorer)

    def packed(self, persist, bstate_dev) -> dict:
        """The carried state of a solve: the fit rows (the session's
        resident tensors, or the standalone upload) and the batch's int32
        rows behind the pod count, per shard."""
        return {"i64": persist["i64"],
                "i32": tuple(torch.cat([pc[None], b])
                             for pc, b in zip(persist["pod_count"], bstate_dev))}

    def state_views(self, packed, s: int) -> dict:
        i64 = packed["i64"][s]
        k = i64.shape[0] - 2
        i32 = packed["i32"][s]
        st = {"used": i64[:k], "nonzero_used": i64[k:], "pod_count": i32[0]}
        off = 1
        for name, rows in zip(("port_used", "spr_cnt", "ipa_in", "ipa_ex"), self.layout):
            st[name] = i32[off : off + rows]
            off += rows
        st.update(self.nom_state[s])
        return st

    def make_step(self, tables, stream):
        """The scan step of one shard's ``tables`` drawing from ``stream``."""
        return _make_step(tables, tie_break=self.tie_break, stream=stream, **self.kw)

    def fused_step(self, tables, st, packed):
        """The fused step kernel's step over the unsharded ``tables``, state
        views ``st`` and packed state ``packed`` where it engages, else
        None."""
        if not self.fused:
            return None
        return ss.Step(tables, st, packed, self.kw, self.tie_break, self.fit_scorer)

    def read_placed(self, parts):
        """The grouped random loop's exit test, timed: one iteration. A
        spread chunk's read brings its water-fill flag too, counted here;
        every shard gets the count placed."""
        tm = self.times
        tm.counts["grouped_iterations"] += 1
        got = tm.read("grouped", gp._read_placed, parts)
        if isinstance(got[0], list):
            placed, waterfill = got[0]
            tm.counts["waterfill_iterations"] += waterfill
            return [placed] * len(got)
        return got

    def plan(self, lo: int, hi: int) -> _Plan:
        """The plan of a call over pods [lo, hi) (host work): every row a
        scan row (``kinds`` None), or each row of a slow chunk a scan row and
        each fast chunk one item. The owed splits' one rule: every scan row
        splits the stream, an invalid one by owing its split to the next
        draw; a fast chunk with a valid pod pays them with its first split;
        an all-padding chunk splits nothing."""
        valid, kinds, vcnt, group = self.valid, self.kinds, self.vcnt, self.group
        chunk = np.arange(lo // group, hi // group)
        if kinds is None:
            kind, vc = np.zeros(len(chunk), np.int64), valid[lo:hi].astype(np.int64)
        else:
            kind, vc = kinds[chunk].astype(np.int64), vcnt[chunk].astype(np.int64)
        # the events in order: every row of a slow chunk, one per fast chunk
        per = np.where(kind == gp.KIND_SLOW, group, 1)
        ev = np.repeat(np.arange(len(chunk)), per)
        at = chunk[ev] * group + np.arange(len(ev)) - np.repeat(np.cumsum(per) - per, per)
        scan = kind[ev] == gp.KIND_SLOW
        owing = np.concatenate([[0], np.cumsum(scan & ~valid[at])])
        d = np.flatnonzero(np.where(scan, valid[at], vc[ev] > 0))
        owed = np.diff(owing[np.append(d, len(ev))], prepend=0)
        step = scan[d]
        rows = chunk[ev[d]] if self.compact else at[d]
        n = np.where(step, np.cumsum(step) - 1, vc[ev[d]])
        items = np.stack([kind[ev[d]], at[d], rows, owed[:-1], n], axis=1).tolist()
        counts = {"scan_steps": int(step.sum())}
        if kinds is not None:
            held = np.bincount(kind[vc > 0], minlength=len(CHUNK_KINDS)).tolist()
            pods = np.bincount(kind, vc, len(CHUNK_KINDS)).astype(np.int64).tolist()
            for name, c, v in zip(CHUNK_KINDS, held, pods):
                counts[f"chunks.{name}"], counts[f"chunk_pods.{name}"] = c, v
        quota = counts.get("chunks.spread", 0) + counts.get("chunks.anti", 0) > 0
        return _Plan(lo, hi, items, np.stack([rows, at[d], owed[:-1]])[:, step], int(owed[-1]),
                     counts, quota)

    def __call__(self, packed, plan: _Plan, key) -> None:
        """Runs ``plan`` drawing from the threefry stream of ``key`` in
        random mode, on the graph pass's buffers, its stream and assignments
        included, where one engages; the pass copies the state and the
        assignments back at the end."""
        gp_pass = None if self.graphs is None else self.graphs.start(self, packed, plan, key)
        if gp_pass is None:
            stream = tf.Stream(key, self.dev) if self.tie_break == TIE_RANDOM else None
            asg = self.assignments
        else:
            packed, stream, asg = gp_pass.packed, gp_pass.stream, gp_pass.asg
        self._steps(packed, plan, stream, asg, gp_pass)
        if gp_pass is not None:
            gp_pass.finish()

    def _steps(self, packed, plan: _Plan, stream, asg, gp_pass) -> None:
        """Walks ``plan``: a scan step replays its graph or steps eagerly, a
        fast chunk runs its loop; the stream is owed each item's splits as
        the walk comes to it."""
        k = self.mesh.size
        sts = [self.state_views(packed, s) for s in range(k)]
        shard_packed = [{"i64": packed["i64"][s], "i32": packed["i32"][s]} for s in range(k)]
        steps = [self.make_step(self.tables[s], stream) for s in range(k)]
        fused_step = None  # made at the first eager scan step it takes
        counts = self.times.counts
        for name, v in plan.counts.items():
            counts[name] += v
        group, kw, fit_scorer = self.group, self.kw, self.fit_scorer
        # the spread chunks' fused loops count their iterations on the card
        fused = None
        if plan.counts.get("chunks.spread") and gs.engages(self.dev, k, self.tie_break,
                                                           fit_scorer):
            fused = torch.zeros(2, dtype=torch.int64, device=self.dev)
        fast_kw = dict(
            group=group, tie_break=self.tie_break, stream=stream, fit_scorer=fit_scorer,
            fdtype=kw["fdtype"], w_fit=kw["w_fit"], w_balanced=kw["w_balanced"],
            w_taint=kw["w_taint"], w_nodeaff=kw["w_nodeaff"], w_image=kw["w_image"],
            use_extra=kw["use_extra_score"], read_placed=self.read_placed, graphs=gp_pass,
            fused=fused,
        )
        for kind, at, row, owed, n in plan.items:
            if stream is not None:
                stream.pending += owed
            if kind == gp.KIND_SLOW:
                if gp_pass is not None and gp_pass.step(n):
                    continue
                xr = self.xs.row(row)
                if self.fused:
                    if fused_step is None:
                        # a graph pass steps through its epoch's, which its
                        # captures launch too
                        fused_step = (gp_pass.fused_step() if gp_pass is not None else
                                      self.fused_step(self.tables[0], sts[0], shard_packed[0]))
                    fused_step(xr[0], at, asg, stream)
                    counts["fused_scan_steps"] += 1
                    continue
                asg[at] = sh.lockstep(
                    steps[s](sts[s], shard_packed[s], xr[s]) for s in range(k))[0]
                continue
            iterations0 = counts["grouped_iterations"]
            if self.tie_break != TIE_RANDOM:
                counts["grouped_iterations"] += n  # one pod an iteration, no read
            mode = {gp.KIND_PLAIN: None, gp.KIND_SPREAD: "spread", gp.KIND_ANTI: "anti"}[kind]
            if fused is not None and mode == "spread":
                counts["fused_chunks.spread"] += 1
            xr = self.xs.row(row)
            h = self.xs.host_row(row)
            out = sh.lockstep(
                gp.fast_chunk(mode, self.tables[s], sts[s], xr[s], h, n, **fast_kw)
                for s in range(k))
            asg[at : at + group] = out[0][0]
            counts[f"chunk_iterations.{CHUNK_KINDS[kind]}"] += (
                counts["grouped_iterations"] - iterations0)
            for s in range(k):
                m = out[s][1]
                shard_packed[s]["i64"] += xr[s]["take64"][:, None] * m.to(torch.int64)[None, :]
                shard_packed[s]["i32"] += xr[s]["take32"][:, None] * m[None, :]
        if stream is not None:
            stream.pending += plan.tail
        if fused is not None:
            self.times.defer(fused, (("grouped_iterations", "chunk_iterations.spread"),
                                     ("waterfill_iterations",)))
