"""Exact-parity solver: a scan over pods in queue order, standalone mode.

Counterpart of ``kubernetes_tpu/solver/exact.py`` for the per-pod scan.
Each step is a dense filter mask + score over all nodes at once, then a
tie-break argmax, then the assume scatter into the carried node state, so
the next step sees the updated state -- the reference's strict pod-by-pod
semantics (schedule_one.go#schedulePod -> findNodesThatFitPod ->
prioritizeNodes -> selectHost, then cache.AssumePod).

Filter pipeline per step: NodeResourcesFit, the static class mask
(NodeName, NodeUnschedulable, TaintToleration, NodeAffinity, precompiled
per pod class), NodePorts, PodTopologySpread hard constraints and
InterPodAffinity. Score pipeline: the fit strategy, BalancedAllocation,
TaintToleration, NodeAffinity, ImageLocality, PodTopologySpread and
InterPodAffinity, normalized and weighted as the default profile does.

The scan is a Python loop whose state stays on the device. Nothing in the
loop reads the device: the pick, the found flag and the scatters are
device tensors, and what the loop branches on (the pod's class, its
constraint slots, whether it is valid) is host data from the tensorizers.
One device-to-host read at the end brings back the assignments and the
written-back node state together.

selectHost tie-break: "first" takes the lowest node index among the
max-score ties and is bit-identical to the JAX package's per-pod scan and
grouped path. "random" draws uniformly among the ties from a
``torch.Generator`` seeded with ``seed + solve count``; it cannot reproduce
the JAX package's threefry stream, and is held to the oracle's tie set.

Only the standalone per-pod scan is ported here: session mode
(``col_versions``), nominated pods, ``split``, ``mesh``, ``defer_read``,
``chain_occupancy`` and ``stream_carry_out`` raise NotImplementedError.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
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

TIE_RANDOM = "random"
TIE_FIRST = "first"


@dataclass(frozen=True)
class ExactSolverConfig:
    """The JAX package's ExactSolverConfig, field for field, without its
    TPU-only ``pallas`` switch: the domain_counts kernel is what runs on the
    card, with no flag. ``group_size`` and ``compact_wire`` select the JAX
    package's grouped path, which this port does not have yet; the per-pod
    scan ignores them (in "first" mode the two paths agree bit for bit)."""

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
    use_extra_score: bool = False,
):
    """One pod's filter + score pipeline over all nodes against node state
    ``st``. Returns ``score`` [N] int32, -1 on infeasible lanes.

    ``x`` holds the pod's rows as device tensors, plus host values: its
    class ``class_of`` and ``has_port_conflicts`` (False when no port slot
    can conflict, which makes NodePorts a no-op for this pod)."""
    alloc = tables["alloc"]
    alloc2 = alloc[: MEM_IDX + 1]  # cpu, memory rows for scoring
    fit_scorer = _fit_scorer(scoring_strategy, rtc_shape)
    cls = x["class_of"]

    mask = tables["static_mask"][cls] & tables["node_valid"]
    if "NodeResourcesFit" not in disabled:
        mask = mask & nr.fit_mask(
            x["req"], x["req_mask"], alloc, st["used"],
            st["pod_count"], tables["max_pods"],
        )
    if "NodePorts" not in disabled and x["has_port_conflicts"]:
        mask = mask & ~pl.ports_conflict_mask(x["pod_conflict"], st["port_used"])
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
        found = best >= 0
        idx = pick.view(1)
        packed["i64"].index_add_(1, idx, (x["take64"] * found.to(torch.int64))[:, None])
        packed["i32"].index_add_(1, idx, (x["take32"] * found.to(torch.int32))[:, None])
        return torch.where(found, pick, -1)

    return step


def _solve_scan(tables, packed, state, xs, valid, assignments, *, tie_break, generator, **kw):
    """Runs the step over every valid pod in queue order; an invalid pod
    (padding, or statically infeasible) is never placed, so its step is
    skipped and its assignment stays -1."""
    step = _make_step(tables, tie_break=tie_break, generator=generator, **kw)
    for i in np.flatnonzero(valid):
        x = {name: a[i] for name, a in xs["dev"].items()}
        x.update({name: a[i] for name, a in xs["host"].items()})
        assignments[i] = step(state, packed, x)
    return assignments


def _to_dev(a, dev, dtype=None) -> torch.Tensor:
    """A device copy of a host array (never an alias of the numpy buffer)."""
    t = torch.tensor(np.ascontiguousarray(a), device=dev)
    return t if dtype is None else t.to(dtype)


class ExactSolver:
    """Host-facing wrapper: NodeBatch/PodBatch (+ plugin tensors) in,
    assignments out, node state written back (the device-side assume)."""

    def __init__(self, config: ExactSolverConfig | None = None):
        self.config = config or ExactSolverConfig()
        self._step_count = 0
        # executable-dispatch histogram, as the JAX package keeps it:
        # "scan" counts per-pod-scan solves
        self.dispatch_counts: Counter = Counter()

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
    ) -> np.ndarray:
        """Returns assignments [num_pods] of node indices (-1 =
        unschedulable) and writes the updated ``used``, ``nonzero_used``
        and ``pod_count`` back into ``nodes`` in place.

        ``device``: where the scan runs; None is the card (and raises when
        CUDA is absent). Without ``static``/``ports``/``spread``/``interpod``
        tensors, trivial ones reproduce the resources-only pipeline. The
        arguments after ``interpod`` select branches of the JAX package's
        solve that are not ported yet; asking for one raises
        NotImplementedError."""
        for name, asked in (
            ("session mode (col_versions)", col_versions is not None),
            ("nominated pods", nominated is not None and not nominated.empty),
            ("split > 1", split > 1),
            ("mesh", mesh is not None),
            ("defer_read", defer_read),
            ("chain_occupancy", chain_occupancy),
            ("stream_carry_out", stream_carry_out),
        ):
            if asked:
                raise NotImplementedError(
                    f"{name} is not ported; the port solves standalone per-pod scans"
                )
        dev = device_mod.resolve(device)
        cfg = self.config
        fdtype = torch.float64 if cfg.balanced_fdtype == "float64" else torch.float32
        generator = None
        if cfg.tie_break == TIE_RANDOM:
            generator = torch.Generator(device=dev)
            generator.manual_seed(cfg.seed + self._step_count)
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

        # the static pieces the steps would otherwise recompute
        spr_static = sp.static_tables(spread.dom, spread.elig, spread.d_pad)
        ipa_in_dom = _to_dev(interpod.in_dom, dev)
        ipa_ex_dom = _to_dev(interpod.ex_dom, dev)
        tables = {
            "alloc": _to_dev(nodes.allocatable, dev),
            "max_pods": _to_dev(nodes.max_pods, dev),
            "node_valid": _to_dev(nodes.valid, dev),
            "fit_weights": torch.tensor(
                [cfg.cpu_weight, cfg.mem_weight], dtype=torch.int64, device=dev
            ),
            "static_mask": _to_dev(static.mask, dev),
            "taint_cnt": _to_dev(static.taint_cnt, dev),
            "nodeaff_pref": _to_dev(static.nodeaff_pref, dev),
            "image_score": _to_dev(static.image_score, dev),
            # per-node rows on the device, slot tables on the host
            # (ops/spread.py and ops/interpod.py module notes)
            "spr": {
                "dom": _to_dev(spread.dom, dev),
                **{k: _to_dev(v, dev) for k, v in spr_static.items()},
                "n_dom_host": spr_static["n_dom"],
                "launch": {},
                "max_skew": np.asarray(spread.max_skew),
                "min_domains": np.asarray(spread.min_domains),
                "self_match": np.asarray(spread.self_match),
                "is_hostname": np.asarray(spread.is_hostname),
                "hard": np.asarray(spread.hard),
                "soft": np.asarray(spread.soft),
            },
            "ipa": {
                "in_dom": ipa_in_dom,
                "ex_dom": ipa_ex_dom,
                **ip.static_tables(ipa_in_dom, ipa_ex_dom),
                "launch": {},
                "ex_anti": _to_dev(interpod.ex_anti, dev),
                "in_pref_w": np.asarray(interpod.in_pref_w),
                "cls_req_aff": np.asarray(interpod.cls_req_aff),
                "cls_req_anti": np.asarray(interpod.cls_req_anti),
                "cls_pref": np.asarray(interpod.cls_pref),
            },
        }
        if static.extra_score is not None:
            tables["extra_score"] = _to_dev(static.extra_score, dev)

        # the carried node state, packed by dtype so that one index_add_
        # per dtype is the whole assume scatter; the named entries are
        # row views of the packed tensors
        k = nodes.allocatable.shape[0]
        rows32 = [
            ("pod_count", np.asarray(nodes.pod_count, np.int32)[None]),
            ("port_used", ports.used),
            ("spr_cnt", spread.cnt0),
            ("ipa_in", interpod.in_cnt0),
            ("ipa_ex", interpod.ex_cnt0),
        ]
        packed = {
            "i64": _to_dev(np.concatenate([nodes.used, nodes.nonzero_used]), dev,
                           torch.int64),
            "i32": _to_dev(np.concatenate([r for _, r in rows32]), dev, torch.int32),
        }
        state = {"used": packed["i64"][:k], "nonzero_used": packed["i64"][k:]}
        off = 0
        for name, r in rows32:
            state[name] = packed["i32"][off : off + r.shape[0]]
            off += r.shape[0]
        state["pod_count"] = state["pod_count"][0]

        # per-pod inputs: what one placement adds to each packed state row,
        # and the rows the pipeline reads
        pp = pods.padded
        take32 = np.concatenate(
            [
                np.ones((pp, 1), np.int32),
                np.asarray(ports.pod_takes, np.int32),
                np.asarray(spread.placed_match, np.int32),
                np.asarray(interpod.in_match, np.int32),
                np.asarray(interpod.ex_owned, np.int32),
            ],
            axis=1,
        )
        pod_conflict = np.asarray(ports.pod_conflict, bool)
        take64 = _to_dev(np.concatenate([pods.req, pods.nonzero_req], axis=1), dev,
                         torch.int64)
        xs = {
            "dev": {
                "take64": take64,
                "take32": _to_dev(take32, dev),
                "req": take64[:, :k],
                "nonzero_req": take64[:, k:],
                "req_mask": _to_dev(pods.req_mask, dev),
                "pod_conflict": _to_dev(pod_conflict, dev),
                "ipa_m_anti": _to_dev(interpod.m_anti, dev),
                "ipa_m_w": _to_dev(interpod.m_w, dev, torch.int32),
                "ipa_self_aff": _to_dev(interpod.self_aff, dev),
            },
            "host": {
                "class_of": np.asarray(static.class_of).astype(np.int64),
                "has_port_conflicts": pod_conflict.any(axis=1),
            },
        }
        valid = np.asarray(pods.valid & pods.feasible_static, bool)

        kw = dict(
            tie_break=cfg.tie_break,
            generator=generator,
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
            use_extra_score=static.extra_score is not None,
        )
        self.dispatch_counts["scan"] += 1
        assignments = torch.full((pp,), -1, dtype=torch.int64, device=dev)
        _solve_scan(tables, packed, state, xs, valid, assignments, **kw)

        # one device-to-host read: node state and assignments together
        flat = torch.cat(
            [
                packed["i64"].reshape(-1),
                state["pod_count"].to(torch.int64),
                assignments,
            ]
        ).cpu().numpy()
        npad = nodes.padded
        nodes.used = flat[: k * npad].reshape(k, npad)
        nodes.nonzero_used = flat[k * npad : (k + 2) * npad].reshape(2, npad)
        o = (k + 2) * npad
        nodes.pod_count = flat[o : o + npad].astype(np.int32)
        o += npad
        return flat[o:].astype(np.int32)[: pods.num_pods]
