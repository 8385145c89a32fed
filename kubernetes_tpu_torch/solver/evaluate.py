"""Stateless batched filter/score evaluation: the device path behind the
served extender boundary (SURVEY §8.2).

Counterpart of ``kubernetes_tpu/solver/evaluate.py``. The extender protocol
is advisory: /filter and /prioritize report feasibility and scores for one
pod against a node list, and the calling kube-scheduler does the assume and
the bind. So the served evaluation is a pure function of the snapshot: the
solver's filter + score pipeline (``solver.exact._mask_and_score``) for
every pod of a batch against the same node state, giving ``[P, N]`` scores
with -1 on infeasible lanes.

The JAX package gets this as a ``jax.vmap`` of ``_mask_and_score`` over the
pod axis, where XLA computes what depends only on the node state once per
call. The port's ``_mask_and_score`` runs one pod at a time and resolves the
pod's class on the host, so calling it per pod would cost a hundred torch
launches per request. ``evaluate_tensors`` is its batched counterpart, in
three tiers:

- **state only, once per call**: the InterPodAffinity domain totals of the
  ``in`` and ``ex`` tables (``ops/interpod.py`` ``node_totals``, one launch
  of the ``domain_counts`` kernel) and every spread row's domain count
  (``ops/spread.py`` ``aggregate_rows``, one launch), so the launches per
  evaluation do not depend on the number of pods;
- **per distinct class** ``[C, N]``: the static mask, the hard spread
  violations, the incoming InterPodAffinity filter terms and the preferred
  raw score, vectorized over the class slots;
- **per pod** ``[P, N]``: the fit mask and scores, NodePorts, the
  existing-anti symmetry, the first-pod affinity case, the symmetric score,
  the soft spread score, and each plugin's normalization over the pod's own
  feasible set.

Every per-lane operation is the one ``_mask_and_score`` applies to that
lane, in the same dtype and order, so each row equals the per-pod pipeline
bit for bit. The JAX package's ``jax_enable_x64`` switch and persistent
compile cache have no counterpart here.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import device as device_mod
from ..api.objects import Node, Pod
from ..ops import interpod as ip
from ..ops import noderesources as nr
from ..ops import plugins as pl
from ..ops import spread as sp
from ..tensorize.interpod import build_interpod_tensors, trivial_interpod_tensors
from ..tensorize.plugins import (
    build_port_tensors,
    build_static_tensors,
    trivial_port_tensors,
)
from ..tensorize.schema import MEM_IDX, build_node_batch, build_pod_batch
from ..tensorize.spread import build_spread_tensors, trivial_spread_tensors
from .exact import ExactSolverConfig, _fit_scorer
from . import timing
from .session import _node_tables, _place_class_tables, to_dev

MAX_NODE_SCORE = 100


class BatchEvaluator:
    """Object-level entry: pods × nodes → score matrix on ``device`` (None
    = the card, raising without CUDA; ``"cpu"`` runs on the CPU).

    Reuses the solver's tensorizers, so the served scores are what the
    exact solver would compute for each pod against the same snapshot (the
    first scan step sees exactly this state)."""

    def __init__(self, config: ExactSolverConfig | None = None, device=None):
        self.config = config or ExactSolverConfig()
        self.device = device_mod.resolve(device)
        from ..utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()

    def evaluate(
        self,
        pods: list[Pod],
        nodes: list[Node],
        pods_by_node: dict[str, list[Pod]],
        services: list | None = None,
        pvs: list | None = None,
        pvcs: list | None = None,
    ) -> np.ndarray:
        """Returns scores [len(pods), len(nodes)] int32; -1 = infeasible.

        Node index space is the order of ``nodes``; ``pods_by_node`` carries
        already-placed pods (the extender's watch-fed NodeInfo view)."""
        cfg = self.config
        batch = build_node_batch(nodes, pods_by_node)
        pbatch = build_pod_batch(pods, batch.vocab)
        slot_nodes: list[Node | None] = list(nodes) + [None] * (
            batch.padded - len(nodes)
        )
        placed_by_slot = {
            i: list(pods_by_node[n.name])
            for i, n in enumerate(nodes)
            if pods_by_node.get(n.name)
        }

        services = services or []
        need_spread = any(p.topology_spread_constraints for p in pods)
        class_key_extra = None
        if services and cfg.spread_defaulting == "System":
            from ..ops.oracle.spread import default_selector, default_selector_key

            need_spread = need_spread or any(
                not p.topology_spread_constraints
                and default_selector(p, services) is not None
                for p in pods
            )

            def class_key_extra(p):
                if p.topology_spread_constraints:
                    return None
                return default_selector_key(p, services)

        def has_pod_affinity(p: Pod) -> bool:
            return p.affinity is not None and (
                p.affinity.pod_affinity is not None
                or p.affinity.pod_anti_affinity is not None
            )

        need_interpod = any(has_pod_affinity(p) for p in pods) or any(
            has_pod_affinity(q)
            for placed in pods_by_node.values()
            for q in placed
        )
        need_ports = any(p.host_ports() for p in pods)

        volume_ctx = None
        if any(p.pvc_names for p in pods):
            from ..ops.oracle.volumes import VolumeContext

            volume_ctx = VolumeContext.build(
                pvs or [], pvcs or [], dict(pods_by_node)
            )

        static = build_static_tensors(
            pods, pbatch, slot_nodes, batch.padded, volume_ctx,
            disabled=frozenset(cfg.disabled_filters),
            added_affinity=cfg.added_affinity,
            class_key_extra=class_key_extra,
        )
        if need_ports:
            ports = build_port_tensors(
                pods, pbatch, slot_nodes, placed_by_slot, batch.padded
            )
        else:
            ports = trivial_port_tensors(pbatch, batch.padded)
        if need_spread:
            spread = build_spread_tensors(
                pods, static.reps, pbatch, slot_nodes, placed_by_slot,
                batch.padded, static.c_pad,
                services=services, defaulting=cfg.spread_defaulting,
            )
        else:
            spread = trivial_spread_tensors(pbatch, batch.padded, static.c_pad)
        if need_interpod:
            interpod = build_interpod_tensors(
                pods, static.reps, pbatch, slot_nodes, placed_by_slot,
                batch.padded, static.c_pad,
                hard_pod_affinity_weight=cfg.hard_pod_affinity_weight,
            )
        else:
            interpod = trivial_interpod_tensors(
                pbatch, batch.padded, static.c_pad
            )
        return self.evaluate_tensors(
            batch, pbatch, static, ports, spread, interpod
        )[:, : len(nodes)]

    def evaluate_tensors(
        self, batch, pbatch, static, ports, spread, interpod
    ) -> np.ndarray:
        """Low-level entry: prepared tensors -> scores
        [num_pods, padded_nodes] int32 (-1 = infeasible); statically
        infeasible pods (a resource no node advertises) are -1 on every
        node."""
        cfg = self.config
        dev = self.device
        p = pbatch.num_pods
        pod_valid = (pbatch.valid & pbatch.feasible_static)[:p]
        npad = batch.padded
        if p == 0:
            return np.zeros((0, npad), np.int32)
        fdtype = torch.float64 if cfg.balanced_fdtype == "float64" else torch.float32
        use_spread = not spread.empty
        use_interpod = not interpod.empty
        disabled = frozenset(cfg.disabled_filters)

        nt, persist = _node_tables(batch, dev)
        ct = _place_class_tables(static, spread, interpod, dev)
        k = batch.allocatable.shape[0]
        used, nonzero_used = persist["i64"][:k], persist["i64"][k:]
        node_valid = nt["node_valid"]

        # the batch's classes: C distinct rows, ``inv`` maps each pod to its
        # ktpu: ignore[TPU001]: static.class_of is a host numpy table from tensorize; no card value is read
        class_of = np.asarray(static.class_of[:p]).astype(np.int64)
        classes, inv_host = np.unique(class_of, return_inverse=True)
        inv = to_dev(inv_host, dev, torch.int64)
        cls_dev = to_dev(classes, dev, torch.int64)
        pod_cls = cls_dev[inv]

        # -- filters --
        mask = (ct["static_mask"][cls_dev] & node_valid)[inv]
        if "NodeResourcesFit" not in disabled:
            req = to_dev(pbatch.req[:p], dev, torch.int64)
            req_mask = to_dev(pbatch.req_mask[:p], dev)
            alloc = nt["alloc"]
            res_ok = (used[None] + req[:, :, None] <= alloc[None]) | ~req_mask[:, :, None]
            count_ok = persist["pod_count"] + 1 <= nt["max_pods"]
            mask = mask & torch.all(res_ok, dim=1) & count_ok
        if "NodePorts" not in disabled:
            conflict = to_dev(ports.pod_conflict[:p], dev)
            occupied = to_dev(ports.used, dev) > 0
            mask = mask & ~_any_product(conflict, occupied)
        spr = ct["spr"]
        spr_cnt = node_cnt = min_match = None
        if use_spread:
            spr_cnt = to_dev(spread.cnt0, dev, torch.int32)
            node_cnt, min_match = sp.aggregate_rows(spr, spr_cnt, spread.d_pad)
            if "PodTopologySpread" not in disabled:
                mask = mask & ~_hard_spread(spr, node_cnt, min_match, classes)[inv]
        ipa_raw = None
        if use_interpod:
            ipa_ok, ipa_raw = _interpod(
                ct["ipa"], interpod, classes, inv, node_valid, p, dev,
                score=interpod.has_score and cfg.interpod_weight > 0,
            )
            if "InterPodAffinity" not in disabled:
                mask = mask & ipa_ok

        # -- scores --
        nonzero_req = to_dev(pbatch.nonzero_req[:p], dev, torch.int64)
        # [R, P * N]: the per-node scorers, unchanged, over every (pod, node)
        requested = (nonzero_used[:, None, :] + nonzero_req.T[:, :, None]).reshape(2, -1)
        alloc2 = nt["alloc"][: MEM_IDX + 1][:, None, :].expand(2, p, npad).reshape(2, -1)
        fit_w = torch.tensor([cfg.cpu_weight, cfg.mem_weight], dtype=torch.int64, device=dev)
        fit_scorer = _fit_scorer(cfg.scoring_strategy, tuple(tuple(x) for x in cfg.rtc_shape))
        score = cfg.fit_weight * fit_scorer(requested, alloc2, fit_w)
        score = score + cfg.balanced_weight * nr.balanced_allocation_score(
            requested, alloc2, fdtype=fdtype
        )
        score = score.to(torch.int32).reshape(p, npad)
        if cfg.taint_weight:
            score = score + cfg.taint_weight * pl.normalize_score(
                ct["taint_cnt"][pod_cls], mask, reverse=True
            )
        if cfg.node_affinity_weight:
            score = score + cfg.node_affinity_weight * pl.normalize_score(
                ct["nodeaff_pref"][pod_cls], mask, reverse=False
            )
        if cfg.image_weight:
            score = score + cfg.image_weight * ct["image_score"][pod_cls]
        if static.extra_score is not None:
            score = score + ct["extra_score"][pod_cls]
        if use_spread and cfg.spread_weight and spread.has_soft:
            score = score + cfg.spread_weight * _soft_spread(
                spr, spr_cnt, node_cnt, class_of, mask, fdtype
            )
        if use_interpod and cfg.interpod_weight and interpod.has_score:
            score = score + cfg.interpod_weight * ip.normalize(ipa_raw, mask)
        out = torch.where(mask, score, -1)
        t_read = time.perf_counter()
        # ktpu: ignore[TPU001]: the evaluation's one card read, its [P, N] result for the webhook's reply: one wait per evaluation, not per launch (ROADMAP speed levers)
        out = out.cpu().numpy()
        timing.note("evaluate", t_read)
        return np.where(pod_valid[:, None], out, np.int32(-1))


def _any_product(a, b):
    """[P, N] bool: any_v a[p, v] & b[v, n], as a product of 0/1 floats
    (CUDA has no integer matrix product; a sum of at most V ones is exact
    in float32)."""
    if a.shape[1] == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=torch.bool, device=b.device)
    return (a.to(torch.float32) @ b.to(torch.float32)) > 0


def _hard_spread(spr, node_cnt, min_match, classes):
    """[C, N] bool: any hard spread constraint of each class violated
    (``ops/spread.py`` ``hard_violations``, over every class at once)."""
    dev = node_cnt.device
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    hard = np.asarray(spr["hard"])[classes]
    viol = torch.zeros((len(classes), node_cnt.shape[1]), dtype=torch.bool, device=dev)
    for col in hard.T:
        live = col >= 0
        # ktpu: ignore[TPU002]: .any() of a host numpy column of a class table; no card value is read
        if not live.any():
            continue
        j = np.maximum(col, 0)
        # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
        md = np.asarray(spr["min_domains"])[j]
        # a constraint short of its minDomains counts the global minimum as 0
        # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
        floor0 = (md >= 0) & (np.asarray(spr["n_dom_host"])[j] < md)
        jd = to_dev(j, dev, torch.int64)
        mm = torch.where(to_dev(floor0, dev), 0, min_match[jd])
        # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
        skew = node_cnt[jd] + to_dev(np.asarray(spr["self_match"])[j], dev, torch.int32)[:, None] \
            - mm[:, None]
        # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
        v = ~spr["hk"][jd] | (skew > to_dev(np.asarray(spr["max_skew"])[j], dev)[:, None])
        viol = viol | (v & to_dev(live, dev)[:, None])
    return viol


def _interpod(ipa, interpod, classes, inv, node_valid, p: int, dev, score: bool):
    """([P, N] allowed, [P, N] int32 raw score): ``ops/interpod.py``
    ``filter_and_score`` for every pod of the batch against one state."""
    in_cnt = to_dev(interpod.in_cnt0, dev, torch.int32)
    ex_cnt = to_dev(interpod.ex_cnt0, dev, torch.int32)
    in_counts, ex_counts = ip.node_totals(ipa, in_cnt, ex_cnt, interpod.d_pad,
                                          interpod.ident)
    in_hk, ex_hk = ipa["in_hk"], ipa["ex_hk"]
    c, n = len(classes), in_counts.shape[1]

    # 1. existing pods' required anti-affinity vs each pod (symmetry)
    m_anti = to_dev(interpod.m_anti[:p], dev)
    blocked = _any_product(m_anti & ipa["ex_anti"][None, :], ex_hk & (ex_counts > 0))

    # 2. incoming required anti-affinity of each class (missing key -> passes)
    viol = torch.zeros((c, n), dtype=torch.bool, device=dev)
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    for col in np.asarray(ipa["cls_req_anti"])[classes].T:
        j, live = _slot(col, dev)
        if live is not None:
            viol = viol | ((in_hk[j] & (in_counts[j] > 0)) & live[:, None])
    allowed = ~blocked & ~viol[inv]

    # 3. incoming required affinity + first-pod special case
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    req_aff = np.asarray(ipa["cls_req_aff"])[classes]
    has_aff = req_aff[:, 0] >= 0
    # ktpu: ignore[TPU002]: .any() of a host numpy column of a class table; no card value is read
    if has_aff.any():
        all_ok = torch.ones((c, n), dtype=torch.bool, device=dev)
        has_all_keys = torch.ones((c, n), dtype=torch.bool, device=dev)
        total_any = torch.zeros(c, dtype=torch.int64, device=dev)
        for col in req_aff.T:
            j, live = _slot(col, dev)
            if live is None:
                continue
            lv = live[:, None]
            all_ok = all_ok & (~lv | (in_hk[j] & (in_counts[j] > 0)))
            has_all_keys = has_all_keys & (~lv | in_hk[j])
            total_any = total_any + torch.where(
                live, torch.sum(torch.where(in_hk[j] & node_valid, in_cnt[j], 0), dim=1), 0
            )
        self_aff = to_dev(interpod.self_aff[:p], dev)
        first_pod = ((total_any == 0)[inv] & self_aff)[:, None] & has_all_keys[inv]
        aff_ok = torch.where(to_dev(has_aff, dev)[inv][:, None],
                             all_ok[inv] | first_pod, True)
        allowed = allowed & aff_ok

    raw = torch.zeros((p, n), dtype=torch.int32, device=dev)
    if score:
        pref = torch.zeros((c, n), dtype=torch.int32, device=dev)
        # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
        w_all = np.asarray(ipa["in_pref_w"])
        # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
        for col in np.asarray(ipa["cls_pref"])[classes].T:
            j, live = _slot(col, dev)
            if live is None:
                continue
            w = to_dev(np.where(col >= 0, w_all[np.maximum(col, 0)], 0), dev, torch.int32)
            pref = pref + torch.where(in_hk[j] & live[:, None], w[:, None] * in_counts[j], 0)
        # the JAX package's int32 matvec m_w @ counts, as a float64 product:
        # exact for every integer sum below 2^53, cast back to int32 modulo 2^32
        m_w = to_dev(interpod.m_w[:p], dev, torch.float64)
        sym = m_w @ torch.where(ex_hk, ex_counts, 0).to(torch.float64)
        raw = pref[inv] + sym.to(torch.int64).to(torch.int32)
    return allowed, raw


def _slot(col: np.ndarray, dev):
    """One slot column of a class table: (row index per class, on the
    device; live per class, or None when no class uses the slot)."""
    live = col >= 0
    # ktpu: ignore[TPU002]: .any() of a host numpy column of a class table; no card value is read
    if not live.any():
        return None, None
    return to_dev(np.maximum(col, 0), dev, torch.int64), to_dev(live, dev)


def _soft_spread(spr, cnt, node_cnt, class_of, mask, fdtype):
    """[P, N] int32: ``ops/spread.py`` ``soft_scores`` for every pod, over
    its own feasible set (the hostname rows read the pod's own feasible
    count, so this tier is per pod)."""
    dev = mask.device
    p, n = mask.shape
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    soft = np.asarray(spr["soft"])[class_of]  # [P, Ss]
    raw = torch.zeros((p, n), dtype=fdtype, device=dev)
    ignored = torch.zeros((p, n), dtype=torch.bool, device=dev)
    n_feasible = torch.sum(mask.to(torch.int32), dim=1).to(fdtype)
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    n_dom = np.asarray(spr["n_dom_host"])
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    is_host = np.asarray(spr["is_hostname"])
    # ktpu: ignore[TPU001]: the argument is a host numpy class table (the session keeps class tables on the host); no card value is read
    skew = np.asarray(spr["max_skew"])
    for col in soft.T:
        j, live = _slot(col, dev)
        if live is None:
            continue
        jh = np.maximum(col, 0)
        host = to_dev(is_host[jh], dev)
        c = torch.where(host[:, None], cnt[j], node_cnt[j]).to(fdtype)
        size = torch.where(host, n_feasible, to_dev(n_dom[jh], dev).to(fdtype))
        contrib = c * torch.log(size + 2.0)[:, None] + (
            to_dev(skew[jh], dev).to(fdtype) - 1.0)[:, None]
        hk = spr["hk"][j] & live[:, None]
        raw = raw + torch.where(hk, contrib, 0.0)
        ignored = ignored | (~spr["hk"][j] & live[:, None])
    raw_i = torch.round(raw).to(torch.int32)

    considered = mask & ~ignored
    mx = torch.amax(torch.where(considered, raw_i, -sp.INF_COUNT), dim=1, keepdim=True)
    mn = torch.amin(torch.where(considered, raw_i, sp.INF_COUNT), dim=1, keepdim=True)
    any_considered = torch.any(considered, dim=1, keepdim=True)
    norm = torch.div(
        MAX_NODE_SCORE * (mx + mn - raw_i), torch.clamp(mx, min=1), rounding_mode="floor"
    )
    norm = torch.where(mx == 0, MAX_NODE_SCORE, norm)
    has_soft = to_dev(soft[:, 0] >= 0, dev)[:, None]
    return torch.where(considered & any_considered & has_soft, norm, 0)

