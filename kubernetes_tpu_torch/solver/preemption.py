"""Batched preemption dry-run (SURVEY.md §8.5).

The reference dry-runs SelectVictimsOnNode per candidate node inside a
16-way parallel-for (preemption.go#DryRunPreemption). Here ONE device
program evaluates every node at once:

- Phase A: remove ALL lower-priority pods per node (their aggregated
  requests arrive precomputed as ``lower_sum``), assume the incoming pod,
  check fit -> candidate mask over the whole node axis.
- Phase B: greedy reprieve as a loop over the per-node victim-slot axis
  (PDB-violating candidates first, then non-violating, each in
  MoreImportantPod order — the ordering is precompiled host-side into the
  slot order, so the device loop is just "does it still fit if I re-add
  slot s", vectorized over nodes).
- Phase C: per-node victim statistics for pickOneNodeForPreemption
  (violations, max/sum victim priority, victim count, latest start among
  top-priority victims); the final lexicographic argmin runs host-side on
  [N] arrays.

Candidacy is gated on the pod's static per-node feasibility (taints,
affinity, nodeName, unschedulable) — preemption cannot resolve those, which
mirrors the reference skipping UnschedulableAndUnresolvable nodes.

Ported from ``kubernetes_tpu/solver/preemption.py``: ``_preempt_scan`` (a
``lax.scan`` that XLA fused there) is torch code here, a loop over the
victim slots whose carry updates through ``torch.where``, run on the
caller's ``device`` (None = the card). The dtypes that fix results are the
JAX package's: int64 resources, ``NEG`` priorities, the float32 start
times and the ``-inf`` fill of the latest top-priority start. The
lexicographic pick runs on the host, as there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod

from ..api.objects import Pod
from ..ops.oracle.preemption import (
    PodDisruptionBudget,
    classify_pdb_violations,
    sort_more_important,
)
from ..tensorize.schema import NodeBatch, bucket_pow2
from . import timing

SLOT_PAD = 8
NEG = -(1 << 30)


def _preempt_scan(
    alloc,  # [K, N] int64
    max_pods,  # [N] int32
    keep_used,  # [K, N] int64 — usage by pods that stay (priority >= incoming)
    keep_cnt,  # [N] int32
    static_ok,  # [N] bool
    req,  # [K] int64
    cand_req,  # [S, K, N] int64 — reprieve-ordered victim-candidate requests
    cand_active,  # [S, N] bool
    cand_viol,  # [S, N] bool
    cand_prio,  # [S, N] int32
    cand_start,  # [S, N] float32
):
    """The batched dry-run on torch tensors (all on one device). Returns
    (fits_all [N] bool, victims [S, N] bool, n_victims [N] int32, n_viol
    [N] int32, max_prio [N] int32, sum_prio [N] int64, latest_top_start
    [N] float32), the JAX function's outputs and dtypes."""
    base_used = keep_used + req[:, None]
    fits_all = (
        torch.all(base_used <= alloc, dim=0)
        & (keep_cnt + 1 <= max_pods)
        & static_ok
    )
    used_cur = base_used
    cnt_cur = keep_cnt + 1
    victims = torch.empty_like(cand_active)
    for s in range(cand_req.shape[0]):
        try_used = used_cur + cand_req[s]
        ok = (
            torch.all(try_used <= alloc, dim=0)
            & (cnt_cur + 1 <= max_pods)
            & cand_active[s]
        )
        used_cur = torch.where(ok[None, :], try_used, used_cur)
        cnt_cur = cnt_cur + ok.to(cnt_cur.dtype)
        victims[s] = cand_active[s] & ~ok

    n_victims = victims.sum(dim=0, dtype=torch.int32)
    n_viol = (victims & cand_viol).sum(dim=0, dtype=torch.int32)
    neg = torch.tensor(NEG, dtype=cand_prio.dtype, device=cand_prio.device)
    max_prio = torch.where(victims, cand_prio, neg).amax(dim=0)
    sum_prio = torch.where(victims, cand_prio.to(torch.int64), 0).sum(dim=0)
    top = victims & (cand_prio == max_prio[None, :])
    ninf = torch.tensor(-np.inf, dtype=cand_start.dtype, device=cand_start.device)
    latest_top_start = torch.where(top, cand_start, ninf).amax(dim=0)
    return fits_all, victims, n_victims, n_viol, max_prio, sum_prio, latest_top_start


@dataclass
class PreemptionResult:
    node_name: str
    victims: list[Pod]
    num_violating: int


class PreemptionEvaluator:
    """Host driver: builds the per-pod candidate tensors, runs the batched
    dry-run, applies pickOneNodeForPreemption.

    Two-phase design (SURVEY §8.5 + reference SelectVictimsOnNode):
    the batched device dry-run is a fit-only pre-screen + ranking over ALL
    nodes at once; when the pod's failure can involve beyond-fit filters
    (ports/spread/interpod), at least the top ``refine_k`` ranked candidates
    (and more until one yields victims) are re-evaluated with the
    full-filter scalar oracle
    (select_victims_on_node_full), which also computes the exact victim set
    under per-re-add filter re-runs. When no beyond-fit filter is in play,
    fit-only IS the full pipeline (static per-node feasibility is already
    gated), so the device result commits directly.
    """

    def __init__(self, refine_k: int = 100, device=None):
        # Floor mirrors the reference's candidate sampling
        # (preemption.go#GetOffsetAndNumCandidates: minCandidateNodesAbsolute
        # = 100): at least this many fit-ranked candidates get the exact
        # full-filter dry-run. If none of them yields victims, refinement
        # keeps walking the remaining ranked candidates until one does (the
        # fit-only ranking is a heuristic; a feasible candidate must never be
        # lost to the cutoff).
        self.refine_k = refine_k
        # where the dry-run runs: None = the card (raises without CUDA)
        self.device = device

    def _dry_run(
        self,
        pod: Pod,
        nodes: NodeBatch,
        placed_by_slot: dict[int, list[Pod]],
        static_row: np.ndarray,
        pdbs: list[PodDisruptionBudget],
    ):
        """The batched device dry-run shared by the in-process PostFilter
        path (evaluate) and the served /preempt verb (victims_by_node):
        returns (fits_all, victims [S, N], n_victims, n_viol, max_prio,
        sum_prio, latest, slot_candidates)."""
        n_pad = nodes.padded
        k = len(nodes.vocab)
        prio = pod.effective_priority

        keep_used = np.zeros((k, n_pad), dtype=np.int64)
        keep_cnt = np.zeros(n_pad, dtype=np.int32)
        # slot -> (reprieve-ordered candidates, PDB-violating keys)
        slot_candidates: dict[int, tuple[list[Pod], set]] = {}
        max_slots = 1
        for slot, placed in placed_by_slot.items():
            if slot >= n_pad:
                continue
            lower = [q for q in placed if q.effective_priority < prio]
            for q in placed:
                if q.effective_priority >= prio:
                    keep_used[:, slot] += nodes.vocab.vectorize(
                        q.resource_request()
                    )
                    keep_cnt[slot] += 1
            if lower:
                violating, non_violating = classify_pdb_violations(
                    sort_more_important(lower), pdbs
                )
                ordered = sort_more_important(violating) + sort_more_important(
                    non_violating
                )
                slot_candidates[slot] = (ordered, {q.key for q in violating})
                max_slots = max(max_slots, len(ordered))
        # nodes with no placed pods: keep arrays stay zero

        s_pad = bucket_pow2(max_slots, floor=SLOT_PAD)
        cand_req = np.zeros((s_pad, k, n_pad), dtype=np.int64)
        cand_active = np.zeros((s_pad, n_pad), dtype=bool)
        cand_viol = np.zeros((s_pad, n_pad), dtype=bool)
        cand_prio = np.zeros((s_pad, n_pad), dtype=np.int32)
        cand_start = np.zeros((s_pad, n_pad), dtype=np.float32)
        for slot, (ordered, viol_keys) in slot_candidates.items():
            for s, q in enumerate(ordered):
                cand_req[s, :, slot] = nodes.vocab.vectorize(q.resource_request())
                cand_active[s, slot] = True
                cand_viol[s, slot] = q.key in viol_keys
                cand_prio[s, slot] = q.effective_priority
                cand_start[s, slot] = q.start_time

        req = nodes.vocab.vectorize(pod.resource_request())
        dev = device_mod.resolve(self.device)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        out = _preempt_scan(
            up(nodes.allocatable, np.int64),
            up(nodes.max_pods, np.int32),
            up(keep_used, np.int64),
            up(keep_cnt, np.int32),
            up(static_row & nodes.valid, bool),
            up(req, np.int64),
            up(cand_req, np.int64),
            up(cand_active, bool),
            up(cand_viol, bool),
            up(cand_prio, np.int32),
            up(cand_start, np.float32),
        )
        t_read = time.perf_counter()
        fits_all, victims, n_victims, n_viol, max_prio, sum_prio, latest = (
            # ktpu: ignore[TPU004]: the dry-run's verdicts must reach the host to pick victims: one card read per dry-run, after the batch's solve (ROADMAP speed levers)
            x.cpu().numpy() for x in out
        )
        timing.note("preemption", t_read)
        return (
            fits_all, victims, n_victims, n_viol, max_prio, sum_prio,
            latest, slot_candidates,
        )

    def victims_by_node(
        self,
        pod: Pod,
        nodes: NodeBatch,
        slot_names: list[str],
        placed_by_slot: dict[int, list[Pod]],
        static_row: np.ndarray,
        pdbs: list[PodDisruptionBudget] | None = None,
        candidate_slots: list[int] | None = None,
    ) -> dict[str, tuple[list[Pod], int]]:
        """Per-candidate victim sets for the served /preempt verb
        (extender.go#ProcessPreemption's nodeNameToVictims map): node name
        -> (victims in reprieve order, PDB violations). Fit-only
        semantics, same as the scalar select_victims_on_node the verb
        previously used per node — but ONE device dry-run covers every
        candidate. A node where the pod fits WITHOUT evictions stays in
        the result with an empty victim list (the wire contract keeps
        it; extender.go#ProcessPreemption treats it as a free
        candidate), while infeasible nodes drop."""
        if pod.preemption_policy == "Never":
            return {}
        pdbs = pdbs or []
        (
            fits_all, victims, n_victims, n_viol, _mx, _sm, _lt,
            slot_candidates,
        ) = self._dry_run(pod, nodes, placed_by_slot, static_row, pdbs)
        slots = (
            candidate_slots
            if candidate_slots is not None
            else list(range(len(slot_names)))
        )
        out: dict[str, tuple[list[Pod], int]] = {}
        for slot in slots:
            if not fits_all[slot]:
                continue
            ordered, _ = slot_candidates.get(slot, ([], set()))
            chosen = [q for s, q in enumerate(ordered) if victims[s, slot]]
            out[slot_names[slot]] = (chosen, int(n_viol[slot]))
        return out

    def evaluate(
        self,
        pod: Pod,
        nodes: NodeBatch,
        slot_names: list[str],
        placed_by_slot: dict[int, list[Pod]],
        static_row: np.ndarray,  # [Np] bool — pod's static feasibility
        pdbs: list[PodDisruptionBudget] | None = None,
        slot_nodes: list | None = None,  # [Np] Node|None, for full filters
        beyond_fit: bool = False,
        disabled: frozenset = frozenset(),  # profile's disabled filters
    ) -> PreemptionResult | None:
        if pod.preemption_policy == "Never":
            return None
        pdbs = pdbs or []
        n_pad = nodes.padded
        (
            fits_all, victims, n_victims, n_viol, max_prio, sum_prio,
            latest, slot_candidates,
        ) = self._dry_run(pod, nodes, placed_by_slot, static_row, pdbs)

        if beyond_fit and slot_nodes is not None:
            # Beyond-fit filters in play: a node where the pod fits with
            # ZERO fit-victims can still be the right candidate (evictions
            # may free ports / relax spread / remove anti-affinity owners),
            # so keep every fit-feasible node with at least one lower-
            # priority pod and let the full-filter oracle decide.
            has_lower = np.zeros(n_pad, dtype=bool)
            for slot in slot_candidates:
                has_lower[slot] = True
            cand_idx = np.flatnonzero(fits_all & has_lower)
        else:
            # Fit-only world: zero-victim "candidates" mean the pod fits
            # without eviction, so the solve failure was elsewhere — never
            # nominate a node and "preempt" nothing.
            cand_idx = np.flatnonzero(fits_all & (n_victims > 0))
        if cand_idx.size == 0:
            return None
        # pickOneNodeForPreemption lexicographic via numpy lexsort
        # (last key is primary)
        order = np.lexsort(
            (
                cand_idx,  # stable node order last-resort tie-break
                -latest[cand_idx],
                n_victims[cand_idx],
                sum_prio[cand_idx],
                max_prio[cand_idx],
                n_viol[cand_idx],
            )
        )
        if not (beyond_fit and slot_nodes is not None):
            best = int(cand_idx[order[0]])
            ordered, _ = slot_candidates.get(best, ([], set()))
            chosen = [q for s, q in enumerate(ordered) if victims[s, best]]
            return PreemptionResult(
                node_name=slot_names[best],
                victims=chosen,
                num_violating=int(n_viol[best]),
            )

        # Full-filter refinement (reference SelectVictimsOnNode semantics)
        # over the top-ranked candidates. Ranking comes from the fit
        # approximation; the victim sets and the final pickOneNode run on
        # exact full-filter results. refine_k bounds host cost the way the
        # reference bounds DryRunPreemption by candidate sampling.
        from ..ops.oracle.preemption import (
            pick_one_node,
            select_victims_on_node_full,
        )
        from ..ops.oracle.profile import FullOracle, make_oracle_nodes

        live = [
            (slot, slot_nodes[slot])
            for slot in range(min(len(slot_nodes), n_pad))
            if slot_nodes[slot] is not None
        ]
        oracle_idx = {slot: j for j, (slot, _) in enumerate(live)}
        oracle = FullOracle(
            make_oracle_nodes(
                [nd for _, nd in live],
                {
                    nd.name: list(placed_by_slot.get(slot, []))
                    for slot, nd in live
                },
            ),
            disabled=disabled,
        )
        refined: dict[str, object] = {}
        names_in_order: list[str] = []
        for n_tried, rank in enumerate(order):
            if n_tried >= self.refine_k and refined:
                break  # past the floor with at least one exact candidate
            slot = int(cand_idx[rank])
            if slot not in oracle_idx:
                continue
            nv = select_victims_on_node_full(
                pod, oracle_idx[slot], oracle, pdbs
            )
            if nv is None or not nv.victims:
                continue
            name = slot_names[slot]
            refined[name] = nv
            names_in_order.append(name)
        best_name = pick_one_node(refined, names_in_order)
        if best_name is None:
            return None
        nv = refined[best_name]
        return PreemptionResult(
            node_name=best_name,
            victims=list(nv.victims),
            num_violating=nv.num_violating,
        )
