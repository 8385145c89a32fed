"""InterPodAffinity tensorizer (SURVEY.md §8.7 step 7, the memory-hard one).

Two term-instance spaces, both with per-node count state carried through the
scan (pods placed mid-batch immediately affect later pods — including the
symmetry direction):

INCOMING terms (T_in) — the batch pod classes' own affinity terms:
  req-affinity / req-anti-affinity / preferred(±weight). State
  in_cnt[T_in, N] counts existing pods matching the term per node;
  placed batch pods fold in via in_match[P, T_in].

EXISTING-side terms (T_ex) — terms OWNED by pods (placed or batch), needed
for the symmetry checks (filtering.go#satisfyExistingPodsAntiAffinity,
scoring's symmetric preferred/hard-affinity contributions): required-anti
(filter-blocking), preferred ±w and required-affinity (scored with
hardPodAffinityWeight). State ex_cnt[T_ex, N] counts OWNER pods per node;
batch pods that own terms fold in via ex_owned[P, T_ex]. Whether instance u
concerns incoming pod p (selector+namespace vs p) is the per-pod bit/weight
matrix m_anti[P, T_ex] / m_w[P, T_ex] — precompiled host-side, so the
device never touches label strings.

Domain aggregation on device uses one flattened segment-sum over
(term, domain) pairs per step (ops/interpod.py) — the dense-tensor
restructuring of the reference's topologyToMatchedTermCount maps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from ..api.objects import Node, Pod, PodAffinityTerm
from ..ops.oracle import interpod as oip
from .schema import PodBatch, bucket_pow2

INST_PAD = 8
DOM_PAD = 8

# existing-term kinds
K_REQ_ANTI = 0
K_PREF_AFF = 1
K_PREF_ANTI = 2
K_REQ_AFF = 3


@dataclass
class InterpodTensors:
    num_in: int
    num_ex: int
    d_pad: int
    # per incoming-term tables
    in_dom: np.ndarray  # [Ti, Np] int32 (-1 = node lacks key)
    in_cnt0: np.ndarray  # [Ti, Np] int32
    in_pref_w: np.ndarray  # [Ti] int32 signed weight (preferred terms only)
    # class tables (-1 pad)
    cls_req_aff: np.ndarray  # [Cp, Sa]
    cls_req_anti: np.ndarray  # [Cp, Sb]
    cls_pref: np.ndarray  # [Cp, Sp]
    # per existing-term tables
    ex_dom: np.ndarray  # [Te, Np] int32
    ex_cnt0: np.ndarray  # [Te, Np] int32 — owner pods per node
    ex_anti: np.ndarray  # [Te] bool — required-anti (filter)
    # per-pod matrices (xs)
    in_match: np.ndarray  # [Pp, Ti] int32 — placed pod matches incoming term
    ex_owned: np.ndarray  # [Pp, Te] int32 — pod owns the term (count)
    m_anti: np.ndarray  # [Pp, Te] bool — ex required-anti term selects pod
    m_w: np.ndarray  # [Pp, Te] int32 — signed score weight vs pod
    self_aff: np.ndarray  # [Pp] bool — pod matches all own req-aff terms

    @property
    def empty(self) -> bool:
        return self.num_in == 0 and self.num_ex == 0

    @property
    def ident(self) -> bool:
        """True when every term row maps each valid node to a UNIQUE domain
        (hostname topologies with per-node hostname labels) — verified
        numerically, enabling domain_counts' no-aggregation fast path.
        Rows are deduped by content first: terms sharing a topology key
        share byte-identical rows (dom_cache), so each distinct row is
        checked once."""
        seen: set[bytes] = set()
        for dom in (self.in_dom, self.ex_dom):
            for row in dom:
                key = row.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                v = row[row >= 0]
                if v.size and np.unique(v).size != v.size:
                    return False
        return True

    @property
    def has_score(self) -> bool:
        """False when no preferred terms / symmetry weights exist anywhere
        in the batch: the scoring section is statically all-zero."""
        return bool((self.in_pref_w != 0).any() or (self.m_w != 0).any())

    @property
    def anti_only(self) -> bool:
        """True when the batch carries required ANTI-affinity only — no
        required affinity, no preferred terms anywhere. The shape the
        grouped solver's quota fast path can handle (solver/exact.py
        _chunk_kinds refines per chunk)."""
        return bool((self.cls_req_aff < 0).all()) and not self.has_score


def trivial_interpod_tensors(
    pbatch: PodBatch, padded_n: int, c_pad: int
) -> InterpodTensors:
    zi = np.zeros((INST_PAD, padded_n), dtype=np.int32)
    return InterpodTensors(
        num_in=0,
        num_ex=0,
        d_pad=DOM_PAD,
        in_dom=zi - 1,
        in_cnt0=zi.copy(),
        in_pref_w=np.zeros(INST_PAD, dtype=np.int32),
        cls_req_aff=np.full((c_pad, 1), -1, dtype=np.int32),
        cls_req_anti=np.full((c_pad, 1), -1, dtype=np.int32),
        cls_pref=np.full((c_pad, 1), -1, dtype=np.int32),
        ex_dom=zi - 1,
        ex_cnt0=zi.copy(),
        ex_anti=np.zeros(INST_PAD, dtype=bool),
        in_match=np.zeros((pbatch.padded, INST_PAD), dtype=np.int32),
        ex_owned=np.zeros((pbatch.padded, INST_PAD), dtype=np.int32),
        m_anti=np.zeros((pbatch.padded, INST_PAD), dtype=bool),
        m_w=np.zeros((pbatch.padded, INST_PAD), dtype=np.int32),
        self_aff=np.zeros(pbatch.padded, dtype=bool),
    )


def _ex_terms_of(pod: Pod):
    """(kind, term, weight) triples owned by ``pod`` that the symmetry
    machinery needs. Terms are made EFFECTIVE here (matchLabelKeys merged
    from the owner's labels) because the dedup key and the per-pod match
    rows depend on the owner-resolved selector, not the raw spec."""
    out = []
    for t in oip._required_anti_terms(pod):
        out.append((K_REQ_ANTI, oip.effective_term(t, pod), 0))
    for wt in oip._preferred_terms(pod, anti=False):
        out.append((K_PREF_AFF, oip.effective_term(wt.term, pod), wt.weight))
    for wt in oip._preferred_terms(pod, anti=True):
        out.append((K_PREF_ANTI, oip.effective_term(wt.term, pod), -wt.weight))
    for t in oip._required_aff_terms(pod):
        out.append((K_REQ_AFF, oip.effective_term(t, pod), 0))
    return out


def build_interpod_tensors(
    pods: Sequence[Pod],
    class_reps: Sequence[Pod],
    pbatch: PodBatch,
    slot_nodes: Sequence[Node | None],
    placed_by_slot: Mapping[int, Sequence[Pod]],
    padded_n: int,
    c_pad: int,
    hard_pod_affinity_weight: int = 1,
    nominated: Sequence[tuple[Pod, int]] = (),
) -> InterpodTensors:
    """``nominated`` carries (pod, node slot) pairs for unbound pods whose
    ``status.nominatedNodeName`` resolved to a live slot: they fold into
    ``in_cnt0`` and ``ex_cnt0`` exactly like placed pods (the
    RunFilterPluginsWithNominatedPods convention), so both the incoming
    terms and the symmetry direction see a nominated peer at its slot."""
    # ---- incoming terms per class ----
    in_terms: list[tuple[int, PodAffinityTerm, int, int]] = []  # (cls, term, kind, w)
    per_class: list[tuple[list[int], list[int], list[int]]] = []
    for c, rep in enumerate(class_reps):
        aff_ids, anti_ids, pref_ids = [], [], []
        for t in oip._required_aff_terms(rep):
            aff_ids.append(len(in_terms))
            in_terms.append((c, t, K_REQ_AFF, 0))
        for t in oip._required_anti_terms(rep):
            anti_ids.append(len(in_terms))
            in_terms.append((c, t, K_REQ_ANTI, 0))
        for wt in oip._preferred_terms(rep, anti=False):
            pref_ids.append(len(in_terms))
            in_terms.append((c, wt.term, K_PREF_AFF, wt.weight))
        for wt in oip._preferred_terms(rep, anti=True):
            pref_ids.append(len(in_terms))
            in_terms.append((c, wt.term, K_PREF_ANTI, -wt.weight))
        per_class.append((aff_ids, anti_ids, pref_ids))

    # ---- existing-side terms (owned by placed AND batch pods), deduped ----
    ex_index: dict = {}
    ex_terms: list[tuple[int, PodAffinityTerm, int, str]] = []  # kind, term, w, owner_ns

    def ex_intern(kind: int, term: PodAffinityTerm, w: int, owner_ns: str) -> int:
        key = (kind, term, w, owner_ns)
        i = ex_index.get(key)
        if i is None:
            i = len(ex_terms)
            ex_index[key] = i
            ex_terms.append((kind, term, w, owner_ns))
        return i

    placed_pods: list[tuple[int, Pod]] = [
        (slot, p) for slot, ps in placed_by_slot.items() for p in ps
    ]
    # nominated pods count exactly like placed pods at their slot — both
    # in the incoming count state and as existing-side term owners
    placed_pods += [
        (n_i, p) for p, n_i in nominated if 0 <= n_i < padded_n
    ]
    owner_map_placed: list[tuple[int, int]] = []  # (slot, ex_id)
    for slot, p in placed_pods:
        for kind, t, w in _ex_terms_of(p):
            owner_map_placed.append((slot, ex_intern(kind, t, w, p.namespace)))
    owner_map_batch: list[tuple[int, int]] = []  # (pod idx, ex_id)
    for p_i, p in enumerate(pods):
        for kind, t, w in _ex_terms_of(p):
            owner_map_batch.append((p_i, ex_intern(kind, t, w, p.namespace)))

    if not in_terms and not ex_terms:
        return trivial_interpod_tensors(pbatch, padded_n, c_pad)

    ti_pad = bucket_pow2(max(len(in_terms), 1), floor=INST_PAD)
    te_pad = bucket_pow2(max(len(ex_terms), 1), floor=INST_PAD)

    # ---- domain vocab per topology key ----
    all_keys = {t.topology_key for _, t, _, _ in in_terms} | {
        t.topology_key for _, t, _, _ in ex_terms
    }
    key_vocab: dict[str, dict[str, int]] = {k: {} for k in all_keys}
    for node in slot_nodes:
        if node is None:
            continue
        for key in all_keys:
            v = node.labels.get(key)
            if v is not None:
                vocab = key_vocab[key]
                vocab.setdefault(v, len(vocab))
    d_pad = bucket_pow2(
        max((len(v) for v in key_vocab.values()), default=1), floor=DOM_PAD
    )

    def dom_row(key: str) -> np.ndarray:
        row = np.full(padded_n, -1, dtype=np.int32)
        vocab = key_vocab[key]
        for n_i, node in enumerate(slot_nodes):
            if node is None or n_i >= padded_n:
                continue
            v = node.labels.get(key)
            if v is not None:
                row[n_i] = vocab[v]
        return row

    dom_cache: dict[str, np.ndarray] = {}

    def dom_for(key: str) -> np.ndarray:
        if key not in dom_cache:
            dom_cache[key] = dom_row(key)
        return dom_cache[key]

    # ---- incoming tables ----
    in_dom = np.full((ti_pad, padded_n), -1, dtype=np.int32)
    in_cnt0 = np.zeros((ti_pad, padded_n), dtype=np.int32)
    in_pref_w = np.zeros(ti_pad, dtype=np.int32)
    in_match = np.zeros((pbatch.padded, ti_pad), dtype=np.int32)
    sa = max(max((len(a) for a, _, _ in per_class), default=0), 1)
    sb = max(max((len(b) for _, b, _ in per_class), default=0), 1)
    sp = max(max((len(p) for _, _, p in per_class), default=0), 1)
    cls_req_aff = np.full((c_pad, sa), -1, dtype=np.int32)
    cls_req_anti = np.full((c_pad, sb), -1, dtype=np.int32)
    cls_pref = np.full((c_pad, sp), -1, dtype=np.int32)
    for c, (aff_ids, anti_ids, pref_ids) in enumerate(per_class):
        cls_req_aff[c, : len(aff_ids)] = aff_ids
        cls_req_anti[c, : len(anti_ids)] = anti_ids
        cls_pref[c, : len(pref_ids)] = pref_ids

    for t_i, (c, term, kind, w) in enumerate(in_terms):
        rep = class_reps[c]
        in_dom[t_i] = dom_for(term.topology_key)
        in_pref_w[t_i] = w
        for slot, q in placed_pods:
            if slot < padded_n and oip.term_matches_pod(term, rep, q):
                in_cnt0[t_i, slot] += 1
        for p_i, q in enumerate(pods):
            if oip.term_matches_pod(term, rep, q):
                in_match[p_i, t_i] = 1

    # ---- existing tables ----
    ex_dom = np.full((te_pad, padded_n), -1, dtype=np.int32)
    ex_cnt0 = np.zeros((te_pad, padded_n), dtype=np.int32)
    ex_anti = np.zeros(te_pad, dtype=bool)
    ex_owned = np.zeros((pbatch.padded, te_pad), dtype=np.int32)
    m_anti = np.zeros((pbatch.padded, te_pad), dtype=bool)
    m_w = np.zeros((pbatch.padded, te_pad), dtype=np.int32)

    for e_i, (kind, term, w, owner_ns) in enumerate(ex_terms):
        ex_dom[e_i] = dom_for(term.topology_key)
        ex_anti[e_i] = kind == K_REQ_ANTI
        score_w = w if kind in (K_PREF_AFF, K_PREF_ANTI) else (
            hard_pod_affinity_weight if kind == K_REQ_AFF else 0
        )
        for p_i, p in enumerate(pods):
            if not term.matches_namespace(owner_ns, p.namespace):
                continue
            if term.label_selector is not None and term.label_selector.matches(
                p.labels
            ):
                if kind == K_REQ_ANTI:
                    m_anti[p_i, e_i] = True
                elif score_w:
                    m_w[p_i, e_i] = score_w
    for slot, e_i in owner_map_placed:
        if slot < padded_n:
            ex_cnt0[e_i, slot] += 1
    for p_i, e_i in owner_map_batch:
        ex_owned[p_i, e_i] += 1

    # ---- self-affinity bits (first-pod special case) ----
    self_aff = np.zeros(pbatch.padded, dtype=bool)
    for p_i, p in enumerate(pods):
        terms = oip._required_aff_terms(p)
        self_aff[p_i] = bool(terms) and all(
            oip.term_matches_pod(t, p, p) for t in terms
        )

    return InterpodTensors(
        num_in=len(in_terms),
        num_ex=len(ex_terms),
        d_pad=d_pad,
        in_dom=in_dom,
        in_cnt0=in_cnt0,
        in_pref_w=in_pref_w,
        cls_req_aff=cls_req_aff,
        cls_req_anti=cls_req_anti,
        cls_pref=cls_pref,
        ex_dom=ex_dom,
        ex_cnt0=ex_cnt0,
        ex_anti=ex_anti,
        in_match=in_match,
        ex_owned=ex_owned,
        m_anti=m_anti,
        m_w=m_w,
        self_aff=self_aff,
    )
