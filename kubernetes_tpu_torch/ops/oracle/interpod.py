"""Scalar oracle for InterPodAffinity (Filter + Score).

Transcription of pkg/scheduler/framework/plugins/interpodaffinity/
{plugin,filtering,scoring}.go (SURVEY.md §3.2). The four cross-products:

Filter on candidate node n for incoming pod p:
1. EXISTING pods' required anti-affinity vs p (symmetry,
   filtering.go#satisfyExistingPodsAntiAffinity): for every existing pod q
   with required anti-affinity, each of q's terms whose selector matches p
   (namespace rule evaluated from q's perspective) "occupies" the domain
   (term.topologyKey -> q's node's value). n fails if it sits in any
   occupied domain.
2. p's required anti-affinity vs existing pods
   (#satisfyPodAntiAffinity): no existing pod matching a term may sit in
   n's domain for that term (n lacking the key => count 0 => passes).
3. p's required affinity (#satisfyPodAffinity): every term must have a
   matching existing pod in n's domain (n must have the key), EXCEPT the
   first-pod case: no matching pod exists anywhere for ANY term and p's own
   labels satisfy every term (allows bootstrapping a self-affine group).

Score (scoring.go#PreScore/#Score/#NormalizeScore):
  per existing pod q on node m, contributions keyed by q's domains:
  + w·matches for p's preferred affinity terms (q matches term selector)
  - w·matches for p's preferred anti-affinity terms
  + w_q·(q's preferred affinity terms matching p)        [symmetry]
  - w_q·(q's preferred anti-affinity terms matching p)   [symmetry]
  + hardPodAffinityWeight per required-affinity term of q matching p
  candidate n sums the entries of its own domains; NormalizeScore is
  max-min: 100*(score-min)/(max-min), 0 when max==min.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from ...api.objects import Node, Pod, PodAffinityTerm

MAX_NODE_SCORE = 100
DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1


def effective_term(term: PodAffinityTerm, owner: Pod) -> PodAffinityTerm:
    """Apply matchLabelKeys: each listed key takes the OWNER pod's label
    value and is ANDed into the selector as an In-requirement
    (framework/types.go#GetAffinityTerms + the MatchLabelKeysInPodAffinity
    merge). Terms without matchLabelKeys pass through unchanged."""
    if not term.match_label_keys or term.label_selector is None:
        return term
    from ...api.labels import IN, Requirement, Selector

    extra = tuple(
        Requirement(k, IN, (owner.labels[k],))
        for k in term.match_label_keys
        if k in owner.labels
    )
    if not extra:
        return term
    sel = term.label_selector
    return PodAffinityTerm(
        label_selector=Selector(sel.requirements + extra, sel.match_labels),
        topology_key=term.topology_key,
        namespaces=term.namespaces,
        namespace_selector=term.namespace_selector,
        match_label_keys=(),
    )


def term_matches_pod(
    term: PodAffinityTerm, owner: Pod, target: Pod
) -> bool:
    """Does ``term`` (owned by ``owner``) select ``target``?
    framework/types.go#AffinityTerm.Matches: namespace rule from the owner's
    perspective + label selector (with matchLabelKeys merged) on the
    target's labels."""
    if not term.matches_namespace(owner.namespace, target.namespace):
        return False
    t = effective_term(term, owner)
    return t.label_selector is not None and t.label_selector.matches(
        target.labels
    )


def _required_anti_terms(p: Pod) -> tuple[PodAffinityTerm, ...]:
    a = p.affinity.pod_anti_affinity if p.affinity else None
    return a.required if a else ()


def _required_aff_terms(p: Pod) -> tuple[PodAffinityTerm, ...]:
    a = p.affinity.pod_affinity if p.affinity else None
    return a.required if a else ()


def _preferred_terms(p: Pod, anti: bool):
    a = (
        (p.affinity.pod_anti_affinity if anti else p.affinity.pod_affinity)
        if p.affinity
        else None
    )
    return a.preferred if a else ()


@dataclass
class InterpodFilterState:
    """Pod-level precomputation (filtering.go#preFilterState): the
    topologyToMatchedTermCount maps reduced to domain sets — built ONCE per
    pod, then checked per candidate node in O(#terms)."""

    # (topologyKey, value) pairs occupied by existing pods whose required
    # anti-affinity selects the incoming pod (symmetry)
    existing_anti_pairs: set
    # per incoming required-anti term: occupied domain values
    anti_terms: list[tuple[PodAffinityTerm, set]]
    # per incoming required-aff term: domain values with >=1 matching pod
    aff_terms: list[tuple[PodAffinityTerm, set]]
    # first-pod special case inputs
    any_aff_match_anywhere: bool
    self_matches_all: bool

    def check(self, node: Node) -> bool:
        labels = node.labels
        for key, v in self.existing_anti_pairs:
            if labels.get(key) == v:
                return False
        for t, occupied in self.anti_terms:
            v = labels.get(t.topology_key)
            if v is not None and v in occupied:
                return False
        if self.aff_terms:
            # all topology keys must exist on the node — even the first-pod
            # special case cannot admit a keyless node
            # (filtering.go#satisfyPodAffinity)
            if any(
                labels.get(t.topology_key) is None for t, _ in self.aff_terms
            ):
                return False
            all_satisfied = all(
                labels[t.topology_key] in matched
                for t, matched in self.aff_terms
            )
            if not all_satisfied:
                if self.any_aff_match_anywhere or not self.self_matches_all:
                    return False
        return True


def build_interpod_state(
    pod: Pod, all_nodes: Sequence[tuple[Node, Sequence[Pod]]]
) -> InterpodFilterState:
    existing_anti_pairs: set = set()
    anti = _required_anti_terms(pod)
    aff = _required_aff_terms(pod)
    anti_occ: list[set] = [set() for _ in anti]
    aff_matched: list[set] = [set() for _ in aff]
    any_aff_anywhere = False

    for m, pods_on_m in all_nodes:
        for q in pods_on_m:
            # symmetry: q's required anti-affinity vs incoming pod
            for t in _required_anti_terms(q):
                v_owner = m.labels.get(t.topology_key)
                if v_owner is not None and term_matches_pod(t, q, pod):
                    existing_anti_pairs.add((t.topology_key, v_owner))
            # incoming terms vs q
            for i, t in enumerate(anti):
                v = m.labels.get(t.topology_key)
                if v is not None and term_matches_pod(t, pod, q):
                    anti_occ[i].add(v)
            for i, t in enumerate(aff):
                v = m.labels.get(t.topology_key)
                if v is not None and term_matches_pod(t, pod, q):
                    aff_matched[i].add(v)
                    any_aff_anywhere = True

    return InterpodFilterState(
        existing_anti_pairs=existing_anti_pairs,
        anti_terms=list(zip(anti, anti_occ)),
        aff_terms=list(zip(aff, aff_matched)),
        any_aff_match_anywhere=any_aff_anywhere,
        self_matches_all=all(term_matches_pod(t, pod, pod) for t in aff),
    )


def interpod_filter(
    pod: Pod,
    node: Node,
    all_nodes: Sequence[tuple[Node, Sequence[Pod]]],
) -> bool:
    """Single-node probe; hot paths build the state once via
    build_interpod_state and call .check per node."""
    return build_interpod_state(pod, all_nodes).check(node)


def interpod_raw_scores(
    pod: Pod,
    candidates: Sequence[Node],
    all_nodes: Sequence[tuple[Node, Sequence[Pod]]],
    hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT,
) -> list[int]:
    """Unnormalized per-candidate scores (scoring.go topologyScore sums)."""
    # contributions keyed by (topologyKey, value)
    pair_score: dict[tuple[str, str], int] = {}

    def add(key: str, owner_node: Node, w: int) -> None:
        v = owner_node.labels.get(key)
        if v is None or w == 0:
            return
        pair_score[(key, v)] = pair_score.get((key, v), 0) + w

    pref_aff = _preferred_terms(pod, anti=False)
    pref_anti = _preferred_terms(pod, anti=True)
    for m, pods_on_m in all_nodes:
        for q in pods_on_m:
            for wt in pref_aff:
                if term_matches_pod(wt.term, pod, q):
                    add(wt.term.topology_key, m, wt.weight)
            for wt in pref_anti:
                if term_matches_pod(wt.term, pod, q):
                    add(wt.term.topology_key, m, -wt.weight)
            # symmetry: q's preferred terms vs incoming pod
            for wt in _preferred_terms(q, anti=False):
                if term_matches_pod(wt.term, q, pod):
                    add(wt.term.topology_key, m, wt.weight)
            for wt in _preferred_terms(q, anti=True):
                if term_matches_pod(wt.term, q, pod):
                    add(wt.term.topology_key, m, -wt.weight)
            # symmetry: q's REQUIRED affinity terms, weighted by config
            if hard_pod_affinity_weight:
                for t in _required_aff_terms(q):
                    if term_matches_pod(t, q, pod):
                        add(t.topology_key, m, hard_pod_affinity_weight)

    out = []
    for n in candidates:
        s = 0
        for (key, v), w in pair_score.items():
            if n.labels.get(key) == v:
                s += w
        out.append(s)
    return out


def normalize_scores(raw: Sequence[int]) -> list[int]:
    """scoring.go#NormalizeScore: max-min scaling to 0..100."""
    if not raw:
        return []
    mx, mn = max(raw), min(raw)
    if mx == mn:
        return [0 for _ in raw]
    return [MAX_NODE_SCORE * (s - mn) // (mx - mn) for s in raw]


def interpod_scores(
    pod: Pod,
    candidates: Sequence[Node],
    all_nodes: Sequence[tuple[Node, Sequence[Pod]]],
    hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT,
) -> list[int]:
    return normalize_scores(
        interpod_raw_scores(pod, candidates, all_nodes, hard_pod_affinity_weight)
    )
