"""PodTopologySpread tensorizer: compile each pod class's spread constraints
into "constraint instances" evaluated on-device with segment reductions.

Per instance j (one (class, constraint) pair, hard or soft):
- dom[j, n]   : domain id of node n under the instance's topologyKey
                (-1 = node lacks the key). Ids are per-topologyKey vocabs.
- elig[j, n]  : counting eligibility (common.go#calPreFilterState — node has
                ALL the class's keys + nodeAffinityPolicy/nodeTaintsPolicy).
- max_skew[j], min_domains[j] (-1 = nil), self_match[j], is_hostname[j].

The per-node match counts cnt[j, n] are SOLVE STATE: they start from the
already-placed pods and are incremented in-scan when a batch pod lands on a
node and matches instance j's selector+namespace (placed_match[p, j],
precompiled host-side). Domain aggregation (counts per domain, min over
registered domains, #domains) runs on device per step as segment sums over
the node axis — the tensor equivalent of the reference's
TpPairToMatchNum/criticalPaths bookkeeping (filtering.go#preFilterState).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from ..api.objects import Node, Pod
from ..ops.oracle import spread as osp
from .schema import PodBatch, bucket_pow2

INST_PAD = 8  # instance-axis quantum
DOM_PAD = 8


@dataclass
class SpreadTensors:
    num_instances: int
    d_pad: int  # static segment count for domain reductions
    # per-instance tables
    dom: np.ndarray  # [Jp, Np] int32, -1 = key missing
    elig: np.ndarray  # [Jp, Np] bool
    max_skew: np.ndarray  # [Jp] int32
    min_domains: np.ndarray  # [Jp] int32, -1 = nil
    self_match: np.ndarray  # [Jp] bool
    is_hostname: np.ndarray  # [Jp] bool
    # class -> instance tables (-1 pad)
    hard: np.ndarray  # [Cp, Sh] int32
    soft: np.ndarray  # [Cp, Ss] int32
    # state + per-pod
    cnt0: np.ndarray  # [Jp, Np] int32 — matching placed pods per node
    placed_match: np.ndarray  # [Pp, Jp] bool

    @property
    def empty(self) -> bool:
        return self.num_instances == 0

    @property
    def has_soft(self) -> bool:
        """False when no class has a soft constraint: soft_scores is
        statically zero and the scan can skip it."""
        return bool((self.soft >= 0).any())


def trivial_spread_tensors(pbatch: PodBatch, padded_n: int, c_pad: int) -> SpreadTensors:
    z = np.zeros((INST_PAD, padded_n), dtype=np.int32)
    return SpreadTensors(
        num_instances=0,
        d_pad=DOM_PAD,
        dom=z - 1,
        elig=np.zeros((INST_PAD, padded_n), dtype=bool),
        max_skew=np.ones(INST_PAD, dtype=np.int32),
        min_domains=np.full(INST_PAD, -1, dtype=np.int32),
        self_match=np.zeros(INST_PAD, dtype=bool),
        is_hostname=np.zeros(INST_PAD, dtype=bool),
        hard=np.full((c_pad, 1), -1, dtype=np.int32),
        soft=np.full((c_pad, 1), -1, dtype=np.int32),
        cnt0=z.copy(),
        placed_match=np.zeros((pbatch.padded, INST_PAD), dtype=bool),
    )


def build_spread_tensors(
    pods: Sequence[Pod],
    class_reps: Sequence[Pod],
    pbatch: PodBatch,
    slot_nodes: Sequence[Node | None],
    placed_by_slot: Mapping[int, Sequence[Pod]],
    padded_n: int,
    c_pad: int,
    services: Sequence | None = None,
    defaulting: str = "System",
    nominated: Sequence[tuple[Pod, int]] = (),
) -> SpreadTensors:
    """class_reps comes from the static tensorizer so all per-class tables
    share one class id space (xs carries class_of for the gather).

    ``services`` + ``defaulting`` feed PodTopologySpreadArgs.defaultingType
    =System: classes with no explicit constraints get the soft
    zone/hostname system defaults when a service selects them.

    ``nominated`` carries (pod, node slot) pairs for unbound pods whose
    ``status.nominatedNodeName`` resolved to a live slot: they count in
    ``cnt0`` exactly like placed pods (the
    RunFilterPluginsWithNominatedPods convention the synchronous filter
    path already applies via the ports tensorizer) so a spread
    constraint sees a nominated peer as occupying its slot."""
    # collect instances per class
    per_class: list[tuple[list, list]] = []  # (hard ECs, soft ECs)
    insts: list[tuple[int, osp.EffectiveConstraint, bool, Pod]] = []
    for c, rep in enumerate(class_reps):
        defaults = (
            osp.system_default_constraints(rep, services)
            if defaulting == "System" and services
            else ()
        )
        hard = osp.effective_constraints(rep, hard=True)
        soft = osp.effective_constraints(rep, hard=False, defaults=defaults)
        per_class.append((hard, soft))
        for ec in hard:
            insts.append((c, ec, True, rep))
        for ec in soft:
            insts.append((c, ec, False, rep))

    if not insts:
        return trivial_spread_tensors(pbatch, padded_n, c_pad)

    j_pad = bucket_pow2(len(insts), floor=INST_PAD)
    sh = max(max((len(h) for h, _ in per_class), default=0), 1)
    ss = max(max((len(s) for _, s in per_class), default=0), 1)
    hard_tbl = np.full((c_pad, sh), -1, dtype=np.int32)
    soft_tbl = np.full((c_pad, ss), -1, dtype=np.int32)

    # domain vocab per topology key (over all live nodes)
    all_keys = {ec.topology_key for _, ec, _, _ in insts}
    key_vocab: dict[str, dict[str, int]] = {k: {} for k in all_keys}
    for node in slot_nodes:
        if node is None:
            continue
        for key in all_keys:
            v = node.labels.get(key)
            if v is not None:
                vocab = key_vocab[key]
                vocab.setdefault(v, len(vocab))
    max_domains = max((len(v) for v in key_vocab.values()), default=1)
    d_pad = bucket_pow2(max_domains, floor=DOM_PAD)

    dom = np.full((j_pad, padded_n), -1, dtype=np.int32)
    elig = np.zeros((j_pad, padded_n), dtype=bool)
    max_skew = np.ones(j_pad, dtype=np.int32)
    min_domains = np.full(j_pad, -1, dtype=np.int32)
    self_match = np.zeros(j_pad, dtype=bool)
    is_hostname = np.zeros(j_pad, dtype=bool)
    cnt0 = np.zeros((j_pad, padded_n), dtype=np.int32)
    placed_match = np.zeros((pbatch.padded, j_pad), dtype=bool)

    # counting eligibility is shared by every instance of one (class,
    # hardness) bucket (upstream counts one node set per bucket) — compute
    # each bucket's [N] row once, not once per instance
    elig_cache: dict[tuple[int, bool], np.ndarray] = {}

    def bucket_elig(c: int, is_hard: bool) -> np.ndarray:
        row = elig_cache.get((c, is_hard))
        if row is None:
            bucket = per_class[c][0] if is_hard else per_class[c][1]
            rep = class_reps[c]
            row = np.zeros(padded_n, dtype=bool)
            for n_i, node in enumerate(slot_nodes):
                if node is not None and n_i < padded_n:
                    row[n_i] = osp._node_counted(rep, node, bucket)
            elig_cache[(c, is_hard)] = row
        return row

    hard_fill: dict[int, int] = {}
    soft_fill: dict[int, int] = {}
    for j, (c, ec, is_hard, rep) in enumerate(insts):
        tbl, fill = (hard_tbl, hard_fill) if is_hard else (soft_tbl, soft_fill)
        s = fill.get(c, 0)
        tbl[c, s] = j
        fill[c] = s + 1

        max_skew[j] = ec.max_skew
        if ec.min_domains is not None:
            min_domains[j] = ec.min_domains
        self_match[j] = osp._sel_matches(ec.selector, rep.labels)
        is_hostname[j] = ec.topology_key == osp.HOSTNAME_KEY
        elig[j] = bucket_elig(c, is_hard)

        vocab = key_vocab.get(ec.topology_key, {})
        for n_i, node in enumerate(slot_nodes):
            if node is None or n_i >= padded_n:
                continue
            v = node.labels.get(ec.topology_key)
            if v is not None:
                dom[j, n_i] = vocab[v]
        for n_i, placed in placed_by_slot.items():
            if n_i >= padded_n:
                continue
            cnt0[j, n_i] = sum(
                1
                for p in placed
                if p.namespace == rep.namespace
                and osp._sel_matches(ec.selector, p.labels)
            )
        for p, n_i in nominated:
            # nominated-pod parity: count a matching nominated pod at
            # its slot exactly like a placed pod
            if 0 <= n_i < padded_n and (
                p.namespace == rep.namespace
                and osp._sel_matches(ec.selector, p.labels)
            ):
                cnt0[j, n_i] += 1

        for p_i, pod in enumerate(pods):
            placed_match[p_i, j] = pod.namespace == rep.namespace and (
                osp._sel_matches(ec.selector, pod.labels)
            )

    return SpreadTensors(
        num_instances=len(insts),
        d_pad=d_pad,
        dom=dom,
        elig=elig,
        max_skew=max_skew,
        min_domains=min_domains,
        self_match=self_match,
        is_hostname=is_hostname,
        hard=hard_tbl,
        soft=soft_tbl,
        cnt0=cnt0,
        placed_match=placed_match,
    )
