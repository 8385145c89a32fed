"""Plugin tensorizer: compile the static plugin semantics (taints, node
affinity, nodeName, unschedulable, image locality) and the node-ports state
into per-batch device tensors (SURVEY.md §8.1).

The key idea is **pod scheduling classes**: pods whose scheduling-relevant
spec (tolerations, nodeSelector/affinity, nodeName, images) is identical
share one row of the [C, N] static tensors. Real workloads come from
deployments/jobs, so C << P — the host evaluates each distinct spec once per
node instead of once per pod (the reference evaluates every (pod, node) pair
from scratch inside the goroutine parallel-for; the class dedup is the
TPU-native restructuring that makes the host prep O(C·N) and the device work
a gather).

Static per-class tensors (filter mask + raw score inputs; normalization
happens in-scan because DefaultNormalizeScore normalizes over the FEASIBLE
set, which depends on solve state):
- mask[C, N]       : NodeName ∧ NodeUnschedulable ∧ TaintToleration(Filter)
                     ∧ NodeAffinity(Filter)
- taint_cnt[C, N]  : # intolerable PreferNoSchedule taints (Score, reverse)
- nodeaff_pref[C,N]: Σ weights of matching preferred terms (Score)
- image_score[C,N] : ImageLocality final 0-100 (no normalize step upstream)

NodePorts is state-dependent (placed pods occupy ports) so it tensorizes as
a (hostIP, protocol, hostPort) vocabulary:
- used[V, N]        : occupancy counts from already-placed pods
- pod_conflict[P, V]: vocab entries that clash with the pod's wanted ports
                      (HostPortInfo.CheckConflict wildcard-IP semantics
                      precompiled host-side)
- pod_takes[P, V]   : vocab counts the pod adds when placed (the in-scan
                      scatter that replaces cache.AssumePod's port tracking)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from ..api.objects import Node, Pod
from ..ops.oracle import plugins as opl
from ..ops.oracle import volumes as ovol
from .schema import PodBatch, bucket_pow2

CLASS_PAD = 8  # pad the class axis to multiples of this (sublane-ish quantum)
PORT_PAD = 8


def _class_key(pod: Pod, with_images: bool):
    """Everything the static plugins read from the pod spec. Image names only
    matter when some node reports images (image_score is their sole
    consumer); excluding them otherwise keeps C small for image-diverse
    batches. PodTopologySpread reads the pod's own labels (selfMatch,
    matchLabelKeys) and namespace, so those join the key only for pods that
    carry spread constraints."""
    na = pod.affinity.node_affinity if pod.affinity else None
    spread = (
        (
            pod.topology_spread_constraints,
            pod.namespace,
            tuple(sorted(pod.labels.items())),
        )
        if pod.topology_spread_constraints
        else ()
    )
    # InterPodAffinity: the incoming-term set depends on the pod's affinity
    # spec AND its namespace/labels (term namespaces default to the pod's
    # own; matchLabelKeys and the first-pod self-match read its labels)
    pa = pod.affinity.pod_affinity if pod.affinity else None
    paa = pod.affinity.pod_anti_affinity if pod.affinity else None
    interpod = (
        (pa, paa, pod.namespace, tuple(sorted(pod.labels.items())))
        if (pa is not None or paa is not None)
        else ()
    )
    return (
        pod.node_name,
        tuple(sorted(pod.node_selector.items())),
        na,
        pod.tolerations,
        tuple(tuple(c.images) for c in pod.containers) if with_images else (),
        len(pod.containers) if with_images else 0,
        spread,
        interpod,
        # volume plugins resolve PVCs by (namespace, claim name)
        (pod.namespace, pod.pvc_names) if pod.pvc_names else (),
    )


@dataclass
class StaticPluginTensors:
    num_classes: int
    class_of: np.ndarray  # [Pp] int32
    mask: np.ndarray  # [Cp, Np] bool
    taint_cnt: np.ndarray  # [Cp, Np] int32
    nodeaff_pref: np.ndarray  # [Cp, Np] int32
    image_score: np.ndarray  # [Cp, Np] int32
    # representative pod per class, for downstream per-class tensorizers
    # (spread, interpod affinity); not shipped to device
    reps: list = None
    # out-of-tree ScorePlugin contributions, weight-premultiplied
    # (framework/runtime.py#fold_out_of_tree); None = no custom plugins
    extra_score: np.ndarray | None = None  # [Cp, Np] int32

    @property
    def c_pad(self) -> int:
        return self.mask.shape[0]

    def device_arrays(self) -> dict[str, np.ndarray]:
        return {
            "class_of": self.class_of,
            "mask": self.mask,
            "taint_cnt": self.taint_cnt,
            "nodeaff_pref": self.nodeaff_pref,
            "image_score": self.image_score,
        }


def trivial_static_tensors(pbatch: PodBatch, padded_n: int, schedulable: np.ndarray) -> StaticPluginTensors:
    """One all-pods class whose mask is just the node schedulable bit —
    the pre-plugin behavior, used when a caller has only resource data."""
    mask = np.zeros((CLASS_PAD, padded_n), dtype=bool)
    mask[0] = schedulable[:padded_n]
    z = np.zeros((CLASS_PAD, padded_n), dtype=np.int32)
    return StaticPluginTensors(
        num_classes=1,
        class_of=np.zeros(pbatch.padded, dtype=np.int32),
        mask=mask,
        taint_cnt=z,
        nodeaff_pref=z.copy(),
        image_score=z.copy(),
        reps=[],
    )


VOLUME_PLUGINS = frozenset(
    {"VolumeBinding", "VolumeZone", "VolumeRestrictions", "NodeVolumeLimits"}
)


def build_static_tensors(
    pods: Sequence[Pod],
    pbatch: PodBatch,
    slot_nodes: Sequence[Node | None],
    padded_n: int,
    volume_ctx=None,
    disabled: frozenset = frozenset(),
    added_affinity=None,
    class_key_extra=None,
) -> StaticPluginTensors:
    """slot_nodes: Node per snapshot slot (None = free/invalid slot), so the
    class tensors share the solver's node index space. ``volume_ctx`` (an
    ops.oracle.volumes.VolumeContext) folds the volume plugin family's
    static checks into the mask.

    ``disabled``: filter-point plugin names disabled by the profile
    (runtime/framework.go honors plugins.filter.disabled); the volume
    family is fused, so disabling any one of its four names disables the
    fused check (the config loader warns about the coarseness).
    ``added_affinity``: NodeAffinityArgs.addedAffinity — required terms AND
    into every class mask, preferred weights add to the NodeAffinity score.
    ``class_key_extra``: optional callable(pod) mixed into the class key —
    used for identity the base key cannot see (e.g. the service-derived
    System spread-default selector).
    """
    live_nodes = [n for n in slot_nodes if n is not None]
    image_states = opl.build_image_states(live_nodes)
    total_nodes = len(live_nodes)
    any_images = bool(image_states)

    class_of = np.zeros(pbatch.padded, dtype=np.int32)
    reps: list[Pod] = []
    index: dict = {}
    for i, pod in enumerate(pods):
        key = _class_key(pod, with_images=any_images)
        if class_key_extra is not None:
            key = (key, class_key_extra(pod))
        c = index.get(key)
        if c is None:
            c = len(reps)
            index[key] = c
            reps.append(pod)
        class_of[i] = c

    c_pad = bucket_pow2(max(len(reps), 1), floor=CLASS_PAD)
    mask = np.zeros((c_pad, padded_n), dtype=bool)
    taint_cnt = np.zeros((c_pad, padded_n), dtype=np.int32)
    nodeaff_pref = np.zeros((c_pad, padded_n), dtype=np.int32)
    image_score = np.zeros((c_pad, padded_n), dtype=np.int32)

    for c, rep in enumerate(reps):
        for j, node in enumerate(slot_nodes):
            if node is None or j >= padded_n:
                continue
            ok = (
                ("NodeName" in disabled or opl.node_name_filter(rep, node))
                and (
                    "NodeUnschedulable" in disabled
                    or opl.node_unschedulable_filter(rep, node)
                )
                and (
                    "TaintToleration" in disabled
                    or opl.taint_toleration_filter(rep, node)
                )
                and (
                    "NodeAffinity" in disabled
                    or (
                        opl.node_affinity_filter(rep, node)
                        and opl.added_affinity_filter(added_affinity, node)
                    )
                )
                and (
                    volume_ctx is None
                    or not rep.pvc_names
                    or bool(VOLUME_PLUGINS & disabled)
                    or ovol.volume_filter(rep, node, volume_ctx)
                )
            )
            mask[c, j] = ok
            if not ok:
                continue  # score rows are only read where mask holds
            if node.taints:
                taint_cnt[c, j] = opl.taint_toleration_score(rep, node)
            aff = rep.affinity.node_affinity if rep.affinity else None
            if aff is not None and aff.preferred:
                nodeaff_pref[c, j] = opl.node_affinity_score(rep, node)
            if added_affinity is not None and added_affinity.preferred:
                nodeaff_pref[c, j] += opl.added_affinity_score(
                    added_affinity, node
                )
            if any_images:
                image_score[c, j] = opl.image_locality_score(
                    rep, node, image_states, total_nodes
                )

    return StaticPluginTensors(
        num_classes=len(reps),
        class_of=class_of,
        mask=mask,
        taint_cnt=taint_cnt,
        nodeaff_pref=nodeaff_pref,
        image_score=image_score,
        reps=reps,
    )


@dataclass
class PortTensors:
    num_ports: int
    vocab: list[tuple[str, str, int]]
    used: np.ndarray  # [Vp, Np] int32
    pod_conflict: np.ndarray  # [Pp, Vp] bool
    pod_takes: np.ndarray  # [Pp, Vp] int32

    def device_arrays(self) -> dict[str, np.ndarray]:
        return {
            "used": self.used,
            "pod_conflict": self.pod_conflict,
            "pod_takes": self.pod_takes,
        }


def _conflicts_as_used(want: tuple[str, str, int], entry: tuple[str, str, int]) -> bool:
    """Would occupancy of vocab ``entry`` block a pod wanting ``want``?
    Delegates to the oracle's CheckConflict transcription so kernel and
    oracle can't diverge."""
    return opl.port_conflicts(want, [entry])


class PortStaging:
    """Reusable host-prep staging for the port-occupancy half of
    ``build_port_tensors`` (the streaming dispatcher's tensorize
    micro-opt): the vocab and the ``used`` occupancy matrix depend only
    on PLACED pods and the node slot layout, so consecutive batches
    against an unchanged cache (the streaming burst window: no applies,
    no watch events between tensorizes) can reuse them instead of
    re-scanning every placed pod per batch. Validity is fingerprinted
    by ``key`` — the caller passes (cache generation, padded_n), so any
    cache mutation (the dirty-node/dirty-pod check) or slot-layout
    change rebuilds from scratch. Batch wants may EXTEND a staged vocab
    (new entries have zero placed occupancy by construction — the
    staged scan already interned every placed port), growing ``used``
    only when the pow2 pad actually grows."""

    def __init__(self) -> None:
        self.key: tuple | None = None
        self.vocab: list[tuple[str, str, int]] | None = None
        self.vocab_index: dict[tuple[str, str, int], int] | None = None
        self.used: np.ndarray | None = None
        self.hits = 0
        self.misses = 0


def build_port_tensors(
    pods: Sequence[Pod],
    pbatch: PodBatch,
    slot_nodes: Sequence[Node | None],
    placed_by_slot: Mapping[int, Sequence[Pod]],
    padded_n: int,
    nominated: Sequence[tuple[Pod, int]] = (),
    staging: PortStaging | None = None,
    staging_key: tuple | None = None,
) -> PortTensors:
    """``nominated`` (pod, slot) pairs contribute their hostPorts to the
    vocab so build_nominated_tensors can encode their occupancy rows in
    this batch's port space (NominatedTensors.port_takes).

    ``staging``/``staging_key``: see PortStaging — a matching key skips
    the placed-pod occupancy scan and reuses the staged vocab + used
    matrix (the returned arrays are never mutated downstream: ``used``
    is copied into the bstate upload, so sharing one array across
    consecutive batches is safe)."""
    reuse = (
        staging is not None
        and staging_key is not None
        and staging.key == staging_key
    )
    if reuse:
        staging.hits += 1
        # copies, not the staged objects: a prior batch's PortTensors
        # holds the previous list, and interning THIS batch's wants into
        # it would retroactively grow a vocab that batch's pod_conflict
        # width was sized for (journal attribution reads it at apply)
        vocab = list(staging.vocab)
        vocab_index = dict(staging.vocab_index)
    else:
        if staging is not None:
            staging.misses += 1
        vocab_index = {}
        vocab = []

    def intern(t: tuple[str, str, int]) -> int:
        v = vocab_index.get(t)
        if v is None:
            v = len(vocab)
            vocab_index[t] = v
            vocab.append(t)
        return v

    wants: list[tuple[tuple[str, str, int], ...]] = []
    for pod in pods:
        w = pod.host_ports()
        wants.append(w)
        for t in w:
            intern(t)
    if not reuse:
        used_entries: dict[int, list[int]] = {}
        for slot, placed in placed_by_slot.items():
            lst = used_entries.setdefault(slot, [])
            for p in placed:
                for t in p.host_ports():
                    lst.append(intern(t))
    for p, _slot in nominated:
        for t in p.host_ports():
            intern(t)

    v_pad = bucket_pow2(max(len(vocab), 1), floor=PORT_PAD)
    if reuse:
        used = staging.used
        if used.shape[0] < v_pad:
            # batch wants extended the vocab past the staged pad: grow
            # with zero rows (new entries cannot have placed occupancy)
            grown = np.zeros((v_pad, padded_n), dtype=np.int32)
            grown[: used.shape[0]] = used
            used = grown
    else:
        used = np.zeros((v_pad, padded_n), dtype=np.int32)
        for slot, entries in used_entries.items():
            if slot >= padded_n:
                continue
            for v in entries:
                used[v, slot] += 1
    if staging is not None and staging_key is not None:
        staging.key = staging_key
        staging.vocab = vocab
        staging.vocab_index = vocab_index
        staging.used = used

    pod_conflict = np.zeros((pbatch.padded, v_pad), dtype=bool)
    pod_takes = np.zeros((pbatch.padded, v_pad), dtype=np.int32)
    for i, w in enumerate(wants):
        if not w:
            continue
        for t in w:
            pod_takes[i, vocab_index[t]] += 1
        for v, entry in enumerate(vocab):
            if any(_conflicts_as_used(want, entry) for want in w):
                pod_conflict[i, v] = True

    return PortTensors(
        num_ports=len(vocab),
        vocab=vocab,
        used=used,
        pod_conflict=pod_conflict,
        pod_takes=pod_takes,
    )


def trivial_port_tensors(pbatch: PodBatch, padded_n: int) -> PortTensors:
    return PortTensors(
        num_ports=0,
        vocab=[],
        used=np.zeros((PORT_PAD, padded_n), dtype=np.int32),
        pod_conflict=np.zeros((pbatch.padded, PORT_PAD), dtype=bool),
        pod_takes=np.zeros((pbatch.padded, PORT_PAD), dtype=np.int32),
    )
