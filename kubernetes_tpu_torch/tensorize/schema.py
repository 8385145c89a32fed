"""The tensor schema: API objects -> padded device arrays (SURVEY.md §8.1).

This is the TPU-native replacement for the reference's per-node NodeInfo
structs (pkg/scheduler/framework/types.go#NodeInfo: Requested,
NonZeroRequested, Allocatable, pod counts) and the per-cycle CycleState
scratch. Instead of 10k heap-allocated NodeInfo objects walked by goroutines,
the snapshot is a struct-of-arrays with the **node axis last** so it lands on
TPU lanes:

    allocatable[K, N]   int64   per-resource allocatable (resource-major!)
    used[K, N]          int64   NodeInfo.Requested equivalent
    nonzero_used[2, N]  int64   NodeInfo.NonZeroRequested (cpu milli, mem bytes)
    pod_count[N]        int32   len(NodeInfo.Pods)
    max_pods[N]         int32   NodeInfo.Allocatable.AllowedPodNumber

K (the resource vocabulary) is small and lives on sublanes; N is padded to a
multiple of 128 (TPU lane width) with a validity mask. Dtypes: resources are
int64 — exact parity with the reference's resource.Quantity int64 arithmetic
comes first; a scaled-int32 fast path can be layered on later without
changing kernel signatures.

Pod batches are pod-major (``req[P, K]``) because the exact-parity solver
scans over pods and gathers one row per step.

Padding uses "impossible" values (allocatable=0, request=+inf-ish) so padded
lanes never win an argmax and never pass a filter; every array also carries
an explicit validity mask.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import numpy as np

from ..api.objects import (
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Node,
    Pod,
)

LANE = 128  # TPU lane width: last-dim padding quantum

# Resources that are always in the vocabulary, in fixed order, so kernels can
# special-case cpu/memory by index (non-zero defaults apply to them only).
BASE_RESOURCES = (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE)
CPU_IDX = 0
MEM_IDX = 1


def pad_to(n: int, quantum: int = LANE) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def bucket_pow2(n: int, floor: int = LANE) -> int:
    """Round up to the next power-of-two-ish bucket to bound XLA recompiles
    (SURVEY.md §8.8 'recompile storms')."""
    b = floor
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class ResourceVocab:
    """Per-deployment resource vocabulary. cpu/memory/ephemeral-storage are
    always present at fixed indices; extended resources follow, sorted.
    The ``pods`` resource is handled as dedicated count arrays, mirroring
    NodeInfo.Allocatable.AllowedPodNumber."""

    names: tuple[str, ...]

    @functools.cached_property
    def index(self) -> dict[str, int]:
        # cached: vectorize runs once per node/pod on the host hot path
        return {n: i for i, n in enumerate(self.names)}

    def __len__(self) -> int:
        return len(self.names)

    @staticmethod
    def build(pods: Iterable[Pod], nodes: Iterable[Node]) -> "ResourceVocab":
        extended: set[str] = set()
        for p in pods:
            for r in p.resource_request():
                if r not in BASE_RESOURCES and r != RESOURCE_PODS:
                    extended.add(r)
        for n in nodes:
            for r in n.allocatable:
                if r not in BASE_RESOURCES and r != RESOURCE_PODS:
                    extended.add(r)
        return ResourceVocab(BASE_RESOURCES + tuple(sorted(extended)))

    def vectorize(self, res: Mapping[str, int]) -> np.ndarray:
        out = np.zeros(len(self.names), dtype=np.int64)
        idx = self.index
        for k, v in res.items():
            if k in idx:
                out[idx[k]] = v
        return out

    def has_unknown(self, res: Mapping[str, int]) -> bool:
        """True if ``res`` names a resource outside the vocabulary with a
        non-zero value. The vocab covers everything any node advertises, so
        an unknown requested resource can never be satisfied — the pod must
        be statically infeasible (the reference's Fit filter fails it on
        every node), NOT silently dropped."""
        idx = self.index
        return any(v > 0 and k not in idx and k != RESOURCE_PODS for k, v in res.items())


@dataclass
class NodeBatch:
    """Device-shaped snapshot of N nodes (padded to Np)."""

    vocab: ResourceVocab
    names: list[str]  # length num_nodes (unpadded)
    num_nodes: int
    padded: int

    allocatable: np.ndarray  # [K, Np] int64
    used: np.ndarray  # [K, Np] int64
    nonzero_used: np.ndarray  # [2, Np] int64
    pod_count: np.ndarray  # [Np] int32
    max_pods: np.ndarray  # [Np] int32
    valid: np.ndarray  # [Np] bool
    # static per-node feasibility from node state alone; the exact solver
    # ANDs this into every pod's mask. Starts as ~unschedulable; plugin
    # tensorizers (taints, etc.) refine it per pod class elsewhere.
    schedulable: np.ndarray  # [Np] bool  (node.Spec.Unschedulable inverted)

    def index_of(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.names)}

    def device_arrays(self) -> dict[str, np.ndarray]:
        """The pytree the solver ships to HBM."""
        return {
            "allocatable": self.allocatable,
            "used": self.used,
            "nonzero_used": self.nonzero_used,
            "pod_count": self.pod_count,
            "max_pods": self.max_pods,
            "valid": self.valid,
            "schedulable": self.schedulable,
        }


@dataclass
class PodBatch:
    """Device-shaped batch of P pending pods (padded to Pp), in queue order."""

    vocab: ResourceVocab
    keys: list[str]  # ns/name, length num_pods
    num_pods: int
    padded: int

    req: np.ndarray  # [Pp, K] int64 — computePodResourceRequest
    req_mask: np.ndarray  # [Pp, K] bool — which resources the pod requests >0
    feasible_static: np.ndarray  # [Pp] bool — False: requests a resource no node advertises
    nonzero_req: np.ndarray  # [Pp, 2] int64 — scoring requests w/ defaults
    priority: np.ndarray  # [Pp] int32
    valid: np.ndarray  # [Pp] bool

    def device_arrays(self) -> dict[str, np.ndarray]:
        return {
            "req": self.req,
            "req_mask": self.req_mask,
            "feasible_static": self.feasible_static,
            "nonzero_req": self.nonzero_req,
            "priority": self.priority,
            "valid": self.valid,
        }


def build_node_batch(
    nodes: Sequence[Node],
    pods_by_node: Mapping[str, Sequence[Pod]] | None = None,
    vocab: ResourceVocab | None = None,
    pad: int | None = None,
) -> NodeBatch:
    """Tensorize a node snapshot.

    ``pods_by_node`` carries the already-placed (scheduled + assumed) pods per
    node; their aggregated requests become ``used``/``nonzero_used`` exactly as
    cache.AssumePod accumulates NodeInfo.Requested in the reference.
    """
    pods_by_node = pods_by_node or {}
    if vocab is None:
        all_pods = [p for ps in pods_by_node.values() for p in ps]
        vocab = ResourceVocab.build(all_pods, nodes)
    n = len(nodes)
    np_pad = pad if pad is not None else pad_to(n)
    k = len(vocab)

    allocatable = np.zeros((k, np_pad), dtype=np.int64)
    used = np.zeros((k, np_pad), dtype=np.int64)
    nonzero_used = np.zeros((2, np_pad), dtype=np.int64)
    pod_count = np.zeros(np_pad, dtype=np.int32)
    max_pods = np.zeros(np_pad, dtype=np.int32)
    valid = np.zeros(np_pad, dtype=bool)
    schedulable = np.zeros(np_pad, dtype=bool)

    for i, node in enumerate(nodes):
        allocatable[:, i] = vocab.vectorize(node.allocatable)
        max_pods[i] = node.allocatable.get(RESOURCE_PODS, 0)
        valid[i] = True
        schedulable[i] = not node.unschedulable
        placed = pods_by_node.get(node.name) or ()
        pod_count[i] = len(placed)
        for p in placed:
            used[:, i] += vocab.vectorize(p.resource_request())
            nz = p.non_zero_request()
            nonzero_used[0, i] += nz[0]
            nonzero_used[1, i] += nz[1]

    return NodeBatch(
        vocab=vocab,
        names=[nd.name for nd in nodes],
        num_nodes=n,
        padded=np_pad,
        allocatable=allocatable,
        used=used,
        nonzero_used=nonzero_used,
        pod_count=pod_count,
        max_pods=max_pods,
        valid=valid,
        schedulable=schedulable,
    )


@dataclass
class NominatedTensors:
    """Nominated-pod load for RunFilterPluginsWithNominatedPods semantics
    (framework/runtime/framework.go#addNominatedPods): when scheduling pod
    p, nominated pods with priority >= p.priority count as if already
    placed on their nominated node — the resource/count filters see their
    load, so a preemptor's freed capacity cannot be stolen by a
    lower-priority pod.

    Levels are the distinct nominated priorities, DESCENDING; row l of the
    cumulative tensors holds the total load of nominated pods with
    priority >= levels[l-1] (row 0 = no load, for pods outranking every
    nomination). A pod's row index comes from level_of(). Only the
    monotone filters (resources, pod count) consume this — adding load
    can only shrink the feasible set, so the reference's run-twice
    protocol collapses to one run for them.

    NodePorts is covered too (ADVICE r3: port conflicts are as monotone
    as resources): when the caller passes the batch's PortTensors, the
    nominated pods' hostPorts are interned into that batch's port
    vocabulary (build_port_tensors takes ``nominated`` for exactly this)
    and ``port_takes`` carries their cumulative occupancy rows — a
    conflicting pod can no longer find a preemptor's reserved node
    port-feasible during the nomination window. PodTopologySpread and
    InterPodAffinity count nominated pods at their slots inside their own
    tensorizers (build_spread_tensors / build_interpod_tensors also take
    ``nominated``, VERDICT r5 parity), not through these cumulative rows —
    their counting is per-term, not per-priority-level.
    """

    levels: np.ndarray  # [L] int32 distinct nominated priorities, desc
    used: np.ndarray  # [L+1, K, Np] int64 cumulative nominated requests
    count: np.ndarray  # [L+1, Np] int32 cumulative nominated pod counts
    # [L+1, B, Np] int32 cumulative nominated hostPort occupancy in the
    # batch's port vocab (None: no port tensors supplied / no ports)
    port_takes: np.ndarray | None = None

    @property
    def empty(self) -> bool:
        return self.levels.size == 0

    def level_of(self, priority: np.ndarray) -> np.ndarray:
        """[P] priorities -> [P] row indices: number of levels with
        priority >= the pod's (0 = none apply)."""
        # levels desc; count levels >= priority
        return np.searchsorted(-self.levels, -np.asarray(priority), side="right").astype(
            np.int32
        )


def build_nominated_tensors(
    nominated: Sequence[tuple[Pod, int]],  # (pod, node slot)
    vocab: "ResourceVocab",
    n_pad: int,
    ports=None,  # PortTensors whose vocab includes the nominated ports
) -> NominatedTensors:
    """``nominated``: unbound pods carrying status.nominatedNodeName,
    with their nominated node's snapshot slot. With ``ports`` (the
    batch's PortTensors, built with the same ``nominated`` so its vocab
    interns their hostPorts), the cumulative port-occupancy rows are
    built too."""
    if not nominated:
        return NominatedTensors(
            levels=np.zeros(0, dtype=np.int32),
            used=np.zeros((1, len(vocab), n_pad), dtype=np.int64),
            count=np.zeros((1, n_pad), dtype=np.int32),
        )
    k = len(vocab)
    prios = sorted({p.effective_priority for p, _ in nominated}, reverse=True)
    levels = np.asarray(prios, dtype=np.int32)
    # pad the level axis to a small pow2 bucket so the number of distinct
    # nominated priorities doesn't mint fresh XLA executables (§8.8
    # recompile storms); padding rows repeat the last cumulative row and
    # are never indexed (level_of <= len(prios))
    rows = 4
    while rows < len(prios) + 1:
        rows *= 2
    used = np.zeros((rows, k, n_pad), dtype=np.int64)
    count = np.zeros((rows, n_pad), dtype=np.int32)
    port_takes = None
    port_index = None
    if ports is not None and any(p.host_ports() for p, _ in nominated):
        port_index = {t: i for i, t in enumerate(ports.vocab)}
        port_takes = np.zeros(
            (rows, ports.used.shape[0], n_pad), dtype=np.int32
        )
    # each pod's load lands in every cumulative row that includes its
    # priority (its own level row and every lower-priority row below it)
    for pod, slot in nominated:
        row = prios.index(pod.effective_priority) + 1
        r = vocab.vectorize(pod.resource_request())
        used[row:, :, slot] += r[None, :]
        count[row:, slot] += 1
        if port_takes is not None:
            for t in pod.host_ports():
                v = port_index.get(t)
                if v is not None:  # vocab built with `nominated` has all
                    port_takes[row:, v, slot] += 1
    return NominatedTensors(
        levels=levels, used=used, count=count, port_takes=port_takes
    )


def build_pod_batch(
    pods: Sequence[Pod],
    vocab: ResourceVocab,
    pad: int | None = None,
) -> PodBatch:
    p = len(pods)
    pp = pad if pad is not None else bucket_pow2(p)
    k = len(vocab)

    req = np.zeros((pp, k), dtype=np.int64)
    req_mask = np.zeros((pp, k), dtype=bool)
    feasible_static = np.ones(pp, dtype=bool)
    nonzero_req = np.zeros((pp, 2), dtype=np.int64)
    priority = np.zeros(pp, dtype=np.int32)
    valid = np.zeros(pp, dtype=bool)

    for i, pod in enumerate(pods):
        rr = pod.resource_request()
        r = vocab.vectorize(rr)
        req[i] = r
        req_mask[i] = r > 0
        if vocab.has_unknown(rr):
            feasible_static[i] = False
        nz = pod.non_zero_request()
        nonzero_req[i, 0] = nz[0]
        nonzero_req[i, 1] = nz[1]
        priority[i] = pod.effective_priority
        valid[i] = True

    return PodBatch(
        vocab=vocab,
        keys=[pod.key for pod in pods],
        num_pods=p,
        padded=pp,
        req=req,
        req_mask=req_mask,
        feasible_static=feasible_static,
        nonzero_req=nonzero_req,
        priority=priority,
        valid=valid,
    )
