"""Fragmentation detection from the live snapshot tensors.

Everything here is host-side numpy over the ``NodeBatch`` arrays the
scheduler's ``Snapshot`` already maintains (``allocatable``/``used``/
``pod_count``/``valid``/``schedulable``) — no device reads, no new sync
points (TPU001-clean by construction, same contract as the decision
journal's attribution).

The signals:

- **packed utilization** — the dominant-resource fill of the nodes that
  actually host pods: ``max(cpu, mem)`` of ``sum(used) / sum(alloc)``
  over non-empty schedulable nodes. A perfectly consolidated cluster
  runs its in-use nodes near full on their binding resource; a
  fragmented one spreads the same load thin. Dominant-resource (max,
  not mean) so a cpu-bound node counts as full even with memory spare —
  using the mean would make well-packed cpu-bound clusters look
  permanently fragmented and the rebalancer would chase an unreachable
  threshold forever.
- **bin-packing lower bound** — the fewest nodes the current load could
  occupy (total used / largest per-node allocatable, per resource, take
  the max). ``nodes_in_use`` far above it means consolidation headroom.
- **stranded capacity** — the fraction of total free capacity that
  hides on partly-used nodes (free slivers between resident pods)
  rather than on empty nodes, dominant-resource like packing (per
  resource, take the max). High stranding is what makes large pods
  unschedulable on a cluster whose aggregate free capacity is ample.

Copied from ``kubernetes_tpu/rebalance/detector.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tensorize.schema import CPU_IDX, MEM_IDX


@dataclass(frozen=True)
class FragmentationReport:
    nodes_total: int  # schedulable nodes in the snapshot
    nodes_in_use: int  # schedulable nodes hosting >= 1 pod
    ideal_nodes: int  # bin-packing lower bound for the current load
    packed_utilization: float  # dominant-resource fill of in-use nodes
    stranded_fraction: float  # free capacity hiding on partly-used nodes
    fragmented: bool  # packed_utilization < threshold with headroom
    # pending pods whose priority exceeds the lowest bound priority — a
    # signal that re-packing could seat them (advisory; the planner
    # itself only consolidates)
    priority_inversions: int = 0


def detect(
    batch,
    *,
    min_packing: float = 0.7,
    priority_inversions: int = 0,
) -> FragmentationReport:
    """Compute the fragmentation report for one snapshot ``NodeBatch``.

    ``fragmented`` is True when the in-use nodes run below
    ``min_packing`` on their dominant resource AND the load could
    provably fit on fewer nodes (``nodes_in_use > ideal_nodes``) — the
    second clause keeps a sparse-but-unconsolidatable cluster (one pod
    per node, each pod near node-sized) from triggering pointless plan
    solves every interval.
    """
    live = np.asarray(batch.valid) & np.asarray(batch.schedulable)
    pod_count = np.asarray(batch.pod_count)
    nonempty = live & (pod_count > 0)
    nodes_total = int(live.sum())
    nodes_in_use = int(nonempty.sum())

    cpu_a = np.asarray(batch.allocatable[CPU_IDX], dtype=np.float64)
    mem_a = np.asarray(batch.allocatable[MEM_IDX], dtype=np.float64)
    cpu_u = np.asarray(batch.used[CPU_IDX], dtype=np.float64)
    mem_u = np.asarray(batch.used[MEM_IDX], dtype=np.float64)

    if nodes_in_use == 0:
        return FragmentationReport(
            nodes_total=nodes_total,
            nodes_in_use=0,
            ideal_nodes=0,
            packed_utilization=1.0,
            stranded_fraction=0.0,
            fragmented=False,
            priority_inversions=priority_inversions,
        )

    def frac(used, alloc, mask) -> float:
        denom = float(alloc[mask].sum())
        return float(used[mask].sum()) / denom if denom > 0 else 0.0

    packed = max(
        frac(cpu_u, cpu_a, nonempty), frac(mem_u, mem_a, nonempty)
    )

    # bin-packing lower bound: per resource, total load over the
    # LARGEST single node's capacity (a true lower bound even on
    # heterogeneous clusters); dominant resource decides
    ideal = 0
    for used, alloc in ((cpu_u, cpu_a), (mem_u, mem_a)):
        cap = float(alloc[live].max()) if nodes_total else 0.0
        if cap > 0:
            ideal = max(
                ideal, int(np.ceil(float(used[live].sum()) / cap))
            )

    # dominant-resource, like packing: a memory-fragmented cluster
    # (cpu free concentrated on empty nodes, memory free scattered as
    # slivers) must still report high stranding
    stranded = 0.0
    for used, alloc in ((cpu_u, cpu_a), (mem_u, mem_a)):
        free = np.maximum(alloc - used, 0.0)
        total_free = float(free[live].sum())
        if total_free > 0:
            stranded = max(
                stranded, float(free[nonempty].sum()) / total_free
            )

    return FragmentationReport(
        nodes_total=nodes_total,
        nodes_in_use=nodes_in_use,
        ideal_nodes=ideal,
        packed_utilization=packed,
        stranded_fraction=stranded,
        fragmented=packed < min_packing and nodes_in_use > max(ideal, 1),
        priority_inversions=priority_inversions,
    )


def packing_score(batch, slot: int, extra_used=None) -> int:
    """Integer dominant-resource fill of one snapshot slot, in percent
    points — the planner's per-move gain currency (integer so move
    selection is exactly deterministic). ``extra_used`` (a [K] vector)
    adjusts the slot's usage, e.g. minus the candidate pod's own request
    on its source node."""
    cpu_a = float(batch.allocatable[CPU_IDX, slot])
    mem_a = float(batch.allocatable[MEM_IDX, slot])
    cpu_u = float(batch.used[CPU_IDX, slot])
    mem_u = float(batch.used[MEM_IDX, slot])
    if extra_used is not None:
        cpu_u += float(extra_used[CPU_IDX])
        mem_u += float(extra_used[MEM_IDX])
    cpu_f = cpu_u / cpu_a if cpu_a > 0 else 0.0
    mem_f = mem_u / mem_a if mem_a > 0 else 0.0
    return int(100.0 * max(min(cpu_f, 1.0), min(mem_f, 1.0), 0.0))
