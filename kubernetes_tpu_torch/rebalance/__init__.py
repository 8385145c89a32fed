"""Continuous global rebalancer — the background defragmentation engine
(ROADMAP open item #2, grounded in CvxCluster's whole-cluster allocation
and "Priority Matters"' constraint-based re-packing, PAPERS.md).

The single-shot auction (solver/single_shot.py) solves the 50k x 10k
global re-placement in one batched solve; this package is the production
loop around it:

- **detect** (``detector.py``): fragmentation and priority-inversion
  signals computed from the live ``Snapshot`` node tensors — pure host
  numpy over arrays the scheduler already maintains, zero new device
  syncs;
- **plan** (``planner.py``): run the auction with the ``pack``
  objective over the current cluster to get a consolidation target
  assignment, diff target vs actual placement into candidate moves;
- **bound** (``planner.select_moves``): max-churn budget per cycle,
  PDB-aware selection through ``ops/oracle/preemption.py``'s
  ``classify_pdb_violations`` machinery, priority-ordered, and only
  moves that strictly improve the packing score — an unimprovable pod
  is never touched;
- **execute** (``runtime.py``): evict through the ``ClusterState``
  eviction subresource (Conflict-on-stale, PDB-enforcing, under the
  PR 8 commit fencing so a zombie incarnation can never move anything)
  with a nominated-node hint toward the target; the evicted pod
  re-enters the ordinary scheduling queue and the existing commit path
  performs the migration.

The loop is leader/fence-gated and, in fleet mode, naturally
shard-scoped: a replica's cache IS its shard, so it only ever plans
over (and evicts from) nodes it owns.

Copied from ``kubernetes_tpu/rebalance/__init__.py``.
"""

from .detector import FragmentationReport, detect
from .planner import Move, RebalancePlan, plan_moves, select_moves
from .runtime import RebalanceConfig, Rebalancer, RunRecord

__all__ = [
    "FragmentationReport",
    "detect",
    "Move",
    "RebalancePlan",
    "plan_moves",
    "select_moves",
    "RebalanceConfig",
    "Rebalancer",
    "RunRecord",
]
