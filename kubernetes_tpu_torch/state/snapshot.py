"""Device snapshot: the double-buffer between the scheduler cache and the
solver's HBM tensors.

Reference: pkg/scheduler/backend/cache/snapshot.go#Snapshot +
cache.go#UpdateSnapshot — the incremental O(changed-nodes) contract. Here
"copying a NodeInfo" becomes rewriting one column of the [K, N] arrays
(a dirty-column scatter); node add/remove manages slots (removed nodes leave
invalid slots that are reused) so node indices stay stable between updates —
important because the solver returns node *indices* and compiled shapes only
change when capacity grows (pow2 growth to bound XLA recompiles).

Copied from ``kubernetes_tpu/state/snapshot.py``.
"""

from __future__ import annotations

import numpy as np

from ..api.objects import RESOURCE_PODS, Node
from ..tensorize.schema import LANE, NodeBatch, ResourceVocab, bucket_pow2
from .cache import SchedulerCache


class Snapshot:
    def __init__(self) -> None:
        self.batch: NodeBatch | None = None
        # node-padding multiple beyond the LANE/pow2 bucket: the mesh
        # device count when the solve is sharded over the node axis (a
        # NamedSharding needs the trailing axis evenly divisible). Set by
        # the Scheduler from SchedulerConfig.mesh_devices before the
        # first update; padding columns stay valid=False/schedulable=
        # False so they are masked out of every filter/score/argmax path.
        self.pad_multiple = 1
        self.names: list[str] = []  # slot -> node name ("" = free)
        self._slot_of: dict[str, int] = {}
        self._free: list[int] = []
        self._last_generation = -1
        # per-column write versions: every column (re)write bumps its entry
        # from a monotonic counter. Device-resident solver sessions compare
        # against the version they last uploaded and re-heal only columns
        # written since — the device-side analog of the generation-based
        # incremental UpdateSnapshot contract.
        self.col_versions: np.ndarray = np.zeros(0, dtype=np.int64)
        self._col_counter = 0

    def _bump_col(self, i: int) -> None:
        self._col_counter += 1
        self.col_versions[i] = self._col_counter

    def touch(self, slot: int) -> None:
        """Force-mark a column dirty for device sessions. Used when host-side
        bookkeeping for a solver-made placement failed (e.g. assume rejected)
        so the device state may hold a placement the cache never saw."""
        self._bump_col(slot)

    def slot_of(self, name: str) -> int:
        return self._slot_of[name]

    def name_of(self, slot: int) -> str:
        return self.names[slot]

    # -- internals --

    def _ensure_capacity(self, n: int, vocab: ResourceVocab) -> None:
        cap = 0 if self.batch is None else self.batch.padded
        if n <= cap and self.batch is not None and tuple(vocab.names) == tuple(
            self.batch.vocab.names
        ):
            return
        # never shrink: existing slot indices must remain valid
        new_cap = bucket_pow2(max(n, cap, LANE))
        if self.pad_multiple > 1:
            # keep LANE alignment AND device-count divisibility (the
            # sharded node axis): round up to lcm(LANE, devices). For
            # power-of-two device counts <= LANE this is a no-op.
            import math

            q = math.lcm(LANE, self.pad_multiple)
            new_cap = ((new_cap + q - 1) // q) * q
        k = len(vocab)
        old = self.batch
        b = NodeBatch(
            vocab=vocab,
            names=[],
            num_nodes=0,
            padded=new_cap,
            allocatable=np.zeros((k, new_cap), dtype=np.int64),
            used=np.zeros((k, new_cap), dtype=np.int64),
            nonzero_used=np.zeros((2, new_cap), dtype=np.int64),
            pod_count=np.zeros(new_cap, dtype=np.int32),
            max_pods=np.zeros(new_cap, dtype=np.int32),
            valid=np.zeros(new_cap, dtype=bool),
            schedulable=np.zeros(new_cap, dtype=bool),
        )
        if old is not None and tuple(vocab.names) == tuple(old.vocab.names):
            c = old.padded
            b.allocatable[:, :c] = old.allocatable
            b.used[:, :c] = old.used
            b.nonzero_used[:, :c] = old.nonzero_used
            b.pod_count[:c] = old.pod_count
            b.max_pods[:c] = old.max_pods
            b.valid[:c] = old.valid
            b.schedulable[:c] = old.schedulable
            self.batch = b
        else:
            self.batch = b
            if old is not None:
                # vocab changed: every occupied column must be rewritten
                self._last_generation = -1
        self.names.extend([""] * (new_cap - len(self.names)))
        if len(self.col_versions) < new_cap:
            grown = np.zeros(new_cap, dtype=np.int64)
            grown[: len(self.col_versions)] = self.col_versions
            self.col_versions = grown

    def _required_vocab(self, cache: SchedulerCache) -> ResourceVocab:
        cur = self.batch.vocab if self.batch is not None else None
        needed: set[str] = set()
        for info in cache.nodes.values():
            if info.node is not None:
                needed.update(info.node.allocatable.keys())
            needed.update(k for k, v in info.used.items() if v)
        needed.discard(RESOURCE_PODS)
        if cur is not None and needed.issubset(cur.names):
            return cur
        from ..tensorize.schema import BASE_RESOURCES

        extended = sorted(needed - set(BASE_RESOURCES))
        return ResourceVocab(BASE_RESOURCES + tuple(extended))

    def _write_column(self, i: int, info, vocab: ResourceVocab) -> None:
        b = self.batch
        node = info.node
        b.allocatable[:, i] = vocab.vectorize(node.allocatable)
        b.used[:, i] = vocab.vectorize(info.used)
        b.nonzero_used[0, i] = info.nonzero_cpu
        b.nonzero_used[1, i] = info.nonzero_mem
        b.pod_count[i] = len(info.pods)
        b.max_pods[i] = node.allocatable.get(RESOURCE_PODS, 0)
        b.valid[i] = True
        b.schedulable[i] = not node.unschedulable
        self._bump_col(i)

    # -- the public incremental update --

    def update(self, cache: SchedulerCache) -> NodeBatch:
        """cache.go#UpdateSnapshot: refresh only what changed."""
        vocab = self._required_vocab(cache)
        live = {
            name: info
            for name, info in cache.nodes.items()
            if info.node is not None
        }
        new_count = sum(1 for name in live if name not in self._slot_of)
        self._ensure_capacity(len(self._slot_of) + new_count, vocab)
        b = self.batch

        # removals: slots whose node vanished (or became pod-only ghost)
        for name in list(self._slot_of):
            if name not in live:
                i = self._slot_of.pop(name)
                self.names[i] = ""
                b.valid[i] = False
                b.schedulable[i] = False
                self._free.append(i)
                self._bump_col(i)

        # additions + dirty rewrites. Fresh slots must dodge EVERY taken
        # slot, not just count up from the pre-add maximum: a removal can
        # free a HIGH slot in this same update, and once _free hands it
        # out, a max+1 counter sitting below it would walk back up and
        # assign the same slot twice — two nodes sharing one column, the
        # second _write_column silently erasing the first node's usage
        # (device tables then understate and the solver overcommits;
        # caught by the sim harness's capacity invariant under node-churn
        # profiles).
        taken = set(self._slot_of.values())
        next_slot = 0
        for name, info in live.items():
            i = self._slot_of.get(name)
            if i is None:
                if self._free:
                    i = self._free.pop()
                else:
                    while next_slot in taken:
                        next_slot += 1
                    i = next_slot
                taken.add(i)
                self._slot_of[name] = i
                self.names[i] = name
                self._write_column(i, info, vocab)
            elif info.generation > self._last_generation:
                self._write_column(i, info, vocab)

        self._last_generation = cache.generation
        b.num_nodes = len(self._slot_of)
        b.names = [n for n in self.names if n]
        return b
