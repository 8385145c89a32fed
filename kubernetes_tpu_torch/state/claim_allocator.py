"""ResourceClaim allocator — the Reserve/PreBind/Unreserve stages of the
dynamicresources plugin (plugins/dynamicresources/dynamicresources.go
#Reserve -> claim assume, #PreBind -> allocation + reservedFor API writes,
#Unreserve [U]), shaped after this repo's VolumeBinder.

Flow inside a scheduling batch (gate: DynamicResourceAllocation):
  Reserve  : assume_pod_claims(pod, node) — resolve the pod's claims,
             greedily pick concrete free devices on the CHOSEN node
             (ops/oracle/dra.py#DraContext.pick, which also pins
             already-allocated claims to their node), and record the
             assumption. Assumed devices count as taken for later pods in
             the same batch even though nothing is written yet.
  PreBind  : bind_pod_claims(pod) — write allocation + reservedFor into
             the cluster state for every assumption.
  failure  : unreserve(pod) — roll back writes + assumptions.

Claim sharing: two pods may reference the same claim. The first Reserve
allocates it; the second pod's Reserve succeeds only on the allocation
node (otherwise it fails here and the pod requeues — the next batch's
filter mask pins it to the right node, the same assume-and-retry pattern
the reference uses for in-flight claim state).

Concurrency: Reserve runs under the cluster lock (inside schedule_batch);
PreBind/Unreserve run on the lockless binding cycle, so their claim-object
mutations take the cluster lock explicitly. The ``writing`` suppression
flag is THREAD-LOCAL: only events emitted from this thread's own
bind-write call stack are suppressed — another thread's concurrent
slice/claim event must still wake parked pods.

Copied from ``kubernetes_tpu/state/claim_allocator.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..api.dra import DeviceResult, ResourceClaim
from ..api.objects import Pod
from ..ops.oracle.dra import ClaimError, DraContext
from .cluster import ApiError, ClusterState


class ClaimAllocationError(Exception):
    pass


@dataclass
class _Assumption:
    claim: ResourceClaim
    node_name: str
    # the allocation this pod depends on — the freshly-picked devices when
    # this pod allocated the claim (fresh=True), or a COPY of the pinned
    # in-flight/written allocation when it joined as a sharer. Sharers
    # carrying the results means the in-flight accounting and the PreBind
    # write survive the original allocator rolling back first.
    results: tuple[DeviceResult, ...]
    fresh: bool
    # set by bind_pod_claims when THIS pod's PreBind wrote the allocation;
    # unreserve only clears an allocation this scheduler wrote (fresh or
    # wrote_alloc) — a pre-existing driver/controller allocation the pod
    # merely joined is never destroyed by our rollback
    wrote_alloc: bool = False


@dataclass
class ClaimAllocator:
    cluster: ClusterState
    # pod key -> assumptions made at Reserve
    _assumed: dict[str, list[_Assumption]] = field(default_factory=dict)
    # (dra_generation, DraContext) — the base context rebuild walks every
    # slice/class/claim, so it is cached until a DRA object changes
    _ctx_cache: tuple | None = None
    # in-flight overlay, maintained INCREMENTALLY as assumptions come and
    # go (rebuilding it from _assumed on every Reserve would be quadratic
    # across a DRA-heavy batch): per-node taken device ids and per-claim
    # pinned allocations
    _ov_taken: dict[str, set] = field(default_factory=dict)
    _ov_claims: dict[str, ResourceClaim] = field(default_factory=dict)
    _ov_dirty: bool = False
    # thread-local bind-write depth (see module docstring)
    _writing: threading.local = field(default_factory=threading.local)

    @property
    def writing(self) -> int:
        """Nonzero iff THIS thread is inside a bind-side claim write."""
        return getattr(self._writing, "n", 0)

    def _overlay_add(self, assumptions: list[_Assumption]) -> None:
        for a in assumptions:
            t = self._ov_taken.setdefault(a.node_name, set())
            for r in a.results:
                t.add((r.driver, r.pool, r.device))
            # pin the claim for later sharers while its status is unwritten
            if not a.claim.allocated:
                c = a.claim
                self._ov_claims[c.key] = ResourceClaim(
                    name=c.name,
                    namespace=c.namespace,
                    requests=c.requests,
                    allocated_node=a.node_name,
                    results=a.results,
                    reserved_for=c.reserved_for,
                    resource_version=c.resource_version,
                )

    def _rebuild_overlay(self) -> None:
        self._ov_taken = {}
        self._ov_claims = {}
        for assumptions in self._assumed.values():
            self._overlay_add(assumptions)
        self._ov_dirty = False

    def context(self) -> DraContext:
        # snapshot generation + the three lists atomically: callers run
        # outside the cluster lock (the fold section, the binding cycle),
        # and individually-locked list calls could tear against a
        # concurrent slice/claim write
        with self.cluster.lock:
            gen = getattr(self.cluster, "dra_generation", -1)
            if self._ctx_cache is None or self._ctx_cache[0] != gen:
                self._ctx_cache = (
                    gen,
                    DraContext.build(
                        self.cluster.list_resource_slices(),
                        self.cluster.list_device_classes(),
                        self.cluster.list_resource_claims(),
                    ),
                )
        base = self._ctx_cache[1]
        if self._ov_dirty:
            self._rebuild_overlay()
        # merged view: classes/by_node are immutable after build and
        # shared; claims/taken merge the in-flight overlay on top of the
        # base. Sets from ``base`` are SHARED where no overlay exists —
        # context consumers must not mutate ctx.taken (pick() uses a
        # local ``extra`` set).
        taken = dict(base.taken)
        for n, s in self._ov_taken.items():
            taken[n] = (base.taken.get(n) or set()) | s
        claims = dict(base.claims)
        for k, pinned in self._ov_claims.items():
            live = claims.get(k)
            if live is not None and not live.allocated:
                claims[k] = pinned
        return DraContext(
            classes=base.classes,
            claims=claims,
            by_node=base.by_node,
            taken=taken,
        )

    def assume_pod_claims(self, pod: Pod, node_name: str) -> bool:
        """Reserve. True if anything was assumed; False for the
        claim-free fast path. Raises ClaimAllocationError when a claim
        cannot be satisfied on the chosen node — the caller unreserves
        and requeues."""
        if not pod.resource_claim_names and not pod.claim_templates_unresolved:
            return False
        ctx = self.context()
        try:
            claims = ctx.pod_claims(pod)
        except ClaimError as e:
            raise ClaimAllocationError(str(e)) from None
        # the effective (possibly batch-assumed) claim objects
        claims = [ctx.claims[c.key] for c in claims]
        picked = ctx.pick(node_name, claims)
        if picked is None:
            raise ClaimAllocationError(
                f"cannot allocate resourceclaims on node {node_name}: "
                "devices exhausted or claim allocated elsewhere"
            )
        assumptions = []
        for c in claims:
            live = self.cluster.get_resource_claim(c.namespace, c.name)
            fresh = c.key in picked
            # sharers copy the allocation they depend on (the written one,
            # or the in-flight overlay's) so their PreBind can write it if
            # the allocating pod rolled back first
            results = (
                tuple(picked[c.key])
                if fresh
                else (ctx.claims[c.key].results or live.results)
            )
            assumptions.append(
                _Assumption(
                    claim=live,
                    node_name=node_name,
                    results=results,
                    fresh=fresh,
                )
            )
        if assumptions:
            self._assumed[pod.key] = assumptions
            self._overlay_add(assumptions)
            return True
        return False

    def bind_pod_claims(self, pod: Pod) -> None:
        """PreBind: write allocation + reservedFor for every assumption.
        A sharer writes the allocation too when the claim is (still or
        again) unallocated — the allocating pod may have failed its bind
        after this pod reserved. Runs on the lockless binding cycle, so
        the claim mutations take the cluster lock explicitly."""
        self._writing.n = getattr(self._writing, "n", 0) + 1
        try:
            with self.cluster.lock:
                for a in self._assumed.get(pod.key, ()):
                    c = a.claim
                    if not c.allocated and a.results:
                        c.allocated_node = a.node_name
                        c.results = a.results
                        a.wrote_alloc = True
                    if pod.key not in c.reserved_for:
                        c.reserved_for = c.reserved_for + (pod.key,)
                    self.cluster.update_resource_claim(c)
        finally:
            self._writing.n -= 1

    def finish(self, pod_key: str) -> None:
        """Binding succeeded: drop the assumption bookkeeping (the claim
        status is written, so the base context now carries it)."""
        if self._assumed.pop(pod_key, None) is not None:
            self._ov_dirty = True

    def unreserve(self, pod_key: str) -> None:
        """Roll back assumptions AND any PreBind writes (idempotent).
        The allocation is cleared only when no other pod reserves the
        claim AND this scheduler wrote it — a bound sharer keeps it
        alive, and a pre-existing controller allocation the pod merely
        joined is never destroyed."""
        assumptions = self._assumed.pop(pod_key, None)
        if assumptions is None:
            return
        self._ov_dirty = True
        with self.cluster.lock:
            for a in assumptions:
                c = a.claim
                changed = False
                if pod_key in c.reserved_for:
                    c.reserved_for = tuple(
                        k for k in c.reserved_for if k != pod_key
                    )
                    changed = True
                if (
                    c.allocated
                    and not c.reserved_for
                    and (a.fresh or a.wrote_alloc)
                ):
                    c.allocated_node = ""
                    c.results = ()
                    changed = True
                if changed:
                    try:
                        self.cluster.update_resource_claim(c)
                    except ApiError:
                        pass
