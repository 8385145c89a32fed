"""DRA allocation oracle — the dynamicresources plugin's candidate-node
and device-picking logic (pkg/scheduler/framework/plugins/dynamicresources/
[U], structured parameters), host-side.

Device accounting model ([BOUNDARY], api/dra.py documents the scope): a
device is identified by (driver, pool, name) on one node; it is free
unless some allocated ResourceClaim's results contain it. A claim is
allocatable on a node iff, walking its requests in order and taking
devices greedily (lowest slice/device index first — deterministic), every
request finds `count` free devices matching its DeviceClass. Allocated
claims pin their pods to the allocation's node.

The per-class node-count view feeds the solver's static mask the same way
the fused volume filter does: scheduling classes whose claims cannot be
satisfied on a node get that node masked before the device solve.

Copied from ``kubernetes_tpu/ops/oracle/dra.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import numpy as np

from ...api.dra import DeviceClass, DeviceResult, ResourceClaim, ResourceSlice
from ...api.objects import Node, Pod


class ClaimError(Exception):
    """Unresolvable claim reference / unsupported shape — the pod is
    unschedulable with this message (UnschedulableAndUnresolvable)."""


@dataclass
class _NodeDevices:
    # parallel lists, slice order then device order (deterministic
    # picking); identity of row i is ids[i] = (driver, pool, name)
    drivers: list[str] = field(default_factory=list)
    ids: list[tuple[str, str, str]] = field(default_factory=list)
    devices: list = field(default_factory=list)  # Device objects


@dataclass
class DraContext:
    classes: dict[str, DeviceClass]
    claims: dict[str, ResourceClaim]  # key = ns/name
    by_node: dict[str, _NodeDevices]
    # (driver, pool, device name) identities already taken, per node
    taken: dict[str, set[tuple[str, str, str]]]

    @staticmethod
    def build(
        slices: Iterable[ResourceSlice],
        classes: Iterable[DeviceClass],
        claims: Iterable[ResourceClaim],
    ) -> "DraContext":
        by_node: dict[str, _NodeDevices] = {}
        for s in sorted(slices, key=lambda s: s.name):
            nd = by_node.setdefault(s.node_name, _NodeDevices())
            for dv in s.devices:
                nd.drivers.append(s.driver)
                nd.ids.append((s.driver, s.pool, dv.name))
                nd.devices.append(dv)
        taken: dict[str, set[tuple[str, str, str]]] = {}
        claim_map = {c.key: c for c in claims}
        for c in claim_map.values():
            if c.allocated:
                t = taken.setdefault(c.allocated_node, set())
                for r in c.results:
                    t.add((r.driver, r.pool, r.device))
        return DraContext(
            classes={c.name: c for c in classes},
            claims=claim_map,
            by_node=by_node,
            taken=taken,
        )

    # -- feasibility --

    def pod_claims(self, pod: Pod) -> list[ResourceClaim]:
        """Resolve the pod's claim references; ClaimError on a missing
        claim, an unknown DeviceClass, or an unexpanded claim template."""
        if pod.claim_templates_unresolved:
            raise ClaimError(
                "pod references a resourceClaimTemplateName; claim "
                "generation from templates is out of scope (create the "
                "ResourceClaim and reference it by resourceClaimName)"
            )
        out = []
        # dedupe repeated references: a pod listing one claim twice uses
        # ONE claim, not two allocations
        for name in dict.fromkeys(pod.resource_claim_names):
            key = f"{pod.namespace}/{name}"
            c = self.claims.get(key)
            if c is None:
                raise ClaimError(f"resourceclaim {key} not found")
            for r in c.requests:
                if r.device_class_name not in self.classes:
                    raise ClaimError(
                        f"resourceclaim {key}: deviceclass "
                        f"{r.device_class_name!r} not found"
                    )
            out.append(c)
        return out

    def _free_indices(
        self, node_name: str, cls: DeviceClass, extra_taken: set
    ) -> list[int]:
        nd = self.by_node.get(node_name)
        if nd is None:
            return []
        t = self.taken.get(node_name, set())
        return [
            i
            for i, did in enumerate(nd.ids)
            if did not in t
            and did not in extra_taken
            and cls.matches(nd.drivers[i], nd.devices[i])
        ]

    def pick(
        self, node_name: str, claims: Sequence[ResourceClaim]
    ) -> dict[str, list[DeviceResult]] | None:
        """Greedy deterministic allocation of every unallocated claim's
        requests on one node; None when it doesn't fit. Allocated claims
        must already sit on this node (else None). Returns
        claim key -> device results."""
        picked: dict[str, list[DeviceResult]] = {}
        extra: set[tuple[str, str, str]] = set()
        nd = self.by_node.get(node_name)
        for c in claims:
            if c.allocated:
                if c.allocated_node != node_name:
                    return None
                continue
            results: list[DeviceResult] = []
            for req in c.requests:
                cls = self.classes[req.device_class_name]
                free = self._free_indices(node_name, cls, extra)
                if len(free) < req.count:
                    return None
                for i in free[: req.count]:
                    drv, pool, dev = nd.ids[i]
                    extra.add(nd.ids[i])
                    results.append(
                        DeviceResult(
                            request=req.name,
                            driver=drv,
                            device=dev,
                            pool=pool,
                        )
                    )
            picked[c.key] = results
        return picked

    def feasible_mask(
        self, pod: Pod, slot_nodes: Sequence[Node | None]
    ) -> np.ndarray:
        """[N] bool: nodes where every claim of ``pod`` can be satisfied
        (allocated claims pin to their node). Raises ClaimError for
        unresolvable references — the caller reports the pod
        unschedulable rather than masking silently."""
        claims = self.pod_claims(pod)
        n = len(slot_nodes)
        mask = np.zeros(n, dtype=bool)
        if not claims:
            mask[:] = True
            return mask
        pinned = {c.allocated_node for c in claims if c.allocated}
        if len(pinned) > 1:
            return mask  # claims allocated on different nodes: infeasible
        for i, node in enumerate(slot_nodes):
            if node is None:
                continue
            if pinned and node.name not in pinned:
                continue
            mask[i] = self.pick(node.name, claims) is not None
        return mask
