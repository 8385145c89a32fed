"""Scalar oracle for the volume plugin family ([BOUNDARY], SURVEY.md §3.2):

- volumebinding (static F-stage of volumebinding/volume_binding.go#Filter):
  per PVC of the pod:
    * bound claim (volumeName set): the PV must exist and its zone labels /
      nodeAffinity must admit the node;
    * unbound + WaitForFirstConsumer class: defer — passes Filter (binding
      happens at Reserve/PreBind, out of static scope);
    * unbound immediate class: some AVAILABLE PV must match (class, size,
      access mode) AND admit the node (find_matching_pv);
  dynamic provisioning is stubbed: no matching PV and not WFFC => fail.
- volumezone (volumezone/volume_zone.go): the zone-label check above.
- volumerestrictions (volumerestrictions/volume_restrictions.go): a
  ReadWriteOnce PV already attached on node m pins every other pod using
  the same claim to m (GCE-PD/EBS single-attach semantics).
- nodevolumelimits (nodevolumelimits/csi.go): count of CSI volumes (per
  driver) on the node + the pod's new ones must stay within the node's
  attachable limit, read from allocatable "attachable-volumes-csi-<driver>".

The VolumeContext aggregates what the reference's informers/CSINode objects
provide; the tensorizer compiles the same checks into the per-class static
mask (volumerestrictions contributes per-node state like ports).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from ...api.objects import (
    ACCESS_RWO,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
)


@dataclass
class VolumeContext:
    pvs: dict[str, PersistentVolume] = field(default_factory=dict)
    pvcs: dict[str, PersistentVolumeClaim] = field(default_factory=dict)
    # pv name -> node name currently holding an attached RWO claimant
    rwo_attached: dict[str, str] = field(default_factory=dict)
    # node -> csi driver -> attached UNIQUE volume names (upstream
    # nodevolumelimits counts distinct volume handles: two pods sharing one
    # PV consume ONE attachment slot, csi.go#filterAttachableVolumes)
    node_csi_volumes: dict[str, dict[str, set]] = field(default_factory=dict)

    def csi_count(self, node_name: str, driver: str) -> int:
        return len(self.node_csi_volumes.get(node_name, {}).get(driver, ()))

    @staticmethod
    def build(
        pvs: Sequence[PersistentVolume],
        pvcs: Sequence[PersistentVolumeClaim],
        pods_by_node: Mapping[str, Sequence[Pod]],
    ) -> "VolumeContext":
        ctx = VolumeContext(
            pvs={pv.name: pv for pv in pvs},
            pvcs={pvc.key: pvc for pvc in pvcs},
        )
        for node_name, pods in pods_by_node.items():
            for pod in pods:
                for claim in pod.pvc_names:
                    pvc = ctx.pvcs.get(f"{pod.namespace}/{claim}")
                    if pvc is None or not pvc.volume_name:
                        continue
                    pv = ctx.pvs.get(pvc.volume_name)
                    if pv is None:
                        continue
                    if ACCESS_RWO in pv.access_modes:
                        ctx.rwo_attached[pv.name] = node_name
                    if pv.csi_driver:
                        drv = ctx.node_csi_volumes.setdefault(node_name, {})
                        drv.setdefault(pv.csi_driver, set()).add(pv.name)
        return ctx


def find_matching_pv(
    ctx: VolumeContext, pvc: PersistentVolumeClaim, node: Node
) -> PersistentVolume | None:
    """volumebinding binder.go#findMatchingVolume, static slice: available,
    class matches, big enough, access mode present, admits the node."""
    best: PersistentVolume | None = None
    for pv in ctx.pvs.values():
        if pv.claim_ref and pv.claim_ref != pvc.key:
            continue
        if pv.storage_class != pvc.storage_class:
            continue
        if pv.capacity_bytes < pvc.request_bytes:
            continue
        if not set(pvc.access_modes) <= set(pv.access_modes):
            continue
        if not pv.matches_node(node):
            continue
        # smallest adequate volume wins (binder's preference)
        if best is None or pv.capacity_bytes < best.capacity_bytes:
            best = pv
    return best


def csi_limit_key(driver: str) -> str:
    return f"attachable-volumes-csi-{driver}"


def volume_filter(pod: Pod, node: Node, ctx: VolumeContext) -> bool:
    """All four volume plugins' Filter stages, fused."""
    new_csi: dict[str, set] = {}  # driver -> new unique volume names
    for claim in pod.pvc_names:
        pvc = ctx.pvcs.get(f"{pod.namespace}/{claim}")
        if pvc is None:
            return False  # missing claim: UnschedulableAndUnresolvable
        if pvc.volume_name:
            pv = ctx.pvs.get(pvc.volume_name)
            if pv is None:
                return False
            # volumezone + PV nodeAffinity
            if not pv.matches_node(node):
                return False
            # volumerestrictions: RWO single-attach follows the holder
            holder = ctx.rwo_attached.get(pv.name)
            if (
                holder is not None
                and holder != node.name
                and ACCESS_RWO in pv.access_modes
            ):
                return False
            if pv.csi_driver:
                new_csi.setdefault(pv.csi_driver, set()).add(pv.name)
        elif pvc.wait_for_first_consumer:
            continue  # defer to Reserve/PreBind
        else:
            pv = find_matching_pv(ctx, pvc, node)
            if pv is None:
                return False  # no static match, no dynamic provisioning
            if pv.csi_driver:
                new_csi.setdefault(pv.csi_driver, set()).add(pv.name)

    # nodevolumelimits: unique existing + unique NEW volumes per driver must
    # stay within the allocatable limit; a volume already attached on this
    # node consumes no extra slot (csi.go counts distinct volume handles)
    if new_csi:
        attached = ctx.node_csi_volumes.get(node.name, {})
        for driver, names in new_csi.items():
            limit = node.allocatable.get(csi_limit_key(driver))
            if limit is None:
                continue  # no limit advertised
            have = attached.get(driver, set())
            if len(have | names) > limit:
                return False
    return True
