"""Volume binder — the Reserve/PreBind stages of the volumebinding plugin
(volumebinding/volume_binding.go#Reserve -> binder.AssumePodVolumes,
#PreBind -> binder.BindPodVolumes, #Unreserve), closing the VERDICT r2
gap: the static F-stage mask said where a pod COULD bind its volumes; this
actually binds them.

[BOUNDARY] depth per SURVEY §3.2: the in-memory cluster state stands in
for the apiserver, so "API writes + wait for bound" collapses to
synchronous PV/PVC updates under the cluster lock. Dynamic provisioning
remains stubbed (no matching PV and not resolvable -> Reserve fails, the
pod requeues — the same observable outcome as a provisioning timeout).

Flow inside a scheduling batch (matching the reference's cycle order):
  Reserve  : assume_pod_volumes(pod, node) — for each of the pod's unbound
             claims (incl. WaitForFirstConsumer, whose whole point is to
             bind at scheduling time on the CHOSEN node), pick the best
             matching PV (binder.go#findMatchingVolume preference: the
             smallest adequate volume) and record the assumption.
  PreBind  : bind_pod_volumes(pod) — write claimRef/volumeName into the
             cluster state for every assumption.
  failure  : unreserve(pod) — roll back any writes + assumptions.

Copied from ``kubernetes_tpu/state/volume_binder.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.objects import Node, PersistentVolume, PersistentVolumeClaim, Pod
from ..ops.oracle.volumes import VolumeContext, find_matching_pv
from .cluster import ApiError, ClusterState


class VolumeBindingError(Exception):
    pass


@dataclass
class _Assumption:
    pvc: PersistentVolumeClaim
    pv: PersistentVolume


@dataclass
class VolumeBinder:
    cluster: ClusterState
    # pod key -> assumptions made at Reserve
    _assumed: dict[str, list[_Assumption]] = field(default_factory=dict)

    def assume_pod_volumes(self, pod: Pod, node: Node) -> bool:
        """Reserve. Returns True if anything was assumed (pod has unbound
        claims), False for the no-volume fast path. Raises
        VolumeBindingError when an unbound claim matches no PV on the
        chosen node — the caller unreserves + requeues."""
        if not pod.pvc_names:
            return False
        pvcs = {c.key: c for c in self.cluster.list_pvcs()}
        # one mutable context: assumed PVs are removed as claims take them,
        # so multi-claim pods never share a PV and nothing is copied per
        # claim
        ctx = VolumeContext(
            pvs={pv.name: pv for pv in self.cluster.list_pvs()},
        )
        assumptions: list[_Assumption] = []
        for claim_name in pod.pvc_names:
            key = f"{pod.namespace}/{claim_name}"
            pvc = pvcs.get(key)
            if pvc is None:
                raise VolumeBindingError(f"claim {key} not found")
            if pvc.volume_name:
                continue  # already bound — nothing to assume
            # find_matching_pv already prefers the smallest adequate PV
            pv = find_matching_pv(ctx, pvc, node)
            if pv is None:
                raise VolumeBindingError(
                    f"claim {key}: no matching PersistentVolume on "
                    f"node {node.name}"
                )
            del ctx.pvs[pv.name]  # later claims of this pod can't reuse it
            assumptions.append(_Assumption(pvc=pvc, pv=pv))
        if assumptions:
            self._assumed[pod.key] = assumptions
            return True
        return False

    def bind_pod_volumes(self, pod: Pod) -> None:
        """PreBind: commit every assumption into the cluster state.

        The objects are the cluster's live references, so the in-place
        claim_ref/volume_name writes are visible immediately; unreserve
        reverts UNCONDITIONALLY so a mid-commit failure can never strand a
        half-bound claim."""
        for a in self._assumed.get(pod.key, ()):
            a.pv.claim_ref = a.pvc.key
            a.pvc.volume_name = a.pv.name
            self.cluster.update_pv(a.pv)
            self.cluster.update_pvc(a.pvc)

    def finish(self, pod_key: str) -> None:
        """Binding succeeded: drop the assumption bookkeeping."""
        self._assumed.pop(pod_key, None)

    def unreserve(self, pod_key: str) -> None:
        """Roll back assumptions unconditionally (idempotent: clearing an
        already-clear binding is a no-op write)."""
        for a in self._assumed.pop(pod_key, ()):
            a.pv.claim_ref = ""
            a.pvc.volume_name = ""
            try:
                self.cluster.update_pv(a.pv)
                self.cluster.update_pvc(a.pvc)
            except ApiError:
                pass
