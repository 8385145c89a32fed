"""Outbound scheduler-extender client — the scheduler-side half of the
extender boundary (pkg/scheduler/extender.go#HTTPExtender), so the
``extenders[]`` section of KubeSchedulerConfiguration is HONORED, not just
parsed: configured extenders are consulted during the solve
(schedule_one.go#findNodesThatPassExtenders / #prioritizeNodes) and can
own the bind (#Bind).

TPU-shaped consultation model: the reference calls extenders once per
pod. Here Filter/Prioritize verdicts fold into the per-scheduling-class
device tables (like out-of-tree framework plugins): ONE filter + ONE
prioritize HTTP round trip per (class, extender) per batch, amortizing
the wire across every pod in the class. The divergence this buys is
documented and narrow: an extender is not re-consulted between two pods
of the same batch, so extender-side state that changes per placement is
not observed mid-batch — the same contract a nodeCacheCapable extender
already accepts between cache syncs.

Wire shapes are extender/v1 (lowercase JSON tags like the server half in
server/extender.py): ExtenderArgs{pod, nodes|nodenames} ->
ExtenderFilterResult{nodes|nodenames, failedNodes,
failedAndUnresolvableNodes, error} / HostPriorityList, and
ExtenderBindingArgs{podName, podNamespace, podUID, node} ->
ExtenderBindingResult{error}.

Copied from ``kubernetes_tpu/server/extender_client.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Sequence

from ..api.objects import Node, Pod
from ..config.types import Extender

# extender/v1/types.go#MaxExtenderPriority; scores rescale into the
# framework's MaxNodeScore range by MAX_NODE_SCORE / MAX_EXTENDER_PRIORITY
MAX_EXTENDER_PRIORITY = 10
MAX_NODE_SCORE = 100


class ExtenderError(Exception):
    """A non-ignorable extender failed: the reference aborts the pod's
    scheduling cycle with an error status (not Unschedulable)."""


class HTTPExtenderClient:
    """One configured extender (extender.go#HTTPExtender).

    ``transport`` is the injectable wire seam: a callable
    ``(verb, payload) -> parsed JSON`` that replaces the real HTTP POST.
    Production leaves it None (urllib against ``url_prefix``); the
    cluster simulator injects a fault transport here so extender
    latency/timeout/5xx scenarios exercise the REAL client paths —
    ignorable-skip, non-ignorable batch abort, malformed-result
    rejection — without a socket. A transport signals failure by raising
    ``OSError`` (connection/timeout analog) or ``ValueError`` (bad
    body); both map to ExtenderError exactly like the HTTP path."""

    def __init__(
        self, cfg: Extender, timeout: float = 5.0, transport=None
    ) -> None:
        self.cfg = cfg
        self.timeout = timeout
        self.transport = transport
        # cross-process trace propagation (kubernetes_tpu/obs): when
        # set — the scheduler points it at the current batch's trace
        # context before folding — every outbound verb carries it as
        # the payload's optional ``traceContext`` member, so an
        # extender server sharing the obs layer attributes its
        # micro-batched evaluation to the CALLER's trace. Servers that
        # don't know the field ignore it (extender/v1 parsers skip
        # unknown members; the reference server does).
        self.trace_context: dict | None = None

    @property
    def name(self) -> str:
        return self.cfg.url_prefix

    @property
    def is_binder(self) -> bool:
        return bool(self.cfg.bind_verb)

    @property
    def ignorable(self) -> bool:
        return self.cfg.ignorable

    def is_interested(self, pod: Pod) -> bool:
        """extender.go#IsInterested: no managedResources = all pods;
        otherwise any container requesting a managed resource."""
        if not self.cfg.managed_resources:
            return True
        managed = {
            m.get("name") for m in self.cfg.managed_resources if m.get("name")
        }
        return any(r in managed for r in pod.resource_request())

    # -- verbs --

    def _post(self, verb: str, payload: dict) -> dict | list:
        if self.trace_context is not None and isinstance(payload, dict):
            payload = dict(payload, traceContext=self.trace_context)
        if self.transport is not None:
            try:
                return self.transport(verb, payload)
            except (OSError, ValueError) as e:
                raise ExtenderError(
                    f"extender {self.name}/{verb}: {e}"
                ) from e
        req = urllib.request.Request(
            f"{self.cfg.url_prefix.rstrip('/')}/{verb}",
            json.dumps(payload).encode(),
            {"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ExtenderError(f"extender {self.name}/{verb}: {e}") from e

    def _args(self, pod: Pod, nodes: Sequence[Node]) -> dict:
        if self.cfg.node_cache_capable:
            return {
                "pod": pod.to_dict(),
                "nodenames": [n.name for n in nodes],
            }
        return {
            "pod": pod.to_dict(),
            "nodes": {"items": [n.to_dict() for n in nodes]},
        }

    def filter(
        self, pod: Pod, nodes: Sequence[Node]
    ) -> tuple[set, dict, dict]:
        """(kept node names, failedNodes, failedAndUnresolvableNodes)."""
        out = self._post(self.cfg.filter_verb, self._args(pod, nodes))
        if not isinstance(out, dict):
            raise ExtenderError(
                f"extender {self.name}: malformed filter result"
            )
        if out.get("error"):
            raise ExtenderError(f"extender {self.name}: {out['error']}")
        if out.get("nodenames") is not None:
            kept = set(out["nodenames"])
        else:
            kept = {
                d.get("metadata", {}).get("name")
                for d in (out.get("nodes") or {}).get("items") or []
            }
        return (
            kept,
            dict(out.get("failedNodes") or {}),
            dict(out.get("failedAndUnresolvableNodes") or {}),
        )

    def prioritize(self, pod: Pod, nodes: Sequence[Node]) -> dict:
        """node name -> weighted score contribution, already rescaled
        into the framework range: score * weight *
        (MaxNodeScore / MaxExtenderPriority) — prioritizeNodes' math."""
        out = self._post(self.cfg.prioritize_verb, self._args(pod, nodes))
        if not isinstance(out, list):
            raise ExtenderError(
                f"extender {self.name}: malformed HostPriorityList"
            )
        factor = self.cfg.weight * (MAX_NODE_SCORE // MAX_EXTENDER_PRIORITY)
        scores: dict[str, int] = {}
        try:
            for item in out:
                host, score = item.get("host"), int(item.get("score", 0))
                if host is None:
                    continue
                if not 0 <= score <= MAX_EXTENDER_PRIORITY:
                    raise ExtenderError(
                        f"extender {self.name}: score {score} for {host} "
                        f"outside [0, {MAX_EXTENDER_PRIORITY}]"
                    )
                scores[host] = score * factor
        except (TypeError, ValueError, AttributeError) as e:
            # malformed items stay inside the ExtenderError hierarchy so
            # an ignorable extender's bad response is skippable
            raise ExtenderError(
                f"extender {self.name}: malformed HostPriorityList "
                f"item: {e}"
            ) from e
        return scores

    def bind(self, pod: Pod, node_name: str) -> None:
        """Delegate the bind (extender.go#Bind): the extender commits the
        binding subresource; an {error} result fails the binding cycle."""
        out = self._post(
            self.cfg.bind_verb,
            {
                "podName": pod.name,
                "podNamespace": pod.namespace,
                "podUID": pod.uid or "",
                "node": node_name,
            },
        )
        if isinstance(out, dict) and out.get("error"):
            raise ExtenderError(f"extender {self.name}: {out['error']}")


def fold_extenders(
    clients: Sequence[HTTPExtenderClient],
    reps: Sequence[Pod],
    slot_nodes: Sequence[Node | None],
    mask,
    extra_score,
) -> None:
    """Fold extender Filter/Prioritize verdicts into the per-class device
    tables (the out-of-tree-plugin folding pattern,
    framework/runtime.py#fold_out_of_tree): per scheduling class, each
    extender in configured order filters the class's surviving candidate
    set and its prioritize scores accumulate weighted into extra_score.
    failedNodes and failedAndUnresolvableNodes both clear the mask (the
    unresolvable distinction only matters to preemption, which re-checks
    candidates itself). An ignorable extender's failure skips that
    extender; a non-ignorable failure raises ExtenderError, aborting the
    batch — an outage must not silently read as Unschedulable."""
    for c, rep in enumerate(reps):
        interested = [cl for cl in clients if cl.is_interested(rep)]
        if not interested:
            continue
        for cl in interested:
            candidates = [
                (slot, node)
                for slot, node in enumerate(slot_nodes)
                if node is not None and mask[c, slot]
            ]
            if not candidates:
                break
            nodes = [node for _, node in candidates]
            if cl.cfg.filter_verb:
                try:
                    kept, _failed, _unresolvable = cl.filter(rep, nodes)
                except ExtenderError:
                    if cl.ignorable:
                        continue
                    raise
                for slot, node in candidates:
                    if node.name not in kept:
                        mask[c, slot] = False
            if cl.cfg.prioritize_verb:
                # re-read the mask: prioritize only the set that SURVIVED
                # this extender's own filter pass (the reference
                # prioritizes the feasible set, and a partial-view server
                # may reject names it just failed)
                survivors = [
                    (slot, node)
                    for slot, node in candidates
                    if mask[c, slot]
                ]
                if not survivors:
                    continue
                try:
                    scores = cl.prioritize(
                        rep, [node for _, node in survivors]
                    )
                except ExtenderError:
                    if cl.ignorable:
                        continue
                    raise
                for slot, node in survivors:
                    s = scores.get(node.name)
                    if s:
                        extra_score[c, slot] += s
