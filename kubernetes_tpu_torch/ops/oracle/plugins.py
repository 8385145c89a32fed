"""Scalar oracles for the "static" in-tree plugins — TaintToleration,
NodeAffinity, NodeName, NodePorts, NodeUnschedulable, ImageLocality — plus
the shared DefaultNormalizeScore helper.

Direct transcriptions of the reference semantics (SURVEY.md §3.2); used as
ground truth by kernel parity tests. Never vectorized on purpose.

Reference:
- tainttoleration/taint_toleration.go#Filter (FindMatchingUntoleratedTaint
  over NoSchedule|NoExecute), #Score (countIntolerableTaintsPreferNoSchedule),
  #NormalizeScore (DefaultNormalizeScore reverse=true)
- nodeaffinity/node_affinity.go#Filter (GetRequiredNodeAffinity =
  spec.nodeSelector AND requiredDuringScheduling...), #Score (sum of matched
  preferred-term weights), #NormalizeScore (DefaultNormalizeScore)
- nodename/node_name.go#Filter
- nodeports/node_ports.go#Filter + framework/types.go#HostPortInfo.CheckConflict
- nodeunschedulable/node_unschedulable.go#Filter (tolerating the
  node.kubernetes.io/unschedulable:NoSchedule taint bypasses the check)
- imagelocality/image_locality.go#Score (#sumImageScores, #scaledImageScore,
  #calculatePriority, #normalizedImageName)
- plugins/helper/normalize_score.go#DefaultNormalizeScore
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

from ...api.objects import (
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    Node,
    Pod,
    Taint,
)
from ...api.labels import Selector, selector_from_match_labels

MAX_NODE_SCORE = 100

# v1.TaintNodeUnschedulable
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"

MB = 1024 * 1024
# imagelocality/image_locality.go
IMAGE_MIN_THRESHOLD = 23 * MB
IMAGE_MAX_THRESHOLD = 1000 * MB


# ---------------------------------------------------------------------------
# NodeName
# ---------------------------------------------------------------------------


def node_name_filter(pod: Pod, node: Node) -> bool:
    """nodename/node_name.go#Fits."""
    return not pod.node_name or pod.node_name == node.name


# ---------------------------------------------------------------------------
# NodeUnschedulable
# ---------------------------------------------------------------------------


def node_unschedulable_filter(pod: Pod, node: Node) -> bool:
    """node_unschedulable.go#Filter: unschedulable nodes pass only for pods
    tolerating the unschedulable:NoSchedule taint."""
    if not node.unschedulable:
        return True
    probe = Taint(key=TAINT_NODE_UNSCHEDULABLE, effect=TAINT_NO_SCHEDULE)
    return any(t.tolerates(probe) for t in pod.tolerations)


# ---------------------------------------------------------------------------
# TaintToleration
# ---------------------------------------------------------------------------


def taint_toleration_filter(pod: Pod, node: Node) -> bool:
    """Every NoSchedule/NoExecute taint must be tolerated."""
    for taint in node.taints:
        if taint.effect not in (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE):
            continue
        if not any(t.tolerates(taint) for t in pod.tolerations):
            return False
    return True


def taint_toleration_score(pod: Pod, node: Node) -> int:
    """Count of intolerable PreferNoSchedule taints (raw score; normalized
    reverse so fewer = better)."""
    cnt = 0
    for taint in node.taints:
        if taint.effect != TAINT_PREFER_NO_SCHEDULE:
            continue
        if not any(t.tolerates(taint) for t in pod.tolerations):
            cnt += 1
    return cnt


# ---------------------------------------------------------------------------
# NodeAffinity
# ---------------------------------------------------------------------------


def node_affinity_filter(pod: Pod, node: Node) -> bool:
    """GetRequiredNodeAffinity: spec.nodeSelector (AND of equals) AND
    nodeAffinity.requiredDuringScheduling (OR of terms)."""
    if pod.node_selector:
        sel = selector_from_match_labels(pod.node_selector)
        if not sel.matches(node.labels):
            return False
    na = pod.affinity.node_affinity if pod.affinity else None
    if na is not None and na.required is not None:
        fields = node.field_labels()
        if not any(t.matches(node.labels, fields) for t in na.required):
            return False
    return True


def added_affinity_filter(added, node: Node) -> bool:
    """NodeAffinityArgs.addedAffinity required terms (node_affinity.go: the
    scheduler-level selector is ANDed with the pod's own)."""
    if added is None or added.required is None:
        return True
    fields = node.field_labels()
    return any(t.matches(node.labels, fields) for t in added.required)


def added_affinity_score(added, node: Node) -> int:
    """Sum of matching addedAffinity preferred-term weights."""
    if added is None:
        return 0
    fields = node.field_labels()
    return sum(
        p.weight
        for p in added.preferred
        if p.weight and p.preference.matches(node.labels, fields)
    )


def node_affinity_score(pod: Pod, node: Node) -> int:
    """Sum of weights of matching preferredDuringScheduling terms."""
    na = pod.affinity.node_affinity if pod.affinity else None
    if na is None:
        return 0
    score = 0
    fields = node.field_labels()
    for pref in na.preferred:
        if pref.weight == 0:
            continue
        if pref.preference.matches(node.labels, fields):
            score += pref.weight
    return score


# ---------------------------------------------------------------------------
# NodePorts
# ---------------------------------------------------------------------------

WILDCARD_IP = "0.0.0.0"


def port_conflicts(
    want: tuple[str, str, int], used: Iterable[tuple[str, str, int]]
) -> bool:
    """HostPortInfo.CheckConflict for one wanted (hostIP, proto, hostPort)
    against the set of used triples on a node."""
    ip, proto, port = want
    if port <= 0:
        return False
    ip = ip or WILDCARD_IP
    if ip == WILDCARD_IP:
        return any(p == proto and pt == port for (_, p, pt) in used)
    return any(
        (uip == WILDCARD_IP or uip == ip) and p == proto and pt == port
        for (uip, p, pt) in used
    )


def node_ports_filter(pod: Pod, used_ports: Iterable[tuple[str, str, int]]) -> bool:
    used = list(used_ports)
    return not any(port_conflicts(w, used) for w in pod.host_ports())


def used_host_ports(pods: Iterable[Pod]) -> list[tuple[str, str, int]]:
    out: list[tuple[str, str, int]] = []
    for p in pods:
        out.extend(p.host_ports())
    return out


# ---------------------------------------------------------------------------
# ImageLocality
# ---------------------------------------------------------------------------


def normalized_image_name(name: str) -> str:
    """image_locality.go#normalizedImageName: append :latest when the image
    has no tag/digest (':' after the last '/' counts as a tag)."""
    if name.rfind(":") <= name.rfind("/") and "@" not in name:
        name += ":latest"
    return name


def build_image_states(
    nodes: Sequence[Node],
) -> dict[str, tuple[int, int]]:
    """name -> (sizeBytes, numNodes) over the snapshot, mirroring the cache's
    imageStates summary (cache.go#createImageStateSummary)."""
    states: dict[str, tuple[int, int]] = {}
    for node in nodes:
        for img in node.images:
            for n in img.names:
                n = normalized_image_name(n)
                size, cnt = states.get(n, (img.size_bytes, 0))
                states[n] = (size, cnt + 1)
    return states


def image_locality_score(
    pod: Pod,
    node: Node,
    image_states: Mapping[str, tuple[int, int]],
    total_nodes: int,
) -> int:
    """image_locality.go#Score. Only scoring containers (not init);
    scaledImageScore = size * numNodes / totalNodes (float->int64 trunc);
    image counted only if present on THIS node."""
    node_images = {
        normalized_image_name(n) for img in node.images for n in img.names
    }
    sum_scores = 0
    num_containers = len(pod.containers)
    for c in pod.containers:
        for raw in c.images:
            name = normalized_image_name(raw)
            if name not in node_images:
                continue
            size, num_nodes = image_states.get(name, (0, 0))
            if total_nodes > 0:
                sum_scores += int(size * num_nodes / total_nodes)
    min_t = IMAGE_MIN_THRESHOLD * num_containers
    max_t = IMAGE_MAX_THRESHOLD * num_containers
    s = min(max(sum_scores, min_t), max_t)
    if max_t == min_t:
        return 0
    return MAX_NODE_SCORE * (s - min_t) // (max_t - min_t)


# ---------------------------------------------------------------------------
# DefaultNormalizeScore
# ---------------------------------------------------------------------------


def default_normalize_score(
    scores: Sequence[int], reverse: bool, max_priority: int = MAX_NODE_SCORE
) -> list[int]:
    """helper/normalize_score.go#DefaultNormalizeScore (int64 math)."""
    max_count = max(scores, default=0)
    if max_count == 0:
        if reverse:
            return [max_priority for _ in scores]
        return list(scores)
    out = []
    for s in scores:
        s = max_priority * s // max_count
        if reverse:
            s = max_priority - s
        out.append(s)
    return out
