"""The yardstick's peaks and the work a kernel's roofline share is held to.

The least time of a kernel is its bytes at the card's memory bandwidth (the
kernels measured here do next to no arithmetic). The bytes are counted from
what the inputs need, not from the program's launches or padding: a later
PR that changes how the work is done is held to the same count.
"""

from __future__ import annotations

import json

from .reference import selector_matches

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT32 = 4


def _terms(pod: dict) -> list[tuple[str, str, dict]]:
    """(kind, topology key, selector) of each pod-affinity term of ``pod``."""
    aff = (pod.get("spec") or {}).get("affinity") or {}
    out = []
    for side in ("podAffinity", "podAntiAffinity"):
        a = aff.get(side) or {}
        for t in a.get("requiredDuringSchedulingIgnoredDuringExecution") or ():
            out.append((side, t["topologyKey"], t.get("labelSelector")))
        for w in a.get("preferredDuringSchedulingIgnoredDuringExecution") or ():
            t = w["podAffinityTerm"]
            out.append((side, t["topologyKey"], t.get("labelSelector")))
    return out


def domain_aggregation_bytes(pod: dict, config: dict) -> int:
    """Bytes the domain aggregations of one scheduling step of ``pod`` need
    on a cluster of the configuration's nodes.

    A row aggregates one (selector, topology key) pair over the nodes: it
    reads each node's domain index and count (two int32) and writes what its
    caller reads. InterPodAffinity reads a per-node total (one int32 a node)
    for every distinct pair among the pod's own terms and the terms of the
    configuration's pods that select it (existing pods' terms, as
    upstream's symmetry rules count them). PodTopologySpread reads the
    per-domain counts (one int32 a domain) of each DoNotSchedule
    constraint. The domain count is the number of values of the key among
    the configuration's nodes."""
    n = int(config["node_count"])
    labels = pod["metadata"].get("labels") or {}
    domains = {config["nodes"]["hostname_key"]: n}
    if config["nodes"].get("zones"):
        domains[config["nodes"]["zone_key"]] = int(config["nodes"]["zones"])
    rows = {(key, json.dumps(sel, sort_keys=True)) for _, key, sel in _terms(pod)}
    for kind in config["pod_kinds"]:
        for _, key, sel in _terms(kind["pod"]):
            if selector_matches(sel, labels):
                rows.add((key, json.dumps(sel, sort_keys=True)))
    total = len(rows) * n * 3 * INT32
    for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or ():
        if c.get("whenUnsatisfiable", "DoNotSchedule") == "DoNotSchedule":
            total += n * 2 * INT32 + domains[c["topologyKey"]] * INT32
    return total


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
