"""The one traffic generator: nodes and pods as plain Kubernetes-shaped dicts.

A configuration file (``configs/<name>.json``) gives the node count and
shape, the pod kinds with their weights and the pods per rollout wave. The
pods form one stream: pod ``j`` is pod ``j mod wave_pods`` of wave
``j // wave_pods``, and wave ``w`` is namespace ``wave-<w>``, whose kinds
come in a seeded order with the same count of each kind in every wave and
every seed. An arrival process (``processes/<name>.py``, named by the
traffic file) decides when each pod of the stream is created and deleted.

The dicts are what both sides read: the program parses them with its own
``Pod.from_dict`` / ``Node.from_dict``, and the reference reads them as they
are. A pod's dict is a pure function of its key and the seed, so the harness
keeps keys and makes a dict again when the reference asks for it.
"""

from __future__ import annotations

import copy
import re

import numpy as np

MASK64 = (1 << 64) - 1
_KEY = re.compile(r"^wave-(\d{5})/(.+)-(\d{6})$")


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream index."""
    return np.random.default_rng([int(seed) & MASK64, *stream])


def node_dicts(config: dict) -> list[dict]:
    """The cluster's nodes: ``node_count`` nodes of one shape, labelled with
    their hostname and, where the configuration has zones, node ``i`` in
    zone ``z<i mod zones>``."""
    spec = config["nodes"]
    alloc = dict(spec["allocatable"])
    zones = int(spec.get("zones", 0))
    out = []
    for i in range(int(config["node_count"])):
        name = f"node-{i:05d}"
        labels = {spec["hostname_key"]: name}
        if zones:
            labels[spec["zone_key"]] = f"z{i % zones}"
        out.append({
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels},
            "spec": {},
            "status": {"capacity": dict(alloc), "allocatable": dict(alloc)},
        })
    return out


def kind_counts(config: dict, n: int) -> list[int]:
    """How many of ``n`` pods each kind gets: in proportion to the weights,
    the remainder to the first kinds."""
    weights = [k["weight"] for k in config["pod_kinds"]]
    total = sum(weights)
    counts = [n * w // total for w in weights]
    for i in range(n - sum(counts)):
        counts[i % len(counts)] += 1
    return counts


class Traffic:
    """The pod stream of one configuration for one seed."""

    def __init__(self, config: dict, seed: int):
        if config.get("pod_disruption_budgets"):
            # neither the program nor the reference would see them
            raise NotImplementedError("the generator makes no PodDisruptionBudget")
        self.config = config
        self.seed = seed
        self.wave_pods = int(config["wave_pods"])
        self._kinds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # per kind, its spec variants (one per hostPort of its cycle), built
        # once and shared by the pods: neither side writes into a pod's dict
        self._specs = []
        for kind in config["pod_kinds"]:
            cycle = kind.get("host_port_cycle") or [None]
            variants = []
            for port in cycle:
                spec = copy.deepcopy(kind["pod"]["spec"])
                if port is not None:
                    spec["containers"][0]["ports"] = [
                        {"containerPort": int(port), "hostPort": int(port), "protocol": "TCP"}]
                variants.append(spec)
            self._specs.append(variants)
        self._kind_index = {k["name"]: i for i, k in enumerate(config["pod_kinds"])}

    def _wave_kinds(self, w: int) -> tuple[np.ndarray, np.ndarray]:
        if w not in self._kinds:
            counts = kind_counts(self.config, self.wave_pods)
            kinds = np.repeat(np.arange(len(counts)), counts)
            rng(self.seed, 1, w).shuffle(kinds)
            # the i-th pod of a kind takes the i-th value of its cycles
            slot = np.zeros(len(kinds), np.int64)
            for k in range(len(counts)):
                idx = np.flatnonzero(kinds == k)
                slot[idx] = np.arange(len(idx))
            self._kinds[w] = kinds, slot
        return self._kinds[w]

    def _make(self, k: int, s: int, i: int, ns: str) -> dict:
        kind, variants = self.config["pod_kinds"][k], self._specs[k]
        return {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"{kind['name']}-{i:06d}", "namespace": ns,
                         "labels": kind["pod"]["metadata"]["labels"]},
            "spec": variants[s % len(variants)],
        }

    def pod(self, w: int, i: int) -> dict:
        """Pod ``i`` of wave ``w``: the kind's template with its name, its
        namespace and, for a kind with a ``host_port_cycle``, its hostPort."""
        kinds, slot = self._wave_kinds(w)
        return self._make(int(kinds[i]), int(slot[i]), i, f"wave-{w:05d}")

    def pods(self, start: int, stop: int) -> list[dict]:
        """Pods ``start`` to ``stop - 1`` of the stream."""
        return [self.pod(j // self.wave_pods, j % self.wave_pods) for j in range(start, stop)]

    def key(self, j: int) -> str:
        w, i = divmod(j, self.wave_pods)
        kinds, _ = self._wave_kinds(w)
        return f"wave-{w:05d}/{self.config['pod_kinds'][int(kinds[i])]['name']}-{i:06d}"

    def position(self, key: str) -> int | None:
        """The stream position of the pod ``key`` names, None for a key this
        stream never makes."""
        m = _KEY.match(key)
        if m is None:
            return None
        w, i = int(m.group(1)), int(m.group(3))
        if i >= self.wave_pods or self._kind_index.get(m.group(2)) != int(self._wave_kinds(w)[0][i]):
            return None
        return w * self.wave_pods + i


class StreamPods:
    """The dicts of the stream's first ``created`` pods, by key, made again
    on each lookup: what the reference reads in place of kept dicts."""

    def __init__(self, traffic: Traffic):
        self.traffic = traffic
        self.created = 0

    def __contains__(self, key) -> bool:
        j = self.traffic.position(key)
        return j is not None and j < self.created

    def __getitem__(self, key: str) -> dict:
        if key not in self:
            raise KeyError(key)
        w, i = divmod(self.traffic.position(key), self.traffic.wave_pods)
        return self.traffic.pod(w, i)
