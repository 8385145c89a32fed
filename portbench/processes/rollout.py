"""``rollout``: the ``waves`` rollout with every pod of the stream in one
namespace.

The ``waves`` process gives each wave a namespace of its own, so a pod's
terms, which select the pods of their own namespace, never reach the other
live wave. A Deployment's rolling update keeps its old and new replicas in
one namespace, where a required anti-affinity term repels both. Here every
pod lives in the namespace ``rollout`` and is named by its stream position
(``<kind>-<position>``, at least six digits), so names stay unique across
waves. Creates, deletes and the window are the ``waves`` process's: wave
``w`` replaces wave ``w - 2`` a loop call's pods at a time whenever the
queue holds no more than that.
"""

from __future__ import annotations

import re

from portbench import gen, harness

NAMESPACE = "rollout"
_KEY = re.compile(rf"^{NAMESPACE}/(.+)-(\d{{6,}})$")


class OneNamespace(gen.Traffic):
    """The configuration's pod stream, every pod in ``NAMESPACE``."""

    def pod(self, w: int, i: int) -> dict:
        kinds, slot = self._wave_kinds(w)
        return self._make(int(kinds[i]), int(slot[i]), w * self.wave_pods + i, NAMESPACE)

    def key(self, j: int) -> str:
        kinds, _ = self._wave_kinds(j // self.wave_pods)
        return f"{NAMESPACE}/{self.config['pod_kinds'][int(kinds[j % self.wave_pods])]['name']}-{j:06d}"

    def position(self, key: str) -> int | None:
        m = _KEY.match(key)
        if m is None:
            return None
        j = int(m.group(2))
        return j if self.key(j) == key else None


class Process(harness.load_process("waves")):
    def __init__(self, cell, config, params, seed, device, trace, solver_overrides=None):
        super().__init__(cell, config, params, seed, device, trace, solver_overrides)
        self.traffic = OneNamespace(config, seed)
        self.pods = gen.StreamPods(self.traffic)
