"""The plain reference for a configuration whose program preempts: the
default profile of ``reference.py`` plus DefaultPreemption.

It imports numpy and nothing of the program. It replays the program's record
as ``reference.Replay`` does (each batch's bindings, then its preemptions
``(preemptor, node, victims)`` in the order the program made them, then the
pods its rebalancer evicted, and the harness's deletes between batches),
judges the bindings as the default profile does, and counts two numbers more
(upstream's ``framework/preemption/preemption.go`` and
``plugins/defaultpreemption``; SURVEY.md section 3.1's preemption row and
section 4.3):

- ``preemption_faults``: each recorded preemption that breaks a rule below,
  judged on the state after its batch's bindings and the evictions recorded
  before it. The preemptor's ``preemptionPolicy`` is not ``Never``; no node
  passed every filter for it without evictions; every victim was bound on
  the named node at a strictly lower priority; with the victims gone the
  preemptor fits there; the victims are exactly SelectVictimsOnNode's greedy
  reprieve: every pod of lower priority removed, then each re-added in
  MoreImportantPod order (higher priority, then earlier start, then key)
  where the preemptor still fits, the rest the victims; and no node yields a
  candidate better on pickOneNodeForPreemption's first four criteria (fewer
  PDB violations, a lower highest victim priority, a lower sum of the
  victims' priorities each raised by MaxInt32 + 1, so that fewer victims
  come first, then fewer victims).
- ``nomination_breaks``: each binding of a nominated pod off its nominated
  node while that node still fits it (schedule_one.go's
  evaluateNominatedNode tries that node first), and each binding that fits
  only where a nominated pod of equal or higher priority is left out.

A preemption nominates its preemptor on the named node and clears the
nominations of lower priority there (prepareCandidate); a nomination ends
when its pod binds, is deleted or is evicted. Every filter here, the
preemption's too, counts a nominated pod as placed on its nominated node for
each pod of equal or lower priority but itself, and a node passes where it
passes both with and without them (RunFilterPluginsWithNominatedPods). A
nominated pod bound on its nominated node was not picked by score, and its
binding's score is not judged.

Which state a preemption is judged on: the state after all of its batch's
bindings (the record puts them first). The port takes its PostFilter
snapshot at the batch's first failure, before the batch's later pods are
assumed. In a batch that binds pods and preempts for pods of another
priority, a later binding onto the chosen node can read here as
``no_fit_with_the_victims_gone`` or ``a_better_node`` for a preemption that
was sound in the program's view. PreemptionBasic's batches do not show it:
a pod that binds in a batch with a preemption there is a preemptor of the
same priority on the node it was nominated to, which both views count as
taken. A configuration with mixed priorities needs a planted case that
checks this before a cell of it relies on ``preemption_faults``.

Departures from upstream, none of which lets a wrong answer through:

- Upstream dry-runs a sample of the nodes (at least 10 %, or 100) from a
  random offset; this reference judges against every node, so each global
  minimum is still a pick upstream could make.
- The fifth criterion, the victims' start time, is not judged: no pod here
  has a ``status.startTime`` (nor in scheduler_perf, where no kubelet runs).
  A pod dict that has one is refused.
- PodDisruptionBudgets are not in the record: the generator refuses a
  configuration with ``pod_disruption_budgets`` and makes none, so the
  first criterion reads 0 on every node.
- The victims are worked out for NodeResourcesFit (cpu, memory, pod count):
  a preemption where an eviction could move another filter (the preemptor's
  host ports, spread constraints or required anti-affinity, or a bound
  pod's required anti-affinity) is refused.
- Upstream keeps a pod from preempting while a victim on its nominated node
  is still terminating; here a deleted pod is gone at once.
- A rebalancer eviction replays as an eviction; the nomination it may leave
  is not in the record and is not judged.

Each refusal raises NotImplementedError rather than judge wrongly.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np

from . import reference

LIMITS = dict(reference.LIMITS, preemption_faults=0, nomination_breaks=0)


class _Candidate(NamedTuple):
    """SelectVictimsOnNode's answer on one node: its victims, and its key
    for pickOneNodeForPreemption (lower is better)."""

    victims: list[str]
    key: tuple


class PreemptReplay(reference.Replay):
    def __init__(self, node_dicts, pods, sample: set):
        super().__init__(node_dicts, pods, sample)
        # pod key -> the node it is nominated on
        self.nominated: dict[str, int] = {}
        self._priority: dict[str, int] = {}
        # node -> (what its candidate was worked out from, the candidate)
        self._candidates: dict[int, tuple] = {}
        self.faults = self.breaks = 0
        self.preemptions = self.victims = 0
        self.rules: Counter = Counter()

    # -- what the reference reads of a pod beyond PodView --

    def priority(self, key: str) -> int:
        if key not in self._priority:
            d = self.pods[key]
            spec = d.get("spec") or {}
            if (d.get("status") or {}).get("startTime"):
                raise NotImplementedError("a pod's start time is not modelled")
            if spec.get("priorityClassName") and spec.get("priority") is None:
                raise NotImplementedError("a priority class without spec.priority is not resolved")
            self._priority[key] = int(spec.get("priority") or 0)
        return self._priority[key]

    def policy(self, key: str) -> str:
        return (self.pods[key].get("spec") or {}).get("preemptionPolicy") or "PreemptLowerPriority"

    def more_important(self, key: str) -> tuple:
        """MoreImportantPod's order: higher priority, then earlier start
        (none here), then key."""
        return (-self.priority(key), key)

    # -- nominated pods --

    def peers(self, key: str, prio: int) -> list[tuple[reference.PodView, int]]:
        """The nominated pods a pod of priority ``prio`` sees as placed:
        those of equal or higher priority, itself left out."""
        return [(self.view(k), n) for k, n in self.nominated.items()
                if k != key and k not in self.cl.bound and self.priority(k) >= prio]

    @contextmanager
    def placed(self, peers):
        for q, n in peers:
            self.cl.bind(q, n)
        try:
            yield
        finally:
            for q, _ in peers:
                self.cl.delete(q.key)

    def feasible_nominated(self, p: reference.PodView, idx: np.ndarray, peers) -> np.ndarray:
        """The nodes ``idx`` that pass every filter for ``p`` both without and
        with the nominated pods ``peers`` placed."""
        ok = self.cl.feasible(p, idx)
        if peers:
            with self.placed(peers):
                ok &= self.cl.feasible(p, idx)
        return ok

    def score_nodes(self, p: reference.PodView, ok: np.ndarray) -> np.ndarray:
        peers = self.peers(p.key, self.priority(p.key))
        if not peers:
            return ok
        with self.placed(peers):
            return ok & self.cl.feasible(p, self.all_idx)

    def scored(self, p: reference.PodView, node: int) -> bool:
        return self.nominated.get(p.key) != node

    # -- the events --

    def on_bind(self, key: str, node_name: str) -> None:
        if key in self.pods and node_name in self.cl.index and key not in self.seen:
            p, node = self.view(key), self.cl.index[node_name]
            peers = self.peers(key, self.priority(key))
            nom = self.nominated.get(key)
            off = nom is not None and nom != node and bool(
                self.feasible_nominated(p, np.array([nom]), peers)[0])
            ignored = False
            if peers and self.cl.feasible(p, np.array([node]))[0]:
                with self.placed(peers):
                    ignored = not self.cl.feasible(p, np.array([node]))[0]
            if off or ignored:
                self.breaks += 1
                self.rules["bound_off_its_nominated_node" if off else "fits_only_without_a_nominated_pod"] += 1
        super().on_bind(key, node_name)
        if key in self.cl.bound:
            self.nominated.pop(key, None)

    def on_delete(self, key: str) -> None:
        super().on_delete(key)
        self.nominated.pop(key, None)

    def on_preempt(self, preemptor: str, node_name: str, victims) -> None:
        self.preemptions += 1
        self.victims += len(victims)
        broken = self.judge_preemption(preemptor, node_name, list(victims))
        if broken:
            self.faults += 1
            self.rules.update(broken)
        super().on_preempt(preemptor, node_name, victims)
        node = self.cl.index.get(node_name)
        if preemptor in self.pods and node is not None:
            prio = self.priority(preemptor)
            for k, n in list(self.nominated.items()):
                if n == node and self.priority(k) < prio:
                    del self.nominated[k]
            self.nominated[preemptor] = node

    # -- DefaultPreemption's rules --

    def judge_preemption(self, key: str, node_name: str, victims: list[str]) -> list[str]:
        """The rules the preemption breaks, by name; none for a sound one."""
        if key not in self.pods or node_name not in self.cl.index:
            return ["unknown_pod_or_node"]
        if key in self.cl.bound:
            return ["preemptor_already_bound"]
        p, node, prio = self.view(key), self.cl.index[node_name], self.priority(key)
        self._refuse_beyond_fit(p)
        broken = []
        if self.policy(key) == "Never":
            broken.append("policy_never")
        peers = self.peers(key, prio)
        if self.feasible_nominated(p, self.all_idx, peers).any():
            broken.append("fit_without_evictions")
        noms = defaultdict(list)
        for q, n in peers:
            noms[n].append(q)
        on_node = self.cl.on_node[node]
        if len(set(victims)) != len(victims) or any(
                v not in on_node or self.priority(v) >= prio for v in victims):
            broken.append("victim_not_lower_on_the_node")
        elif not self._fits(p, node, noms[node], [self.cl.bound[v][0] for v in victims]):
            broken.append("no_fit_with_the_victims_gone")
        chosen = self.candidate(p, prio, node, noms[node])
        if chosen is None or sorted(chosen.victims) != sorted(victims):
            broken.append("not_the_greedy_reprieve")
        if chosen is not None:
            best = min((c.key for c in (self.candidate(p, prio, n, noms[n]) for n in range(len(self.cl.names)))
                        if c is not None), default=chosen.key)
            if best < chosen.key:
                broken.append("a_better_node")
        return broken

    def _refuse_beyond_fit(self, p: reference.PodView) -> None:
        anti_owners = any(kind == "req_anti" and owners.any()
                          for table in self.cl._owners.values() for (kind, *_), owners in table.items())
        if p.ports or p.spread or p.req_anti or anti_owners:
            raise NotImplementedError("preemption beyond NodeResourcesFit is not modelled")

    def _fits(self, p, node: int, add, remove) -> bool:
        """NodeResourcesFit for ``p`` on ``node`` with the pods ``add``
        placed and ``remove`` gone."""
        cl = self.cl
        cpu = cl.cpu[node] + p.cpu + sum(q.cpu for q in add) - sum(q.cpu for q in remove)
        mem = cl.mem[node] + p.mem + sum(q.mem for q in add) - sum(q.mem for q in remove)
        count = cl.count[node] + 1 + len(add) - len(remove)
        return bool(count <= cl.alloc_pods[node] and (not p.cpu or cpu <= cl.alloc_cpu[node])
                    and (not p.mem or mem <= cl.alloc_mem[node]))

    def candidate(self, p, prio: int, node: int, noms) -> _Candidate | None:
        """SelectVictimsOnNode on ``node`` for ``p`` with the nominated pods
        ``noms`` placed there: None where nothing of lower priority is there,
        where ``p`` does not fit with all of it gone, or where it fits with
        none of it gone."""
        sig = (int(self.cl.stamp[node]), p.cpu, p.mem, prio, tuple(q.key for q in noms))
        hit = self._candidates.get(node)
        if hit is not None and hit[0] == sig:
            return hit[1]
        lower = sorted((k for k in self.cl.on_node[node] if self.priority(k) < prio), key=self.more_important)
        out = None
        if lower:
            views = [self.cl.bound[k][0] for k in lower]
            if self._fits(p, node, noms, views):
                removed, victims = list(views), []
                for k, q in zip(lower, views):
                    removed.remove(q)
                    if not self._fits(p, node, noms, removed):
                        removed.append(q)
                        victims.append(k)
                if victims:
                    prios = [self.priority(k) for k in victims]
                    # upstream raises each priority by MaxInt32 + 1 before the sum
                    out = _Candidate(victims, (0, max(prios), sum(q + 2 ** 31 for q in prios), len(victims)))
        self._candidates[node] = (sig, out)
        return out

    def numbers(self, mismatch: int) -> dict:
        return dict(super().numbers(mismatch), preemption_faults=self.faults, nomination_breaks=self.breaks,
                    _preemptions=self.preemptions, _victims=self.victims, _broken_rules=dict(self.rules))


def judge(node_dicts, pods, events, program_store: dict, program_nodes: dict | None, sample: set) -> dict:
    """``reference.judge``'s replay and numbers, and ``preemption_faults``
    and ``nomination_breaks``."""
    replay = PreemptReplay(node_dicts, pods, sample)
    replay.run(events)
    return replay.numbers(replay.readback(program_store, program_nodes))
