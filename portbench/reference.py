"""The plain reference: kube-scheduler's default profile over plain dicts.

It imports numpy and nothing of the program. It reads the same node and pod
dicts the program was given, replays the program's answers (the bindings it
returned, in the order it returned them, and the harness's deletes between
them), and judges each binding against the state that binding saw:

- feasibility, for every binding: NodeResourcesFit (cpu, memory, pod count),
  NodePorts, PodTopologySpread's DoNotSchedule constraints and
  InterPodAffinity's required anti-affinity, in both directions;
- score, for a sample of bindings drawn from the seed: the default profile's
  weighted total over the feasible nodes (NodeResourcesFit LeastAllocated x1,
  NodeResourcesBalancedAllocation in float64 x1, InterPodAffinity x2 with
  its max-min normalisation over the feasible nodes, in float64 as
  upstream computes it). The plugins that give every node of these clusters one value
  (TaintToleration, NodeAffinity, ImageLocality, PodTopologySpread's score
  for pods with no ScheduleAnyway constraint and no Service) move no pick
  and are left out. The gap is how far the pick's total lies below the best
  feasible total: 0 for any pick kube-scheduler could have made.

Upstream semantics follow pkg/scheduler/framework/plugins/{noderesources,
nodeports,podtopologyspread,interpodaffinity}. A pod dict with a feature
this reference does not model (required pod affinity, namespaces or a
namespaceSelector on a term, minDomains, init containers, overhead) is
refused with NotImplementedError rather than judged wrongly.
"""

from __future__ import annotations

import functools
import json
import math
from collections import defaultdict
from fractions import Fraction

import numpy as np

MAX_NODE_SCORE = 100
# resource_allocation.go: the requests scoring assumes for a container that
# states none
DEFAULT_MILLI_CPU = 100
DEFAULT_MEMORY = 200 * 1024 * 1024
WEIGHT_FIT, WEIGHT_BALANCED, WEIGHT_INTERPOD = 1, 1, 2

_BIN = {"Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40, "Pi": 2 ** 50, "Ei": 2 ** 60}
_DEC = {"n": Fraction(1, 10 ** 9), "u": Fraction(1, 10 ** 6), "m": Fraction(1, 1000), "": 1,
        "k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12, "P": 10 ** 15, "E": 10 ** 18}


def quantity(s) -> Fraction:
    """A resource.Quantity string as an exact number."""
    s = str(s).strip()
    for suf, mul in _BIN.items():
        if s.endswith(suf):
            return Fraction(s[: -len(suf)]) * mul
    if s[-1:] in _DEC and not s[-1:].isdigit():
        return Fraction(s[:-1]) * _DEC[s[-1]]
    return Fraction(s)


@functools.lru_cache(maxsize=1024)
def milli(q) -> int:
    """cpu in millicores, rounded up as Quantity.MilliValue does."""
    return math.ceil(quantity(q) * 1000)


@functools.lru_cache(maxsize=1024)
def whole(q) -> int:
    """memory or a count, rounded up as Quantity.Value does."""
    return math.ceil(quantity(q))


def selector_matches(sel: dict | None, labels: dict) -> bool:
    """metav1.LabelSelector: matchLabels and matchExpressions, ANDed. A
    missing selector matches nothing."""
    if sel is None:
        return False
    for k, v in (sel.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for e in sel.get("matchExpressions") or ():
        op, key, vals = e["operator"], e["key"], e.get("values") or ()
        if op == "In" and labels.get(key) not in vals:
            return False
        if op == "NotIn" and key in labels and labels[key] in vals:
            return False
        if op == "Exists" and key not in labels:
            return False
        if op == "DoesNotExist" and key in labels:
            return False
    return True


class PodView:
    """What the reference reads of one pod dict."""

    __slots__ = ("key", "ns", "labels", "cpu", "mem", "nz_cpu", "nz_mem", "ports",
                 "spread", "req_anti", "pref_aff", "pref_anti", "owned")

    def __init__(self, d: dict):
        meta, spec = d["metadata"], d.get("spec") or {}
        self.ns = meta.get("namespace") or "default"
        self.key = f"{self.ns}/{meta['name']}"
        self.labels = dict(meta.get("labels") or {})
        if spec.get("initContainers") or spec.get("overhead"):
            raise NotImplementedError("init containers and pod overhead are not modelled")
        self.cpu = self.mem = self.nz_cpu = self.nz_mem = 0
        ports = []
        for c in spec.get("containers") or ():
            req = (c.get("resources") or {}).get("requests") or {}
            cpu = milli(req["cpu"]) if "cpu" in req else 0
            mem = whole(req["memory"]) if "memory" in req else 0
            self.cpu += cpu
            self.mem += mem
            self.nz_cpu += cpu or DEFAULT_MILLI_CPU
            self.nz_mem += mem or DEFAULT_MEMORY
            for p in c.get("ports") or ():
                if int(p.get("hostPort") or 0) > 0:
                    ports.append((p.get("protocol") or "TCP", int(p["hostPort"]),
                                  p.get("hostIP") or "0.0.0.0"))
        self.ports = tuple(ports)
        self.spread = []
        for c in spec.get("topologySpreadConstraints") or ():
            if c.get("whenUnsatisfiable", "DoNotSchedule") != "DoNotSchedule":
                continue
            if c.get("minDomains") or c.get("matchLabelKeys"):
                raise NotImplementedError("minDomains and matchLabelKeys are not modelled")
            self.spread.append((int(c["maxSkew"]), c["topologyKey"], _canon(c.get("labelSelector"))))
        aff = spec.get("affinity") or {}
        pa, paa = aff.get("podAffinity") or {}, aff.get("podAntiAffinity") or {}
        if pa.get("requiredDuringSchedulingIgnoredDuringExecution") or aff.get("nodeAffinity") \
                or spec.get("nodeSelector") or spec.get("tolerations"):
            raise NotImplementedError("required pod affinity, node affinity and tolerations are not modelled")
        self.req_anti = [_term(t) for t in paa.get("requiredDuringSchedulingIgnoredDuringExecution") or ()]
        self.pref_aff = [(int(w["weight"]), *_term(w["podAffinityTerm"]))
                         for w in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or ()]
        self.pref_anti = [(int(w["weight"]), *_term(w["podAffinityTerm"]))
                          for w in paa.get("preferredDuringSchedulingIgnoredDuringExecution") or ()]
        # the terms this pod holds while it is bound, as others see them:
        # (kind, weight, topology key, selector)
        self.owned = ([("req_anti", 0, k, s) for k, s in self.req_anti]
                      + [("pref_aff", w, k, s) for w, k, s in self.pref_aff]
                      + [("pref_anti", w, k, s) for w, k, s in self.pref_anti])


_PARSED: dict[str, dict | None] = {}


def _canon(sel) -> str:
    c = json.dumps(sel, sort_keys=True)
    _PARSED.setdefault(c, sel)
    return c


def _sel(canon: str) -> dict | None:
    return _PARSED[canon]


def _term(t: dict) -> tuple[str, str]:
    if t.get("namespaces") or t.get("namespaceSelector") is not None or t.get("matchLabelKeys"):
        raise NotImplementedError("namespaces, namespaceSelector and matchLabelKeys are not modelled")
    return t["topologyKey"], _canon(t.get("labelSelector"))


class Cluster:
    """The node state the reference keeps, from the node dicts and the
    bindings replayed into it."""

    def __init__(self, node_dicts: list[dict]):
        self.names = [n["metadata"]["name"] for n in node_dicts]
        self.index = {name: i for i, name in enumerate(self.names)}
        n = len(self.names)
        alloc = [n_["status"]["allocatable"] for n_ in node_dicts]
        self.alloc_cpu = np.array([milli(a["cpu"]) for a in alloc], np.int64)
        self.alloc_mem = np.array([whole(a["memory"]) for a in alloc], np.int64)
        self.alloc_pods = np.array([whole(a["pods"]) for a in alloc], np.int64)
        self.cpu = np.zeros(n, np.int64)
        self.mem = np.zeros(n, np.int64)
        self.nz_cpu = np.zeros(n, np.int64)
        self.nz_mem = np.zeros(n, np.int64)
        self.count = np.zeros(n, np.int64)
        self.labels = [dict(n_["metadata"].get("labels") or {}) for n_ in node_dicts]
        self._domains: dict[str, tuple[np.ndarray, int]] = {}
        # (protocol, port, ip) -> pods per node holding it
        self.ports: dict[tuple, np.ndarray] = {}
        # namespace -> (selector, topology key) -> matching bound pods per domain
        self._match: dict[str, dict[tuple, np.ndarray]] = defaultdict(dict)
        # namespace -> (kind, weight, topology key, selector) -> owners per domain
        self._owners: dict[str, dict[tuple, np.ndarray]] = defaultdict(dict)
        self.bound: dict[str, tuple[PodView, int]] = {}

    def domains(self, key: str) -> tuple[np.ndarray, int]:
        """Per node, the index of its value of ``key`` (-1 without it), and
        the number of values."""
        if key not in self._domains:
            values: dict[str, int] = {}
            dom = np.array([values.setdefault(lab[key], len(values)) if key in lab else -1
                            for lab in self.labels], np.int64)
            self._domains[key] = (dom, len(values))
        return self._domains[key]

    def matching(self, ns: str, sel: str, key: str) -> np.ndarray:
        """Bound pods of namespace ``ns`` that ``sel`` selects, per domain of
        ``key``."""
        table = self._match[ns]
        if (sel, key) not in table:
            dom, nd = self.domains(key)
            c = np.zeros(nd, np.int64)
            for p, node in self.bound.values():
                if p.ns == ns and dom[node] >= 0 and selector_matches(_sel(sel), p.labels):
                    c[dom[node]] += 1
            table[(sel, key)] = c
        return table[(sel, key)]

    def _update(self, p: PodView, node: int, sign: int) -> None:
        self.cpu[node] += sign * p.cpu
        self.mem[node] += sign * p.mem
        self.nz_cpu[node] += sign * p.nz_cpu
        self.nz_mem[node] += sign * p.nz_mem
        self.count[node] += sign
        for port in p.ports:
            arr = self.ports.setdefault(port, np.zeros(len(self.names), np.int64))
            arr[node] += sign
        for (sel, key), c in self._match[p.ns].items():
            if selector_matches(_sel(sel), p.labels):
                dom, _ = self.domains(key)
                if dom[node] >= 0:
                    c[dom[node]] += sign
        owners = self._owners[p.ns]
        for kind, w, key, sel in p.owned:
            dom, nd = self.domains(key)
            if (kind, w, key, sel) not in owners:
                owners[(kind, w, key, sel)] = np.zeros(nd, np.int64)
            if dom[node] >= 0:
                owners[(kind, w, key, sel)][dom[node]] += sign

    def bind(self, p: PodView, node: int) -> None:
        self.bound[p.key] = (p, node)
        self._update(p, node, +1)

    def delete(self, key: str) -> None:
        p, node = self.bound.pop(key)
        self._update(p, node, -1)

    # -- the default profile --

    def feasible(self, p: PodView, idx: np.ndarray) -> np.ndarray:
        """Which of the nodes ``idx`` pass every Filter for ``p``."""
        ok = (self.count[idx] + 1 <= self.alloc_pods[idx])
        if p.cpu:
            ok &= self.cpu[idx] + p.cpu <= self.alloc_cpu[idx]
        if p.mem:
            ok &= self.mem[idx] + p.mem <= self.alloc_mem[idx]
        for proto, port, ip in p.ports:
            for (pr, po, i2), arr in self.ports.items():
                if pr == proto and po == port and (ip == i2 or "0.0.0.0" in (ip, i2)):
                    ok &= arr[idx] == 0
        for max_skew, key, sel in p.spread:
            dom, nd = self.domains(key)
            c = self.matching(p.ns, sel, key)
            self_match = int(selector_matches(_sel(sel), p.labels))
            d = dom[idx]
            lowest = c.min() if nd else 0
            ok &= (d >= 0) & (np.where(d >= 0, c[np.maximum(d, 0)], 0) + self_match - lowest <= max_skew)
        for key, sel in p.req_anti:
            dom, _ = self.domains(key)
            c = self.matching(p.ns, sel, key)
            d = dom[idx]
            ok &= (d < 0) | (c[np.maximum(d, 0)] == 0)
        # existing pods' required anti-affinity toward p
        for (kind, _w, key, sel), owners in self._owners[p.ns].items():
            if kind == "req_anti" and selector_matches(_sel(sel), p.labels):
                dom, _ = self.domains(key)
                d = dom[idx]
                ok &= (d < 0) | (owners[np.maximum(d, 0)] == 0)
        return ok

    def scores(self, p: PodView, idx: np.ndarray) -> np.ndarray:
        """The weighted total of the pick-moving plugins over the nodes
        ``idx``, which are the feasible ones (InterPodAffinity normalises
        over them)."""
        cpu = self.nz_cpu[idx] + p.nz_cpu
        mem = self.nz_mem[idx] + p.nz_mem
        ac, am = self.alloc_cpu[idx], self.alloc_mem[idx]

        def least(req, alloc):  # least_allocated.go, int64
            return np.where((alloc == 0) | (req > alloc), 0, (alloc - req) * MAX_NODE_SCORE // np.maximum(alloc, 1))

        fit = (least(cpu, ac) + least(mem, am)) // 2
        fc = np.minimum(cpu / ac, 1.0)  # balanced_allocation.go, float64
        fm = np.minimum(mem / am, 1.0)
        balanced = ((1.0 - np.abs(fc - fm) / 2.0) * MAX_NODE_SCORE).astype(np.int64)
        raw = np.zeros(len(idx), np.int64)
        touched = False
        for sign, terms in ((1, p.pref_aff), (-1, p.pref_anti)):
            for w, key, sel in terms:
                dom, _ = self.domains(key)
                d = dom[idx]
                raw += sign * w * np.where(d >= 0, self.matching(p.ns, sel, key)[np.maximum(d, 0)], 0)
                touched = True
        for (kind, w, key, sel), owners in self._owners[p.ns].items():
            if kind == "req_anti" or not selector_matches(_sel(sel), p.labels):
                continue
            weight = {"pref_aff": w, "pref_anti": -w}[kind]
            dom, _ = self.domains(key)
            d = dom[idx]
            raw += weight * np.where(d >= 0, owners[np.maximum(d, 0)], 0)
            touched = True
        interpod = normalize_interpod(raw) if touched else np.zeros(len(idx), np.int64)
        return WEIGHT_FIT * fit + WEIGHT_BALANCED * balanced + WEIGHT_INTERPOD * interpod


def normalize_interpod(raw: np.ndarray) -> np.ndarray:
    """interpodaffinity/scoring.go NormalizeScore over the feasible nodes:
    ``int64(float64(MaxNodeScore) * (float64(s - min) / float64(max - min)))``,
    0 everywhere when all are equal. The product is taken in float64 and
    truncated, as upstream does: 29 of 100 normalises to 28, not 29."""
    if not len(raw):
        return np.zeros(0, np.int64)
    lo, hi = int(raw.min()), int(raw.max())
    if hi == lo:
        return np.zeros(len(raw), np.int64)
    return (float(MAX_NODE_SCORE) * ((raw - lo).astype(np.float64) / float(hi - lo))).astype(np.int64)


def judge(node_dicts, pods, events, program_store: dict, program_nodes: dict | None,
          sample: set) -> dict:
    """Replay the program's answers and judge them.

    ``pods``: pod key -> the pod dict handed to the program (a mapping
    with ``in`` and ``[]``). ``events``: in
    order, ``("bind", key, node)`` for each binding the program returned and
    ``("delete", key)`` for each pod the harness deleted. ``program_store``:
    pod key -> node name ("" unbound) as the program's ClusterState reads
    back after the run. ``program_nodes``: node name -> (cpu, memory, pod
    keys) as the program's cache holds them, or None. ``sample``: the
    positions among the bindings whose score is checked.

    Returns the numbers compared, each of which is 0 in a correct run."""
    cl = Cluster(node_dicts)
    views: dict[str, PodView] = {}
    infeasible = unknown = double = 0
    gap = 0
    checked = 0
    seen: set[str] = set()
    n_bind = 0
    all_idx = np.arange(len(cl.names))
    for ev in events:
        if ev[0] == "delete":
            if ev[1] in cl.bound:
                cl.delete(ev[1])
            continue
        _, key, node_name = ev
        if key not in pods or node_name not in cl.index:
            unknown += 1
            continue
        if key in seen:
            double += 1
            continue
        seen.add(key)
        p = views.get(key) or views.setdefault(key, PodView(pods[key]))
        node = cl.index[node_name]
        if n_bind in sample:
            ok = cl.feasible(p, all_idx)
            feas = np.flatnonzero(ok)
            if not ok[node]:
                infeasible += 1
            else:
                tot = cl.scores(p, feas)
                gap = max(gap, int(tot.max() - tot[np.searchsorted(feas, node)]))
            checked += 1
        elif not cl.feasible(p, np.array([node]))[0]:
            infeasible += 1
        cl.bind(p, node)
        n_bind += 1

    # read-back: what the program's store and cache say against the replay
    mismatch = 0
    for key, node_name in program_store.items():
        want = cl.bound.get(key)
        if (want is None and node_name) or (want is not None and cl.names[want[1]] != node_name):
            mismatch += 1
    mismatch += sum(1 for key in cl.bound if key not in program_store)
    if program_nodes is not None:
        on_node: dict[int, set] = defaultdict(set)
        for k, (_, n) in cl.bound.items():
            on_node[n].add(k)
        for name, (cpu, mem, keys) in program_nodes.items():
            i = cl.index.get(name)
            if i is None or cpu != cl.cpu[i] or mem != cl.mem[i] or set(keys) != on_node.get(i, set()):
                mismatch += 1
    return {
        "infeasible_binds": infeasible,
        "score_gap": gap,
        "double_or_unknown_binds": double + unknown,
        "readback_mismatches": mismatch,
        "_bindings": n_bind,
        "_score_checked": checked,
    }
