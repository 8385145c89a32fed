"""Churn generators: seeded event streams from scenario profiles.

``ChurnGenerator.generate(cycle)`` derives the cycle's events from the
profile's rates and ONE ``random.Random`` dedicated to generation (the
fault injectors draw from a separate stream, so mid-run fault decisions
never shift what churn a cycle produces). Events are plain dicts —
exactly what lands in the trace — and ``apply`` executes them against
the live ``ClusterState``. Replay skips ``generate`` entirely and feeds
recorded event dicts straight to ``apply``.

All choices over live cluster state go through sorted snapshots, never
raw set/dict iteration, so a run is independent of PYTHONHASHSEED.

Copied from ``kubernetes_tpu/sim/generators.py``.
"""

from __future__ import annotations

import random

from .. import metrics
from ..api.objects import Node, Pod
from ..state.cluster import ApiError, ClusterState
from .profiles import Profile


def make_node(
    name: str, cpu: str, mem: str, labels: dict[str, str] | None = None
) -> Node:
    from ..api.wrappers import MakeNode

    b = (
        MakeNode()
        .name(name)
        .capacity({"cpu": cpu, "memory": mem, "pods": "110"})
        .label("kubernetes.io/hostname", name)
    )
    for k, v in (labels or {}).items():
        b = b.label(k, v)
    return b.obj()


ZONE_KEY = "topology.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"
SIM_PORTS = (8080, 8081)  # small pool: conflicts actually happen
# poison marker (kubernetes_tpu_torch/resilience poison-batch quarantine):
# the SolverFaultInjector breaks any solve whose batch contains a pod
# carrying this label, at every ladder tier
POISON_LABEL = "sim.kubernetes.io/poison"
# PDB-guarded cohort (kubernetes_tpu/rebalance): the harness seeds a
# PodDisruptionBudget with disruptionsAllowed=0 over this label, so
# the rebalancer must never evict a pod carrying it
PDB_GUARD_LABEL = "sim.kubernetes.io/pdb-guard"


def make_pod(
    name: str, cpu: str, priority: int = 0, shape: str = "plain",
    port: int = 0, poison: bool = False, pdb_guard: bool = False,
    gang: str = "", gang_min: int = 0, workload_class: str = "",
) -> Pod:
    """``shape``: plain | spread (hard maxSkew=1 zone spread over the
    app=spread cohort) | anti (required hostname anti-affinity over
    app=anti) | ports (hostPort ``port``). ``poison`` marks the pod
    with POISON_LABEL (its presence breaks the solve — the bisection
    quarantine's food). ``pdb_guard`` joins the PDB-guarded cohort the
    rebalancer must never evict. ``gang`` joins the named pod group
    (kubernetes_tpu_torch/gang): the pod carries the pod-group label plus the
    ``gang_min`` min-member annotation, and ``workload_class`` labels
    it for the heterogeneity throughput term."""
    from ..api.wrappers import MakePod

    b = MakePod().name(name).req({"cpu": cpu, "memory": "1Gi"})
    if gang:
        from ..gang import GANG_LABEL, MIN_MEMBER_ANNOTATION

        b = b.label(GANG_LABEL, gang).annotation(
            MIN_MEMBER_ANNOTATION, str(gang_min or 1)
        )
    if workload_class:
        from ..gang import WORKLOAD_CLASS_LABEL

        b = b.label(WORKLOAD_CLASS_LABEL, workload_class)
    if priority:
        b = b.priority(priority)
    if shape == "spread":
        b = b.label("app", "spread").spread_constraint(
            1, ZONE_KEY, "DoNotSchedule", {"app": "spread"}
        )
    elif shape == "anti":
        b = b.label("app", "anti").pod_anti_affinity(
            HOST_KEY, {"app": "anti"}
        )
    elif shape == "ports":
        b = b.host_port(port or SIM_PORTS[0])
    if poison:
        b = b.label(POISON_LABEL, "1")
    if pdb_guard:
        b = b.label(PDB_GUARD_LABEL, "1")
    return b.obj()


def _count(rng: random.Random, rate: float) -> int:
    """Expected-count rate -> integer count: the whole part always
    happens, the fractional part happens with its probability."""
    whole = int(rate)
    return whole + (1 if rng.random() < (rate - whole) else 0)


class ChurnGenerator:
    def __init__(
        self, profile: Profile, rng: random.Random, cluster: ClusterState
    ) -> None:
        self.profile = profile
        self.rng = rng
        self.cluster = cluster
        self._pod_seq = 0
        self._node_seq = 0
        self._flap_seq = 0
        self._gang_seq = 0

    # -- seeding (before the scheduler exists; not part of the trace —
    # replay re-derives it from the header's profile) --

    def seed_nodes(self) -> list[Node]:
        out = []
        for _ in range(self.profile.nodes):
            out.append(self._make_labeled_node())
        return out

    def _make_labeled_node(self) -> Node:
        """Node with a deterministic zone label (z{seq % zones}) so the
        spread-shaped arrivals have topology domains to spread over —
        and, on gang profiles, a seq-derived accelerator-class label
        (RNG-free like the zone, so node identity never shifts the gen
        stream) feeding the heterogeneity throughput term."""
        zone = f"z{self._node_seq % max(self.profile.zones, 1)}"
        labels = {"topology.kubernetes.io/zone": zone}
        if self.profile.gang_accel_classes:
            from ..gang import ACCEL_CLASS_LABEL

            classes = self.profile.gang_accel_classes
            labels[ACCEL_CLASS_LABEL] = classes[
                self._node_seq % len(classes)
            ]
        return make_node(
            self._next_node_name(),
            self.profile.node_cpu,
            self.profile.node_mem,
            labels=labels,
        )

    def _next_node_name(self) -> str:
        name = f"n{self._node_seq:03}"
        self._node_seq += 1
        return name

    def _next_pod_name(self) -> str:
        name = f"p{self._pod_seq:05}"
        self._pod_seq += 1
        return name

    # -- per-cycle event stream --

    def generate(self, cycle: int) -> list[dict]:
        """The cycle's churn, in a fixed category order. Each event dict
        is self-contained (wire-shape payloads) so the trace replays
        without this generator."""
        p, rng = self.profile, self.rng
        events: list[dict] = []

        # backlog seeding (backlog_drain profiles): the mega-backlog
        # lands as ordinary cycle-0 create_pod events — same hard-shape
        # draw, same trace/replay machinery — BEFORE the cycle's
        # arrivals, so cycle 0's drive sees the full backlog queued.
        # Workload shift (tuning_convergence profiles): from shift_at
        # on, arrivals draw from the shifted band — the regime change
        # the auto-tuner must detect and re-converge for.
        arrivals = p.arrivals
        if p.shift_at >= 0 and cycle >= p.shift_at and p.shift_arrivals:
            arrivals = p.shift_arrivals
        n_arrivals = rng.randint(*arrivals)
        if cycle == 0 and p.backlog:
            n_arrivals += p.backlog

        # pod arrivals (shape drawn per arrival in a fixed order so the
        # stream is a pure function of the gen RNG)
        for _ in range(n_arrivals):
            shape, port = "plain", 0
            if p.pod_spread_rate and rng.random() < p.pod_spread_rate:
                shape = "spread"
            elif p.pod_anti_rate and rng.random() < p.pod_anti_rate:
                shape = "anti"
            elif p.pod_ports_rate and rng.random() < p.pod_ports_rate:
                shape = "ports"
                port = rng.choice(SIM_PORTS)
            # poison/pdb-guard draws guarded on the rate so profiles
            # without them consume no RNG here (existing traces stay
            # byte-identical)
            poison = bool(
                p.poison_rate and rng.random() < p.poison_rate
            )
            pdb_guard = bool(
                p.pdb_guard_rate and rng.random() < p.pdb_guard_rate
            )
            pod = make_pod(
                self._next_pod_name(),
                rng.choice(p.pod_cpu_choices),
                rng.choice(p.pod_priorities),
                shape=shape,
                port=port,
                poison=poison,
                pdb_guard=pdb_guard,
            )
            events.append({"op": "create_pod", "pod": pod.to_dict()})

        # gang arrivals (kubernetes_tpu_torch/gang): each gang's members all
        # land this cycle as ordinary create_pod events (self-contained
        # wire dicts — replay needs no gang logic here). Draws are
        # guarded on the gang knobs so non-gang profiles consume no RNG
        # (existing traces stay byte-identical).
        if p.gang_rate:
            for _ in range(_count(rng, p.gang_rate)):
                events.extend(self._gang_events(rng.choice(p.gang_sizes)))
        if p.gang_short_at >= 0 and cycle == p.gang_short_at:
            # the never-satisfiable gang: min-member is one more than
            # the members that will ever exist, so the quorum cannot
            # assemble and the whole gang must ride gang_incomplete
            # rounds into quarantine
            events.extend(
                self._gang_events(max(p.gang_sizes), short=True)
            )

        # pod deletes (any pod — pending or bound; bound deletes free
        # capacity, pending deletes exercise mid-flight removal)
        candidates = sorted(q.key for q in self.cluster.list_pods())
        for _ in range(_count(rng, p.delete_pod_rate)):
            if not candidates:
                break
            key = candidates.pop(rng.randrange(len(candidates)))
            ns, name = key.split("/", 1)
            events.append({"op": "delete_pod", "ns": ns, "name": name})

        # node adds
        for _ in range(_count(rng, p.node_add_rate)):
            node = self._make_labeled_node()
            events.append({"op": "create_node", "node": node.to_dict()})

        # node deletes (keep at least one node alive)
        names = sorted(n.name for n in self.cluster.list_nodes())
        for _ in range(_count(rng, p.node_delete_rate)):
            if len(names) <= 1:
                break
            name = names.pop(rng.randrange(len(names)))
            events.append({"op": "delete_node", "name": name})

        # label flaps (conflict-fence food: _node_change_could_help)
        for _ in range(_count(rng, p.label_flap_rate)):
            if not names:
                break
            name = rng.choice(names)
            self._flap_seq += 1
            events.append(
                {
                    "op": "flap_label",
                    "name": name,
                    "key": "sim.kubernetes.io/flap",
                    "value": f"f{self._flap_seq}",
                }
            )

        # allocatable grow/shrink (cpu only). A shrink never goes below
        # the node's CURRENT bound usage: shrinking under load is
        # legitimate cluster behavior (kubelet eviction territory, not a
        # scheduler bug), so allowing it would make the capacity
        # invariant unsound — the same reasoning that forbids combining
        # shrinks with delayed watch delivery (profiles.py). The floor
        # keeps "used > allocatable" attributable to a bad BIND only.
        used_cpu: dict[str, int] = {}
        for q in self.cluster.list_pods():
            if q.node_name:
                used_cpu[q.node_name] = used_cpu.get(
                    q.node_name, 0
                ) + q.resource_request().get("cpu", 0)
        staged_alloc: dict[str, int] = {}  # staged cpu deltas this cycle
        alloc_of = {
            n.name: n.allocatable.get("cpu", 0)
            for n in self.cluster.list_nodes()
        }
        for op, rate in (
            ("grow", p.alloc_grow_rate),
            ("shrink", p.alloc_shrink_rate),
        ):
            for _ in range(_count(rng, rate)):
                if not names:
                    break
                name = rng.choice(names)
                cur = alloc_of.get(name, 0) + staged_alloc.get(name, 0)
                if op == "shrink":
                    floor = max(used_cpu.get(name, 0), 1000)
                    if cur - 1000 < floor:
                        continue  # would undercut committed usage
                    staged_alloc[name] = staged_alloc.get(name, 0) - 1000
                else:
                    staged_alloc[name] = staged_alloc.get(name, 0) + 1000
                events.append({"op": f"alloc_{op}", "name": name})

        # external competing binds: another actor places a pending pod
        # (ground-truth fit-checked at generation time against THIS
        # cycle's staged allocatable deltas — shrinks apply before binds;
        # the scheduler may be racing for the same slot — that's the
        # point)
        for _ in range(_count(rng, p.external_bind_rate)):
            ev = self._external_bind_event(events, staged_alloc)
            if ev is None:
                break
            events.append(ev)
        return events

    def _gang_events(self, size: int, short: bool = False) -> list[dict]:
        """Create-pod events for one pod group: ``size`` members, one
        shared cpu request and workload class (DL replicas are
        homogeneous), min-member = size — or size + 1 when ``short``,
        making the gang permanently unsatisfiable."""
        p, rng = self.profile, self.rng
        self._gang_seq += 1
        gid = f"g{self._gang_seq:03}"
        wc = (
            rng.choice(p.gang_workload_classes)
            if p.gang_workload_classes
            else ""
        )
        cpu = rng.choice(p.pod_cpu_choices)
        min_member = size + 1 if short else size
        out = []
        for _ in range(size):
            pod = make_pod(
                self._next_pod_name(),
                cpu,
                gang=gid,
                gang_min=min_member,
                workload_class=wc,
            )
            out.append({"op": "create_pod", "pod": pod.to_dict()})
        return out

    def _external_bind_event(
        self, staged: list[dict], staged_alloc: dict[str, int]
    ) -> dict | None:
        staged_deletes = {
            f"{e['ns']}/{e['name']}"
            for e in staged
            if e["op"] in ("delete_pod", "external_bind")
        }
        staged_node_deletes = {
            e["name"] for e in staged if e["op"] == "delete_node"
        }
        pods = sorted(
            (q for q in self.cluster.list_pods()), key=lambda q: q.key
        )
        pending = [
            q
            for q in pods
            if not q.node_name and q.key not in staged_deletes
        ]
        if not pending:
            return None
        pod = self.rng.choice(pending)
        used: dict[str, dict[str, int]] = {}
        for q in pods:
            if q.node_name:
                u = used.setdefault(q.node_name, {})
                for r, v in q.resource_request().items():
                    u[r] = u.get(r, 0) + v
        # earlier external binds staged this cycle consume capacity too
        for e in staged:
            if e["op"] != "external_bind":
                continue
            q = next(
                (
                    x
                    for x in pods
                    if x.namespace == e["ns"] and x.name == e["name"]
                ),
                None,
            )
            if q is not None:
                u = used.setdefault(e["node"], {})
                for r, v in q.resource_request().items():
                    u[r] = u.get(r, 0) + v
        fits = []
        for node in sorted(self.cluster.list_nodes(), key=lambda n: n.name):
            if node.name in staged_node_deletes or node.unschedulable:
                continue
            u = used.get(node.name, {})
            if all(
                u.get(r, 0) + v
                <= node.allocatable.get(r, 0)
                + (staged_alloc.get(node.name, 0) if r == "cpu" else 0)
                for r, v in pod.resource_request().items()
                if v > 0 and r != "pods"
            ):
                fits.append(node.name)
        if not fits:
            return None
        return {
            "op": "external_bind",
            "ns": pod.namespace,
            "name": pod.name,
            "node": self.rng.choice(fits),
        }


def apply_event(cluster: ClusterState, ev: dict) -> None:
    """Execute one churn event against the state service. Tolerates
    NotFound/AlreadyExists/Conflict — under replay the cluster can have
    drifted only if the scheduler diverged, and the decision journal
    catches that with a better message than a KeyError here."""
    op = ev["op"]
    metrics.sim_events_total.labels(op).inc()
    try:
        if op == "create_pod":
            cluster.create_pod(Pod.from_dict(ev["pod"]))
        elif op == "delete_pod":
            cluster.delete_pod(ev["ns"], ev["name"])
        elif op == "create_node":
            cluster.create_node(Node.from_dict(ev["node"]))
        elif op == "delete_node":
            cluster.delete_node(ev["name"])
        elif op == "flap_label":
            node = cluster.get_node(ev["name"])
            import dataclasses

            labels = dict(node.labels)
            labels[ev["key"]] = ev["value"]
            cluster.update_node(dataclasses.replace(node, labels=labels))
        elif op in ("alloc_grow", "alloc_shrink"):
            node = cluster.get_node(ev["name"])
            import dataclasses

            alloc = dict(node.allocatable)
            cpu = alloc.get("cpu", 0)
            # canonical cpu ints are millicores
            delta = 1000 if op == "alloc_grow" else -1000
            alloc["cpu"] = max(cpu + delta, 1000)
            cluster.update_node(
                dataclasses.replace(node, allocatable=alloc)
            )
        elif op == "external_bind":
            cluster.bind(ev["ns"], ev["name"], ev["node"])
        else:
            raise ValueError(f"unknown sim event op {op!r}")
    except ApiError:
        # target vanished between generation and apply (or replay drift
        # that the decision journal will diagnose) — churn, not a bug
        pass
