"""The port's sequential oracle scheduler against the JAX package's.

``kubernetes_tpu_torch/ops/oracle/scheduler.py`` is a copy of
``kubernetes_tpu/ops/oracle/scheduler.py``: the reference's scheduleOne
loop with NodeResourcesFit (LeastAllocated) + BalancedAllocation, in plain
Python. Each case draws its cluster from a seeded numpy generator and
builds it twice, once with each package's ``MakeNode`` / ``MakePod``, so
the two oracles see equal inputs built independently. Node states,
scores, feasible and tie sets, the sequential schedule and the verdicts
of ``validate_assignments`` must be equal, exactly (the oracle is integer
and float64 host arithmetic in both).
"""

import numpy as np
import pytest

from kubernetes_tpu.api import wrappers as ref_wrappers
from kubernetes_tpu.ops.oracle import scheduler as ref_osched
from kubernetes_tpu_torch.api import wrappers as port_wrappers
from kubernetes_tpu_torch.ops.oracle import scheduler as osched

SEEDS = (0, 1, 2, 3, 4, 5)


def draw(seed, n_nodes=12, n_pods=40, placed=6):
    """Plain numbers for one cluster: node capacities (some nodes
    unschedulable), pods with the request mix of
    tests/test_scheduler_e2e.py plus a few that fit nowhere, and some
    pods already placed."""
    rng = np.random.default_rng(seed)
    nodes = [
        {
            "name": f"node-{i:03}",
            "cpu": int(rng.choice([1, 2, 4, 8])),
            "mem_gi": int(rng.choice([2, 4, 8])),
            "pods": int(rng.choice([3, 5, 110])),
            "unschedulable": bool(rng.random() < 0.15),
        }
        for i in range(n_nodes)
    ]
    pods = []
    for i in range(n_pods):
        if rng.random() < 0.1:  # infeasible on every node
            cpu, mem = 64_000, 256
        else:
            cpu = 100 + 70 * int(rng.integers(0, 7))
            mem = 256 + 128 * int(rng.integers(0, 3))
        pods.append({"name": f"p{i:03}", "cpu_m": cpu, "mem_mi": mem})
    on = {}
    for j in range(placed):
        node = nodes[int(rng.integers(0, n_nodes))]["name"]
        on.setdefault(node, []).append(
            {"name": f"bound{j:02}", "cpu_m": 250, "mem_mi": 512}
        )
    return nodes, pods, on


def build(w, spec):
    """(nodes, pods, pods_by_node) as API objects of the package whose
    wrappers module is ``w``."""
    nodes_spec, pods_spec, on = spec

    def node(d):
        b = w.MakeNode().name(d["name"]).capacity(
            {"cpu": str(d["cpu"]), "memory": f"{d['mem_gi']}Gi", "pods": str(d["pods"])}
        )
        if d["unschedulable"]:
            b = b.unschedulable()
        return b.obj()

    def pod(d):
        return w.MakePod().name(d["name"]).req(
            {"cpu": f"{d['cpu_m']}m", "memory": f"{d['mem_mi']}Mi"}
        ).obj()

    return (
        [node(d) for d in nodes_spec],
        [pod(d) for d in pods_spec],
        {n: [pod(d) for d in ps] for n, ps in on.items()},
    )


def both(seed, **kw):
    spec = draw(seed, **kw)
    return build(ref_wrappers, spec), build(port_wrappers, spec)


def state_fields(states):
    return [
        (s.name, s.allocatable, s.used, s.nonzero_used_cpu, s.nonzero_used_mem,
         s.pod_count, s.max_pods, s.schedulable)
        for s in states
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_make_node_states_and_scores_equal(seed):
    (rn, rp, ron), (pn, pp, pon) = both(seed)
    ref_states = ref_osched.make_node_states(rn, ron)
    port_states = osched.make_node_states(pn, pon)
    assert state_fields(port_states) == state_fields(ref_states)
    for rpod, ppod in zip(rp, pp):
        assert [osched.score_one(ppod, s) for s in port_states] == [
            ref_osched.score_one(rpod, s) for s in ref_states
        ]


@pytest.mark.parametrize("seed", SEEDS)
def test_feasible_and_ties_equal(seed):
    (rn, rp, ron), (pn, pp, pon) = both(seed)
    ref_states = ref_osched.make_node_states(rn, ron)
    port_states = osched.make_node_states(pn, pon)
    infeasible = 0
    for rpod, ppod in zip(rp, pp):
        want = ref_osched.feasible_and_ties(rpod, ref_states)
        assert osched.feasible_and_ties(ppod, port_states) == want
        infeasible += not want[0]
    assert infeasible, "the fixture must hold a pod that fits nowhere"


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_equal(seed):
    (rn, rp, ron), (pn, pp, pon) = both(seed)
    want = ref_osched.schedule(rp, ref_osched.make_node_states(rn, ron))
    port_states = osched.make_node_states(pn, pon)
    got = osched.schedule(pp, port_states)
    assert got.assignments == want.assignments
    assert got.tie_sets == want.tie_sets
    assert -1 in got.assignments and max(got.assignments) >= 0
    # the port's states carry the schedule, as the JAX package's do
    ref_after = ref_osched.make_node_states(rn, ron)
    ref_osched.schedule(rp, ref_after)
    assert state_fields(port_states) == state_fields(ref_after)


def test_schedule_refuses_random_mode_like_the_reference():
    (rn, rp, _), (pn, pp, _) = both(0, n_nodes=2, n_pods=2, placed=0)
    with pytest.raises(AssertionError):
        ref_osched.schedule(rp, ref_osched.make_node_states(rn), tie_break="random")
    with pytest.raises(AssertionError):
        osched.schedule(pp, osched.make_node_states(pn), tie_break="random")


def _perturbed(result, n_nodes, rng):
    """Picks that stray from the tie sets: a node outside the tie set for
    some placed pods, -1 for some, and a pick for an unschedulable one."""
    picks = list(result.assignments)
    for i, ties in enumerate(result.tie_sets):
        r = rng.random()
        if ties and r < 0.2:
            outside = [j for j in range(n_nodes) if j not in ties]
            if outside:
                picks[i] = int(rng.choice(outside))
        elif ties and r < 0.3:
            picks[i] = -1
        elif not ties and r < 0.5:
            picks[i] = int(rng.integers(0, n_nodes))
    return picks


@pytest.mark.parametrize("seed", SEEDS)
def test_validate_assignments_agrees(seed):
    (rn, rp, ron), (pn, pp, pon) = both(seed)
    oracle = ref_osched.schedule(rp, ref_osched.make_node_states(rn, ron))
    # accepted: the oracle's own schedule, and any pick inside each tie set
    rng = np.random.default_rng(seed)
    inside = [int(rng.choice(t)) if t else -1 for t in oracle.tie_sets]
    picks = oracle.assignments
    assert ref_osched.validate_assignments(
        rp, ref_osched.make_node_states(rn, ron), picks) == []
    assert osched.validate_assignments(
        pp, osched.make_node_states(pn, pon), picks) == []
    # a pick inside the tie set may change later steps' sets: both sides
    # follow the picks and must give the same verdicts
    want = ref_osched.validate_assignments(rp, ref_osched.make_node_states(rn, ron), inside)
    assert osched.validate_assignments(pp, osched.make_node_states(pn, pon), inside) == want
    # rejected: picks off the tie set, missed placements, impossible ones
    bad = _perturbed(oracle, len(rn), rng)
    want = ref_osched.validate_assignments(rp, ref_osched.make_node_states(rn, ron), bad)
    got = osched.validate_assignments(pp, osched.make_node_states(pn, pon), bad)
    assert got == want
    assert got, "the perturbed picks must be rejected"
