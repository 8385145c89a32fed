"""Nominated pods in the port's per-pod scan (RunFilterPluginsWithNominatedPods
and evaluateNominatedNode) against the JAX package's, on the CPU.

The nominated load is built the way the JAX package's scheduler builds it
(tests/test_nominated_parity.py covers the tensorizers' side): unbound pods
with a nomination, of several priorities, reserve capacity (and hostPorts)
on their nominated nodes for batch pods of lower or equal priority; batch
pods that carry a nomination take their node first when it is feasible;
spread and interpod count the foreign nominations at their slots. In
tie_break="first" with balanced_fdtype="float64" the port equals the JAX
package bit for bit: assignments, written-back node state, dispatch counts
(a nominated batch always runs the per-pod scan)."""

import numpy as np
import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
from kubernetes_tpu.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu.tensorize.schema import (
    ResourceVocab,
    build_node_batch,
    build_nominated_tensors,
    build_pod_batch,
)
from kubernetes_tpu.tensorize.spread import build_spread_tensors
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.solver.exact import ExactSolver

STATE = ("used", "nonzero_used", "pod_count")
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _nodes(n, cpu="4", pods="8"):
    return [
        MakeNode().name(f"n-{i:02}").capacity({"cpu": cpu, "memory": "16Gi", "pods": pods})
        .label(ZONE, f"z{i % 3}").label(HOST, f"n-{i:02}").obj()
        for i in range(n)
    ]


def tensorize(nodes, pods, nom_pairs):
    """The JAX package's scheduler tensorize of one batch with nominated
    pods (scheduler.py _tensorize_group): ports intern the nominated
    hostPorts, spread and interpod count foreign nominations, and batch
    pods get their own nominated slot."""
    vocab = ResourceVocab.build(pods + [p for p, _ in nom_pairs], nodes)
    nb = build_node_batch(nodes, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    ports = build_port_tensors(pods, pb, slots, {}, nb.padded, nominated=nom_pairs)
    keys = {p.key for p in pods}
    peers = [(q, s) for q, s in nom_pairs if q.key not in keys]
    spread = build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad,
                                  nominated=peers)
    ipa = build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad,
                                 nominated=peers)
    nom = build_nominated_tensors(nom_pairs, vocab, nb.padded, ports=ports)
    slot_by_key = {p.key: s for p, s in nom_pairs}
    nominated_slot = np.asarray([slot_by_key.get(p.key, -1) for p in pods], np.int32)
    return (nb, pb, st, ports, spread, ipa), nom, nominated_slot


def _pod(name, cpu, prio, port=0, nominate=None, kind=None):
    b = MakePod().name(name).req({"cpu": f"{cpu}m", "memory": "256Mi"}).priority(prio)
    if port:
        b = b.host_port(port)
    if nominate is not None:
        b = b.nominated_node_name(nominate)
    if kind == "spread":
        b = b.label("app", "web").spread_constraint(1, ZONE, "DoNotSchedule", {"app": "web"})
    elif kind == "anti":
        b = b.label("app", "anti").pod_anti_affinity(HOST, {"app": "anti"})
    return b.obj()


def scenario(name, with_ports):
    """(nodes, batch pods, nominated (pod, slot) pairs)."""
    rng = np.random.default_rng({"reserve": 1, "self": 2, "families": 3}[name])
    nodes = _nodes(9)
    port = (lambda i: 8080 + i % 2) if with_ports else (lambda i: 0)
    foreign = [
        _pod(f"nom-{i}", int(rng.integers(4, 16)) * 250, int(rng.choice([5, 10, 20])),
             port=port(i), nominate=nodes[i % 4].name)
        for i in range(6)
    ]
    nom_pairs = [(p, i % 4) for i, p in enumerate(foreign)]
    pods = []
    for i in range(40):
        prio = int(rng.choice([0, 5, 10, 30]))
        kind = None
        if name == "families":
            kind = ("spread", "anti", None)[i % 3]
        cpu = int(rng.integers(2, 12)) * 250
        nominate = None
        if name == "self" and i % 5 == 0:
            # a preemptor's own nomination: the highest priority, small
            nominate = nodes[(i // 5) % 9].name
            prio, cpu = 30, 250
        p = _pod(f"p-{i:02}", cpu, prio, port=port(i) if i % 3 == 0 and nominate is None else 0,
                 nominate=nominate, kind=kind)
        pods.append(p)
        if nominate is not None:
            nom_pairs.append((p, (i // 5) % 9))
    return nodes, pods, nom_pairs


@pytest.mark.parametrize("with_ports", [False, True], ids=["no_ports", "ports"])
@pytest.mark.parametrize("name", ["reserve", "self", "families"])
def test_nominated_equals_reference(name, with_ports):
    nodes, pods, nom_pairs = scenario(name, with_ports)
    cfg = RefConfig(tie_break="first", balanced_fdtype="float64")

    inputs, nom, slot = tensorize(nodes, pods, nom_pairs)
    assert not nom.empty and (nom.port_takes is not None) == with_ports
    ref = RefSolver(cfg)
    want = ref.solve(*inputs, nominated=nom, nominated_slot=slot)

    ref_inputs, nom2, slot2 = tensorize(nodes, pods, nom_pairs)
    inputs2 = convert.solve_inputs(*ref_inputs)
    port = ExactSolver(convert.solver_config(cfg))
    got = port.solve(*inputs2, nominated=convert.nominated_tensors(nom2),
                     nominated_slot=slot2, device="cpu")
    np.testing.assert_array_equal(got, want)
    for k in STATE:
        np.testing.assert_array_equal(getattr(inputs2[0], k), getattr(inputs[0], k), err_msg=k)
    assert dict(port.dispatch_counts) == dict(ref.dispatch_counts) == {"scan": 1}
    assert (got >= 0).sum() > 10


def test_nomination_changes_the_outcome():
    """The nominated load is not a no-op on these fixtures: without it the
    port places differently, and every batch pod carrying a nomination (the
    highest priority, so no other nomination's load counts against it)
    lands on its nominated node."""
    nodes, pods, nom_pairs = scenario("self", True)
    cfg = convert.solver_config(RefConfig(tie_break="first", balanced_fdtype="float64"))
    inputs, nom, slot = tensorize(nodes, pods, nom_pairs)
    inputs = convert.solve_inputs(*inputs)
    with_nom = ExactSolver(cfg).solve(*inputs, nominated=convert.nominated_tensors(nom),
                                      nominated_slot=slot, device="cpu")
    without = ExactSolver(cfg).solve(*convert.solve_inputs(*tensorize(nodes, pods, [])[0]),
                                     device="cpu")
    assert not np.array_equal(with_nom, without)
    own = [(i, s) for i, s in enumerate(slot) if s >= 0]
    assert len(own) == 8 and all(with_nom[i] == s for i, s in own)


def test_convert_nominated_copies():
    nodes, pods, nom_pairs = scenario("reserve", True)
    _, nom, _ = tensorize(nodes, pods, nom_pairs)
    got = convert.nominated_tensors(nom)
    for f in ("levels", "used", "count", "port_takes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(nom, f))
        assert not np.shares_memory(getattr(got, f), getattr(nom, f))
    prio = np.asarray([0, 5, 10, 20, 30], np.int32)
    np.testing.assert_array_equal(got.level_of(prio), nom.level_of(prio))
