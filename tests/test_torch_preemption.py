"""The port's preemption dry-run against the JAX package's on the CPU.

``_preempt_scan`` on random inputs from a numpy seed: all seven outputs
exactly equal to the JAX function's, dtypes included. The evaluator on
the fixtures of ``tests/test_preemption.py``: the same node and victims.
And the patterns of that file through both Schedulers
(``_torch_sched_pair.Pair``): the same batch results, nominations,
victims, bindings and attempt-metric deltas.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.labels import selector_from_match_labels
from kubernetes_tpu.api.objects import PodDisruptionBudget
from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.solver.preemption import PreemptionEvaluator as RefEvaluator
from kubernetes_tpu.solver.preemption import _preempt_scan_jit
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.tensorize.schema import ResourceVocab, build_node_batch
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api import objects as port_objects
from kubernetes_tpu_torch.solver.preemption import PreemptionEvaluator, _preempt_scan

from _torch_sched_pair import Pair


def _scan_inputs(seed, s=8, k=3, n=24):
    rng = np.random.default_rng(seed)
    alloc = rng.integers(2_000, 8_000, (k, n)).astype(np.int64)
    return (
        alloc,
        rng.integers(2, 6, n).astype(np.int32),
        (alloc * rng.random((k, n)) * 0.8).astype(np.int64),
        rng.integers(0, 3, n).astype(np.int32),
        rng.random(n) > 0.15,
        rng.integers(200, 2_500, k).astype(np.int64),
        rng.integers(0, 2_000, (s, k, n)).astype(np.int64),
        rng.random((s, n)) > 0.3,
        rng.random((s, n)) > 0.7,
        rng.integers(-3, 4, (s, n)).astype(np.int32),  # ties in priority
        rng.choice(np.float32([0.0, 0.5, 1.25, 2.0]), (s, n)),
    )


@pytest.mark.parametrize("seed", range(6))
def test_preempt_scan_equals_reference(seed):
    xs = _scan_inputs(seed, s=8 * (1 + seed % 3))
    want = [np.asarray(x) for x in _preempt_scan_jit(*xs)]
    got = [x.numpy() for x in _preempt_scan(*(torch.from_numpy(np.asarray(x)) for x in xs))]
    names = ("fits_all", "victims", "n_victims", "n_viol", "max_prio", "sum_prio", "latest")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# -- the evaluator on the fixtures of tests/test_preemption.py -------------


def mk_node(name, cpu="4", pods="10"):
    return MakeNode().name(name).capacity({"cpu": cpu, "memory": "16Gi", "pods": pods}).obj()


def mk_pod(name, cpu, prio=0, start=0.0, labels=None):
    b = MakePod().name(name).req({"cpu": cpu}).priority(prio).start_time(start)
    if labels:
        b = b.labels(labels)
    return b.obj()


def _port(obj, cls):
    return convert.api_object(obj, cls)


def _both_evaluate(nodes, placed, incoming, pdbs=(), method="evaluate"):
    all_pods = [incoming] + [p for ps in placed.values() for p in ps]
    vocab = ResourceVocab.build(all_pods, nodes)
    nbatch = build_node_batch(nodes, placed, vocab=vocab)
    names = [n.name for n in nodes] + [""] * (nbatch.padded - len(nodes))
    static_row = np.ones(nbatch.padded, dtype=bool)
    by_slot = {i: placed.get(n.name, []) for i, n in enumerate(nodes)}
    ref = getattr(RefEvaluator(), method)(
        incoming, nbatch, names, by_slot, static_row, list(pdbs)
    )
    p_by_slot = {
        i: [_port(q, port_objects.Pod) for q in ps] for i, ps in by_slot.items()
    }
    p_pdbs = [_port(d, port_objects.PodDisruptionBudget) for d in pdbs]
    port = getattr(PreemptionEvaluator(device="cpu"), method)(
        _port(incoming, port_objects.Pod), convert.node_batch(nbatch), names,
        p_by_slot, static_row, p_pdbs,
    )
    return ref, port


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_evaluator_minimal_victims_equal_reference(seed):
    rng = np.random.default_rng(seed)
    nodes = [mk_node(f"n{i}", cpu="8", pods="20") for i in range(6)]
    placed = {
        n.name: [
            mk_pod(f"p{i}-{j}", f"{int(rng.integers(1, 4))}",
                   prio=int(rng.integers(0, 80)), start=float(rng.random()))
            for j in range(int(rng.integers(1, 6)))
        ]
        for i, n in enumerate(nodes)
    }
    ref, port = _both_evaluate(nodes, placed, mk_pod("in", "6", prio=60))
    assert (ref is None) == (port is None)
    if ref is not None:
        assert port.node_name == ref.node_name
        assert [v.key for v in port.victims] == [v.key for v in ref.victims]
        assert port.num_violating == ref.num_violating
    victims_ref, victims_port = _both_evaluate(
        nodes, placed, mk_pod("in", "6", prio=60), method="victims_by_node"
    )
    assert {k: ([q.key for q in v], n) for k, (v, n) in victims_port.items()} == {
        k: ([q.key for q in v], n) for k, (v, n) in victims_ref.items()
    }


def test_evaluator_respects_pdb_equal_reference():
    nodes = [mk_node("n0"), mk_node("n1")]
    placed = {
        "n0": [mk_pod("db", "4", prio=1, labels={"app": "db"})],
        "n1": [mk_pod("web", "4", prio=1, labels={"app": "web"})],
    }
    pdb = PodDisruptionBudget(
        name="db-pdb", selector=selector_from_match_labels({"app": "db"}),
        disruptions_allowed=0,
    )
    ref, port = _both_evaluate(nodes, placed, mk_pod("in", "3", prio=50), [pdb])
    assert port.node_name == ref.node_name == "n1"
    assert [v.name for v in port.victims] == [v.name for v in ref.victims] == ["web"]


def test_pick_one_node_ordering_equal_reference():
    """pickOneNodeForPreemption's keys in order: fewest PDB violations,
    lowest max victim priority, lowest priority sum, fewest victims,
    latest start among the top victims."""
    nodes = [mk_node(f"n{i}") for i in range(5)]
    pdb = PodDisruptionBudget(
        name="p", selector=selector_from_match_labels({"app": "guarded"}),
        disruptions_allowed=0,
    )
    placed = {
        "n0": [mk_pod("a0", "4", prio=5, labels={"app": "guarded"})],
        "n1": [mk_pod("a1", "4", prio=9)],
        "n2": [mk_pod("a2", "2", prio=5), mk_pod("b2", "2", prio=5)],
        "n3": [mk_pod("a3", "4", prio=5, start=1.0)],
        "n4": [mk_pod("a4", "4", prio=5, start=3.0)],
    }
    ref, port = _both_evaluate(nodes, placed, mk_pod("in", "4", prio=50), [pdb])
    assert port.node_name == ref.node_name == "n4"
    assert [v.key for v in port.victims] == [v.key for v in ref.victims]


# -- the patterns of tests/test_preemption.py through both Schedulers ------


def _zoned(name, cpu="8"):
    return (
        MakeNode().name(name).capacity({"cpu": cpu, "memory": "16Gi", "pods": "10"})
        .label("zone", "z0").obj()
    )


def test_evict_and_reschedule():
    cs = ClusterState()
    for i in range(2):
        cs.create_node(mk_node(f"node-{i}", cpu="4"))
        cs.create_pod(
            MakePod().name(f"low-{i}").node(f"node-{i}").req({"cpu": "4"}).priority(1).obj()
        )
    pair = Pair(cs, batch_size=8)
    pair.create_pod(MakePod().name("vip").req({"cpu": "2"}).priority(100).obj())
    r, p = pair.step()
    assert p.unschedulable == ["default/vip"] and len(p.preemptions) == 1
    _, node, victims = p.preemptions[0]
    assert pair.cluster.get_pod("default", "vip").nominated_node_name == node
    assert all(q.key not in victims for q in pair.cluster.list_pods())
    pair.advance(2.0)
    r, p = pair.step()
    assert ("default/vip", node) in p.scheduled
    pair.assert_equal()


def test_skipped_when_failure_is_not_resources():
    cs = ClusterState()
    cs.create_node(_zoned("node-0"))
    cs.create_pod(MakePod().name("king").node("node-0").req({"cpu": "1"}).priority(1000)
                  .label("app", "king").obj())
    cs.create_pod(MakePod().name("bystander").node("node-0").req({"cpu": "1"}).priority(1).obj())
    pair = Pair(cs, batch_size=4)
    pair.create_pod(MakePod().name("vip").req({"cpu": "1"}).priority(100)
                    .pod_anti_affinity("zone", match_labels={"app": "king"}).obj())
    r, p = pair.step()
    assert p.unschedulable == ["default/vip"] and not p.preemptions
    assert len(pair.cluster.list_pods()) == 3
    pair.assert_equal()


def test_never_policy():
    cs = ClusterState()
    cs.create_node(mk_node("node-0", cpu="4"))
    cs.create_pod(MakePod().name("low").node("node-0").req({"cpu": "4"}).priority(1).obj())
    pair = Pair(cs, batch_size=4)
    pair.create_pod(MakePod().name("polite").req({"cpu": "2"}).priority(100)
                    .preemption_policy("Never").obj())
    r, p = pair.step()
    assert p.unschedulable == ["default/polite"] and not p.preemptions
    assert len(pair.cluster.list_pods()) == 2
    pair.assert_equal()


def test_evicts_anti_affinity_owner():
    cs = ClusterState()
    cs.create_node(_zoned("node-0"))
    cs.create_pod(MakePod().name("king").node("node-0").req({"cpu": "1"}).priority(1)
                  .label("app", "king").obj())
    pair = Pair(cs, batch_size=4)
    pair.create_pod(MakePod().name("vip").req({"cpu": "1"}).priority(100)
                    .pod_anti_affinity("zone", match_labels={"app": "king"}).obj())
    r, p = pair.step()
    assert p.preemptions == [("default/vip", "node-0", ["default/king"])]
    pair.advance(2.0)
    r, p = pair.step()
    assert ("default/vip", "node-0") in p.scheduled
    pair.assert_equal()


def test_evicts_spread_violators():
    cs = ClusterState()
    for z in (0, 1):
        cs.create_node(
            MakeNode().name(f"node-{z}").capacity({"cpu": "8", "memory": "16Gi", "pods": "10"})
            .label("zone", f"z{z}").obj()
        )
    for i in range(2):
        cs.create_pod(MakePod().name(f"web-{i}").node("node-0").req({"cpu": "1"})
                      .priority(1).start_time(float(i)).label("app", "web").obj())
    cs.create_pod(MakePod().name("fort").node("node-1").req({"cpu": "8"}).priority(1000).obj())
    pair = Pair(cs, batch_size=4)
    pair.create_pod(MakePod().name("vip").req({"cpu": "1"}).priority(100).label("app", "web")
                    .spread_constraint(1, "zone", "DoNotSchedule", {"app": "web"}).obj())
    r, p = pair.step()
    assert len(p.preemptions) == 1
    _, node, victims = p.preemptions[0]
    assert node == "node-0" and sorted(victims) == ["default/web-0", "default/web-1"]
    pair.advance(2.0)
    r, p = pair.step()
    assert ("default/vip", "node-0") in p.scheduled
    pair.assert_equal()


def test_evicts_host_port_owner():
    cs = ClusterState()
    cs.create_node(mk_node("node-0", cpu="8"))
    cs.create_pod(MakePod().name("old-lb").node("node-0").req({"cpu": "1"}).priority(1)
                  .host_port(8080).obj())
    pair = Pair(cs, batch_size=4)
    pair.create_pod(MakePod().name("new-lb").req({"cpu": "1"}).priority(100)
                    .host_port(8080).obj())
    r, p = pair.step()
    assert p.preemptions == [("default/new-lb", "node-0", ["default/old-lb"])]
    pair.advance(2.0)
    r, p = pair.step()
    assert ("default/new-lb", "node-0") in p.scheduled
    pair.assert_equal()


def test_full_dry_run_never_evicts_uselessly():
    cs = ClusterState()
    cs.create_node(_zoned("node-0"))
    cs.create_pod(MakePod().name("king").node("node-0").req({"cpu": "1"}).priority(1000)
                  .label("app", "king").obj())
    cs.create_pod(MakePod().name("bystander").node("node-0").req({"cpu": "1"}).priority(1).obj())
    pair = Pair(cs, batch_size=4)
    pair.create_pod(MakePod().name("vip").req({"cpu": "1"}).priority(100)
                    .pod_anti_affinity("zone", match_labels={"app": "king"}).obj())
    r, p = pair.step()
    assert not p.preemptions and len(pair.cluster.list_pods()) == 3
    pair.assert_equal()


def test_many_preemptors_pick_one_node_each():
    """Several preemptors in one batch, each evicting the lowest-priority
    victim set on a different node, with PDB-guarded and later-started
    victims in play: the same nominations and victims as the JAX package,
    then every preemptor bound once the victims are gone."""
    cs = ClusterState()
    pdb = PodDisruptionBudget(
        name="g", selector=selector_from_match_labels({"app": "guarded"}),
        disruptions_allowed=1,
    )
    cs.create_pdb(pdb)
    for i in range(6):
        cs.create_node(mk_node(f"node-{i}", cpu="4"))
        for j in range(2):
            b = (MakePod().name(f"low-{i}-{j}").node(f"node-{i}").req({"cpu": "2"})
                 .priority(1 + (i + j) % 3).start_time(float(i * 2 + j)))
            if i % 2 == 0:
                b = b.label("app", "guarded")
            cs.create_pod(b.obj())
    pair = Pair(cs, batch_size=8)
    for k in range(4):
        pair.create_pod(MakePod().name(f"vip-{k}").req({"cpu": "2"}).priority(100).obj())
    r, p = pair.step()
    assert len(p.preemptions) == 4
    assert len({n for _, n, _ in p.preemptions}) == 4
    pair.advance(2.0)
    pair.settle()
    pair.assert_equal()
    bound = pair.bindings()[1]
    assert all(bound[f"default/vip-{k}"] for k in range(4))
