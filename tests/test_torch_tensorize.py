"""The port's copied tensorizers give byte-identical arrays to the JAX
package's on the same clusters. Each cluster is built twice from one
seeded spec, once with each package's own MakePod/MakeNode.

``mixed_cluster`` and ``tensorize`` are shared with test_torch_solver.py."""

import dataclasses
import importlib

import numpy as np
import pytest

import kubernetes_tpu.api.wrappers as ref_wrappers
import kubernetes_tpu_torch.api.wrappers as port_wrappers

GB = 1024**3
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def mixed_cluster(wrappers, n_nodes, n_pods, seed=7, placed_every=0):
    """The generator pattern of tests/test_parity_large.py: plain pods of
    varied sizes, hard and soft zone spread, hostname anti-affinity,
    preferred zone affinity, host ports with a node selector, tainted and
    labelled nodes. ``placed_every``: every k-th node already runs one
    pod of the spread and anti groups (0: an empty cluster).

    Returns (nodes, pods, placed_by_node)."""
    MakeNode, MakePod = wrappers.MakeNode, wrappers.MakePod
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        b = (
            MakeNode()
            .name(f"n-{i:04}")
            .capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
            .label(ZONE, f"z{i % 3}")
            .label(HOST, f"n-{i:04}")
        )
        if i % 40 == 0:
            b = b.taint("dedicated", "batch", "NoSchedule")
        if i % 7 == 0:
            b = b.label("disk", "ssd")
        nodes.append(b.obj())

    pods = []
    for i in range(n_pods):
        kind = rng.integers(0, 10)
        cpu = int(rng.integers(1, 9)) * 250
        mem = int(rng.integers(1, 5)) * GB
        b = MakePod().name(f"p-{i:05}").req({"cpu": f"{cpu}m", "memory": mem})
        if kind < 3:
            pass
        elif kind < 5:
            b = b.label("app", "web").spread_constraint(1, ZONE, "DoNotSchedule", {"app": "web"})
        elif kind < 6:
            b = b.label("app", "soft").spread_constraint(
                2, ZONE, "ScheduleAnyway", {"app": "soft"}
            )
        elif kind < 8:
            b = b.label("app", f"anti-{i % 4}").pod_anti_affinity(HOST, {"app": f"anti-{i % 4}"})
        elif kind < 9:
            b = b.label("app", "pref").preferred_pod_affinity(10, ZONE, {"app": "pref"})
        else:
            b = b.node_selector({"disk": "ssd"}).host_port(9000 + int(i % 16))
        pods.append(b.obj())

    placed = {}
    if placed_every:
        for i in range(0, n_nodes, placed_every):
            placed[nodes[i].name] = [
                MakePod().name(f"old-{i:04}").label("app", "web").node(nodes[i].name)
                .req({"cpu": "500m", "memory": GB}).obj(),
                MakePod().name(f"olda-{i:04}").label("app", f"anti-{i % 4}")
                .pod_anti_affinity(HOST, {"app": f"anti-{i % 4}"}).node(nodes[i].name)
                .req({"cpu": "250m"}).host_port(9000 + i % 16).obj(),
            ]
    return nodes, pods, placed


def tensorize(pkg, nodes, pods, placed_by_node):
    """The full tensorizer pipeline of ``pkg`` ("kubernetes_tpu" or
    "kubernetes_tpu_torch"), as tests/test_pallas_kernels.py runs it.
    Returns (node batch, pod batch, static, ports, spread, interpod)."""
    schema = importlib.import_module(f"{pkg}.tensorize.schema")
    plugins = importlib.import_module(f"{pkg}.tensorize.plugins")
    spread = importlib.import_module(f"{pkg}.tensorize.spread")
    interpod = importlib.import_module(f"{pkg}.tensorize.interpod")

    all_pods = pods + [p for ps in placed_by_node.values() for p in ps]
    vocab = schema.ResourceVocab.build(all_pods, nodes)
    nb = schema.build_node_batch(nodes, placed_by_node, vocab=vocab)
    pb = schema.build_pod_batch(pods, vocab)
    slot_nodes = list(nodes) + [None] * (nb.padded - len(nodes))
    placed_by_slot = {
        i: placed_by_node[n.name] for i, n in enumerate(nodes) if n.name in placed_by_node
    }
    static = plugins.build_static_tensors(pods, pb, slot_nodes, nb.padded)
    ports = plugins.build_port_tensors(pods, pb, slot_nodes, placed_by_slot, nb.padded)
    spr = spread.build_spread_tensors(
        pods, static.reps, pb, slot_nodes, placed_by_slot, nb.padded, static.c_pad
    )
    ipa = interpod.build_interpod_tensors(
        pods, static.reps, pb, slot_nodes, placed_by_slot, nb.padded, static.c_pad
    )
    return nb, pb, static, ports, spr, ipa


def _assert_same(port, ref, path):
    if dataclasses.is_dataclass(port):
        assert type(port).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(port):
            if f.name == "reps":  # each package's own Pod objects
                assert len(getattr(port, f.name)) == len(getattr(ref, f.name)), path
                continue
            _assert_same(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(port, np.ndarray):
        assert isinstance(ref, np.ndarray), path
        assert port.dtype == ref.dtype and port.shape == ref.shape, path
        assert port.tobytes() == ref.tobytes(), path
    else:
        assert port == ref, path


@pytest.mark.parametrize(
    "n_nodes,n_pods,seed,placed_every",
    [(24, 48, 1, 0), (130, 256, 7, 5), (64, 100, 11, 3)],
)
def test_tensorizers_byte_identical(n_nodes, n_pods, seed, placed_every):
    ref = tensorize(
        "kubernetes_tpu", *mixed_cluster(ref_wrappers, n_nodes, n_pods, seed, placed_every)
    )
    port = tensorize(
        "kubernetes_tpu_torch",
        *mixed_cluster(port_wrappers, n_nodes, n_pods, seed, placed_every),
    )
    names = ["nodes", "pods", "static", "ports", "spread", "interpod"]
    for name, p, r in zip(names, port, ref):
        _assert_same(p, r, name)
    # the derived facts the solver dispatches on
    assert port[4].has_soft == ref[4].has_soft
    assert (port[5].ident, port[5].has_score, port[5].anti_only) == (
        ref[5].ident, ref[5].has_score, ref[5].anti_only,
    )


def test_api_objects_round_trip_identically():
    """The copied api layer parses and serialises wire-shaped objects as
    the reference does."""
    ref = mixed_cluster(ref_wrappers, 6, 20, seed=3, placed_every=2)
    port = mixed_cluster(port_wrappers, 6, 20, seed=3, placed_every=2)
    for r, p in zip(ref[0] + ref[1], port[0] + port[1]):
        assert p.to_dict() == r.to_dict()
        assert type(p).from_dict(r.to_dict()).to_dict() == r.to_dict()
