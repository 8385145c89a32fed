"""An emulation of the exact solver's CUDA graphs for the CPU tests of
solver/graphs.py, and the cluster and inputs those tests build.

``emulated`` lets graphs engage on the CPU, and a capture there records the
function, which each replay runs again, eagerly, through everything a CUDA
graph replays. ``tests/test_torch_step_graphs.py`` (the scan step) and
``tests/test_torch_grouped_graphs.py`` (the quota iterations) import it;
pytest finds a fixture among a test module's names."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch.api.wrappers import MakeNode
from kubernetes_tpu_torch.ops import threefry as tf
from kubernetes_tpu_torch.solver import graphs as sg
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu_torch.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


@pytest.fixture
def emulated(monkeypatch):
    """Graphs engage on the CPU, and a capture records the function, which
    each replay runs again; the streams made meanwhile are recorded, in
    order (the eager solves' own streams)."""
    monkeypatch.setattr(sg, "engages",
                        lambda device, shards, use_nominated: shards == 1 and not use_nominated)
    monkeypatch.setattr(sg.StepGraphs, "capture", lambda self, fn: SimpleNamespace(replay=fn))
    made = []

    class Recorded(tf.Stream):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tf, "Stream", Recorded)
    return made


def nodes(n=48, *, cpu=4, memory="16Gi", pods=20, varied=False):
    """``n`` nodes in 3 zones of ``cpu`` cores each; ``varied``: node ``i``
    has ``i`` more, so that ties are few."""
    return [MakeNode().name(f"n{i:03}").capacity(
        {"cpu": f"{cpu + (i if varied else 0)}", "memory": memory, "pods": f"{pods}"})
        .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:03}").obj() for i in range(n)]


def inputs(nodes, pods):
    """The solver's inputs for ``pods`` on ``nodes``; a resource no node has
    stays unknown, so a pod that requests one is an invalid row."""
    vocab = ResourceVocab.build([], nodes)
    nb = build_node_batch(nodes, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (nb, pb, st, build_port_tensors(pods, pb, slots, {}, nb.padded),
            build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
            build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad))
