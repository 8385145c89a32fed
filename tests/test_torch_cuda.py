"""The port on the card. Every test here needs an NVIDIA GPU and skips
without one. The file imports no JAX (the machine with the card has none),
so it runs there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu_torch.tensorize.schema import (
    ResourceVocab,
    build_node_batch,
    build_pod_batch,
)
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors

pytestmark = pytest.mark.cuda
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU; a skip here is not a pass "
            "(run this file on the card, or chip_smoke.py)"
        )
    return torch.device("cuda")


def _inputs(seed, t, n, d_pad, dev):
    rng = np.random.default_rng(seed)
    dom = torch.from_numpy(rng.integers(-1, d_pad, (t, n)).astype(np.int32)).to(dev)
    cnt = torch.from_numpy(rng.integers(0, 5, (t, n)).astype(np.int32)).to(dev)
    return dom, cnt


@pytest.mark.parametrize(
    "t,n,d_pad",
    [(8, 5120, 8192), (1, 5001, 8), (16, 5120, 8), (3, 777, 65536), (2, 100_000, 16384)],
)
def test_kernel_equals_plain(cuda_device, t, n, d_pad):
    dom, cnt = _inputs(t + n, t, n, d_pad, cuda_device)
    before = dc.LAUNCHES
    got = dc.domain_counts(dom, cnt, d_pad)
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + 1
    assert torch.equal(got, dc.domain_counts_plain(dom, cnt, d_pad))


def test_both_paths_are_taken(cuda_device):
    assert dc.uses_shared_memory(8192, cuda_device)
    assert not dc.uses_shared_memory(65536, cuda_device)


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    dom, cnt = _inputs(0, 4, 256, 8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dc.domain_counts(dom.t().contiguous().t(), cnt, 8)
    with pytest.raises(ValueError):
        dc.domain_counts(dom, cnt.cpu(), 8)
    with pytest.raises(ValueError, match="65535"):
        big = torch.zeros((65536, 1), dtype=torch.int32, device=cuda_device)
        dc.domain_counts(big, big, 8)


def _cluster(n_nodes, n_pods):
    nodes = [
        MakeNode().name(f"n{i:04}").capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
        .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:04}").obj()
        for i in range(n_nodes)
    ]
    pods = []
    for i in range(n_pods):
        b = MakePod().name(f"p{i:04}").label("app", f"k{i % 4}").req(
            {"cpu": "250m", "memory": "512Mi"}
        )
        if i % 4 == 0:
            b = b.host_port(8000 + i % 8)
        elif i % 4 == 1:
            b = b.spread_constraint(1, ZONE, "DoNotSchedule", {"app": "k1"})
        elif i % 4 == 2:
            b = b.pod_anti_affinity(HOST, {"app": "k2"})
        else:
            b = b.preferred_pod_affinity(50, ZONE, {"app": "k1"}).spread_constraint(
                2, ZONE, "ScheduleAnyway", {"app": "k3"}
            )
        pods.append(b.obj())
    return nodes, pods


def _tensorize(nodes, pods):
    vocab = ResourceVocab.build(pods, nodes)
    nb = build_node_batch(nodes, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (
        nb, pb, st, build_port_tensors(pods, pb, slots, {}, nb.padded),
        build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
        build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad),
    )


@pytest.mark.parametrize("fdtype", ["float64", "float32"])
def test_card_equals_cpu(cuda_device, fdtype):
    nodes, pods = _cluster(300, 200)
    cfg = ExactSolverConfig(tie_break="first", balanced_fdtype=fdtype)
    card = _tensorize(nodes, pods)
    cpu = _tensorize(nodes, pods)
    before = dc.LAUNCHES
    a = ExactSolver(cfg).solve(*card, device=cuda_device)
    assert dc.LAUNCHES > before
    b = ExactSolver(cfg).solve(*cpu, device="cpu")
    np.testing.assert_array_equal(a, b)
    for k in ("used", "nonzero_used", "pod_count"):
        np.testing.assert_array_equal(getattr(card[0], k), getattr(cpu[0], k))


def test_random_tie_break_on_the_card(cuda_device):
    """Random mode draws from a CUDA generator: the same seed repeats, and
    every pod is placed with the anti-affinity and port rules held."""
    nodes, pods = _cluster(64, 120)
    cfg = ExactSolverConfig(tie_break="random", seed=5)
    a = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    b = ExactSolver(cfg).solve(*_tensorize(nodes, pods), device=cuda_device)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all()
    anti = a[2::4]
    assert len(set(anti.tolist())) == len(anti)
    for port in range(8000, 8008):
        on = [a[i] for i in range(0, len(pods), 4) if 8000 + i % 8 == port]
        assert len(set(on)) == len(on)
