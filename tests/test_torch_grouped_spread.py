"""The fused spread loop (``csrc/grouped_spread.cu`` via
``ops/grouped_spread.py``) on the card, against the eager loop
(``solver/grouped.py`` ``_Loop``, graphs off) on the same card: every
spread chunk of a solve in one launch, and the solve equal bit for bit --
assignments, carried state, the stream's key after every chunk and at the
end, the iterations and the kept water-fills (read from the device row).
Every test needs an NVIDIA GPU and skips without one; the file imports no
JAX, so it runs on the card without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -rP tests/test_torch_grouped_spread.py
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import grouped_spread as gs

from _torch_spread_cases import assert_same, recorded_solve, spread_cases  # noqa: F401

pytestmark = pytest.mark.cuda
GROUP = 64
# spread5k's shape: 5,000 nodes in 3 zones, a batch of 1,024 pods, 64-pod
# chunks
CASES = spread_cases(5000, 1024, GROUP)
SEEDS = [3_266_489_917, 11, 2_024, 987_654_321, 4_000_000_007]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; a skip here is not a pass "
                    "(run this file on the card)")
    return torch.device("cuda")


def _timed(launches):
    """``gs.spread_loop`` with CUDA events around each launch."""
    real = gs.spread_loop

    def loop(stream, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        real(stream, **kw)
        b.record()
        launches.append((a, b))

    return loop


def _check(recorded_solve, dev, case, seed, launches=None):
    spec = CASES[case]
    want = recorded_solve(spec, dev, seed, fused=False, graphs=False, group=GROUP)
    before = gs.LAUNCHES
    got = recorded_solve(spec, dev, seed, fused=True, group=GROUP,
                         spread_loop=_timed(launches) if launches is not None else None)
    assert_same(got, want, f"{case}, seed {seed}")
    counts = [c for _, _, _, c in got[0]]
    assert gs.LAUNCHES - before == sum(c["fused_chunks.spread"] for c in counts)
    return got, counts


@pytest.mark.parametrize("seed", SEEDS)
def test_spread5k_shape_equals_the_eager_loop(cuda_device, recorded_solve, seed):
    """maxSkew 5 on 5,000 nodes that two live waves load; the fused
    kernel's device time per chunk and per iteration is printed."""
    launches = []
    _, counts = _check(recorded_solve, cuda_device, "skew5_loaded", seed, launches)
    _print_times(f"seed {seed}", launches, counts)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_hostname_spread_equals_the_eager_loop(cuda_device, recorded_solve, seed):
    """maxSkew 1 on kubernetes.io/hostname at 5,000 nodes: a domain a node,
    so the loop's arrays outgrow the block's shared memory and take the
    device workspace; the device time per chunk is printed."""
    # the launch pads N to 5,120 and d_pad to 8,192: more than this
    assert gs._load().grouped_spread_workspace(5000, 5000) > gs.smem_limit(cuda_device)
    launches = []
    _, counts = _check(recorded_solve, cuda_device, "hostname_skew1", seed, launches)
    _print_times(f"hostname seed {seed}", launches, counts)


def _print_times(label, launches, counts):
    torch.cuda.synchronize()
    us = [1e3 * a.elapsed_time(b) for a, b in launches]
    iterations = sum(c["chunk_iterations.spread"] for c in counts)
    print(f"grouped_spread {label} ({torch.cuda.get_device_name(0)}): {len(us)} chunks, "
          f"{iterations} iterations, device us per chunk median {np.median(us):.1f} "
          f"(min {min(us):.1f}, max {max(us):.1f}), per iteration "
          f"{sum(us) / max(iterations, 1):.2f}")


@pytest.mark.parametrize("case", sorted(set(CASES) - {"skew5_loaded", "hostname_skew1"}))
def test_cases_equal_the_eager_loop(cuda_device, recorded_solve, case):
    """maxSkew 1, an empty cluster (the water-fill is kept), a partial
    chunk, full nodes (infeasible chunks), owed splits on entry, nodes of
    differing sizes over two solves, float32 MostAllocated."""
    got, counts = _check(recorded_solve, cuda_device, case, 5)
    if case.startswith("empty"):
        assert sum(c["waterfill_iterations"] for c in counts) > 0
    if case == "infeasible":
        a = got[0][0][0]
        assert (a < 0).any() and (a >= 0).any()


def test_the_workspace_in_device_memory(cuda_device, recorded_solve, monkeypatch):
    """The loop's arrays in the device workspace rather than shared memory
    (a cluster too large for a block's shared memory takes this path)."""
    monkeypatch.setattr(gs, "smem_limit", lambda device: 0)
    _check(recorded_solve, cuda_device, "skew5_loaded", SEEDS[0])
