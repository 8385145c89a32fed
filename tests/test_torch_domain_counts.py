"""The port's domain_counts against the JAX package's kernel.

On the CPU the plain version (and the wrapper, which takes it for CPU
tensors) must equal ``domain_counts_reference`` and the Pallas kernel in
interpret mode exactly. The CUDA kernel itself is compared with the plain
version by the ``cuda`` tests, here and in tests/test_torch_cuda.py (which
imports no JAX, so it runs on the card)."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.pallas_kernels import (
    N_TILE,
    domain_counts_padded,
    domain_counts_pallas,
    domain_counts_reference,
)
from kubernetes_tpu_torch.ops import domain_counts as dc


def _inputs(seed, t, n, d_pad, d_hi=None):
    rng = np.random.default_rng(seed)
    dom = rng.integers(-1, d_hi or d_pad, size=(t, n)).astype(np.int32)
    cnt = rng.integers(0, 5, size=(t, n)).astype(np.int32)
    return dom, cnt


def _port(dom, cnt, d_pad):
    before = dc.LAUNCHES
    plain = dc.domain_counts_plain(torch.from_numpy(dom), torch.from_numpy(cnt), d_pad)
    wrapped = dc.domain_counts(torch.from_numpy(dom), torch.from_numpy(cnt), d_pad)
    assert dc.LAUNCHES == before, "the CPU path must not count launches"
    assert plain.dtype == torch.int32 and wrapped.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), wrapped.numpy())
    return plain.numpy()


# the tiled shapes of tests/test_pallas_kernels.py, plus one d_pad of 8192
# (hostname and zone terms in one batch at 5k nodes)
@pytest.mark.parametrize(
    "t,n_tiles,d_pad", [(8, 1, 8), (8, 2, 16), (16, 4, 32), (8, 2, 8192)]
)
def test_plain_equals_reference_and_pallas(t, n_tiles, d_pad):
    dom, cnt = _inputs(42 + t, t, n_tiles * N_TILE, d_pad)
    got = _port(dom, cnt, d_pad)
    np.testing.assert_array_equal(got, np.asarray(domain_counts_reference(dom, cnt, d_pad)))
    np.testing.assert_array_equal(
        got, np.asarray(domain_counts_pallas(dom, cnt, d_pad, interpret=True))
    )


# the untiled shapes of tests/test_pallas_kernels.py, through the
# reference's padding adapter (which runs the kernel in interpret mode here)
@pytest.mark.parametrize("t,n", [(5, 200), (8, N_TILE), (9, N_TILE + 1), (1, 130)])
def test_plain_equals_reference_untiled(t, n):
    dom, cnt = _inputs(100 + t + n, t, n, 8, d_hi=6)
    got = _port(dom, cnt, 8)
    np.testing.assert_array_equal(got, np.asarray(domain_counts_reference(dom, cnt, 8)))
    np.testing.assert_array_equal(got, np.asarray(domain_counts_padded(dom, cnt, 8)))


def test_missing_key_is_excluded():
    dom = np.full((8, N_TILE), -1, dtype=np.int32)
    cnt = np.ones((8, N_TILE), dtype=np.int32)
    assert _port(dom, cnt, 8).sum() == 0


@pytest.mark.parametrize(
    "dom,cnt,d_pad,err",
    [
        (torch.zeros((2, 4), dtype=torch.int64), torch.zeros((2, 4), dtype=torch.int32), 8, TypeError),
        (torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 5), dtype=torch.int32), 8, ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), 8, ValueError),
        (torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 4), dtype=torch.int32), 0, ValueError),
    ],
    ids=["dtype", "shape", "rank", "d_pad"],
)
def test_wrapper_rejects_bad_input(dom, cnt, d_pad, err):
    with pytest.raises(err):
        dc.domain_counts(dom, cnt, d_pad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernel cannot run on this machine, and a "
            "skip here is not a pass (tests/test_torch_cuda.py and chip_smoke.py "
            "run the kernel on the card)"
        )
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,d_pad", [(8, 5120, 8192), (1, 1000, 8), (3, 777, 65536)])
def test_cuda_kernel_equals_plain_and_reference(cuda_device, t, n, d_pad):
    dom, cnt = _inputs(7 + t, t, n, d_pad)
    dom_d = torch.from_numpy(dom).to(cuda_device)
    cnt_d = torch.from_numpy(cnt).to(cuda_device)
    got = dc.domain_counts(dom_d, cnt_d, d_pad).cpu().numpy()
    np.testing.assert_array_equal(got, dc.domain_counts_plain(dom_d, cnt_d, d_pad).cpu().numpy())
    np.testing.assert_array_equal(got, np.asarray(domain_counts_reference(dom, cnt, d_pad)))
