"""The port's domain_counts against the JAX package's kernel.

On the CPU the plain versions (and the wrappers, which take them for CPU
tensors) must equal ``domain_counts_reference`` and the Pallas kernel in
interpret mode exactly, and the gathered totals and the two-set form must
equal the reference followed by its per-node gather. The CUDA kernel itself is compared with the plain
version by the ``cuda`` tests, here and in tests/test_torch_cuda.py (which
imports no JAX, so it runs on the card)."""

import jax.numpy as jnp
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


def _reference_gathered(dom, cnt, d_pad, gdom=None):
    """The JAX package's aggregation followed by its per-node gather
    (kubernetes_tpu/ops/interpod.py:23-62): take_along_axis over the
    clamped domain index."""
    out = domain_counts_reference(dom, cnt, d_pad)
    g = dom if gdom is None else gdom
    return np.asarray(out), np.asarray(jnp.take_along_axis(out, jnp.where(g >= 0, g, 0), axis=1))


@pytest.mark.parametrize("t,n,d_pad", [(8, 300, 8), (3, 1001, 64), (1, 130, 8192)])
def test_gathered_plain_equals_reference(t, n, d_pad):
    dom, cnt = _inputs(200 + t, t, n, d_pad)
    gdom, _ = _inputs(300 + t, t, n, d_pad)
    for g in (None, gdom):
        ((out, tot),) = dc.aggregate_plain(
            [(torch.from_numpy(dom), torch.from_numpy(cnt), None if g is None else torch.from_numpy(g))],
            d_pad,
        )
        want_out, want_tot = _reference_gathered(dom, cnt, d_pad, g)
        np.testing.assert_array_equal(out.numpy(), want_out)
        np.testing.assert_array_equal(tot.numpy(), want_tot)


@pytest.mark.parametrize("ti,te,n,d_pad", [(8, 8, 512, 16), (5, 3, 777, 8), (8, 0, 300, 8)])
def test_two_set_plain_equals_reference(ti, te, n, d_pad):
    """The two-set form (InterPodAffinity's in and ex tables in one call)
    equals the reference on each set; the wrapper takes it on the CPU and
    counts no launch."""
    sets_np = [_inputs(400 + ti, ti, n, d_pad), _inputs(500 + te, te, n, d_pad)]
    sets = [(torch.from_numpy(d), torch.from_numpy(c), None) for d, c in sets_np]
    before = dc.LAUNCHES
    plain = dc.aggregate_plain(sets, d_pad)
    wrapped = dc.aggregate(sets, d_pad)
    only_tot = dc.aggregate(sets, d_pad, counts=False)
    assert dc.LAUNCHES == before
    for (d, c), (out, tot), (w_out, w_tot), (none, o_tot) in zip(sets_np, plain, wrapped, only_tot):
        want_out, want_tot = _reference_gathered(d, c, d_pad)
        for got, want in ((out, want_out), (w_out, want_out), (tot, want_tot),
                          (w_tot, want_tot), (o_tot, want_tot)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        assert none is None


def test_prepared_aggregation_follows_in_place_updates():
    """A prepared aggregation, as the scan keeps one per solve, reads the
    counts' current contents on every call."""
    dom, cnt = _inputs(600, 4, 700, 16)
    gdom, _ = _inputs(601, 4, 700, 16)
    cnt_t = torch.from_numpy(cnt.copy())
    agg = dc.Aggregation([(torch.from_numpy(dom), cnt_t, torch.from_numpy(gdom))], 16)
    for step in range(3):
        ((out, tot),) = agg()
        want_out, want_tot = _reference_gathered(dom, cnt_t.numpy(), 16, gdom)
        np.testing.assert_array_equal(out.numpy(), want_out)
        np.testing.assert_array_equal(tot.numpy(), want_tot)
        cnt_t[:, step::5] += step + 1


def test_counts_wrap_like_the_reference():
    """int32 totals wrap modulo 2^32, as the int64 sum cast to int32 does."""
    dom = np.zeros((1, 4), np.int32)
    cnt = np.full((1, 4), 2**30, np.int32)
    got = _port(dom, cnt, 8)
    assert got[0, 0] == np.int32(np.int64(2**32) - 2**32)
    np.testing.assert_array_equal(got, np.asarray(domain_counts_reference(dom, cnt, 8)))


# H100: 232,448 bytes of shared memory per block, 132 SMs
@pytest.mark.parametrize(
    "rows,n,d_pad,want",
    [
        (16, 5120, 8192, (8, False)),     # the main path's two-set launch
        (8, 5120, 8192, (8, False)),
        (1, 5001, 8, (8, False)),         # one spread row
        (16, 10240, 16384, (8, False)),
        (8, 5120, 65536, (8, False)),     # needs two blocks, spread to eight
        (8, 600, 65536, (2, False)),      # too few lanes to spread further
        (200, 5120, 8, (1, False)),       # the grid already fills the card
        (40, 5120, 8, (2, False)),
        (4, 300, 8, (1, False)),
        (2, 5120, 8 * 58112, (8, False)),  # the cluster's capacity
        (2, 5120, 8 * 58112 + 1, (8, True)),  # beyond it: the global path
        (2, 700, 2**20, (1, True)),
    ],
)
def test_plan_cluster_size_and_path(rows, n, d_pad, want):
    c, is_global = dc.plan(rows, n, d_pad, smem=232448, sms=132)
    assert (c, is_global) == want
    if not is_global:
        assert -(-d_pad // c) * 4 <= 232448


@pytest.mark.parametrize(
    "sets,err",
    [
        ([], ValueError),
        ([(torch.zeros((1, 4), dtype=torch.int32),) * 2 + (None,)] * 3, ValueError),
        ([(torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32),
           torch.zeros((1, 4), dtype=torch.int64))], TypeError),
        ([(torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32),
           torch.zeros((1, 5), dtype=torch.int32))], ValueError),
    ],
    ids=["no-set", "three-sets", "gather-dtype", "gather-shape"],
)
def test_aggregate_rejects_bad_input(sets, err):
    with pytest.raises(err):
        dc.aggregate(sets, 8)


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
@pytest.mark.parametrize(
    "t,n,d_pad", [(8, 5120, 8192), (1, 1000, 8), (3, 777, 65536), (3, 777, 2**19)]
)
def test_cuda_kernel_equals_plain_and_reference(cuda_device, t, n, d_pad):
    dom, cnt = _inputs(7 + t, t, n, d_pad)
    dom_d = torch.from_numpy(dom).to(cuda_device)
    cnt_d = torch.from_numpy(cnt).to(cuda_device)
    ((got, tot),) = dc.aggregate([(dom_d, cnt_d, None)], d_pad)
    np.testing.assert_array_equal(
        got.cpu().numpy(), dc.domain_counts_plain(dom_d, cnt_d, d_pad).cpu().numpy()
    )
    want_out, want_tot = _reference_gathered(dom, cnt, d_pad)
    np.testing.assert_array_equal(got.cpu().numpy(), want_out)
    np.testing.assert_array_equal(tot.cpu().numpy(), want_tot)
