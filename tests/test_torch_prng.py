"""The port's threefry stream (kubernetes_tpu_torch/ops/prng.py and the
CPU side of ops/threefry.py) against jax.random, bit for bit, with 64-bit
types on and the partitionable threefry layout: the Random123 known
answer, the hash on seeded keys and counters, PRNGKey, split, fold_in,
random_bits at both widths (a draw's columns from ``lo`` equal the full
draw's slice), int64 and int32 randint, float64 uniform, the solver's
scan-step chain with skipped rows, the grouped iteration's draws, and a
hypothesis property over keys, spans and lengths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax._src import prng as jax_prng

from kubernetes_tpu_torch.ops import prng
from kubernetes_tpu_torch.ops import threefry as tf

M32 = 0xFFFFFFFF


def words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(key))


def test_jax_uses_the_partitionable_layout():
    """The port pins the partitionable layout (JAX's default since 0.5);
    a JAX that flips it is reported here, by name."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is True


def test_random123_known_answer():
    got = prng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert got == (0xC4923A9C, 0x483DF7A0)


def test_threefry_on_seeded_keys_and_counters():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 32, size=(16, 2), dtype=np.uint64)
    counts = rng.integers(0, 1 << 32, size=(16, 2, 32), dtype=np.uint64)
    for key, cnt in zip(keys, counts):
        want = np.asarray(jax_prng.threefry_2x32(
            jnp.asarray(key, jnp.uint32), jnp.asarray(cnt.reshape(-1), jnp.uint32)))
        x0 = torch.as_tensor(cnt[0].astype(np.int64))
        x1 = torch.as_tensor(cnt[1].astype(np.int64))
        y0, y1 = prng.threefry2x32(int(key[0]), int(key[1]), x0, x1)
        np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(), want.astype(np.int64))
        # tensor keys broadcast against the counters the same way
        t0, t1 = prng.threefry2x32(torch.tensor(int(key[0])), torch.tensor(int(key[1])), x0, x1)
        assert torch.equal(t0, y0) and torch.equal(t1, y1)


@pytest.mark.parametrize("seed", [0, 7, -1, 2**32 + 5, 2**63 - 1])
def test_prng_key(seed):
    assert prng.prng_key(seed) == words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 3, -9])
def test_split_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    new, sub = jax.random.split(key)
    assert prng.split(prng.prng_key(seed)) == (words(new), words(sub))
    assert prng.next_key(prng.prng_key(seed)) == words(new)
    for i in (0, 1, 2, 17, 123_456):
        assert prng.fold_in(prng.prng_key(seed), i) == words(jax.random.fold_in(key, i))


@pytest.mark.parametrize("width", [32, 64])
def test_random_bits_and_a_slice_from_lo(width):
    key = jax.random.PRNGKey(5)
    dtype = jnp.uint32 if width == 32 else jnp.uint64
    want = np.asarray(jax.random.bits(key, (1000,), dtype=dtype))
    want = want.view(np.int64) if width == 64 else want.astype(np.int64)
    got = prng.random_bits(prng.prng_key(5), width, 0, 1000).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(5), width, 300, 250).numpy(), want[300:550])
    # the scalar draw is index 0, in the key words' own type
    assert prng.random_bits(prng.prng_key(5), width, 0) == int(want[0]) & ((1 << width) - 1)


def test_scalar_int64_randint_over_every_span_up_to_10240():
    """The scan step's draw: randint(sub, (), 0, span) in int64 for spans
    1 .. 10,240, one key (the draw's words do not depend on the span)."""
    sub = jax.random.split(jax.random.PRNGKey(11))[1]
    spans = np.arange(1, 10_241, dtype=np.int64)
    want = np.asarray(jax.vmap(lambda m: jax.random.randint(sub, (), 0, m))(spans))
    got = prng.randint(words(sub), 0, None, 0, torch.as_tensor(spans), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    # a Python-int span gives the same value
    assert prng.randint(words(sub), 0, None, 0, 10_240, 64) == want[-1]


def test_vector_randints_int32_and_int64():
    key = jax.random.PRNGKey(21)
    pk = prng.prng_key(21)
    want = np.asarray(jax.random.randint(key, (4096,), 0, 1 << 20, dtype=jnp.int32))
    np.testing.assert_array_equal(prng.randint(pk, 0, 4096, 0, 1 << 20, 32).numpy(), want)
    np.testing.assert_array_equal(
        prng.randint(pk, 1000, 96, 0, 1 << 20, 32).numpy(), want[1000:1096])
    for span in (1, 3, 1000, 65_537, 2**30 + 3):
        for width, dtype in ((32, jnp.int32), (64, jnp.int64)):
            want = np.asarray(jax.random.randint(key, (64,), 0, span, dtype=dtype))
            np.testing.assert_array_equal(
                prng.randint(pk, 0, 64, 0, span, width).numpy(), want, err_msg=str(span))
    with pytest.raises(ValueError, match="2\\^31"):
        prng.randint(pk, 0, 4, 0, 1 << 31, 64)


def test_float64_uniform():
    key = jax.random.PRNGKey(8)
    want = np.asarray(jax.random.uniform(key, (5120,)))
    assert want.dtype == np.float64
    got = prng.uniform_f64(prng.prng_key(8), 0, 5120)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(prng.uniform_f64(prng.prng_key(8), 5000, 120).numpy(),
                                  want[5000:])


def _jax_scan_chain(key, spans, valid):
    """The JAX package's scan step's draws (solver/exact.py:352-355): one
    split per row, valid or not."""
    out = []
    for span, ok in zip(spans, valid):
        key, sub = jax.random.split(key)
        r = int(jax.random.randint(sub, (), 0, jnp.maximum(jnp.int64(span), 1)))
        if ok:
            out.append(r)
    return out, words(key)


def test_scan_chain_with_skipped_rows_on_a_cpu_stream():
    rng = np.random.default_rng(3)
    spans = rng.integers(0, 300, size=120)
    valid = rng.random(120) > 0.2
    want, key_after = _jax_scan_chain(jax.random.PRNGKey(4), spans, valid)
    stream = tf.Stream(prng.prng_key(4), "cpu")
    got = []
    for span, ok in zip(spans, valid):
        if ok:
            got.append(int(stream.rank(torch.tensor(int(span), dtype=torch.int64))))
        else:
            stream.skip()
    assert got == want
    assert stream.key_words() == key_after


def test_grouped_iteration_draws_on_a_cpu_stream():
    """A grouped iteration: split, then uniform (plain) or the quota modes'
    node keys, and the water-fill's uniform again from the same subkey."""
    n = 700
    key = jax.random.PRNGKey(9)
    stream = tf.Stream(prng.prng_key(9), "cpu")
    stream.skip()  # a skipped scan row before the chunk
    key, _ = jax.random.split(key)
    for it in range(3):
        key, s1 = jax.random.split(key)
        u = np.asarray(jax.random.uniform(s1, (n,)))
        rb = np.asarray(jax.random.randint(s1, (n,), 0, 1 << 20, dtype=jnp.int32)
                        ).astype(np.int64) * n + np.arange(n)
        if it == 1:
            np.testing.assert_array_equal(stream.uniform(0, n).numpy(), u)
        else:
            np.testing.assert_array_equal(stream.node_keys(0, n, n).numpy(), rb)
            np.testing.assert_array_equal(stream.uniform(0, n, split=False).numpy(), u)
            np.testing.assert_array_equal(
                stream.node_keys(100, 50, n, split=False).numpy(), rb[100:150])
    assert stream.key_words() == words(key)


def test_stream_rejects_what_it_cannot_draw():
    stream = tf.Stream(prng.prng_key(0), "cpu")
    with pytest.raises(ValueError, match="subkey"):
        stream.uniform(0, 8, split=False)
    with pytest.raises(ValueError, match="int64"):
        stream.rank(torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.Stream((0, 0), "meta")
    before = (tf.SCAN_LAUNCHES, tf.GROUPED_LAUNCHES)
    stream.rank(torch.tensor(3, dtype=torch.int64))
    stream.uniform(0, 8)
    assert (tf.SCAN_LAUNCHES, tf.GROUPED_LAUNCHES) == before, "the CPU launches no kernel"


_shapes = st.sampled_from([(0, 1), (0, 64), (37, 27), (63, 1)])


@settings(max_examples=40, deadline=None)
@given(
    k0=st.integers(0, M32), k1=st.integers(0, M32),
    span=st.integers(1, (1 << 31) - 1), shape=_shapes, width=st.sampled_from([32, 64]),
)
def test_randint_property(k0, k1, span, shape, width):
    """Any key, span below 2^31 and column range: randint at both widths
    equals jax.random's, the columns from ``lo`` its full draw's slice."""
    lo, n = shape
    key = jnp.asarray([k0, k1], jnp.uint32)  # a raw threefry key
    dtype = jnp.int32 if width == 32 else jnp.int64
    want = np.asarray(jax.random.randint(key, (64,), 0, span, dtype=dtype))
    got = prng.randint((k0, k1), lo, n, 0, span, width).numpy()
    np.testing.assert_array_equal(got, want[lo : lo + n])


def test_the_solver_draws_only_from_the_threefry_stream():
    """No torch generator is left on the exact solver's draw path: its
    random mode draws through ops/threefry.py alone."""
    import inspect

    from kubernetes_tpu_torch.solver import exact, grouped

    for mod in (exact, grouped):
        src = inspect.getsource(mod)
        for banned in ("torch.Generator", "torch.rand(", "torch.randint(", "manual_seed"):
            assert banned not in src, (mod.__name__, banned)
