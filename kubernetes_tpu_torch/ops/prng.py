"""JAX's random stream in plain PyTorch: threefry2x32 and the draws the
exact solver takes from it.

The JAX package draws its random tie-breaks from ``jax.random`` with 64-bit
types on and the partitionable threefry layout (the default since JAX 0.5).
Every piece of that is a fixed integer function over the Threefry-2x32
block cipher of Salmon et al., "Parallel random numbers: as easy as 1, 2,
3" (SC'11, the Random123 family), so this module gives the same bits:

- ``prng_key(seed)``: the key ``(seed >> 32, seed & 0xFFFFFFFF)`` of an int64
  seed (``jax.random.PRNGKey``);
- ``split(key)``: ``(threefry(key, (0, 0)), threefry(key, (0, 1)))``, the new
  key and the subkey;
- ``fold_in(key, i)``: ``threefry(key, (0, i))``;
- ``random_bits(key, width, lo, n)``: the hashes of the flat indices
  ``lo .. lo + n - 1`` as counters ``(i >> 32, i & 0xFFFFFFFF)``, folded to
  32 bits as ``b0 ^ b1`` or joined to 64 as ``b0 << 32 | b1``; ``lo`` lets a
  caller draw only its own columns of a longer draw;
- ``randint`` and ``uniform_f64`` on top, as ``jax.random`` maps the bits.

A key is a pair of uint32 words ``(k0, k1)``. Each word is a Python int or
an int64 tensor holding a value in [0, 2^32), and words broadcast as
tensors do, so one function serves a host chain of scalar keys (the CPU
solver's scan, where a tensor op per round would cost more than the step)
and a key on the card (the plain version the kernel of ``ops/threefry.py``
is held against). The uint32 arithmetic runs in int64 and is masked to 32
bits after every add and left shift; right shifts see only masked,
non-negative values, so torch's arithmetic ``>>`` is the logical one.
64-bit words are int64 bit patterns: their unsigned remainders are taken
32 bits at a time (``_rem_u64``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_M52 = (1 << 52) - 1
_ONE_F64 = 0x3FF0000000000000  # the bits of 1.0 in float64
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the largest span a 64-bit draw takes: its remainders are exact in int64
# below it (spans are node counts)
SPAN_LIMIT = 1 << 31


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: the counter ``(x0, x1)`` hashed under
    the key ``(k0, k1)``. Five groups of four rounds, the rotations
    alternating between the two sets of Random123, and a key injection
    after each group that adds the group's number to the second word."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for g in range(5):
        for r in _ROTATIONS[g & 1]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` of an int64 seed, negative ones
    included."""
    return (seed >> 32) & M32, seed & M32


def next_key(key):
    """The first half of ``split(key)``: the key after one split."""
    return threefry2x32(key[0], key[1], 0, 0)


def split(key):
    """``jax.random.split(key)``: (the new key, the subkey)."""
    return next_key(key), threefry2x32(key[0], key[1], 0, 1)


def fold_in(key, i: int):
    """``jax.random.fold_in(key, i)`` (``i`` taken as a uint32)."""
    return threefry2x32(key[0], key[1], 0, i & M32)


def random_bits(key, width: int, lo: int = 0, n: int | None = None, device=None):
    """The ``width``-bit words (32 or 64) at the flat indices ``lo .. lo +
    n - 1`` of a draw from ``key``: an int64 tensor of ``n`` words on
    ``device`` (64-bit words as bit patterns). ``n`` None: the one word at
    index ``lo``, of the key words' type (a scalar draw is index 0)."""
    if n is None:
        x0, x1 = lo >> 32, lo & M32
    else:
        idx = torch.arange(lo, lo + n, dtype=torch.int64, device=device)
        x0, x1 = idx >> 32, idx & M32
    b0, b1 = threefry2x32(key[0], key[1], x0, x1)
    if width == 32:
        return b0 ^ b1
    if width == 64:
        return (b0 << 32) | b1
    raise ValueError(f"random_bits takes width 32 or 64, got {width}")


def _rem_u64(w, s):
    """``w mod s`` for the unsigned 64-bit word ``w`` and ``s < 2^31``: the
    two 32-bit halves' remainders, recombined (every product < 2^62)."""
    return (((w >> 32) & M32) % s * ((1 << 32) % s) + (w & M32) % s) % s


def randint(key, lo: int, n: int | None, minval, maxval, width: int, device=None):
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` at the flat
    indices ``lo .. lo + n - 1`` for the signed ``width``-bit dtype (``n``
    None: the scalar draw). ``maxval`` may be a tensor (the scan's tie
    count on the device). As JAX does it: ``k1, k2 = split(key)``, two
    ``width``-bit words, ``span = max(maxval - minval, 1)``, ``multiplier =
    (2^(width/2) mod span)^2 mod span`` and ``minval + ((higher mod span) *
    multiplier + lower mod span) mod span``, every product wrapping at
    ``width`` bits. 64-bit draws require ``span < 2^31`` (spans are at most
    the node count; a Python-int span is checked here, a tensor's bound by
    the caller), so their products never reach the wrap."""
    span = maxval - minval
    span = torch.clamp(span, min=1) if isinstance(span, torch.Tensor) else max(span, 1)
    k1, k2 = split(key)
    lw = random_bits(k2, width, lo, n, device)
    if width == 32:
        m16 = (1 << 16) % span
        mult = (m16 * m16 & M32) % span
        if isinstance(mult, int) and mult == 0:
            # a span that divides 2^32 (the node keys' 2^20): the higher
            # word is multiplied by 0, so it is not drawn
            return minval + lw % span
        hi = random_bits(k1, width, lo, n, device)
        off = ((hi % span * mult & M32) + lw % span) & M32
        return minval + off % span
    if width != 64:
        raise ValueError(f"randint takes width 32 or 64, got {width}")
    if not isinstance(span, torch.Tensor) and span >= SPAN_LIMIT:
        raise ValueError(f"a 64-bit randint span must be below 2^31, got {span}")
    hi = random_bits(k1, width, lo, n, device)
    r32 = (1 << 32) % span
    mult = r32 * r32 % span
    return minval + (_rem_u64(hi, span) * mult + _rem_u64(lw, span)) % span


def uniform_f64(key, lo: int, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (..,), float64)`` at the flat indices
    ``lo .. lo + n - 1``: the top 52 bits of each 64-bit word as the
    mantissa of a float in [1, 2), less 1."""
    bits = random_bits(key, 64, lo, n, device)
    return (((bits >> 12) & _M52) | _ONE_F64).view(torch.float64) - 1.0


# -- the solver's draws: the plain versions of ops/threefry.py's kernels ------


def scan_draw(key, n_ties, skip: int = 0):
    """The scan step's draw: ``skip`` splits for the pod rows before this
    one that drew nothing, then ``key, sub = split(key)`` and ``randint(sub,
    (), 0, max(n_ties, 1))`` in int64. Returns (rank, the key after): the
    rank a Python int for an int ``n_ties``, else a 0-d int64 tensor on
    ``n_ties``' device."""
    for _ in range(skip):
        key = next_key(key)
    key, sub = split(key)
    return randint(sub, 0, None, 0, n_ties, 64), key


def grouped_split(key, skip: int = 0):
    """A grouped-loop iteration's split, after ``skip`` pending splits:
    (the key after, the iteration's subkey)."""
    for _ in range(skip):
        key = next_key(key)
    return split(key)


NODE_KEY_BITS = 20  # the grouped quota modes' randint(0, 1 << 20) in int32


def node_keys(sub, lo: int, n: int, n_all: int, device=None) -> torch.Tensor:
    """The quota modes' unique per-node keys over columns ``lo .. lo + n -
    1``: ``randint(sub, (n_all,), 0, 1 << 20, int32) * n_all + iota``, in
    int64."""
    r = randint(sub, lo, n, 0, 1 << NODE_KEY_BITS, 32, device)
    return r * n_all + torch.arange(lo, lo + n, dtype=torch.int64, device=device)
