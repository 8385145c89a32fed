"""The exact solver's random stream: JAX's threefry2x32 key chain, drawn on
the card by a hand-written CUDA kernel and on the CPU by its plain versions.

The JAX package threads one key through a solve (``PRNGKey(seed + solve
count)``, ``fold_in`` per chained sub-batch) and splits it once per scan
row and once per grouped-loop iteration, in chunk order
(``kubernetes_tpu/solver/exact.py`` ``chunk_step``). ``Stream`` is that
chain. Its draws:

- ``rank(n_ties)``: the scan step's ``split`` + int64 ``randint(sub, (), 0,
  max(n_ties, 1))``, with the tie count read where it lies;
- ``uniform(lo, n, split=)`` and ``node_keys(lo, n, n_all, split=)``: a
  grouped iteration's ``split`` and its float64 ``uniform`` or its int32
  ``randint(0, 1 << 20)`` made into the int64 node key ``r * n_all +
  iota``, over columns [lo, lo + n); ``split=False`` draws again from the
  iteration's subkey (the water-fill's second draw);
- ``skip()``: a scan row that draws nothing (an invalid pod) still owes
  its split, which the next draw pays first. A scan step replayed from a
  CUDA graph (``solver/graphs.py``) reads its row's owed splits from the
  device instead: ``skip_at``, set while the step is captured.

Kernel: ``csrc/threefry.cu``, two entry points, one launch per draw. On the
card the key lives in a device tensor that the kernels split in place, so
no draw reads the card; on the CPU it is a pair of Python ints and the
draws are ``ops/prng.py``'s plain versions. A stream takes the plain
versions only because its device is the CPU: on a CUDA device it launches
the kernel or raises ``build.KernelError``; there is no fallback.

The kernel has no TPU counterpart (XLA lowers ``jax.random``); what bounds
it is the hash's integer operations, far below the card's rate at the
solver's widths, so one launch per draw, in place of the ``torch.rand``
launch the port made before, is its design.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import KernelError
from . import prng

# kernel launches since the last reset, per entry point (the wrapper adds
# one per launch)
SCAN_LAUNCHES = 0
GROUPED_LAUNCHES = 0

_UNIFORM, _NODE_KEY = 0, 1

_lib = None
_raw_stream = None


def _load():
    global _lib, _raw_stream
    if _lib is None:
        from .. import build

        lib = build.load("threefry")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.threefry_scan_draw.argtypes = [p, i, p, p, q, p, p]
        lib.threefry_scan_draw.restype = i
        lib.threefry_grouped_draw.argtypes = [p, i, p, q, q, q, i, i, q, p]
        lib.threefry_grouped_draw.restype = i
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda idx: torch.cuda.current_stream(idx).cuda_stream
        )
        _lib = lib
    return _lib


class Stream:
    """One key chain on one device (see the module note). ``key`` is a pair
    of uint32 words (``prng.prng_key`` / ``prng.fold_in``)."""

    def __init__(self, key, device):
        self.device = torch.device(device)
        self.pending = 0  # splits owed by scan rows that drew nothing
        self.has_sub = False  # a grouped split has drawn a subkey
        # an int64 scalar on the stream's device whose value each scan draw
        # adds to the owed splits (a captured step's row, solver/graphs.py)
        self.skip_at = None
        self.cur = 0  # the live key slot of the card's state (the CPU has one key)
        if self.device.type == "cuda":
            _load()
            self.index = (self.device.index if self.device.index is not None
                          else torch.cuda.current_device())
            self.device = torch.device("cuda", self.index)
            # two key slots and the last subkey; ``cur`` is the live slot
            self.state = torch.tensor([key[0], key[1], 0, 0, 0, 0],
                                      dtype=torch.int64).to(self.device)
            self.cur = 0
        elif self.device.type == "cpu":
            self.key = (key[0], key[1])
        else:
            raise ValueError(f"a threefry stream runs on cuda or cpu, not {self.device}")

    def skip(self) -> None:
        self.pending += 1

    def reset(self, key) -> None:
        """Start the chain anew from ``key`` in the same state tensor, whose
        address a captured scan step keeps. On the card the key goes up
        from pinned memory without waiting for the card."""
        self.pending = 0
        self.has_sub = False
        if self.device.type == "cpu":
            self.key = (key[0], key[1])
            return
        words = torch.tensor([key[0], key[1], 0, 0, 0, 0], dtype=torch.int64)
        self.state.copy_(words.pin_memory(), non_blocking=True)
        self.cur = 0

    def rank(self, n_ties: torch.Tensor) -> torch.Tensor:
        """The scan step's pick rank in [0, max(n_ties, 1)): a 0-d int64
        tensor. ``n_ties``: the step's tie count, an int64 scalar on the
        stream's device; it is at most the node count, below 2^31."""
        global SCAN_LAUNCHES
        if n_ties.device != self.device:
            raise ValueError(f"threefry: n_ties on {n_ties.device}, stream on {self.device}")
        if n_ties.dtype != torch.int64 or n_ties.numel() != 1:
            raise ValueError(f"threefry: n_ties must be one int64, got {n_ties.dtype} "
                             f"{tuple(n_ties.shape)}")
        skip, self.pending = self.pending, 0
        at = self.skip_at
        if self.device.type == "cpu":
            # ktpu: ignore[TPU001]: the CPU branch: n_ties and skip_at lie on the host (checked above); no card value is read
            n, skip = int(n_ties), skip + (0 if at is None else int(at))
            # the plain version in Python ints: twenty tensor ops a step
            # would cost more than the step's six hashes
            r, self.key = prng.scan_draw(self.key, n, skip)
            return torch.tensor(r, dtype=torch.int64)
        out = torch.empty((), dtype=torch.int64, device=self.device)
        rc = _lib.threefry_scan_draw(self.state.data_ptr(), self.cur, n_ties.data_ptr(),
                                     out.data_ptr(), skip,
                                     None if at is None else at.data_ptr(),
                                     _raw_stream(self.index))
        if rc != 0:
            raise KernelError(f"threefry_scan_draw launch failed: cudaError {rc}")
        SCAN_LAUNCHES += 1
        return out

    def _grouped(self, what: int, lo: int, n: int, n_all: int, split: bool) -> torch.Tensor:
        global GROUPED_LAUNCHES
        if lo < 0 or n < 0:
            raise ValueError(f"threefry: bad columns [{lo}, {lo + n})")
        if not split and (self.pending or not self.has_sub):
            raise ValueError("threefry: a draw without a split needs the iteration's subkey")
        skip, self.pending = self.pending, 0
        self.has_sub = True
        if self.device.type == "cpu":
            if split:
                self.key, self.sub = prng.grouped_split(self.key, skip)
            if what == _UNIFORM:
                return prng.uniform_f64(self.sub, lo, n, self.device)
            return prng.node_keys(self.sub, lo, n, n_all, self.device)
        out = torch.empty(n, dtype=torch.float64 if what == _UNIFORM else torch.int64,
                          device=self.device)
        rc = _lib.threefry_grouped_draw(self.state.data_ptr(), self.cur, out.data_ptr(), lo, n,
                                        n_all, what, 1 if split else 0, skip,
                                        _raw_stream(self.index))
        if rc != 0:
            raise KernelError(f"threefry_grouped_draw launch failed: cudaError {rc}")
        if split:
            self.cur = 2 - self.cur
        GROUPED_LAUNCHES += 1
        return out

    def uniform(self, lo: int, n: int, *, split: bool = True) -> torch.Tensor:
        """A grouped iteration's float64 ``uniform`` over columns [lo, lo +
        n), after its ``split`` (``split=False``: from the last subkey)."""
        return self._grouped(_UNIFORM, lo, n, 0, split)

    def node_keys(self, lo: int, n: int, n_all: int, *, split: bool = True) -> torch.Tensor:
        """A grouped iteration's unique node keys ``randint(0, 1 << 20) *
        n_all + iota`` (int64) over columns [lo, lo + n) of ``n_all``."""
        return self._grouped(_NODE_KEY, lo, n, n_all, split)

    def key_words(self) -> tuple[int, int]:
        """The live key as two ints, with the pending splits applied (for
        tests and the card's checks: it reads the card)."""
        if self.device.type == "cpu":
            k = self.key
        else:
            w = self.state.cpu().tolist()
            k = (w[self.cur], w[self.cur + 1])
        for _ in range(self.pending):
            k = prng.next_key(k)
        return k
