"""One spread chunk's whole random loop in one launch: the CUDA kernel's
wrapper.

The grouped path places a chunk of identical zone-spread pods (kind 2) by a
random loop, ``solver/grouped.py`` ``fast_chunk`` over ``_Loop.iteration``
in spread mode: each iteration evaluates the domain quotas, scores two
frontier rows, splits the threefry stream for the node keys, picks one
winner a domain (or, where it applies, the water-fill), scatters the picks,
and the host reads the count placed to decide whether to go on. On the card
that is about 195 small kernels and one blocking read an iteration.
``csrc/grouped_spread.cu`` runs the whole loop inside one thread block, one
launch a chunk, and exits on the card; its source note has the design and
what bounds it.

The plain version is the eager loop itself (``_Loop``), which the CPU takes:
``engages`` is true only on a CUDA device, with one shard, in random mode,
for a fit scorer the kernel computes (LeastAllocated or MostAllocated; not
RequestedToCapacityRatio). Where it is true the wrapper launches the kernel
or raises ``build.KernelError``; there is no fallback.

The kernel pays the stream's owed splits, leaves the next key in the live
slot the stream names and the last subkey where the draws read it, and adds
the chunk's iterations and its kept water-fills to a device row
(``counts``), which the solver reads when the card has written it
(``solver/timing.py`` ``DeferredCounts``). ``LAUNCHES`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import KernelError
from . import noderesources as nr

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

# threads of the one block (32 warps); the kernel takes any multiple of 32
# up to 1,024
THREADS = 1024

# the fit scorers the kernel computes, by the code it takes
SCORERS = {nr.least_allocated_score: 0, nr.most_allocated_score: 1}

(W_N, W_DPAD, W_GROUP, W_VCNT, W_SKEW, W_DPRESENT, W_SKIP, W_CUR, W_MOST, W_F64,
 W_WFIT, W_WBAL, W_STATE, W_CAP, W_BASE, W_CDOM, W_DOM, W_HK, W_PRESENT, W_ALLOC,
 W_ALLOC_STRIDE, W_NZU, W_NZU_STRIDE, W_NZ, W_FITW, W_SROW, W_M, W_ASG, W_COUNTS,
 W_WORK, W_SMEM, W_THREADS, W_STREAM, W_WORDS) = range(34)

_lib = None
_raw_stream = None
_smem: dict[int, int] = {}  # device index -> shared memory bytes a block may take


def engages(device, shards: int, tie_break: str, fit_scorer) -> bool:
    """Whether a spread chunk's random loop runs in the kernel: on a CUDA
    device, unsharded, in random mode, with a fit scorer it computes."""
    return (torch.device(device).type == "cuda" and shards == 1 and tie_break == "random"
            and fit_scorer in SCORERS)


def _declare(lib):
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.grouped_spread_words.argtypes = []
    lib.grouped_spread_words.restype = i
    lib.grouped_spread_workspace.argtypes = [q, q]
    lib.grouped_spread_workspace.restype = q
    if hasattr(lib, "grouped_spread_launch"):
        lib.grouped_spread_launch.argtypes = [p]
        lib.grouped_spread_launch.restype = i
        lib.grouped_spread_smem_limit.argtypes = [i]
        lib.grouped_spread_smem_limit.restype = i
        lib.grouped_spread_prepare.argtypes = [i, i]
        lib.grouped_spread_prepare.restype = i
    if lib.grouped_spread_words() != W_WORDS:
        raise KernelError(f"grouped_spread takes {lib.grouped_spread_words()} words, "
                          f"the wrapper packs {W_WORDS}")
    return lib


def _load():
    global _lib, _raw_stream
    if _lib is None:
        from .. import build

        lib = _declare(build.load("grouped_spread"))
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda idx: torch.cuda.current_stream(idx).cuda_stream
        )
        _lib = lib
    return _lib


def smem_limit(device: torch.device) -> int:
    """The shared memory a block of the kernel may take on a CUDA device;
    the first call for a device lets the kernel take all of it."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    lim = _smem.get(idx)
    if lim is None:
        lib = _load()
        lim = lib.grouped_spread_smem_limit(idx)
        if lim < 0:
            raise KernelError(f"cannot query shared memory of cuda:{idx}")
        rc = lib.grouped_spread_prepare(idx, lim)
        if rc != 0:
            raise KernelError(f"grouped_spread: cudaFuncSetAttribute failed: cudaError {rc}")
        _smem[idx] = lim
    return lim


def _check(name, t, dtype, n, dev):
    if t.dtype != dtype or t.device != dev or t.dim() != 1 or t.shape[0] != n or (
            n and t.stride(0) != 1):
        raise ValueError(f"grouped_spread: {name} must be a contiguous [{n}] {dtype} tensor "
                         f"on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_rows(name, t, n, dev):
    if (t.dtype != torch.int64 or t.device != dev or t.dim() != 2 or t.shape[0] < 2
            or t.shape[1] != n or (n and t.stride(1) != 1)):
        raise ValueError(f"grouped_spread: {name} must be [>=2, {n}] int64 rows on {dev}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


class Launch:
    """One chunk's packed launch words, which point at the caller's
    tensors. ``workspace`` is the loop's arrays in a device buffer where
    ``smem`` is 0: freed with the Launch, its memory goes back to the
    caching allocator on the stream the kernel runs on, so a later
    allocation reuses it only behind the kernel."""

    def __init__(self, lib, *, state, cur: int, skip: int, vcnt: int, group: int, skew: int,
                 d_present: int, cap, base, counted_dom, dom, hk, present, alloc, nonzero_used,
                 nz, fit_weights, static_row, fit_scorer, fdtype, w_fit: int, w_balanced: int,
                 m, asg, counts, smem: int, threads: int = THREADS):
        dev = cap.device
        n, d_pad = cap.shape[0], present.shape[0]
        for name, t, dtype, size in (
                ("cap", cap, torch.int32, n), ("base", base, torch.int32, n),
                ("counted_dom", counted_dom, torch.int32, n), ("dom", dom, torch.int32, n),
                ("hk", hk, torch.bool, n), ("present", present, torch.bool, d_pad),
                ("nz", nz, torch.int64, 2), ("fit_weights", fit_weights, torch.int64, 2),
                ("m", m, torch.int32, n), ("asg", asg, torch.int64, group),
                ("counts", counts, torch.int64, 2), ("state", state, torch.int64, 6)):
            _check(name, t, dtype, size, dev)
        if static_row is not None:
            _check("static_row", static_row, torch.int32, n, dev)
        _check_rows("alloc", alloc, n, dev)
        _check_rows("nonzero_used", nonzero_used, n, dev)
        if fit_scorer not in SCORERS:
            raise ValueError("grouped_spread: the fit scorer is LeastAllocated or MostAllocated")
        if fdtype not in (torch.float64, torch.float32):
            raise ValueError(f"grouped_spread: BalancedAllocation in float64 or float32, "
                             f"not {fdtype}")
        if threads % 32 or not 32 <= threads <= 1024:
            raise ValueError(f"grouped_spread: {threads} threads (a multiple of 32, at most 1,024)")
        if cur not in (0, 2) or skip < 0 or not 0 < vcnt <= group:
            raise ValueError(f"grouped_spread: key slot {cur}, {skip} owed splits, "
                             f"{vcnt} of {group} pods")
        nbytes = lib.grouped_spread_workspace(n, d_pad)
        self.smem = nbytes if nbytes <= smem else 0
        self.workspace = None
        if not self.smem:
            self.workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        w = [0] * W_WORDS
        w[W_N], w[W_DPAD], w[W_GROUP], w[W_VCNT] = n, d_pad, group, vcnt
        w[W_SKEW], w[W_DPRESENT], w[W_SKIP], w[W_CUR] = int(skew), int(d_present), skip, cur
        w[W_MOST], w[W_F64] = SCORERS[fit_scorer], int(fdtype == torch.float64)
        w[W_WFIT], w[W_WBAL] = w_fit, w_balanced
        w[W_STATE], w[W_CAP], w[W_BASE] = state.data_ptr(), cap.data_ptr(), base.data_ptr()
        w[W_CDOM], w[W_DOM], w[W_HK] = counted_dom.data_ptr(), dom.data_ptr(), hk.data_ptr()
        w[W_PRESENT], w[W_ALLOC], w[W_ALLOC_STRIDE] = (present.data_ptr(), alloc.data_ptr(),
                                                        alloc.stride(0))
        w[W_NZU], w[W_NZU_STRIDE] = nonzero_used.data_ptr(), nonzero_used.stride(0)
        w[W_NZ], w[W_FITW] = nz.data_ptr(), fit_weights.data_ptr()
        w[W_SROW] = 0 if static_row is None else static_row.data_ptr()
        w[W_M], w[W_ASG], w[W_COUNTS] = m.data_ptr(), asg.data_ptr(), counts.data_ptr()
        w[W_WORK] = 0 if self.workspace is None else self.workspace.data_ptr()
        w[W_SMEM], w[W_THREADS] = self.smem, threads
        self.words = (ctypes.c_longlong * W_WORDS)(*w)
        self.device = dev

    def launch(self) -> None:
        """The kernel on the device's current stream."""
        global LAUNCHES
        dev = self.device
        self.words[W_STREAM] = _raw_stream(
            dev.index if dev.index is not None else torch.cuda.current_device())
        rc = _lib.grouped_spread_launch(ctypes.addressof(self.words))
        if rc != 0:
            raise KernelError(f"grouped_spread kernel launch failed: cudaError {rc}")
        LAUNCHES += 1


def spread_loop(stream, **kw) -> None:
    """One spread chunk's random loop on the card, drawing from the threefry
    ``stream`` (``ops/threefry.py``, on the card): its owed splits are paid
    and it holds the iteration's subkey afterwards. ``kw``: ``Launch``'s
    inputs and outputs but the stream's."""
    if stream.device.type != "cuda":
        raise ValueError(f"grouped_spread runs on the card, not {stream.device}")
    lib = _load()
    Launch(lib, state=stream.state, cur=stream.cur, skip=stream.pending,
           smem=smem_limit(kw["cap"].device), **kw).launch()
    stream.pending = 0
    stream.has_sub = True
