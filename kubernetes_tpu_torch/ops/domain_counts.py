"""Per-(term, domain) count aggregation: the CUDA kernel and its plain version.

    out[t, d] = sum_n cnt[t, n] * [dom[t, n] == d],   lanes with dom < 0 excluded

InterPodAffinity runs it twice per scan step when the batch's topologies
share domains (ops/interpod.py), and PodTopologySpread runs it one row at a
time for its domain counts and domain presence (ops/spread.py).

Kernel: ``csrc/domain_counts.cu``, hand-written for Hopper. It replaces the
TPU kernel ``kubernetes_tpu/ops/pallas_kernels.py:96`` (domain_counts_pallas,
a one-hot MXU contraction in f32) with a shared-memory histogram per
(term row, node chunk) built with int32 atomics, flushed into ``out`` with
global atomics; where ``d_pad`` bins exceed a block's shared memory it adds
straight into ``out`` in global memory. Integer atomics are exact and
independent of order, so the kernel equals the plain version bit for bit.

What bounds it: memory. It reads T*N*8 bytes and writes T*d_pad*4 bytes, at
3.35 TB/s on an H100 SXM; the histogram keeps the per-lane adds on chip, so
device memory sees one atomic per nonzero bin per block.

``domain_counts`` takes the plain version only for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

# nodes per block: enough lanes per block to amortise zeroing and flushing
# the d_pad-bin histogram, few enough blocks per row to keep the SMs busy
CHUNK = 2048

_lib = None
_smem_limit: dict[int, int] = {}


def domain_counts_plain(dom: torch.Tensor, cnt: torch.Tensor, d_pad: int) -> torch.Tensor:
    """The plain version: one flattened ``index_add_`` over t * d_pad
    segments in int64, cast to int32 -- the formulation of
    ``domain_counts_reference`` in the JAX package."""
    t = dom.shape[0]
    hk = dom >= 0
    dd = torch.where(hk, dom, 0).to(torch.int64)
    seg = (dd + torch.arange(t, device=dom.device)[:, None] * d_pad).reshape(-1)
    out = torch.zeros(t * d_pad, dtype=torch.int64, device=dom.device)
    out.index_add_(0, seg, torch.where(hk, cnt, 0).reshape(-1).to(torch.int64))
    return out.reshape(t, d_pad).to(torch.int32)


def _load():
    global _lib
    if _lib is None:
        from .. import build

        lib = build.load("domain_counts")
        lib.domain_counts_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.domain_counts_launch.restype = ctypes.c_int
        lib.domain_counts_smem_limit.argtypes = [ctypes.c_int]
        lib.domain_counts_smem_limit.restype = ctypes.c_int
        _lib = lib
    return _lib


def uses_shared_memory(d_pad: int, device: torch.device) -> bool:
    """True when a d_pad-bin int32 histogram fits in one block's shared
    memory on ``device`` (227 KB on Hopper): the kernel's shared path."""
    lib = _load()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        limit = lib.domain_counts_smem_limit(idx)
        if limit < 0:
            raise RuntimeError(f"cannot query shared memory of cuda:{idx}")
        _smem_limit[idx] = limit
    return d_pad * 4 <= _smem_limit[idx]


def domain_counts(dom: torch.Tensor, cnt: torch.Tensor, d_pad: int) -> torch.Tensor:
    """[T, d_pad] int32 domain totals. dom, cnt: [T, N] int32, contiguous,
    on one device; dom < d_pad (-1 = the node lacks the key)."""
    global LAUNCHES
    if dom.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"domain_counts wants int32, got {dom.dtype} and {cnt.dtype}")
    if dom.dim() != 2 or dom.shape != cnt.shape:
        raise ValueError(
            f"domain_counts wants two [T, N] tensors, got {tuple(dom.shape)} "
            f"and {tuple(cnt.shape)}"
        )
    if dom.device != cnt.device:
        raise ValueError(f"dom on {dom.device}, cnt on {cnt.device}")
    if d_pad < 1:
        raise ValueError(f"d_pad must be positive, got {d_pad}")
    if dom.device.type == "cpu":
        return domain_counts_plain(dom, cnt, d_pad)
    if dom.device.type != "cuda":
        raise ValueError(f"domain_counts runs on cuda or cpu, not {dom.device}")
    if not (dom.is_contiguous() and cnt.is_contiguous()):
        raise ValueError("domain_counts wants contiguous tensors")
    t, n = dom.shape
    out = torch.zeros((t, d_pad), dtype=torch.int32, device=dom.device)
    if t == 0 or n == 0:
        return out
    if t > 65535:
        raise ValueError(f"domain_counts takes at most 65535 term rows, got {t}")
    lib = _load()
    smem = uses_shared_memory(d_pad, dom.device)
    rc = lib.domain_counts_launch(
        dom.data_ptr(), cnt.data_ptr(), out.data_ptr(), t, n, d_pad, CHUNK,
        int(smem), torch.cuda.current_stream(dom.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"domain_counts kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
