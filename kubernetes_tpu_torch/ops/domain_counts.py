"""Per-(term, domain) count aggregation: the CUDA kernel and its plain versions.

    out[t, d] = sum_n cnt[t, n] * [dom[t, n] == d],   lanes with dom < 0 excluded
    tot[t, n] = out[t, max(gdom[t, n], 0)]            (gdom defaults to dom)

``out`` is the TPU kernel's function; ``tot`` is the per-node gather its
callers run after it, with the JAX package's clamped index (a node without
the key reads bin 0, and every caller masks it by ``has_key``).
InterPodAffinity aggregates its ``in`` and ``ex`` tables in one launch per
scan step and reads only ``tot`` (ops/interpod.py); PodTopologySpread
aggregates one constraint row per launch and reads both (ops/spread.py).

Kernel: ``csrc/domain_counts.cu``, hand-written for Hopper. It replaces the
TPU kernel ``kubernetes_tpu/ops/pallas_kernels.py:96`` (domain_counts_pallas,
a one-hot MXU contraction in f32) with one thread-block cluster per term
row whose histogram lives in the cluster's distributed shared memory: int32
atomics, exact and independent of order, so the kernel equals the plain
version bit for bit. Beyond a cluster's capacity (about 464 k bins on an
H100) the histogram lives in ``out`` itself (the global path).

What bounds it: memory. It reads T*N*8 bytes (plus T*N*4 for a separate
gather row) and writes T*d_pad*4 and T*N*4 bytes, at 3.35 TB/s on an H100
SXM; at the scan's shapes that is under a microsecond, so the launch sets
its time, and the design makes each aggregation one launch.

``Aggregation``, ``aggregate`` and ``domain_counts`` take the plain
versions only for tensors on the CPU. On a CUDA tensor they launch the kernel or raise; there
is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import KernelError

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

# the fewest lanes a block of a cluster takes before the row is spread over
# more blocks (PERF.md has the cluster sizes measured at the main path's shape)
MIN_LANES = 512
MAX_CLUSTER = 8  # the portable cluster size

_lib = None
_raw_stream = None
_devices: dict[int, tuple[int, int]] = {}  # index -> (smem bytes per block, SMs)



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


def gather_plain(out: torch.Tensor, gdom: torch.Tensor) -> torch.Tensor:
    """The plain per-node gather: ``out[t, max(gdom[t, n], 0)]``, the JAX
    package's ``take_along_axis`` over the clamped domain index."""
    return torch.gather(out, 1, torch.clamp(gdom, min=0).to(torch.int64))


def aggregate_plain(sets, d_pad: int, *, counts: bool = True, gather: bool = True):
    """The plain version of ``aggregate``: ``index_add_`` per set, then
    ``gather``."""
    res = []
    for dom, cnt, gdom in sets:
        out = domain_counts_plain(dom, cnt, d_pad)
        tot = gather_plain(out, dom if gdom is None else gdom) if gather else None
        res.append((out if counts else None, tot))
    return res


def _load():
    global _lib, _raw_stream
    if _lib is None:
        from .. import build

        lib = build.load("domain_counts")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.domain_counts_launch.argtypes = [p]
        lib.domain_counts_launch.restype = i
        lib.domain_counts_smem_limit.argtypes = [i]
        lib.domain_counts_smem_limit.restype = i
        lib.domain_counts_prepare.argtypes = [i, i]
        lib.domain_counts_prepare.restype = i
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda idx: torch.cuda.current_stream(idx).cuda_stream
        )
        _lib = lib
    return _lib


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def device_limits(device: torch.device) -> tuple[int, int]:
    """(shared memory bytes a block may use, SM count) of a CUDA device;
    the first call for a device also lets the kernel use all of that
    memory (cudaFuncSetAttribute, once per device)."""
    idx = _index(device)
    lim = _devices.get(idx)
    if lim is None:
        lib = _load()
        smem = lib.domain_counts_smem_limit(idx)
        if smem < 0:
            raise KernelError(f"cannot query shared memory of cuda:{idx}")
        rc = lib.domain_counts_prepare(idx, smem)
        if rc != 0:
            raise KernelError(f"domain_counts: cudaFuncSetAttribute failed: cudaError {rc}")
        lim = (smem, torch.cuda.get_device_properties(idx).multi_processor_count)
        _devices[idx] = lim
    return lim


def plan(rows: int, n: int, d_pad: int, smem: int, sms: int) -> tuple[int, bool]:
    """(cluster size, global path) for ``rows`` term rows of ``n`` lanes and
    ``d_pad`` bins on a card with ``smem`` bytes of shared memory per block
    and ``sms`` SMs. The fewest blocks whose slices of the histogram fit in
    shared memory; the global path where eight do not. Then the row is
    spread over more blocks while the grid leaves SMs idle and every block
    keeps at least MIN_LANES lanes."""
    bins = smem // 4
    c = 1
    while c < MAX_CLUSTER and -(-d_pad // c) > bins:
        c *= 2
    is_global = -(-d_pad // c) > bins
    if is_global:
        c = 1
    while c < MAX_CLUSTER and rows * c * 2 <= sms and -(-n // (2 * c)) >= MIN_LANES:
        c *= 2
    return c, is_global


def _check(x: torch.Tensor, shape, device_index: int, contiguous: bool):
    if x.dtype != torch.int32:
        raise TypeError(f"domain_counts wants int32, got {x.dtype}")
    if x.shape != shape:
        raise ValueError(
            f"domain_counts wants [T, N] tensors of one shape, got {tuple(x.shape)} "
            f"and {tuple(shape)}"
        )
    if x.get_device() != device_index:
        raise ValueError(f"domain_counts wants one device, got {x.device}")
    if contiguous and not x.is_contiguous():
        raise ValueError("domain_counts wants contiguous tensors")


class Aggregation:
    """One aggregation over one or two row sets, prepared once and launched
    by each call.

    sets: ``[(dom, cnt, gdom), ...]`` (one or two), each ``[T_s, N]`` int32,
    contiguous, on one device, with the same N; ``gdom`` is the index the
    per-node totals are gathered by, None for ``dom``; dom < d_pad. A call
    returns ``[(out, tot), ...]`` per set: ``out`` [T_s, d_pad] int32 when
    ``counts``, else None; ``tot`` [T_s, N] int32 when ``gather``, else
    None. ``cluster`` forces the cluster size (1, 2, 4 or 8; for
    measurement), where the wrapper would otherwise choose it.

    The checks, the cluster size, the outputs and the launch's packed
    arguments are settled here, once, so that a call on the card costs one
    foreign call -- the scan launches the same aggregation over the same
    tensors every step, whose contents change in place. The card's outputs
    are allocated once and each call overwrites them: read a call's outputs
    (on the launching stream) before the next call. On the CPU each call
    returns the plain versions' new tensors."""

    def __init__(self, sets, d_pad: int, *, counts: bool = True, gather: bool = True,
                 cluster: int | None = None):
        if not 1 <= len(sets) <= 2:
            raise ValueError(f"aggregate takes one or two row sets, got {len(sets)}")
        if d_pad < 1:
            raise ValueError(f"d_pad must be positive, got {d_pad}")
        dom0 = sets[0][0]
        if dom0.dim() != 2:
            raise ValueError(f"domain_counts wants [T, N] tensors, got {tuple(dom0.shape)}")
        on_card = dom0.is_cuda
        idx = dom0.get_device()
        n = dom0.shape[1]
        rows = 0
        for dom, cnt, gdom in sets:
            shape = dom.shape
            if len(shape) != 2 or shape[1] != n:
                raise ValueError("aggregate wants [T, N] row sets with one N")
            for x in (dom, cnt) if gdom is None else (dom, cnt, gdom):
                _check(x, shape, idx, on_card)
            rows += shape[0]
        if not on_card and dom0.device.type != "cpu":
            raise ValueError(f"domain_counts runs on cuda or cpu, not {dom0.device}")
        self.sets, self.d_pad, self.counts, self.gather = list(sets), d_pad, counts, gather
        self._args = None
        self.cluster = self.is_global = None  # the launch's, on the card
        if not on_card:
            return

        c, is_global = plan(rows, n, d_pad, *device_limits(dom0.device))
        if cluster is not None:
            smem = device_limits(dom0.device)[0]
            if cluster not in (1, 2, 4, 8) or (
                not is_global and -(-d_pad // cluster) * 4 > smem
            ):
                raise ValueError(f"cluster size {cluster} cannot hold d_pad {d_pad}")
            c = cluster
        self.cluster, self.is_global = c, is_global
        want_out = counts or is_global
        dev = dom0.device
        out = torch.empty((rows, d_pad), dtype=torch.int32, device=dev) if want_out else None
        tot = torch.empty((rows, n), dtype=torch.int32, device=dev) if gather else None
        t0 = sets[0][0].shape[0]
        if len(sets) == 1:
            self._result = [(out if counts else None, tot)]
        else:
            self._result = [(out[:t0] if counts else None, tot[:t0] if gather else None),
                            (out[t0:] if counts else None, tot[t0:] if gather else None)]
        if rows == 0 or n == 0:
            if want_out:
                out.zero_()
            return
        # pointers into the outputs by row offset (the second set's rows
        # follow the first's); the stream's word is filled in by each call
        words = []
        op = out.data_ptr() if want_out else 0
        tp = tot.data_ptr() if gather else 0
        for dom, cnt, gdom in sets:
            t = dom.shape[0]
            words += [dom.data_ptr(), cnt.data_ptr(),
                      (dom if gdom is None else gdom).data_ptr(), op, tp, t]
            op += t * d_pad * 4 if want_out else 0
            tp += t * n * 4 if gather else 0
        words += [0] * (12 - len(words)) + [n, d_pad, c, int(is_global), 0]
        arr = (ctypes.c_longlong * len(words))(*words)
        self._args = (arr, ctypes.addressof(arr), idx)

    def __call__(self):
        global LAUNCHES
        if self._args is None:
            if not self.sets[0][0].is_cuda:
                return aggregate_plain(self.sets, self.d_pad, counts=self.counts,
                                       gather=self.gather)
            return self._result  # no rows or no nodes: nothing to launch
        arr, addr, idx = self._args
        arr[16] = _raw_stream(idx)
        rc = _lib.domain_counts_launch(addr)
        if rc != 0:
            raise KernelError(f"domain_counts kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
        return self._result


def aggregate(sets, d_pad: int, *, counts: bool = True, gather: bool = True,
              cluster: int | None = None):
    """One aggregation, prepared and launched once (see ``Aggregation``);
    the outputs are the caller's."""
    return Aggregation(sets, d_pad, counts=counts, gather=gather, cluster=cluster)()


def domain_counts(dom: torch.Tensor, cnt: torch.Tensor, d_pad: int) -> torch.Tensor:
    """[T, d_pad] int32 domain totals -- the TPU kernel's function. dom,
    cnt: [T, N] int32, contiguous, on one device; dom < d_pad (-1 = the
    node lacks the key)."""
    return aggregate([(dom, cnt, None)], d_pad, gather=False)[0][0]
