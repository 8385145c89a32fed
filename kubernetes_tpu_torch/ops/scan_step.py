"""The exact solver's per-pod scan step in one launch: the CUDA kernel's
wrapper.

The scan step (``solver/exact.py`` ``_make_step`` over ``_mask_and_score``)
filters and scores every node for one pod, picks a node among the best and
adds the pod's take rows into the carried state there. In PyTorch that is
about 115 small kernels a pod, which the step graphs (``solver/graphs.py``)
replay as one graph launch but the card still runs one after another.
``csrc/scan_step.cu`` computes all of it after the domain totals in one
launch of a thread-block cluster; its source note has the design and what
bounds it. The step's
``domain_counts`` aggregations stay launches of their own in front of it, the
same launches of the same prepared ``Aggregation`` the torch step makes
(``ops/spread.py`` ``prepared``, ``ops/interpod.py`` ``prepared_totals``),
and the kernel reads their outputs.

The plain version is the torch step itself, which the CPU takes:
``engages`` is true only on a CUDA device, with one shard, with no
nominated pods, for a fit scorer the kernel computes (LeastAllocated or
MostAllocated; not RequestedToCapacityRatio). Where it is true the wrapper
launches the kernel or raises ``build.KernelError``; there is no fallback.
A class's constraint slots (its hard and soft spread constraints and its
InterPodAffinity term lists, of any number) reach the kernel as a table of
words in a device buffer that the ``Step`` keeps for the class.

A launch reads the pod's row either from the row tensors it is given (an
eager step) or, in a step replayed from a CUDA graph, from the graphs'
packed row buffer at the step table's device cursor, which it advances; it
writes the assignment, pays the stream's owed splits (the launch's, and the
table's in a replayed step) and leaves the next key in the stream's live
slot. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import KernelError
from . import interpod as ip
from . import noderesources as nr
from . import spread as sp

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

# the cluster: up to 8 blocks (the portable cluster size), each of at least
# NODES_PER_BLOCK nodes where there are enough, one thread a node and one more
# warp for the draw, at most 1,024 threads (the kernel takes any multiple of
# 32 up to that)
MAX_BLOCKS = 8
NODES_PER_BLOCK = 512
THREADS = 1024

# the fit scorers the kernel computes, by the code it takes
SCORERS = {nr.least_allocated_score: 0, nr.most_allocated_score: 1}

(W_N, W_K, W_V, W_J, W_TI, W_TE, W_FLAGS,
 W_I64, W_I64_STRIDE, W_I32, W_I32_STRIDE,
 W_ALLOC, W_ALLOC_STRIDE, W_MAXPODS, W_VALID, W_SMASK, W_TAINT, W_NODEAFF, W_IMAGE, W_EXTRA,
 W_FITW, W_LOGTAB,
 W_WFIT, W_WBAL, W_WTAINT, W_WNODEAFF, W_WIMAGE, W_WSPREAD, W_WINTERPOD,
 W_IN_TOT, W_IN_TOT_STRIDE, W_EX_TOT, W_EX_TOT_STRIDE, W_IN_HK, W_IN_HK_STRIDE,
 W_EX_HK, W_EX_HK_STRIDE, W_EX_ANTI,
 W_TAKE64, W_TAKE32, W_REQ_MASK, W_CONFLICT, W_M_ANTI, W_M_W, W_SELF_AFF, W_ROW_STRIDE,
 W_STEPS, W_STEPS_STRIDE, W_CURSOR, W_POD, W_ASG,
 W_STATE, W_CUR, W_SKIP,
 W_WORK, W_SMEM, W_THREADS, W_BLOCKS, W_STREAM,
 W_NHARD, W_NSOFT, W_NANTI, W_NAFF, W_NPREF, W_SLOTS, W_HSLOTS,
 W_WORDS) = range(67)

F_FIT, F_PORTS, F_IPA, F_IPA_FILTER, F_IPA_SCORE, F_MOST, F_F64, F_RANDOM = (
    1, 2, 4, 8, 16, 32, 64, 128)

# the pod row's arrays, by the launch word that points at each
ROW_WORDS = (("take64", W_TAKE64), ("take32", W_TAKE32), ("req_mask", W_REQ_MASK),
             ("pod_conflict", W_CONFLICT), ("ipa_m_anti", W_M_ANTI), ("ipa_m_w", W_M_W),
             ("ipa_self_aff", W_SELF_AFF))

_lib = None
_raw_stream = None
_smem: dict[int, int] = {}  # device index -> shared memory bytes a block may take


def engages(device, shards: int, use_nominated: bool, fit_scorer) -> bool:
    """Whether the scan steps run in the kernel: on a CUDA device,
    unsharded, with no nominated pods, with a fit scorer it computes."""
    return (torch.device(device).type == "cuda" and shards == 1 and not use_nominated
            and fit_scorer in SCORERS)


def _declare(lib):
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.scan_step_words.argtypes = []
    lib.scan_step_words.restype = i
    lib.scan_step_scratch.argtypes = []
    lib.scan_step_scratch.restype = q
    lib.scan_step_workspace.argtypes = [q, q]
    lib.scan_step_workspace.restype = q
    if hasattr(lib, "scan_step_launch"):
        lib.scan_step_launch.argtypes = [p]
        lib.scan_step_launch.restype = i
        lib.scan_step_smem_limit.argtypes = [i]
        lib.scan_step_smem_limit.restype = i
        lib.scan_step_prepare.argtypes = [i, i]
        lib.scan_step_prepare.restype = i
    if lib.scan_step_words() != W_WORDS:
        raise KernelError(f"scan_step takes {lib.scan_step_words()} words, "
                          f"the wrapper packs {W_WORDS}")
    return lib


def _load():
    global _lib, _raw_stream
    if _lib is None:
        from .. import build

        lib = _declare(build.load("scan_step"))
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda idx: torch.cuda.current_stream(idx).cuda_stream
        )
        _lib = lib
    return _lib


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def smem_limit(device: torch.device) -> int:
    """The shared memory a block of the kernel may take on a CUDA device
    (0 elsewhere); the first call for a device lets the kernel take all of
    it."""
    if device.type != "cuda":
        return 0
    idx = _index(device)
    lim = _smem.get(idx)
    if lim is None:
        lib = _load()
        lim = lib.scan_step_smem_limit(idx)
        if lim < 0:
            raise KernelError(f"cannot query shared memory of cuda:{idx}")
        rc = lib.scan_step_prepare(idx, lim)
        if rc != 0:
            raise KernelError(f"scan_step: cudaFuncSetAttribute failed: cudaError {rc}")
        _smem[idx] = lim
    return lim


def shape(n: int) -> tuple[int, int]:
    """(blocks, threads a block) of the cluster for ``n`` nodes."""
    blocks = min(MAX_BLOCKS, max(1, -(-n // NODES_PER_BLOCK)))
    per_block = -(-n // blocks)
    return blocks, min(THREADS, 32 * (-(-per_block // 32) + 1))


def _check(name, t, dtype, shape, dev):
    if (t.dtype != dtype or t.device != dev or tuple(t.shape) != tuple(shape)
            or (t.numel() and t.stride(-1) != 1)):
        raise ValueError(f"scan_step: {name} must be a {list(shape)} {dtype} tensor on {dev} "
                         f"with unit stride on its last axis, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def _row(t, cls: int) -> int:
    return t.data_ptr() + cls * t.stride(0) * t.element_size()


def _slots(a) -> list[int]:
    return [int(j) for j in a if j >= 0]


class Step:
    """The fused scan step of one unsharded solve's ``tables`` over the
    carried state ``st`` (``_Run.state_views``) and its packed tensors
    ``packed`` (``{"i64": ..., "i32": ...}``), with the pipeline's
    keywords ``kw`` (``_mask_and_score``'s), tie-break ``tie_break`` and
    fit scorer ``scorer`` (one of ``SCORERS``). A call steps one pod
    eagerly; ``replayed`` launches the step a CUDA graph captures, which
    reads its pod at the step table's cursor."""

    def __init__(self, tables, st, packed, kw, tie_break: str, scorer):
        self.tables, self.st, self.kw = tables, st, kw
        self.random = tie_break == "random"
        if scorer not in SCORERS:
            raise ValueError("scan_step: the fit scorer is LeastAllocated or MostAllocated")
        fdtype = kw["fdtype"]
        if fdtype not in (torch.float64, torch.float32):
            raise ValueError(f"scan_step: BalancedAllocation in float64 or float32, not {fdtype}")
        i64, i32 = packed["i64"], packed["i32"]
        alloc = tables["alloc"]
        dev = alloc.device
        k, n = alloc.shape
        blocks, threads = shape(n)
        v, j, ti, te = (st[name].shape[0] for name in ("port_used", "spr_cnt", "ipa_in",
                                                       "ipa_ex"))
        c = tables["static_mask"].shape[0]
        _check("alloc", alloc, torch.int64, (k, n), dev)
        _check("i64", i64, torch.int64, (k + 2, n), dev)
        _check("i32", i32, torch.int32, (1 + v + j + ti + te, n), dev)
        _check("static_mask", tables["static_mask"], torch.bool, (c, n), dev)
        _check("node_valid", tables["node_valid"], torch.bool, (n,), dev)
        _check("max_pods", tables["max_pods"], torch.int32, (n,), dev)
        _check("fit_weights", tables["fit_weights"], torch.int64, (2,), dev)
        for name in ("taint_cnt", "nodeaff_pref", "image_score", "extra_score"):
            if name in tables:
                _check(name, tables[name], torch.int32, (c, n), dev)
        if k < 2:
            raise ValueError(f"scan_step: {k} resource rows, cpu and memory at least")
        lib = _load()
        self.device = dev
        spr, ipa = tables["spr"], tables["ipa"]
        # the workspace holds the minima of as many hard constraints as a
        # class may have
        hslots = spr["hard"].shape[1] if kw["use_spread"] else 0
        scratch = lib.scan_step_scratch()
        nbytes = lib.scan_step_workspace(-(-n // blocks), hslots)
        in_smem = scratch + nbytes <= smem_limit(dev)
        self.smem = scratch + nbytes if in_smem else scratch
        # the per-node arrays in a device buffer, a block's share after
        # another's, where shared memory cannot hold them (freed with the
        # Step; a graph keeps its Step)
        self.workspace = (None if in_smem else
                          torch.empty(nbytes * blocks, dtype=torch.uint8, device=dev))
        logn = max([n] + [int(d) for d in spr["n_dom_host"]])
        w = [0] * W_WORDS
        w[W_N], w[W_K], w[W_V], w[W_J], w[W_TI], w[W_TE] = n, k, v, j, ti, te
        w[W_I64], w[W_I64_STRIDE] = i64.data_ptr(), i64.stride(0)
        w[W_I32], w[W_I32_STRIDE] = i32.data_ptr(), i32.stride(0)
        w[W_ALLOC], w[W_ALLOC_STRIDE] = alloc.data_ptr(), alloc.stride(0)
        w[W_MAXPODS] = tables["max_pods"].data_ptr()
        w[W_VALID] = tables["node_valid"].data_ptr()
        w[W_FITW] = tables["fit_weights"].data_ptr()
        # log(k + 2) for k in [0, logn] by torch.log in the configured type:
        # the soft spread score's log term, whose size is a domain count or
        # the feasible count, as the torch step computes it
        self.logtab = torch.log(torch.arange(logn + 1, dtype=fdtype, device=dev) + 2.0)
        w[W_LOGTAB] = self.logtab.data_ptr()
        w[W_WFIT], w[W_WBAL], w[W_WTAINT], w[W_WNODEAFF] = (
            kw["w_fit"], kw["w_balanced"], kw["w_taint"], kw["w_nodeaff"])
        w[W_WIMAGE], w[W_WSPREAD], w[W_WINTERPOD] = kw["w_image"], kw["w_spread"], kw["w_interpod"]
        if kw["use_interpod"]:
            if kw["ipa_ident"]:
                # every row hostname-unique: the carried counts are the totals
                w[W_IN_TOT], w[W_IN_TOT_STRIDE] = st["ipa_in"].data_ptr(), st["ipa_in"].stride(0)
                w[W_EX_TOT], w[W_EX_TOT_STRIDE] = st["ipa_ex"].data_ptr(), st["ipa_ex"].stride(0)
            for name, rows, word in (("in_hk", ti, W_IN_HK), ("ex_hk", te, W_EX_HK)):
                _check(name, ipa[name], torch.bool, (rows, n), dev)
                w[word], w[word + 1] = ipa[name].data_ptr(), ipa[name].stride(0)
            _check("ex_anti", ipa["ex_anti"], torch.bool, (te,), dev)
            w[W_EX_ANTI] = ipa["ex_anti"].data_ptr()
        w[W_WORK] = 0 if self.workspace is None else self.workspace.data_ptr()
        w[W_SMEM], w[W_THREADS], w[W_BLOCKS] = self.smem, threads, blocks
        w[W_HSLOTS] = hslots
        if self.random:
            w[W_FLAGS] |= F_RANDOM
        if fdtype == torch.float64:
            w[W_FLAGS] |= F_F64
        if SCORERS[scorer]:
            w[W_FLAGS] |= F_MOST
        disabled = kw["disabled"]
        if "NodeResourcesFit" not in disabled:
            w[W_FLAGS] |= F_FIT
        if kw["use_interpod"]:
            w[W_FLAGS] |= F_IPA
            if "InterPodAffinity" not in disabled:
                w[W_FLAGS] |= F_IPA_FILTER
            if kw["ipa_score"] and kw["w_interpod"] > 0:
                w[W_FLAGS] |= F_IPA_SCORE
        self.base = w
        self.classes: dict[int, tuple] = {}
        self.slots: dict[int, tuple] = {}  # class -> (words, table, its host copy)
        self.outs: list = []  # the last step's aggregation outputs

    # -- a class's slots and aggregations --

    def _plan(self, cls: int) -> tuple:
        """(hard slots, soft slots, anti, affinity, preferred terms) of
        ``cls``: the constraint slots its step reads."""
        hit = self.classes.get(cls)
        if hit is None:
            kw, spr, ipa = self.kw, self.tables["spr"], self.tables["ipa"]
            hard = soft = ()
            if kw["use_spread"] and "PodTopologySpread" not in kw["disabled"]:
                hard = _slots(spr["hard"][cls])
            if (kw["use_spread"] and kw["w_spread"] and kw["spread_soft"]
                    and spr["soft"][cls, 0] >= 0):
                soft = _slots(spr["soft"][cls])
            anti = aff = pref = ()
            if kw["use_interpod"]:
                anti, aff = _slots(ipa["cls_req_anti"][cls]), _slots(ipa["cls_req_aff"][cls])
                if kw["ipa_score"] and kw["w_interpod"] > 0:
                    pref = _slots(ipa["cls_pref"][cls])
            hit = self.classes[cls] = (hard, soft, anti, aff, pref)
        return hit

    def _table(self, cls: int, words: list) -> int:
        """The address of ``cls``'s slot table holding ``words``: the one
        kept for the class while its words stay the same (on the card, the
        prepared aggregations' outputs do), else a new one, copied from
        pinned memory without a wait. A captured step finds its class's
        table made by the class's eager warm-up step."""
        hit = self.slots.get(cls)
        if hit is None or hit[0] != words:
            host = torch.tensor(words or [0], dtype=torch.int64)
            if self.device.type == "cuda":
                if torch.cuda.is_current_stream_capturing():
                    raise KernelError(f"scan_step: class {cls}'s slot table made inside a "
                                      f"capture; its eager step comes first")
                host = host.pin_memory()
            hit = self.slots[cls] = (words, host.to(self.device, non_blocking=True), host)
        return hit[1].data_ptr()

    def _words(self, cls: int, hpc: bool) -> list:
        """The launch words of a step of ``cls``: the step's domain_counts
        aggregations launched, in the torch step's order (the hard spread
        constraints, both InterPodAffinity tables, the soft spread
        constraints), and their outputs in the words or the class's slot
        table. On the card the outputs are the prepared aggregations' own;
        on the CPU each call makes new ones, which ``outs`` keeps until the
        next step."""
        hard, soft, anti, aff, pref = self._plan(cls)
        kw, tables, st = self.kw, self.tables, self.st
        spr, ipa = tables["spr"], tables["ipa"]
        w, outs, slots = list(self.base), [], []
        for j in hard:
            _, agg, present, _, hk = sp.prepared(spr, j, st["spr_cnt"], kw["d_pad"])
            ((out, tot),) = agg()
            outs += [out, tot]
            md = int(spr["min_domains"][j])
            slots += [tot.data_ptr(), out.data_ptr(), present.data_ptr(), hk.data_ptr(),
                      present.shape[0], int(spr["max_skew"][j]), int(spr["self_match"][j]),
                      int(md >= 0 and spr["n_dom_host"][j] < md)]
        if kw["use_interpod"] and not kw["ipa_ident"]:
            (_, in_tot), (_, ex_tot) = ip.prepared_totals(
                ipa, st["ipa_in"], st["ipa_ex"], kw["ipa_d_pad"])()
            outs += [in_tot, ex_tot]
            w[W_IN_TOT], w[W_IN_TOT_STRIDE] = in_tot.data_ptr(), in_tot.stride(0)
            w[W_EX_TOT], w[W_EX_TOT_STRIDE] = ex_tot.data_ptr(), ex_tot.stride(0)
        for j in soft:
            _, agg, _, _, hk = sp.prepared(spr, j, st["spr_cnt"], kw["d_pad"])
            ((_, tot),) = agg()
            outs.append(tot)
            host = bool(spr["is_hostname"][j])
            slots += [st["spr_cnt"][j].data_ptr() if host else tot.data_ptr(), hk.data_ptr(),
                      int(host), int(spr["n_dom_host"][j]), int(spr["max_skew"][j])]
        slots += [*anti, *aff, *pref, *(int(ipa["in_pref_w"][j]) for j in pref)]
        w[W_NHARD], w[W_NSOFT], w[W_NANTI], w[W_NAFF], w[W_NPREF] = (
            len(hard), len(soft), len(anti), len(aff), len(pref))
        w[W_SLOTS] = self._table(cls, slots)
        w[W_SMASK] = _row(tables["static_mask"], cls)
        for name, word in (("taint_cnt", W_TAINT), ("nodeaff_pref", W_NODEAFF),
                           ("image_score", W_IMAGE), ("extra_score", W_EXTRA)):
            if name in tables and (name != "extra_score" or kw["use_extra_score"]):
                w[word] = _row(tables[name], cls)
        if hpc and "NodePorts" not in kw["disabled"]:
            w[W_FLAGS] |= F_PORTS
        self.outs = outs
        return w

    # -- launches --

    def _launch(self, w: list, stream) -> None:
        """The kernel on the device's current stream, drawing from
        ``stream`` in random mode (its owed splits paid)."""
        global LAUNCHES
        if self.random:
            w[W_STATE], w[W_CUR], w[W_SKIP] = stream.state.data_ptr(), stream.cur, stream.pending
        words = (ctypes.c_longlong * W_WORDS)(*w)
        self._emit(words, stream)
        if self.random:
            stream.pending = 0
        LAUNCHES += 1

    def _emit(self, words, stream) -> None:
        dev = self.device
        words[W_STREAM] = _raw_stream(_index(dev))
        rc = _lib.scan_step_launch(ctypes.addressof(words))
        if rc != 0:
            raise KernelError(f"scan_step kernel launch failed: cudaError {rc}")

    def __call__(self, x: dict, pod: int, asg: torch.Tensor, stream) -> None:
        """One eager step of the pod whose rows ``x`` holds (device row
        tensors, ``class_of`` and ``has_port_conflicts``): its assignment
        into ``asg[pod]``."""
        w = self._words(x["class_of"], x["has_port_conflicts"])
        for name, word in ROW_WORDS:
            w[word] = x[name].data_ptr()
        w[W_POD], w[W_ASG] = pod, asg.data_ptr()
        self._launch(w, stream)

    def replayed(self, cls: int, hpc: bool, stream, rows: torch.Tensor, layout: tuple,
                 steps: torch.Tensor, cursor: torch.Tensor, asg: torch.Tensor) -> None:
        """The step of a CUDA graph of signature (``cls``, ``hpc``): its pod
        is read at the step table ``steps``' column ``cursor`` (row, pod,
        owed splits) from the packed rows ``rows`` of ``layout``
        (``graphs.row_layout``), its assignment goes into ``asg`` and the
        cursor advances."""
        w = self._words(cls, hpc)
        offsets = {name: off for name, _, _, off, _ in layout}
        for name, word in ROW_WORDS:
            w[word] = rows.data_ptr() + offsets[name]
        w[W_ROW_STRIDE] = rows.stride(0)
        w[W_STEPS], w[W_STEPS_STRIDE] = steps.data_ptr(), steps.stride(0)
        w[W_CURSOR], w[W_ASG] = cursor.data_ptr(), asg.data_ptr()
        self._launch(w, stream)

