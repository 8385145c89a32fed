"""CUDA graphs of the exact solver's per-pod scan step and of the grouped
random loop's iterations.

The scan step (``exact._make_step``: the filter and score pipeline, the
tie-break pick and the assume scatter) issues about 110 small kernels a pod
from Python, each of which runs for about a microsecond on the card, so the
host's issue sets the scan's pace. ``StepGraphs`` captures the step into a
CUDA graph once per *signature* and replays it with one graph launch a pod:
the same kernels in the same order, so a replayed step gives what the eager
step gives, bit for bit. Where the fused step kernel engages
(``ops/scan_step.py``), the eager step and the captured one are the step's
``domain_counts`` launches and one launch of that kernel, which reads the
step table at the cursor, writes the pick and advances the cursor itself.

Signature: what the step branches on in host code, the pod's ``class_of``
and ``has_port_conflicts``, and in random mode the stream's live key slot
(``tf.Stream.cur``, which a grouped split moves). The pipeline flags, the
tie-break and the tables are fixed within an *epoch* of graphs (below).

Per-pod inputs are device data. Each run uploads its pod rows, packed into
one byte row a pod (``pack_rows``), and a step table: for each step a graph
takes, its row, its pod and the splits it owes the random stream, all
three read from the call's plan (``exact._Run.plan``), which the eager
walk reads too. A replay reads the table at a device cursor, gathers its
row, writes its pick into the static assignments and advances the cursor.
The carried state (``i64``, ``i32``) and the stream's key live in static
buffers too: each call copies them in and, when it ends, back out, so the
graphs live across solves and chained sub-batches.

Quota iterations. An iteration of a spread or anti chunk's random loop
(``grouped._Loop.iteration``: the domain counts through the prepared
``domain_counts`` launch, the frontier scores, the threefry node keys, the
winners, the water-fill and its uniform draw, the scatters) issues about
200 kernels and ends in one blocking read of its exit row. In random mode
such a chunk runs on a loop kept for its ``grouped.iteration_key`` in the
epoch, whose buffers each chunk's prologue rewrites, and an iteration
replays a graph of itself per signature: the key, the chunk's valid count
(the loop's arithmetic takes it as a constant) and the stream's live key
slot (each iteration splits once, so a chunk alternates two graphs). The
exit read stays eager, after the replay, on the graph's own exit row. An
iteration that pays splits owed by scan rows that drew nothing runs
eagerly (it is a chunk's first).

Epochs. A graph keeps the address of everything it reads. The buffers
belong to ``StepGraphs``; the tables are the solve's, so an epoch is keyed
by every table tensor's address, shape, strides and dtype, every host
table's content, the packed state's layout and the pipeline flags, and a
solve under another key drops every graph and kept loop first: no stale
graph runs. The session's resident node tables and its content-addressed
class tables keep their addresses from batch to batch; a standalone solve
uploads new ones and recaptures.

Engagement: ``engages`` (the card, one shard, no nominated pods), then for
a scan step per call, per signature: a graph already captured in the
epoch, or at least ``MIN_STEPS`` of its steps in the call; for a quota
iteration, random mode and a graph already captured, or ``MIN_ITERATIONS``
eager iterations of its signature seen in the epoch. Every other step or
iteration is the eager one, unchanged. A signature's first step or
iteration in an epoch runs eagerly, so that every kernel the capture
records has been loaded and launched once.

Counters stay true: a capture (``StepGraphs.record``) launches nothing and
counts nothing, each replay adds its hand-written kernels' launches to
their cells (``timing.launch_counts``), and ``SolveTimes.counts`` counts
the replays and captures, and the replays of fused steps. Each capture,
the step or iteration built and recorded and its graph instantiated, is
timed as the solve's ``capture`` sub-stage, a span carrying its kind when
traced.
"""

from __future__ import annotations

import gc
import hashlib

import numpy as np
import torch

from ..ops import domain_counts as dc
from ..ops import grouped_spread as gs
from ..ops import scan_step as ss
from ..ops import threefry as tf
from ..parallel import sharding as sh
from . import grouped as gp
from .timing import launch_counts

# The fewest steps of a signature in a call that repay its graph: a capture
# and its instantiation cost the host 3.5-5.7 ms against 1,674-1,720 us of
# issue for an eager step, 2.26-2.87 eager steps (interpod5k's shape, 5,120
# nodes and 1,024 pods, on an H100 at 700 W: scripts/step_graph_costs.py,
# PERF.md section 6), and the signature's first step runs eagerly: 3 + 1.
MIN_STEPS = 4

# The eager iterations of a quota iteration's signature seen in an epoch
# before its graph is captured: a capture and its instantiation cost the
# host 4.2-4.7 ms against 3,016-3,708 us of issue for an eager iteration,
# 1.1-1.5 eager iterations (a process's first capture 16-42 ms; spread5k's
# shape, 5,000 nodes in 3 zones and 16 chunks of 64 pods, on an H100 at
# 700 W: scripts/step_graph_costs.py --shape spread5k, PERF.md section 6),
# and the first of them is the warm-up: 2.
MIN_ITERATIONS = 2

# the per-pod arrays a step reads on the device, in the packed row's order:
# the int64 array first and each segment starting on 8 bytes, so that every
# segment views as its own dtype
ROW_NAMES = ("take64", "take32", "ipa_m_w", "req_mask", "pod_conflict", "ipa_m_anti",
             "ipa_self_aff")
_TORCH_DTYPES = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
                 np.dtype(bool): torch.bool}


def engages(device, shards: int, use_nominated: bool) -> bool:
    """Whether a solve may replay step graphs at all: on a CUDA device,
    unsharded, with no nominated pods (their correction rows and branches
    stay eager)."""
    return torch.device(device).type == "cuda" and shards == 1 and not use_nominated


def row_layout(host: dict) -> tuple[tuple, int]:
    """((name, numpy dtype, per-row shape, byte offset, bytes), ...) of the
    packed pod row, and its width in bytes (a multiple of 8)."""
    layout, off = [], 0
    for name in ROW_NAMES:
        a = host[name]
        shape = tuple(a.shape[1:])
        nb = a.dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        layout.append((name, a.dtype, shape, off, nb))
        off += -(-nb // 8) * 8
    return tuple(layout), off


def pack_rows(host: dict, layout: tuple, width: int) -> np.ndarray:
    """The pod rows of ``host`` as one [rows, width] uint8 array."""
    n = host["take64"].shape[0]
    out = np.zeros((n, width), np.uint8)
    for name, dtype, _, off, nb in layout:
        a = np.ascontiguousarray(host[name], dtype=dtype).reshape(n, -1)
        out[:, off : off + nb] = a.view(np.uint8).reshape(n, nb)
    return out


def row_views(row: torch.Tensor, layout: tuple, k: int, b: int) -> dict:
    """The step's pod inputs as views of one gathered packed row (the views
    ``_PodRows`` gives of its per-array tensors): ``k`` resource columns,
    ``b`` port slots."""
    x = {}
    for name, dtype, shape, off, nb in layout:
        x[name] = row[off : off + nb].view(_TORCH_DTYPES[dtype]).reshape(shape)
    x["req"] = x["take64"][:k]
    x["nonzero_req"] = x["take64"][k:]
    x["pod_takes"] = x["take32"][1 : 1 + b]
    return x


def _fingerprint(tree: dict) -> tuple:
    """What a captured step keeps of a table tree: each tensor's address,
    shape, strides, dtype and device, each host array's content, each
    other value. The prepared kernel launches (``launch``) are the
    solve's own and are left out."""
    out = []
    for name in sorted(tree):
        v = tree[name]
        if name == "launch":
            continue
        if isinstance(v, dict):
            out.append((name, _fingerprint(v)))
        elif isinstance(v, torch.Tensor):
            out.append((name, v.data_ptr(), tuple(v.shape), v.stride(), v.dtype, str(v.device)))
        elif isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            out.append((name, a.shape, a.dtype.str,
                        hashlib.blake2b(a.tobytes(), digest_size=16).digest()))
        else:
            out.append((name, v))
    return tuple(out)


def _own_launches(tables: dict) -> dict:
    """A shallow copy of one shard's tables whose spread and interpod
    kernels are prepared afresh: a graph keeps the launches it captured
    (and the outputs they write, in the graphs' memory pool)."""
    t = dict(tables)
    t["spr"] = dict(t["spr"], launch={})
    t["ipa"] = dict(t["ipa"], launch={})
    return t


def _add_launches(deltas) -> None:
    """Adds ``deltas`` (in ``timing.KERNELS`` order) to the hand-written
    kernels' launch cells."""
    n_dc, n_scan, n_grouped, n_fused, n_step = deltas
    dc.LAUNCHES += n_dc
    tf.SCAN_LAUNCHES += n_scan
    tf.GROUPED_LAUNCHES += n_grouped
    gs.LAUNCHES += n_fused
    ss.LAUNCHES += n_step


class _Graph:
    """A captured step or quota iteration: the graph, what it reads that
    must live as long as it does (the tables whose prepared launches it
    captured, or the fused step, or the kept loop), its launches
    of the hand-written kernels (in ``timing.KERNELS`` order), whether it
    is a step of the fused step kernel, and an iteration's exit row
    (``out[-1]``) and the stream's key slot after it."""

    __slots__ = ("graph", "keep", "launches", "fused", "out", "cur")

    def __init__(self, graph, keep, launches, out=None):
        self.graph, self.keep, self.launches, self.out, self.cur = (
            graph, keep, launches, out, 0)
        self.fused = False

    def replay(self) -> None:
        """One launch of the graph, its hand-written kernels' launches
        counted."""
        self.graph.replay()
        _add_launches(self.launches)


class _Buffers:
    """The static buffers the graphs of one epoch read and write."""

    def __init__(self, dev, i64_shape, i32_shape, n_pods: int, n_rows: int, width: int):
        self.i64 = torch.zeros(i64_shape, dtype=torch.int64, device=dev)
        self.i32 = torch.zeros(i32_shape, dtype=torch.int32, device=dev)
        self.rows = torch.zeros((n_rows, width), dtype=torch.uint8, device=dev)
        # the step table: row, pod and owed splits of each graph step
        self.steps = torch.zeros((3, n_pods), dtype=torch.int64, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.asg = torch.full((n_pods,), -1, dtype=torch.int64, device=dev)


def _upload(dst: torch.Tensor, a: np.ndarray) -> None:
    """A host array into ``dst`` on the launching stream; on the card from
    pinned memory, without waiting for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dst.is_cuda:
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


class StepGraphs:
    """One solver's step graphs, their epoch and the buffers they bind."""

    def __init__(self):
        self.graphs: dict[tuple, _Graph] = {}
        self.fused = None  # the epoch's fused step (_Pass.fused_step)
        self.warm: set[tuple] = set()  # signatures stepped eagerly in this epoch
        # the quota iterations': kept loops by iteration key, graphs and the
        # eager iterations seen by signature
        self.loops: dict[tuple, gp._Loop] = {}
        self.iterations: dict[tuple, _Graph] = {}
        self.seen: dict[tuple, int] = {}
        self.epoch = None
        self.buf: _Buffers | None = None
        self.buf_key = None
        self.layout: tuple = ()  # the packed pod row's (row_layout)
        self.stream: tf.Stream | None = None
        self._pool = None
        self._side = None

    def drop(self) -> None:
        """Forget every graph. Their memory pool dies with the last of them,
        so the next capture starts a new one."""
        self.graphs.clear()
        self.fused = None
        self.warm.clear()
        self.loops.clear()
        self.iterations.clear()
        self.seen.clear()
        self.epoch = None
        self._pool = None

    def capture(self, fn):
        """A CUDA graph of what ``fn`` launches; its ``replay()`` runs it.
        The collector is off meanwhile: a collection inside a capture could
        destroy another graph, or free a tensor, in the middle of it."""
        dev = self.buf.i64.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(dev)
        self._side.wait_stream(main)
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._record(graph, fn)
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(self._side)
        return graph

    def record(self, fn, keep, out=None) -> _Graph:
        """``capture(fn)`` as a ``_Graph`` holding ``keep`` and ``out``, and
        the hand-written kernels' launches it recorded, which belong to its
        replays: a capture launches nothing."""
        before = launch_counts()
        graph = self.capture(fn)
        launches = tuple(b - a for a, b in zip(before, launch_counts()))
        _add_launches(tuple(-x for x in launches))
        return _Graph(graph, keep, launches, out)

    def _record(self, graph, fn) -> None:
        with torch.cuda.stream(self._side):
            # thread_local: another thread may touch the card meanwhile
            # (the streaming loop's completion waits)
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 -- the step's own error is the one to raise
                    pass
                raise
            graph.capture_end()

    # -- one call of a run --

    def start(self, run, packed, plan, key):
        """The graph pass of ``run``'s call that walks ``plan``
        (``exact._Plan``), or None when no scan signature there engages
        and no quota chunk is there (the call then runs eagerly, as it
        would without graphs)."""
        quota = plan.quota and run.tie_break == "random"
        if not plan.steps.shape[1] and not quota:
            return None
        if run.graph_epoch is None:
            run.graph_epoch = (
                _fingerprint(run.tables[0]), run.tie_break,
                tuple(sorted(run.kw.items())), run.layout,
            )
        epoch = run.graph_epoch
        host = run.xs.host
        rows = plan.steps[0]
        sig = host["class_of"][rows] * 2 + host["has_port_conflicts"][rows]
        kinds, counts = np.unique(sig, return_counts=True)
        cached = {c * 2 + h for c, h, _ in self.graphs} if epoch == self.epoch else set()
        take = {int(s) for s, n in zip(kinds, counts) if n >= MIN_STEPS or int(s) in cached}
        if not take and not quota:
            return None
        sig = np.where(np.isin(sig, list(take)), sig, -1)
        return _Pass(self, run, packed, plan, key, epoch, sig)

    def bind(self, run, packed, epoch) -> _Buffers:
        """The buffers for ``run`` (new ones, and a new epoch, where the
        shapes change), its epoch made current and its rows uploaded."""
        i64, i32 = packed["i64"][0], packed["i32"][0]
        host = run.xs.host
        layout, width = row_layout(host)
        n_pods, n_rows = run.valid.shape[0], host["take64"].shape[0]
        bk = (i64.device, tuple(i64.shape), tuple(i32.shape), layout, width)
        if (self.buf is None or self.buf_key != bk or self.buf.asg.shape[0] < n_pods
                or self.buf.rows.shape[0] < n_rows):
            self.drop()
            self.buf = _Buffers(i64.device, i64.shape, i32.shape, n_pods, n_rows, width)
            self.buf_key, self.layout = bk, layout
            self.stream = tf.Stream((0, 0), i64.device)
            self._side = None
        if self.epoch != epoch:
            self.drop()
            self.epoch = epoch
        if not run.graph_rows:
            _upload(self.buf.rows[:n_rows], pack_rows(host, layout, width))
            run.graph_rows = True
        return self.buf


class _Pass:
    """One call's graph steps: the buffers bound and filled at the start,
    ``step(n)`` for each scan step of the plan in order, ``finish`` at the
    end."""

    def __init__(self, graphs: StepGraphs, run, packed, plan, key, epoch, sig):
        self.graphs, self.run, self.orig = graphs, run, packed
        self.lo, self.hi = plan.lo, plan.hi
        buf = self.buf = graphs.bind(run, packed, epoch)
        # per scan step of the plan: its signature (class * 2 + port flag)
        # where a graph takes it, or -1
        self.sig = sig.tolist()
        keep = sig >= 0
        table = np.zeros(buf.steps.shape, np.int64)  # whole rows: one contiguous upload
        table[:, : int(keep.sum())] = plan.steps[:, keep]
        _upload(buf.steps, table)
        buf.cursor.zero_()
        buf.i64.copy_(packed["i64"][0])
        buf.i32.copy_(packed["i32"][0])
        buf.asg[self.lo : self.hi].fill_(-1)
        self.packed = {"i64": (buf.i64,), "i32": (buf.i32,)}
        self.asg = buf.asg
        self.stream = None
        if run.tie_break == "random":
            self.stream = graphs.stream
            self.stream.reset(key)

    def step(self, n: int) -> bool:
        """The plan's scan step ``n`` by a graph: True once replayed; False
        where the caller steps it eagerly (a signature's warm-up, or no
        graph step). The stream owes the step's splits (``_Plan.owed``),
        which the step table pays."""
        s = self.sig[n]
        if s < 0:
            return False
        cls, hpc = divmod(s, 2)
        stream, graphs, buf = self.stream, self.graphs, self.buf
        sig = (cls, hpc, stream.cur if stream is not None else 0)
        g = graphs.graphs.get(sig)
        if g is None:
            if (cls, hpc) not in graphs.warm:
                # the warm-up: this pod steps eagerly, its table row passed over
                graphs.warm.add((cls, hpc))
                buf.cursor.add_(1)
                return False
            if stream is not None:
                stream.pending = 0  # the capture's draw owes only its row's splits
            with self.run.times.capture("scan"):
                g = graphs.graphs[sig] = self._capture(sig)
            self.run.times.counts["graph_captures"] += 1
        if stream is not None:
            stream.pending = 0  # the replay pays them from the step table
        g.replay()
        counts = self.run.times.counts
        counts["graph_replays"] += 1
        if g.fused:
            counts["fused_scan_steps"] += 1
        return True

    def fused_step(self):
        """The epoch's fused step (``ops/scan_step.py``) over the buffers,
        made at its first eager step: the pass's eager steps and every
        capture of the epoch launch it, and its tables' prepared launches
        are the graphs' own. None where it does not engage."""
        graphs, run, buf = self.graphs, self.run, self.buf
        if graphs.fused is None and run.fused:
            graphs.fused = run.fused_step(_own_launches(run.tables[0]),
                                          run.state_views(self.packed, 0),
                                          {"i64": buf.i64, "i32": buf.i32})
        return graphs.fused

    def _capture(self, sig) -> _Graph:
        run, buf, stream = self.run, self.buf, self.stream
        host = run.xs.host
        layout, k, b = self.graphs.layout, host["req_mask"].shape[1], host["pod_takes"].shape[1]
        cls, hpc, _ = sig
        fused = self.fused_step()
        if fused is not None:

            def replayed():
                fused.replayed(cls, hpc, stream, buf.rows, layout, buf.steps, buf.cursor,
                               buf.asg)

            g = self.graphs.record(replayed, fused)
            g.fused = True
            return g
        tables = _own_launches(run.tables[0])
        st = run.state_views(self.packed, 0)
        spk = {"i64": buf.i64, "i32": buf.i32}
        step = run.make_step(tables, stream)

        def fn():
            ent = buf.steps.index_select(1, buf.cursor)  # [3, 1]: row, pod, owed splits
            x = row_views(buf.rows.index_select(0, ent[0])[0], layout, k, b)
            x["class_of"], x["has_port_conflicts"] = cls, hpc
            if stream is not None:
                stream.skip_at = ent[2, 0]
            try:
                pick = sh.run_local(step(st, spk, x))
            finally:
                if stream is not None:
                    stream.skip_at = None
            buf.asg.index_copy_(0, ent[1], pick.view(1))
            buf.cursor.add_(1)

        return self.graphs.record(fn, tables)

    # -- the quota chunks' iterations --

    def loop(self, key, make) -> gp._Loop:
        """The loop kept for quota chunks of ``key`` in the epoch
        (``make()`` builds it at the key's first chunk)."""
        loops = self.graphs.loops
        lp = loops.get(key)
        if lp is None:
            lp = loops[key] = make()
        return lp

    def iteration(self, loop, key, vcnt: int):
        """An iteration of ``loop`` (a quota chunk of ``vcnt`` valid pods)
        by a graph: its exit row once replayed; None where the caller runs
        it eagerly (splits owed, or too few of its signature's iterations
        seen yet)."""
        stream, graphs, counts = self.stream, self.graphs, self.run.times.counts
        if stream.pending:
            return None  # a capture would bake the owed count in
        sig = key + (vcnt, stream.cur)
        g = graphs.iterations.get(sig)
        if g is None:
            seen = graphs.seen.get(sig, 0)
            if seen < MIN_ITERATIONS:
                graphs.seen[sig] = seen + 1
                return None
            with self.run.times.capture(loop.mode):
                g = graphs.iterations[sig] = self._capture_iteration(loop, vcnt)
            counts[f"grouped_graph_captures.{loop.mode}"] += 1
        g.replay()
        # what the captured draws left on the host: the split's key slot
        stream.cur, stream.has_sub = g.cur, True
        counts[f"grouped_graph_replays.{loop.mode}"] += 1
        return g.out[-1]

    def _capture_iteration(self, loop, vcnt: int) -> _Graph:
        stream, out = self.stream, []

        def fn():
            out[:] = [sh.run_local(loop.iteration(vcnt, stream))]

        g = self.graphs.record(fn, loop, out)
        g.cur = stream.cur  # the key slot the captured split leaves
        return g

    def finish(self) -> None:
        """The carried state and the assignments back where the call's
        caller reads them."""
        buf, run = self.buf, self.run
        self.orig["i64"][0].copy_(buf.i64)
        self.orig["i32"][0].copy_(buf.i32)
        run.assignments[self.lo : self.hi].copy_(buf.asg[self.lo : self.hi])
