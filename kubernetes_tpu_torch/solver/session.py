"""The device session: node tables and carried state resident on the card
across batches, and the handles a deferred solve returns.

Counterpart of ``kubernetes_tpu/solver/exact.py``: ``_heal`` (:1220),
``_pack_cols``, ``SessionDrainRequired`` (:1252), ``DeferredAssignments``
(:1261), ``BatchCarriedUsage`` (:1307), ``_class_table_arrays`` and
``_class_table_digest`` (:1325-1354), ``_place_class_tables`` (:1357) on
one device, and ``_DeviceSession`` (:1409).

Resident layout. ``nt`` holds the node tables ``alloc`` [K, N] int64,
``max_pods`` [N] int32 and ``node_valid`` [N] bool; ``persist`` holds the
carried fit state ``i64`` [K + 2, N] int64 (``used`` rows, then
``nonzero_used``) and ``pod_count`` [N] int32. The solver's scan writes
``persist["i64"]`` in place and leaves ``persist["pod_count"]`` a view of
the batch's packed int32 state, whose row 0 it is. Torch has no donation:
the JAX package hands these buffers through each call and gets new ones
back, where the port updates them in place. The stream carry (the full
packed state of the last streaming solve) shares both, so every path that
writes ``persist`` in place -- a heal, a full upload, a solve that does
not consume the carry -- drops the carry first, as every donating path
does in the JAX package.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..ops import interpod as ip
from ..ops import spread as sp
from ..tensorize.schema import NodeBatch

# the class-table cache holds this many uploads, least recently used first out
CLASS_CACHE_SIZE = 8


def to_dev(a, dev, dtype=None) -> torch.Tensor:
    """A device copy of a host array (never an alias of the numpy buffer)."""
    t = torch.tensor(np.ascontiguousarray(a), device=dev)
    return t if dtype is None else t.to(dtype)


class SessionDrainRequired(Exception):
    """Raised by a deferred-heal sync (``allow_heal=False``) when the
    session would need a full re-upload (node or vocabulary shape change):
    a full upload from host truth while an earlier solve is still
    unapplied would erase that solve's carried placements. The caller
    drains the solve in flight and dispatches again with healing allowed;
    nothing on the card changed before the raise."""


class DeferredAssignments:
    """Handle to a dispatched session solve whose assignments are not read
    yet.

    On the card the constructor starts a ``non_blocking`` copy of the
    assignments into pinned host memory and records a CUDA event after
    it, so the copy overlaps whatever the host does before ``get()``.
    ``get()`` waits on the event and returns the trimmed int32 assignment
    vector; ``wait()`` only waits. On the CPU the handle holds a plain
    copy.

    ``lo``/``count`` locate a chained sub-batch's pods within the batch
    (``solve(..., split=K)``): this handle covers batch pods
    [lo, lo + count)."""

    __slots__ = ("_host", "_event", "_num_pods", "lo")

    def __init__(self, dev: torch.Tensor, num_pods: int, lo: int = 0) -> None:
        self._num_pods = num_pods
        self.lo = lo
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = dev.clone()
            self._event = None

    @property
    def count(self) -> int:
        return self._num_pods

    def get(self) -> np.ndarray:
        self.wait()
        return self._host.numpy()[: self._num_pods].astype(np.int32)

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()


class BatchCarriedUsage:
    """The full carried state between chained sub-solves of one batch:
    the packed ``i64`` fit rows and the packed ``i32`` rows (pod count,
    port occupancy, spread counts, interpod counts). Sub-batches of one
    batch share one tensorize, which is what makes the carry
    well-defined; it dies with the chain unless it is kept as the
    session's stream carry."""

    __slots__ = ("state",)

    def __init__(self, state: dict) -> None:
        self.state = state


def _heal(nt, persist, cols_i64, cols_i32, cols_bool, idx) -> None:
    """Write dirty snapshot columns into the resident node tables and
    carried state in place (cache.go#UpdateSnapshot's O(changed) contract,
    on the card). ``idx`` [D] int64 node slots; ``cols_i64`` rows are
    alloc [K], used [K], nonzero_used [2]; ``cols_i32`` rows max_pods and
    pod_count; ``cols_bool`` row valid."""
    k = nt["alloc"].shape[0]
    nt["alloc"].index_copy_(1, idx, cols_i64[:k])
    nt["max_pods"].index_copy_(0, idx, cols_i32[0])
    nt["node_valid"].index_copy_(0, idx, cols_bool[0])
    persist["i64"].index_copy_(1, idx, cols_i64[k:])
    persist["pod_count"].index_copy_(0, idx, cols_i32[1])


def _pack_cols(arrs: list[np.ndarray]) -> np.ndarray:
    """Stack row-blocks (each [*, D] or [D]) into one array for upload."""
    rows = [a[None, :] if a.ndim == 1 else a for a in arrs]
    return np.concatenate(rows, axis=0)


def _class_table_arrays(static, spread, interpod) -> list:
    """The flat array list behind one class-table upload -- the content
    hash and the transfer-byte accounting both walk exactly this."""
    arrays = [
        static.mask, static.taint_cnt, static.nodeaff_pref,
        static.image_score, spread.dom, spread.elig, spread.max_skew,
        spread.min_domains, spread.self_match, spread.is_hostname,
        spread.hard, spread.soft, interpod.in_dom, interpod.in_pref_w,
        interpod.cls_req_aff, interpod.cls_req_anti, interpod.cls_pref,
        interpod.ex_dom, interpod.ex_anti,
    ]
    if static.extra_score is not None:
        arrays.append(static.extra_score)
    return arrays


def _class_table_digest(static, spread, interpod) -> bytes:
    """Content hash of the class-table arrays: the session's class-table
    cache key and component 0 of ``ExactSolver.stream_chain_key``."""
    h = hashlib.blake2b(digest_size=16)
    for a in _class_table_arrays(static, spread, interpod):
        arr = np.ascontiguousarray(a)
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.digest()


def _place_class_tables(static, spread, interpod, dev) -> dict:
    """The per-batch class tables on ``dev``: per-node rows as device
    tensors, the small per-class and per-instance slot tables as host
    numpy (the pod's class is a host int, so its slots resolve on the
    host), and the pieces of the spread and interpod tables that no step
    changes (``ops/spread.py`` and ``ops/interpod.py`` ``static_tables``)."""
    spr_static = sp.static_tables(spread.dom, spread.elig, spread.d_pad)
    in_dom = to_dev(interpod.in_dom, dev)
    ex_dom = to_dev(interpod.ex_dom, dev)
    ct = {
        "static_mask": to_dev(static.mask, dev),
        "taint_cnt": to_dev(static.taint_cnt, dev),
        "nodeaff_pref": to_dev(static.nodeaff_pref, dev),
        "image_score": to_dev(static.image_score, dev),
        "spr": {
            "dom": to_dev(spread.dom, dev),
            **{k: to_dev(v, dev) for k, v in spr_static.items()},
            "n_dom_host": spr_static["n_dom"],
            "present_host": spr_static["present"],
            "max_skew": np.asarray(spread.max_skew),
            "min_domains": np.asarray(spread.min_domains),
            "self_match": np.asarray(spread.self_match),
            "is_hostname": np.asarray(spread.is_hostname),
            "hard": np.asarray(spread.hard),
            "soft": np.asarray(spread.soft),
        },
        "ipa": {
            "in_dom": in_dom,
            "ex_dom": ex_dom,
            **ip.static_tables(in_dom, ex_dom),
            "ex_anti": to_dev(interpod.ex_anti, dev),
            "in_pref_w": np.asarray(interpod.in_pref_w),
            "cls_req_aff": np.asarray(interpod.cls_req_aff),
            "cls_req_anti": np.asarray(interpod.cls_req_anti),
            "cls_pref": np.asarray(interpod.cls_pref),
        },
    }
    if static.extra_score is not None:
        ct["extra_score"] = to_dev(static.extra_score, dev)
    return ct


def _node_tables(nodes: NodeBatch, dev) -> tuple[dict, dict]:
    """(node tables, carried fit state) of a full upload."""
    nt = {
        "alloc": to_dev(nodes.allocatable, dev),
        "max_pods": to_dev(nodes.max_pods, dev),
        "node_valid": to_dev(nodes.valid, dev),
    }
    persist = {
        "i64": to_dev(np.concatenate([nodes.used, nodes.nonzero_used]), dev, torch.int64),
        "pod_count": to_dev(np.asarray(nodes.pod_count, np.int32), dev),
    }
    return nt, persist


def _node_bytes(nodes: NodeBatch) -> int:
    return sum(
        np.asarray(a).nbytes
        for a in (nodes.allocatable, nodes.max_pods, nodes.valid,
                  nodes.used, nodes.nonzero_used, nodes.pod_count)
    )


class _DeviceSession:
    """Card-resident mirror of one snapshot's node tensors.

    Engaged by solves given ``col_versions``: the node tables and the
    carried fit state live on the card across batches, dirty snapshot
    columns heal in place, and class-table uploads dedupe by content
    digest. Standalone solves bypass it."""

    def __init__(self) -> None:
        self.padded = -1
        self.k = -1
        self.dev: torch.device | None = None
        self.nt: dict | None = None
        self.persist: dict | None = None
        self.seen_versions: np.ndarray | None = None
        self.class_cache: dict[tuple, dict] = {}
        # the cross-batch occupancy carry of the streaming dispatcher: the
        # full packed state of the last streaming solve, whose tensors are
        # persist's own; ``stream_versions`` is its host-column baseline
        self.stream_carry: dict | None = None
        self.stream_key: tuple | None = None
        self.stream_versions: np.ndarray | None = None

    def drop_stream_carry(self) -> None:
        self.stream_carry = None
        self.stream_key = None
        self.stream_versions = None

    def sync(self, nodes: NodeBatch, col_versions: np.ndarray, dev,
             allow_heal: bool = True) -> int:
        """Bring the resident node tables and state up to date with the
        snapshot; returns the host-to-device bytes this sync uploaded.

        ``allow_heal=False`` (an earlier solve still unapplied): dirty
        columns are not healed and ``seen_versions`` does not advance, so
        the next healing sync picks them up; a shape or device change
        raises SessionDrainRequired instead of uploading over the carried
        state."""
        dev = torch.device(dev)
        if (
            self.padded != nodes.padded
            or self.k != nodes.allocatable.shape[0]
            or self.dev != dev
        ):
            if not allow_heal and self.padded != -1:
                raise SessionDrainRequired()
            self.padded = nodes.padded
            self.k = nodes.allocatable.shape[0]
            self.dev = dev
            # a full upload replaces the resident state wholesale
            self.drop_stream_carry()
            self.nt, self.persist = _node_tables(nodes, dev)
            self.seen_versions = col_versions[: nodes.padded].copy()
            return _node_bytes(nodes)
        dirty = np.nonzero(col_versions[: self.padded] > self.seen_versions)[0]
        if dirty.size and not allow_heal:
            return 0  # defer: seen_versions untouched, a later sync heals
        nbytes = 0
        if dirty.size:
            cols_i64 = _pack_cols(
                [nodes.allocatable[:, dirty], nodes.used[:, dirty],
                 nodes.nonzero_used[:, dirty]]
            )
            cols_i32 = _pack_cols(
                [np.asarray(nodes.max_pods[dirty], np.int32),
                 np.asarray(nodes.pod_count[dirty], np.int32)]
            )
            cols_bool = _pack_cols([nodes.valid[dirty]])
            # the heal writes persist in place, and the stream carry shares
            # persist's tensors: it cannot survive a heal
            self.drop_stream_carry()
            _heal(self.nt, self.persist, to_dev(cols_i64, dev, torch.int64),
                  to_dev(cols_i32, dev), to_dev(cols_bool, dev),
                  to_dev(dirty, dev, torch.int64))
            nbytes = cols_i64.nbytes + cols_i32.nbytes + cols_bool.nbytes + dirty.size * 8
        self.seen_versions = col_versions[: self.padded].copy()
        return nbytes

    def class_tables(self, static, spread, interpod, digest: bytes | None = None):
        """Content-addressed cache of the per-batch class tables on the
        session's device. Returns (tables, bytes uploaded): 0 bytes on a
        hit. ``digest`` short-circuits the content hash with a
        precomputed ``_class_table_digest``."""
        if digest is None:
            digest = _class_table_digest(static, spread, interpod)
        key = (digest, str(self.dev))
        ct = self.class_cache.pop(key, None)
        if ct is not None:
            self.class_cache[key] = ct  # re-insert: LRU refresh on a hit
            return ct, 0
        ct = _place_class_tables(static, spread, interpod, self.dev)
        if len(self.class_cache) >= CLASS_CACHE_SIZE:
            self.class_cache.pop(next(iter(self.class_cache)))
        self.class_cache[key] = ct
        return ct, sum(np.asarray(a).nbytes for a in _class_table_arrays(static, spread, interpod))
