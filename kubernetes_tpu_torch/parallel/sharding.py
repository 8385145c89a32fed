"""Node-axis sharding of the pods x nodes solve over torch devices.

Counterpart of ``kubernetes_tpu/parallel/sharding.py``. The JAX package
annotates shardings on a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; torch has no such compiler, so the port shards by hand:

- a ``NodeMesh`` is an ordered tuple of torch devices, one per shard. The
  node axis (always the last axis) is cut into ``size`` contiguous equal
  shards: shard ``s`` owns the global columns ``[s * w, (s + 1) * w)``,
  ``w = N_pad / size``. The node padding is a multiple of ``lcm(LANE,
  size)`` (``Snapshot.pad_multiple``), and padded columns stay masked
  (``node_valid`` False) in every filter, score and argmax;
- a sharded table is a tuple of ``size`` tensors, each its own allocation
  on its own shard's device, even when shards share one device: a
  one-device mesh runs exactly the code that k cards run;
- replicated tables (the per-pod rows, the scalars and the class tables
  named in ``REPLICATED_TABLE_NAMES``) hold one copy per distinct device,
  shared by the shards on it;
- shard 0 leads: it holds the combines' results and the random generator.

A solve runs one generator per shard in lockstep (``lockstep``). Each
computes on its own block, and where the reference reduces across the node
axis (an argmax, a max, a sum, a per-domain count) it yields a request
``(combine, partial)``; the combine gets every shard's partial in shard
order, reduces on the lead device and sends each shard its reply. The
combines are integer sums, maxima and minima, so a sharded solve equals
the unsharded one bit for bit; the relax planner's float32 sums are the
one exception (ROADMAP's parity rules).

``node_sharding``, ``replicated`` and ``device_put_tree`` have no torch
meaning (a torch tensor carries no sharding annotation): they fold into
``put_node_table`` / ``placers`` / ``shard_node_tree``, which place the
tables directly.

``force_device_count(n)`` makes the visible device list ``n`` entries of
the one device in play: how a one-device box gates the sharded code, as
the JAX package's tests and sim force virtual CPU devices. Only the sim's
``--mesh-devices``, the tests and ``chip_smoke.py`` call it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

NODE_AXIS = "nodes"

# Class/instance tables WITHOUT a trailing node axis (per-instance spread
# scalars, per-class term index rows, per-term flags): replicated. Every
# other solver table shards over its trailing node axis.
REPLICATED_TABLE_NAMES = frozenset(
    {
        # spread
        "max_skew",
        "min_domains",
        "self_match",
        "is_hostname",
        "hard",
        "soft",
        # interpod
        "in_pref_w",
        "cls_req_aff",
        "cls_req_anti",
        "cls_pref",
        "ex_anti",
    }
)

_forced: tuple[int, torch.device] | None = None

# combines run by lockstep on more than one shard since the last reset, and
# the host seconds spent in them (the launches they issue are asynchronous)
COMBINES = 0
COMBINE_S = 0.0


def to_dev(a, dev, dtype=None) -> torch.Tensor:
    """A device copy of a host array (never an alias of the numpy buffer)."""
    t = torch.tensor(np.ascontiguousarray(a), device=dev)
    return t if dtype is None else t.to(dtype)


def force_device_count(n: int | None, device=None) -> None:
    """Make the visible device list ``n`` entries of ``device`` (default:
    ``cuda:0`` when CUDA is available, else the CPU); ``n`` None or 0
    restores the real list."""
    global _forced
    if not n:
        _forced = None
        return
    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    _check_device(dev)
    _forced = (int(n), dev)


def forced_device_count() -> tuple:
    """The current forcing as ``force_device_count``'s arguments, (None,
    None) when none is set: what a caller restores after forcing."""
    return _forced if _forced is not None else (None, None)


def visible_devices(device=None) -> list[torch.device]:
    """The visible device list: the forced one when set, else
    ``cuda:0 .. cuda:{count-1}`` for a card (``device`` None or CUDA) and
    the host's one CPU device for a CPU scheduler."""
    if _forced is not None:
        return [_forced[1]] * _forced[0]
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _check_device(dev: torch.device) -> None:
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"NodeMesh names {dev}, but CUDA is not available")
        if dev.index is not None and not 0 <= dev.index < torch.cuda.device_count():
            raise ValueError(
                f"NodeMesh names {dev}, but {torch.cuda.device_count()} CUDA "
                "device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"NodeMesh runs on cuda or cpu devices, not {dev}")


@dataclass(frozen=True)
class NodeMesh:
    """One shard per entry of ``devices`` (a device may hold several
    shards). Raises ValueError at construction for a device that is not
    there."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("NodeMesh needs at least one device")
        for d in devs:
            _check_device(d)
        object.__setattr__(self, "devices", devs)

    axis_names = (NODE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in shard order of first appearance."""
        return tuple(dict.fromkeys(self.devices))

    def shards_per_device(self) -> int:
        """The most shards any one device holds."""
        return max(self.devices.count(d) for d in self.distinct)

    def width(self, node_pad: int) -> int:
        """Columns per shard; the node padding must divide evenly."""
        if node_pad % self.size:
            raise ValueError(
                f"node padding {node_pad} is not a multiple of the mesh size "
                f"{self.size} (Snapshot.pad_multiple / lcm(LANE, size))"
            )
        return node_pad // self.size

    def split(self, a, dtype=None) -> tuple:
        """A host array (or a tensor) cut over its trailing node axis: one
        contiguous tensor per shard, each its own allocation."""
        w = self.width(a.shape[-1])
        out = []
        for s, dev in enumerate(self.devices):
            blk = a[..., s * w : (s + 1) * w]
            if isinstance(blk, torch.Tensor):
                t = blk.to(dev).clone(memory_format=torch.contiguous_format)
                out.append(t if dtype is None else t.to(dtype))
            else:
                out.append(to_dev(blk, dev, dtype))
        return tuple(out)

    def replicate(self, a, dtype=None) -> tuple:
        """One copy of ``a`` per distinct device, indexed by shard."""
        copies = {}
        for dev in self.distinct:
            if isinstance(a, torch.Tensor):
                t = a.to(dev).clone()
                copies[dev] = t if dtype is None else t.to(dtype)
            else:
                copies[dev] = to_dev(a, dev, dtype)
        return tuple(copies[d] for d in self.devices)


def single(device) -> NodeMesh:
    """The unsharded solve as a mesh of one shard on ``device``."""
    return NodeMesh((torch.device(device),))


def node_mesh(n_devices: int | None = None, device=None) -> NodeMesh:
    """A mesh over the first ``n_devices`` visible devices (default: all)."""
    devices = visible_devices(device)
    if n_devices is not None:
        devices = devices[:n_devices]
    return NodeMesh(tuple(devices))


def resolve_mesh(mesh_devices: int = 0, mesh_slice: tuple | None = None, device=None):
    """SchedulerConfig.mesh_devices (+ optional mesh_slice) -> NodeMesh |
    None, with the JAX package's arithmetic over ``visible_devices(device)``
    (``resolve_indices``).

    Without a slice: 0 = all visible devices; 1 = single-device (None, the
    unsharded path); N > 1 = the first min(N, visible) devices. A resolved
    count below 2 returns None.

    ``mesh_slice=(rank, count)`` is the fleet's device-tier partition
    (fleet.meshSlice = "rank/count"): the visible list is cut into
    ``count`` contiguous equal shares and this process owns share ``rank``;
    ``mesh_devices`` then applies within it (0 = the whole share). A
    1-device slice still returns a 1-way mesh: the mesh is what pins the
    solve to this replica's device."""
    devices = visible_devices(device)
    idx = resolve_indices(mesh_devices, mesh_slice, len(devices))
    return None if idx is None else NodeMesh(tuple(devices[i] for i in idx))


def resolve_indices(mesh_devices: int, mesh_slice: tuple | None, visible: int):
    """The positions in a visible list of ``visible`` devices that
    ``resolve_mesh`` takes, or None for the unsharded path; raises the JAX
    package's ValueError for a bad or unsatisfiable slice."""
    if mesh_slice is None:
        if mesh_devices == 1:
            return None
        n = visible if mesh_devices <= 0 else min(mesh_devices, visible)
        if n < 2:
            return None
        return list(range(n))

    rank, count = int(mesh_slice[0]), int(mesh_slice[1])
    if count < 1 or not 0 <= rank < count:
        raise ValueError(
            f"mesh_slice must be (rank, count) with 0 <= rank < count; "
            f"got {mesh_slice!r}"
        )
    share = visible // count
    if share < 1:
        raise ValueError(
            f"mesh_slice {rank}/{count} needs at least {count} visible "
            f"devices for disjoint per-replica slices; only "
            f"{visible} are visible"
        )
    mine = list(range(rank * share, (rank + 1) * share))
    n = len(mine) if mesh_devices <= 0 else min(mesh_devices, len(mine))
    return mine[:n]


def mesh_fingerprint(mesh) -> tuple | None:
    """Hashable identity for session and chain keys: the shard devices in
    order and the axis names. None for the unsharded path."""
    if mesh is None:
        return None
    return (tuple(str(d) for d in mesh.devices), mesh.axis_names)


def put_node_table(mesh, a, node_pad: int | None = None) -> tuple:
    """Place one solver table: sharded over its trailing node axis when
    that axis is the node padding (or ``node_pad`` is None), replicated
    otherwise."""
    a = np.asarray(a)
    if node_pad is not None and (a.ndim == 0 or a.shape[-1] != node_pad):
        return mesh.replicate(a)
    return mesh.split(a)


def placers(mesh, node_pad: int | None = None, device=None):
    """The (replicated-put, node-table-put) pair: ``dev`` replicates,
    ``dev_n`` shards over the trailing node axis (``put_node_table``).
    ``mesh=None`` places both whole on ``device`` (one shard)."""
    if mesh is None:
        mesh = single(device if device is not None else "cpu")

    def dev(a):
        return mesh.replicate(a)

    def dev_n(a):
        return put_node_table(mesh, a, node_pad)

    return dev, dev_n


def shard_node_tree(mesh, tree, replicate_names: frozenset[str] = frozenset()):
    """A dict tree of host arrays placed on the mesh: each array shards over
    its trailing node axis unless its key is in ``replicate_names``."""
    out = {}
    for key, a in tree.items():
        if isinstance(a, dict):
            out[key] = shard_node_tree(mesh, a, replicate_names)
        elif key in replicate_names:
            out[key] = mesh.replicate(a)
        else:
            out[key] = mesh.split(np.asarray(a))
    return out


# -- lockstep execution and the combines ---------------------------------


def lockstep(gens) -> list:
    """Run one generator per shard together: each yields ``(combine,
    partial)`` requests at the same points (their branches are host data),
    the combine maps the shards' partials, in shard order, to one reply per
    shard, and each generator resumes with its reply. Returns the
    generators' return values in shard order."""
    global COMBINES, COMBINE_S
    gens = list(gens)
    k = len(gens)
    replies = [None] * k
    while True:
        reqs = []
        done = []
        for g, r in zip(gens, replies):
            try:
                reqs.append(g.send(r))
            except StopIteration as e:
                done.append(e.value)
        if done:
            if len(done) != k:
                raise RuntimeError("shards left the lockstep at different points")
            return done
        fn = reqs[0][0]
        if k == 1:
            replies = fn([reqs[0][1]])
            continue
        t0 = time.perf_counter()
        replies = fn([p for _, p in reqs])
        COMBINE_S += time.perf_counter() - t0
        COMBINES += 1


def run_local(gen):
    """Run one generator as the only shard: every combine gets one
    partial."""
    return lockstep([gen])[0]


def _lead(parts):
    return parts[0].device


def _fold(parts, op):
    if len(parts) == 1:
        return parts
    lead = _lead(parts)
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(lead))
    return [acc if p.device == lead else acc.to(p.device) for p in parts]


def c_max(parts):
    """Elementwise maximum over shards."""
    return _fold(parts, torch.maximum)


def c_min(parts):
    return _fold(parts, torch.minimum)


def c_sum(parts):
    """Elementwise sum over shards, in shard order, in the partials'
    dtype (integer adds: exact, whatever the order)."""
    return _fold(parts, torch.add)


def c_any(parts):
    return _fold(parts, torch.logical_or)


def c_prefix(parts):
    """(exclusive prefix over earlier shards, total) per shard of 0-d
    partials: a cross-shard cumsum's offsets."""
    if len(parts) == 1:
        return [(torch.zeros_like(parts[0]), parts[0])]
    lead = _lead(parts)
    vals = torch.stack([p.to(lead) for p in parts])
    inc = torch.cumsum(vals, dim=0, dtype=vals.dtype)
    tot = inc[-1]
    return [((inc[s] - vals[s]).to(p.device), tot.to(p.device)) for s, p in enumerate(parts)]


def _first_extreme(parts, extreme):
    if len(parts) == 1:
        v, pick, lo = parts[0]
        return [(v, pick + lo if lo else pick)]
    lead = parts[0][0].device
    vals = torch.stack([v.to(lead) for v, _, _ in parts])
    picks = torch.stack([p.to(lead) + lo for _, p, lo in parts])
    v = extreme(vals)
    pick = torch.min(torch.where(vals == v, picks, torch.iinfo(picks.dtype).max))
    return [(v.to(b.device), pick.to(b.device)) for b, _, _ in parts]


def c_first_max(parts):
    """Partials ``(best, local index, shard offset)`` -> the global max
    and the lowest global index holding it, on every shard (the unsharded
    ``torch.max(dim=0)``'s first maximal index)."""
    return _first_extreme(parts, torch.max)


def c_first_min(parts):
    """Partials ``(least, local index, shard offset)`` -> the global min
    and the lowest global index holding it (``torch.argmin``'s first)."""
    return _first_extreme(parts, torch.min)


def c_draw(parts):
    """Partials ``(draw, lo, w, device)``: ``draw()`` runs once, on the
    lead shard, for the whole node axis; each shard gets its own columns
    (``lo`` None: the whole draw, a scalar).
    One random stream whatever the shard count, so a sharded random-mode
    solve draws exactly what the unsharded one draws."""
    full = parts[0][0]()
    if len(parts) == 1:
        return [full]
    return [(full if lo is None else full[lo : lo + w]).to(dev) for _, lo, w, dev in parts]


def c_apply(parts):
    """Partials ``(fn, payload)``: the lead shard's ``fn`` called once with
    every shard's payload in shard order; it returns one reply per
    shard."""
    return parts[0][0]([payload for _, payload in parts])
