"""Device-memory capacity planning for card-resident solves.

A copy of the JAX package's ``solver/budget.py`` (its module note holds
the design): an analytic per-component byte model of the arrays
``ExactSolver.solve`` uploads and keeps resident under the tensorizers'
padding discipline, the chunk planner that halves an over-budget chunk
group-aligned, and ``assert_index_headroom``, the index-width audit that
``solve`` runs before every dispatch. Two things differ from the copy:

- ``device_budget_bytes`` returns what this process can still allocate
  on the card, where the JAX package asks its allocator for
  ``bytes_limit``: the card's free memory (``torch.cuda.mem_get_info``)
  plus what the caching allocator reserves and does not hand out now
  (``memory_reserved - memory_allocated``), capped by the per-process
  memory fraction when one is set. The CUDA context, other processes'
  memory and tensors this process holds outside the drain are not in it;
- ``WORKSPACE_FACTOR`` is re-derived on the card, and kept at the JAX
  package's 1.5: ``chip_smoke.py`` phase 7d (``drain_backlog`` of 100,000
  pods on 20,000 nodes, 1,024-pod chunks, NVIDIA H100 80GB HBM3 at 700 W)
  reads each chunk dispatch's peak allocated bytes
  (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``,
  less what the process held before the drain) at 25,160,192 B in steady
  state and 25,291,264 B at most, 1.40 times the model's resident set
  (``sharded_bytes + replicated_bytes`` = 18,109,396 B), so 1.5 leaves a
  7 % margin over the reading. The factor covers the eager solve's
  temporaries that the caching allocator hands out; the memory already
  taken when the drain starts (the CUDA context, a kernel's build, other
  tensors) is what ``device_budget_bytes`` leaves out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..tensorize.interpod import INST_PAD as IPA_INST_PAD
from ..tensorize.plugins import CLASS_PAD, PORT_PAD
from ..tensorize.schema import LANE, bucket_pow2
from ..tensorize.spread import DOM_PAD, INST_PAD as SPREAD_INST_PAD

# Fallback per-device budget when the runtime reports no bytes_limit
# (CPU backends, older PJRT): one conservative accelerator-die floor.
DEFAULT_DEVICE_BUDGET_BYTES = 8 << 30

# Workspace multiplier over the analytic resident set: the eager solve's
# temporaries from PyTorch's caching allocator. Measured on the card at
# 1.40 (the module note); 1.5 keeps a 7 % margin over that reading.
WORKSPACE_FACTOR = 1.5


class BudgetExceeded(Exception):
    """The shape does not fit the per-device HBM budget at ANY chunk
    size >= the minimum chunk. Raised by ``plan_chunk`` — the caller
    decides (refuse the drain, shrink the node axis, add devices);
    nothing was dispatched, so no device state is at risk."""

    def __init__(self, estimate: "ShapeEstimate", budget_bytes: int):
        self.estimate = estimate
        self.budget_bytes = budget_bytes
        super().__init__(
            f"per-device estimate {estimate.per_device_bytes:,} B exceeds "
            f"the {budget_bytes:,} B budget even at the minimum chunk "
            f"({estimate.chunk_pods} pods x {estimate.nodes} nodes)"
        )


class IndexWidthError(Exception):
    """A flattened-index product in the solve pipeline would overflow
    its container dtype at this shape (the 512k x 102k audit's typed
    failure — loud at dispatch, never a silent device-side wrap)."""


def node_padding(nodes: int, pad_multiple: int = 1) -> int:
    """The snapshot's node-axis padding for ``nodes`` live nodes:
    pow2 bucket (>= LANE) rounded up to lcm(LANE, devices) when the
    solve is mesh-sharded — exactly ``Snapshot._ensure_capacity``."""
    cap = bucket_pow2(max(nodes, LANE))
    if pad_multiple > 1:
        q = math.lcm(LANE, pad_multiple)
        cap = ((cap + q - 1) // q) * q
    return cap


def pod_padding(chunk_pods: int, group: int) -> int:
    """The pod-axis bucket a drain chunk tensorizes into: the grouped
    fast path keeps the batch-size bucket exactly when it is
    group-aligned (scheduler._tensorize_group's pod_pad), else the
    pow2 bucket."""
    if group > 1 and chunk_pods > 0 and chunk_pods % group == 0:
        return chunk_pods
    return bucket_pow2(max(chunk_pods, 1))


@dataclass(frozen=True)
class DrainShape:
    """The inputs the footprint of a drain chunk is a function of.
    Row counts default to the tensorizers' floor pads (PORT_PAD /
    INST_PAD = 8): workloads with wide port vocabularies or many
    spread/interpod instances should pass the real padded counts."""

    nodes: int
    chunk_pods: int
    vocab_k: int = 3
    classes: int = 1
    # per-family activity: inactive families still upload their
    # floor-padded trivial rows (bstate/class tables), but their
    # PER-POD rows only exist when the batch carries the shape
    spread: bool = False
    interpod: bool = False
    port_rows: int = PORT_PAD
    spread_rows: int = SPREAD_INST_PAD
    ipa_in_rows: int = IPA_INST_PAD
    ipa_ex_rows: int = IPA_INST_PAD
    d_pad: int = DOM_PAD
    mesh_devices: int = 1
    group: int = 64
    stream_depth: int = 4
    pad_multiple: int = 0  # 0 = mesh_devices (the scheduler default)


@dataclass(frozen=True)
class ShapeEstimate:
    """Analytic footprint of one drain-chunk shape. ``components`` maps
    name -> (bytes, sharded) for observability; the headline numbers:

    - ``per_device_bytes``: worst-case resident HBM per device with the
      stream ring full (node-sharded tables divided across the mesh,
      replicated per-pod arrays per in-flight slot, x WORKSPACE_FACTOR)
      — what ``plan_chunk`` asserts against the budget;
    - ``session_upload_bytes``: host->device bytes of a FRESH-session
      first chunk (tables + state + per-pod arrays), mirroring the
      ``scheduler_tpu_host_to_device_bytes_total`` accounting so the
      model is checkable against the measured counter;
    - ``chunk_upload_bytes`` / ``chunk_upload_bytes_compact``: the
      steady-state per-chunk upload with full per-pod rows vs the
      compact wire (one representative row per group chunk — the
      uniform-backlog fast path); a CHAINED chunk additionally skips
      ``bstate_bytes``.
    """

    nodes: int
    chunk_pods: int
    node_pad: int
    pod_pad: int
    devices: int
    sharded_bytes: int
    replicated_bytes: int
    per_device_bytes: int
    session_upload_bytes: int
    chunk_upload_bytes: int
    chunk_upload_bytes_compact: int
    bstate_bytes: int
    components: tuple


def estimate(shape: DrainShape) -> ShapeEstimate:
    """Per-component byte model of one drain-chunk dispatch, mirroring
    the arrays ``ExactSolver.solve`` uploads/keeps resident (the
    packed-transfer layer's wire protocol) under the tensorizers' own
    padding discipline."""
    pad_mult = shape.pad_multiple or shape.mesh_devices
    n = node_padding(shape.nodes, pad_mult)
    p = pod_padding(shape.chunk_pods, shape.group)
    k = shape.vocab_k
    c = bucket_pow2(max(shape.classes, 1), floor=CLASS_PAD)
    b = max(shape.port_rows, 1)
    s = max(shape.spread_rows, 1)
    ti = max(shape.ipa_in_rows, 1)
    te = max(shape.ipa_ex_rows, 1)

    # -- node-sharded residents (trailing node axis) --
    node_tables = k * n * 8 + n * 4 + n  # alloc + max_pods + valid
    persist = k * n * 8 + 2 * n * 8 + n * 4  # used + nonzero + pod_count
    class_tables = (
        c * n * (1 + 4 + 4 + 4)  # mask + taint + nodeaff + image
        + s * n * (4 + 1)  # spr.dom + spr.elig
        + (ti + te) * n * 4  # ipa.in_dom + ipa.ex_dom
        # per-instance/per-class scalar tables (max_skew, min_domains,
        # self_match, is_hostname, hard, soft, in_pref_w, cls_* rows,
        # ex_anti): node-axis-free, a rounding error at drain scale
        + s * 10 + ti * 4 + te + c * 5 * 4
    )
    bstate = (b + s + ti + te) * n * 4  # port_used + cnt0 + in/ex rows
    # the stream carry keeps one extra generation of the occupancy rows
    # resident while the next chained solve donates through
    carry = bstate
    sharded = node_tables + persist + class_tables + bstate + carry

    # -- replicated per-pod arrays, one set per in-flight ring slot --
    i64_w = (k + 2) * 8  # req [K] + nonzero_req [2]
    i32_w = (1 + b) * 4  # class_of + pod_takes [B]
    bool_w = k + 1 + b  # req_mask + pod_valid + pod_conflict [B]
    if shape.spread:
        bool_w += s  # spr_placed
    if shape.interpod:
        i32_w += (2 * ti + te) * 4  # in_match + m_w [Ti], ex_owned [Te]
        bool_w += te + 1  # m_anti [Te] + self_aff
    per_pod = i64_w + i32_w + bool_w
    kinds_vcnt = (p // max(shape.group, 1)) * 8 + 8 + 4  # kinds+vcnt+dummies
    slot = p * per_pod + p * 4 + kinds_vcnt  # + assignments
    slots_live = shape.stream_depth + 1
    replicated = slots_live * slot

    devices = max(shape.mesh_devices, 1)
    per_device = int(
        WORKSPACE_FACTOR * (math.ceil(sharded / devices) + replicated)
    )

    chunk_upload = p * per_pod + bstate + kinds_vcnt
    chunk_upload_compact = (p // max(shape.group, 1)) * per_pod + bstate + kinds_vcnt
    session_upload = node_tables + persist + class_tables + chunk_upload

    return ShapeEstimate(
        nodes=shape.nodes,
        chunk_pods=shape.chunk_pods,
        node_pad=n,
        pod_pad=p,
        devices=devices,
        sharded_bytes=sharded,
        replicated_bytes=replicated,
        per_device_bytes=per_device,
        session_upload_bytes=session_upload,
        chunk_upload_bytes=chunk_upload,
        chunk_upload_bytes_compact=chunk_upload_compact,
        bstate_bytes=bstate,
        components=(
            ("node_tables", node_tables, True),
            ("persist", persist, True),
            ("class_tables", class_tables, True),
            ("bstate_rows", bstate, True),
            ("stream_carry", carry, True),
            ("per_pod_slots", replicated, False),
        ),
    )


@dataclass(frozen=True)
class RelaxEstimate:
    """Analytic per-device footprint of one relaxation solve
    (solver/relax.py): the [RC, N] class tables + [K, N] duals shard
    over the node axis; the per-pod rank/searchsorted workspace
    replicates. Same WORKSPACE_FACTOR discipline as the drain model."""

    node_pad: int
    pod_pad: int
    rc_pad: int
    sharded_bytes: int
    replicated_bytes: int
    per_device_bytes: int
    components: tuple


def relax_estimate(
    nodes: int,
    pods: int,
    rc: int,
    vocab_k: int = 3,
    mesh_devices: int = 1,
    group: int = 64,
) -> RelaxEstimate:
    """Byte model of the relaxation's resident set at (pods, nodes,
    rc): what ``RelaxSolver`` asserts against the device budget before
    the 2M-pod mega-shape dispatches. Mirrors the arrays ``_relax``
    materializes — fractional mass / logits / quota tables on [RC, N],
    duals and integer capacities on [K, N], the flat quota prefix on
    [RC * N], and the per-pod sort/rank/searchsorted workspace."""
    pad_mult = mesh_devices if mesh_devices > 1 else 1
    n = node_padding(nodes, pad_mult)
    p = pod_padding(pods, group)
    k = vocab_k
    # [RC, N] lanes: x + softmax workspace (z, logits, pen) f32, the
    # static ok mask (bool), desired + clamped quotas (int32)
    class_tables = rc * n * (4 * 4 + 1 + 2 * 4)
    # [K, N]: lam f32, free int64, alloc/used int64, inv_free f32
    duals = k * n * (4 + 8 + 8 + 8 + 4) + n * (4 + 4 + 4)  # + mu/cnt/score
    flat_prefix = rc * n * 8 * 2  # flat_q + gcum, int64
    sharded = class_tables + duals + flat_prefix
    # per-pod workspace: sort key + argsort (int64), rc_of/priority/
    # rank/assigned (int32), valid (bool), g/flat_cell (int64)
    per_pod = 8 + 8 + 4 * 4 + 1 + 8 + 8
    replicated = p * per_pod
    devices = max(mesh_devices, 1)
    per_device = int(
        WORKSPACE_FACTOR * (math.ceil(sharded / devices) + replicated)
    )
    return RelaxEstimate(
        node_pad=n,
        pod_pad=p,
        rc_pad=rc,
        sharded_bytes=sharded,
        replicated_bytes=replicated,
        per_device_bytes=per_device,
        components=(
            ("class_tables", class_tables, True),
            ("duals", duals, True),
            ("flat_prefix", flat_prefix, True),
            ("pod_workspace", replicated, False),
        ),
    )


def device_budget_bytes(override: int = 0, device=None, shards_per_device: int = 1) -> int:
    """The per-device memory budget: an explicit override; else, on a
    CUDA ``device`` (None: the current card, when CUDA is available), the
    bytes this process can still allocate there -- the card's free memory
    plus the caching allocator's reserved bytes not allocated now, capped
    by the per-process memory fraction's limit on the allocator's
    reserve (the counterpart of the JAX package's ``bytes_limit``); else
    the conservative DEFAULT_DEVICE_BUDGET_BYTES floor.

    ``shards_per_device``: the most node-axis mesh shards one device
    holds. ``estimate``'s per-device bytes are one shard's share (the
    sharded tables divided by the shard count, as the JAX package divides
    by its device count); k shards on one card hold all k shares there,
    so the budget one shard plans against is the device's divided by k."""
    spd = max(int(shards_per_device), 1)
    return _device_budget_bytes(override, device) // spd


def _device_budget_bytes(override: int, device) -> int:
    if override > 0:
        return override
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return DEFAULT_DEVICE_BUDGET_BYTES
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return DEFAULT_DEVICE_BUDGET_BYTES
    if device.index is None:  # the memory-fraction query wants an index
        device = torch.device("cuda", torch.cuda.current_device())
    free, total = torch.cuda.mem_get_info(device)
    reserved = torch.cuda.memory_reserved(device)
    allocated = torch.cuda.memory_allocated(device)
    limit = free + reserved
    fraction = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    if fraction is not None:
        limit = min(limit, int(fraction(device) * total))
    return max(int(limit - allocated), 0)


def split_fleet_budget(
    total_bytes: int, replicas: int, *, replica_index: int = 0
) -> int:
    """One replica's slice of a shared per-device HBM budget for the
    FLEET backlog drain. Multi-process replicas own exclusive device
    slices and pass the full budget through (replicas=1); co-hosted
    replicas (sim, tests) drain CONCURRENTLY against the same device,
    so each must plan its chunks against an even split — the remainder
    goes to the low indices, and every replica gets at least one byte
    so ``plan_chunk`` fails typed (BudgetExceeded), not on a zero."""
    replicas = max(int(replicas), 1)
    total = max(int(total_bytes), replicas)
    share, rem = divmod(total, replicas)
    return share + (1 if int(replica_index) % replicas < rem else 0)


def plan_chunk(
    shape: DrainShape,
    budget_bytes: int,
    min_chunk: int = 0,
) -> tuple[ShapeEstimate, int]:
    """Largest group-aligned chunk <= ``shape.chunk_pods`` whose
    per-device estimate fits ``budget_bytes``. Returns (estimate,
    splits) where ``splits`` counts the halvings taken — the
    budget-driven auto-split the drain metrics report. Raises the typed
    ``BudgetExceeded`` when even the minimum chunk (one group, floor
    LANE/8) does not fit: nothing has touched the device, so the caller
    can refuse cleanly instead of OOMing mid-drain."""
    import dataclasses

    group = max(shape.group, 1)
    floor = max(min_chunk, min(group, shape.chunk_pods), 1)
    chunk = shape.chunk_pods
    splits = 0
    while True:
        est = estimate(dataclasses.replace(shape, chunk_pods=chunk))
        assert_index_headroom(
            est.pod_pad, est.node_pad, d_pad=shape.d_pad, group=group
        )
        if est.per_device_bytes <= budget_bytes:
            return est, splits
        if chunk <= floor:
            raise BudgetExceeded(est, budget_bytes)
        half = chunk // 2
        if half >= group:
            half = (half // group) * group  # keep the grouped bucket
        chunk = max(half, floor)
        splits += 1


def assert_index_headroom(
    pod_pad: int,
    node_pad: int,
    d_pad: int = DOM_PAD,
    group: int = 64,
    max_rounds_shift: int = 32,
    rc_pad: int = 0,
) -> None:
    """Typed overflow audit for the flattened-index arithmetic the
    compiled solve programs form at this shape (the 512k x 102k scale
    check). Each clause names the kernel-side product it guards:

    - grouped quota positions (`rank * d_present + d_rank`,
      solver/exact.py wf_accept): accepted ranks are < group and the
      scatter clamps to it, so the int32 container needs
      (group + 1) * d_pad + d_pad < 2^31;
    - unique per-node random keys (`randint(2^20) * n + iota`,
      exact.py winner_accept): int64 needs 2^20 * node_pad < 2^63;
    - auction admission sort keys (`target * 2^32 + inv_prio`,
      single_shot.py): int64 needs node_pad * 2^32 < 2^63;
    - class-rank keys (`rc_of * P + pod_idx`, single_shot.py): int64
      needs pod_pad^2 < 2^62 (rc count is bounded by pod count);
    - int32 per-pod/segment counters (cumsum ranks, pod counts):
      pod_pad and node_pad and d_pad each < 2^31;
    - with ``rc_pad`` > 0 (the relaxation mega-planner, solver/
      relax.py): the flat quota-prefix cell index (`rc * N`, int64)
      needs rc_pad * node_pad < 2^63, and the class-priority rank key
      (`rc * 2^32 + inv_prio`, int64) must stay strictly below the
      2^62 invalid-pod sentinel — the relaxation's own flattened-index
      lanes, audited at dispatch like the auction's.
    """
    i32 = 1 << 31
    i63 = 1 << 63
    if pod_pad >= i32 or node_pad >= i32 or d_pad >= i32:
        raise IndexWidthError(
            f"axis exceeds int32 index range: pods={pod_pad} "
            f"nodes={node_pad} domains={d_pad}"
        )
    if (group + 1) * d_pad + d_pad >= i32:
        raise IndexWidthError(
            f"grouped quota position (group={group} x d_pad={d_pad}) "
            "would overflow its int32 container"
        )
    if (1 << 20) * node_pad + node_pad >= i63:
        raise IndexWidthError(
            f"per-node random key (2^20 x nodes={node_pad}) would "
            "overflow int64"
        )
    if node_pad * (1 << max_rounds_shift) + (1 << 32) >= i63:
        raise IndexWidthError(
            f"admission sort key (nodes={node_pad} << 32) would "
            "overflow int64"
        )
    if pod_pad * pod_pad >= (1 << 62):
        raise IndexWidthError(
            f"class-rank key (P^2, P={pod_pad}) would overflow int64"
        )
    if rc_pad > 0:
        if rc_pad * node_pad >= i63:
            raise IndexWidthError(
                f"relax flat quota-prefix cell (rc={rc_pad} x "
                f"nodes={node_pad}) would overflow int64"
            )
        if rc_pad * (1 << 32) + (1 << 32) >= (1 << 62):
            raise IndexWidthError(
                f"relax class-priority rank key (rc={rc_pad} << 32) "
                "would cross the invalid-pod sentinel (2^62)"
            )
