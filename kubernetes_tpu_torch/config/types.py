"""KubeSchedulerConfiguration — typed config mirroring the reference's
component-config field names so reference YAML mostly parses unchanged
(pkg/scheduler/apis/config/types.go + v1/defaults.go + validation/,
SURVEY.md §6.6), plus the TPU solver section.

Covered surface:
- top level: parallelism, percentageOfNodesToScore, podInitialBackoffSeconds,
  podMaxBackoffSeconds, profiles[], extenders[]
- per profile: schedulerName, plugins{score.enabled[{name,weight}],
  filter/score disabled[...]} (the subset that changes solver behavior),
  pluginConfig[{name,args}] for NodeResourcesFitArgs.scoringStrategy
  (LeastAllocated | MostAllocated | RequestedToCapacityRatio),
  InterPodAffinityArgs.hardPodAffinityWeight,
  PodTopologySpreadArgs.defaultingType, NodeAffinityArgs.addedAffinity
- extenders[]: urlPrefix, filterVerb/prioritizeVerb/preemptVerb/bindVerb,
  weight, nodeCacheCapable, ignorable, managedResources
- tpuSolver (ours): batchSize, tieBreak, seed, balancedFdtype, singleShot
  {maxRounds, priceStep, topT, repairRounds}, enablePreemption, groupSize,
  meshDevices (node-axis solve mesh: 0 = all visible devices)
- rebalance (ours): enabled, intervalSeconds, maxMovesPerCycle,
  minPackingUtilization, minGainPoints, nominate — the continuous
  defragmentation loop (kubernetes_tpu/rebalance)
- fleet (ours): replica, replicas, hubAddress (a bulk gRPC server whose
  HubOp method serves the shared occupancy hub), meshSlice ("rank/count"
  — this replica's EXCLUSIVE contiguous slice of the visible device
  set), maxRowAgeSeconds — the active-active scale-out tier
  (kubernetes_tpu/fleet)
- gang (ours): enabled, minMemberTimeoutSeconds, quarantineAfter,
  throughputWeight, classThroughput / classThroughputPath — all-or-
  nothing pod-group scheduling plus the heterogeneity-aware
  effective-throughput objective (kubernetes_tpu/gang)

Unknown plugin names and unsupported pluginConfig args are collected into
`warnings` rather than rejected — the validation posture of a scheduler that
must accept configs written for the full reference plugin set.

Copied from ``kubernetes_tpu/config/types.py``. What differs:

- ``load`` takes a mapping, JSON text (the standard library's parser) or
  YAML text; ``yaml`` is imported only to parse YAML text, and its absence
  then raises an ImportError naming it. Nothing here imports it at
  module load, so the package needs no YAML parser.
- ``_solver_config`` maps onto the port's ``ExactSolverConfig``, which has
  no ``pallas`` switch (the port's kernel always runs); ``tpuSolver.pallas``
  is parsed and ignored.
- ``scheduler_config`` hands the ``fleet`` and ``rebalance`` sections to
  the ``SchedulerConfig`` as they are parsed, and ``fleet.meshSlice`` as
  ``mesh_slice``: the port's Scheduler refuses all three at construction
  (``_refuse_unported``, ``parallel/sharding.resolve_mesh``), naming their
  ROADMAP items, instead of ignoring them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# default score weights: apis/config/v1/default_plugins.go
DEFAULT_WEIGHTS = {
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "ImageLocality": 1,
}

KNOWN_PLUGINS = set(DEFAULT_WEIGHTS) | {
    "NodeName",
    "NodePorts",
    "NodeUnschedulable",
    "SchedulingGates",
    "PrioritySort",
    "DefaultPreemption",
    "DefaultBinder",
    "VolumeBinding",
    "VolumeRestrictions",
    "VolumeZone",
    "NodeVolumeLimits",
}


@dataclass
class ScoringStrategy:
    type: str = "LeastAllocated"  # | MostAllocated | RequestedToCapacityRatio
    resources: list[dict] = field(
        default_factory=lambda: [
            {"name": "cpu", "weight": 1},
            {"name": "memory", "weight": 1},
        ]
    )
    # RequestedToCapacityRatio shape points [{utilization, score}]
    shape: list[dict] = field(default_factory=list)


@dataclass
class Profile:
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    score_weights: dict[str, int] = field(
        default_factory=lambda: dict(DEFAULT_WEIGHTS)
    )
    disabled_filters: set[str] = field(default_factory=set)
    scoring_strategy: ScoringStrategy = field(default_factory=ScoringStrategy)
    hard_pod_affinity_weight: int = 1
    spread_defaulting_type: str = "System"  # System | List
    added_affinity: dict | None = None  # NodeAffinityArgs.addedAffinity


@dataclass
class Extender:
    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    preempt_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    managed_resources: list[dict] = field(default_factory=list)


@dataclass
class SingleShotSection:
    max_rounds: int = 32
    price_step: int = 8
    top_t: int = 1024
    # full-width repair rounds closing the scarcity gap (0 = off)
    repair_rounds: int = 16


@dataclass
class RebalanceSection:
    """``rebalance:`` — the continuous defragmentation loop
    (kubernetes_tpu/rebalance). Ours, like tpuSolver: no reference
    analog (upstream delegates to the out-of-tree descheduler)."""

    enabled: bool = False
    interval_seconds: float = 60.0
    # max-churn budget: evictions per rebalance cycle
    max_moves_per_cycle: int = 512
    # dominant-resource packed-utilization threshold below which the
    # in-use nodes count as fragmented
    min_packing_utilization: float = 0.7
    # minimum strict packing-score gain (percent points) per move
    min_gain_points: int = 1
    # carry the auction target as a nominated-node hint on eviction
    nominate: bool = True


@dataclass
class FleetSection:
    """``fleet:`` — the active-active fleet tier (kubernetes_tpu/fleet).
    Ours, like tpuSolver: the reference's only HA is active/passive
    leader election."""

    # this replica's identity; empty = fleet mode off
    replica: str = ""
    # the configured universe (the replica itself is always included)
    replicas: list[str] = field(default_factory=list)
    # "host:port" of a bulk gRPC server serving the shared occupancy
    # hub over its HubOp method (fleet/runtime.RemoteOccupancyExchange);
    # comma-separate several for a replicated hub (primary + standbys —
    # the client fails over between them, hub HA); empty = an
    # in-process private hub (single-replica degenerate)
    hub_address: str = ""
    # "rank/count": this replica's EXCLUSIVE mesh slice — contiguous
    # first-N partition of the visible device set, so N replicas on one
    # host solve against disjoint devices. None = no slice.
    mesh_slice: "tuple[int, int] | None" = None
    # occupancy-staleness bound (FleetConfig.max_row_age_s)
    max_row_age_seconds: float = 30.0
    # write-behind flush batch for the remote hub adapter
    # (FleetConfig.flush_batch); 0 = the adapter default. Auto-tunable
    # (tuning knob "fleet_flush").
    flush_batch: int = 0


@dataclass
class GangSection:
    """``gang:`` — all-or-nothing pod-group scheduling and the
    heterogeneity-aware effective-throughput objective
    (kubernetes_tpu/gang). Ours, like tpuSolver: the reference's gang
    support lives out of tree (scheduler-plugins coscheduling)."""

    enabled: bool = False
    # how long an incomplete group may wait for its remaining members
    # before the whole gang is quarantined
    min_member_timeout_seconds: float = 30.0
    # consecutive failed all-or-nothing rounds before the gang is
    # quarantined instead of requeued
    quarantine_after: int = 3
    # score points per unit of relative throughput (0 = objective off)
    throughput_weight: int = 0
    # inline (workload class -> accelerator class -> relative
    # throughput) matrix; mutually exclusive with classThroughputPath
    class_throughput: dict = field(default_factory=dict)
    # path to a JSON file holding the same matrix
    class_throughput_path: str = ""


@dataclass
class TpuSolverSection:
    batch_size: int = 1024
    tie_break: str = "random"  # random | first
    seed: int = 0
    balanced_fdtype: str = "float32"
    enable_preemption: bool = True
    # grouped fast-path chunk size (ExactSolverConfig.group_size; 0 = off)
    group_size: int = 64
    # node-axis mesh device count (SchedulerConfig.mesh_devices):
    # 0 = all visible devices, 1 = force single-device, N > 1 = first N.
    # Results are bit-exactly device-count invariant.
    mesh_devices: int = 0
    # streaming dispatcher work-ring depth (SchedulerConfig.stream_depth)
    stream_depth: int = 4
    # RTT-hiding batch split (SchedulerConfig.pipeline_split): 0 =
    # adaptive (CounterWindow EWMA rule / the tuning controller), 1 =
    # never split, > 1 = fixed cap
    pipeline_split: int = 0
    # backlog drain chunk (SchedulerConfig.backlog_chunk_pods): 0 =
    # plan from the HBM budget model starting at batchSize
    backlog_chunk_pods: int = 0
    # Pallas-kernel tier (ExactSolverConfig.pallas): route the
    # InterPodAffinity domain aggregation through the MXU kernel.
    # Default off — see ops/pallas_kernels.py's measured decision.
    pallas: bool = False
    single_shot: SingleShotSection = field(default_factory=SingleShotSection)


# the tunable hot-path knobs (kubernetes_tpu/tuning runtime names);
# kept literal here so parsing a config never imports the tuning (and
# transitively metrics/prometheus) machinery
TUNABLE_KNOBS = (
    "backlog_chunk",
    "stream_depth",
    "pipeline_split",
    "fleet_flush",
)


@dataclass
class TuningSection:
    """``tuning:`` — closed-loop hot-path auto-tuning
    (kubernetes_tpu/tuning). Ours, like tpuSolver. ``knobs`` names what
    the runtime may govern; to pin one knob statically, set its
    tpuSolver/fleet value and drop it from the list (the tuned-profile
    emitter writes exactly such a pinned document back out). An
    explicit empty list pins EVERYTHING — the runtime is inert; an
    absent key means all knobs."""

    enabled: bool = False
    eval_batches: int = 6
    hysteresis: float = 0.05
    settle_after: int = 2
    max_probes: int = 16
    shift_threshold: float = 0.75
    knobs: list[str] = field(
        default_factory=lambda: list(TUNABLE_KNOBS)
    )


def validate_tuning_params(
    eval_batches: int,
    hysteresis: float,
    settle_after: int,
    max_probes: int,
    shift_threshold: float,
    knobs,
) -> None:
    """The ONE home of the tuning-parameter range checks: the YAML
    loader below and ``TuningConfig.validate`` (kubernetes_tpu/tuning/
    runtime.py) both call it, so a bound change cannot land in one and
    not the other. Pure — importable from config parsing without
    dragging the tuning/metrics machinery in."""
    if eval_batches < 1:
        raise ValueError(
            f"tuning.evalBatches must be >= 1 (got {eval_batches})"
        )
    if not 0.0 < hysteresis < 1.0:
        raise ValueError(
            f"tuning.hysteresis must be in (0, 1) (got {hysteresis})"
        )
    if settle_after < 1:
        raise ValueError(
            f"tuning.settleAfter must be >= 1 (got {settle_after})"
        )
    if max_probes < 1:
        raise ValueError(
            f"tuning.maxProbes must be >= 1 (got {max_probes})"
        )
    if shift_threshold <= 0:
        raise ValueError(
            f"tuning.shiftThreshold must be > 0 (got {shift_threshold})"
        )
    unknown = set(knobs) - set(TUNABLE_KNOBS)
    if unknown:
        # a typo'd knob name would silently leave the intended knob
        # static — the quiet-misconfiguration failure mode, rejected
        # hard like fleet.meshSlice
        raise ValueError(
            f"tuning.knobs: unknown {sorted(unknown)}; "
            f"known: {list(TUNABLE_KNOBS)}"
        )


@dataclass
class KubeSchedulerConfiguration:
    parallelism: int = 16  # accepted for parity; the TPU solve is dense
    percentage_of_nodes_to_score: int = 0  # 0 = all (we always score all)
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    profiles: list[Profile] = field(default_factory=lambda: [Profile()])
    extenders: list[Extender] = field(default_factory=list)
    tpu_solver: TpuSolverSection = field(default_factory=TpuSolverSection)
    rebalance: RebalanceSection = field(default_factory=RebalanceSection)
    fleet: FleetSection = field(default_factory=FleetSection)
    tuning: TuningSection = field(default_factory=TuningSection)
    gang: GangSection = field(default_factory=GangSection)
    warnings: list[str] = field(default_factory=list)

    def profile_for(self, scheduler_name: str) -> Profile | None:
        for p in self.profiles:
            if p.scheduler_name == scheduler_name:
                return p
        return None


def _parse_plugin_config(profile: Profile, items, warnings: list[str]) -> None:
    for pc in items or ():
        name = pc.get("name")
        args = pc.get("args") or {}
        if name == "NodeResourcesFit":
            strat = (args.get("scoringStrategy") or {})
            if strat:
                profile.scoring_strategy = ScoringStrategy(
                    type=strat.get("type") or "LeastAllocated",
                    resources=strat.get("resources")
                    or ScoringStrategy().resources,
                    shape=(
                        (strat.get("requestedToCapacityRatio") or {}).get(
                            "shape"
                        )
                        or []
                    ),
                )
        elif name == "InterPodAffinity":
            if "hardPodAffinityWeight" in args:
                profile.hard_pod_affinity_weight = int(
                    args["hardPodAffinityWeight"]
                )
        elif name == "PodTopologySpread":
            if "defaultingType" in args:
                profile.spread_defaulting_type = args["defaultingType"]
        elif name == "NodeAffinity":
            if "addedAffinity" in args:
                profile.added_affinity = args["addedAffinity"]
        elif name in ("DefaultPreemption", "VolumeBinding"):
            pass  # accepted, defaults apply
        else:
            warnings.append(f"pluginConfig for {name!r} not consumed")


def _parse_profile(d: Mapping, warnings: list[str]) -> Profile:
    profile = Profile(
        scheduler_name=d.get("schedulerName") or DEFAULT_SCHEDULER_NAME
    )
    plugins = d.get("plugins") or {}
    for point in ("score", "multiPoint"):
        sec = plugins.get(point) or {}
        for e in sec.get("enabled") or ():
            name = e.get("name")
            if name not in KNOWN_PLUGINS:
                warnings.append(f"unknown plugin {name!r} enabled")
                continue
            if "weight" in e and name in DEFAULT_WEIGHTS:
                profile.score_weights[name] = int(e["weight"])
        for e in sec.get("disabled") or ():
            name = e.get("name")
            if name == "*":
                profile.score_weights = {k: 0 for k in profile.score_weights}
            elif name in DEFAULT_WEIGHTS:
                profile.score_weights[name] = 0
    for e in (plugins.get("filter") or {}).get("disabled") or ():
        name = e.get("name")
        if name:
            profile.disabled_filters.add(name)
    _parse_plugin_config(profile, d.get("pluginConfig"), warnings)
    return profile


def _nn(value, default):
    """``value`` unless it is None — the null-tolerant default for
    keys where falsy values (0, False) are meaningful, so neither
    ``get(k, d)`` (misses explicit YAML nulls) nor ``get(k) or d``
    (swallows 0/False) is right."""
    return default if value is None else value


def _parse_text(text: str):
    """JSON text through the standard library; anything else as YAML,
    which needs the ``yaml`` package (imported here only)."""
    import json

    if not text.strip():
        return {}
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "parsing YAML text needs the 'yaml' package (PyYAML); pass a "
            "mapping or JSON text instead"
        ) from e
    return yaml.safe_load(text)


def load(data: Mapping | str) -> KubeSchedulerConfiguration:
    """Parse a KubeSchedulerConfiguration document: a mapping, or JSON or
    YAML text."""
    if isinstance(data, str):
        data = _parse_text(data) or {}
    cfg = KubeSchedulerConfiguration()
    warnings = cfg.warnings

    api_version = data.get("apiVersion", "")
    if api_version and not api_version.startswith("kubescheduler.config.k8s.io/"):
        warnings.append(f"unexpected apiVersion {api_version!r}")

    if "parallelism" in data:
        cfg.parallelism = int(data["parallelism"])
    if "percentageOfNodesToScore" in data:
        cfg.percentage_of_nodes_to_score = int(data["percentageOfNodesToScore"])
        if cfg.percentage_of_nodes_to_score not in (0, 100):
            warnings.append(
                "percentageOfNodesToScore: the TPU solve always scores all "
                "nodes (dense is free); sampling is parsed but not applied"
            )
    if "podInitialBackoffSeconds" in data:
        cfg.pod_initial_backoff_seconds = float(data["podInitialBackoffSeconds"])
    if "podMaxBackoffSeconds" in data:
        cfg.pod_max_backoff_seconds = float(data["podMaxBackoffSeconds"])

    if data.get("profiles"):
        cfg.profiles = [_parse_profile(p, warnings) for p in data["profiles"]]
    names = [p.scheduler_name for p in cfg.profiles]
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate profile schedulerName in {names}")

    for e in data.get("extenders") or ():
        cfg.extenders.append(
            Extender(
                url_prefix=e.get("urlPrefix") or "",
                filter_verb=e.get("filterVerb") or "",
                prioritize_verb=e.get("prioritizeVerb") or "",
                preempt_verb=e.get("preemptVerb") or "",
                bind_verb=e.get("bindVerb") or "",
                weight=int(e.get("weight") or 1),
                node_cache_capable=bool(e.get("nodeCacheCapable")),
                ignorable=bool(e.get("ignorable")),
                managed_resources=list(e.get("managedResources") or ()),
            )
        )

    ts = data.get("tpuSolver") or {}
    ss = ts.get("singleShot") or {}
    cfg.tpu_solver = TpuSolverSection(
        batch_size=int(ts.get("batchSize") or 1024),
        tie_break=ts.get("tieBreak") or "random",
        seed=int(ts.get("seed") or 0),
        balanced_fdtype=ts.get("balancedFdtype") or "float32",
        enable_preemption=bool(ts.get("enablePreemption", True)),
        group_size=int(ts.get("groupSize", 64)),
        mesh_devices=int(ts.get("meshDevices", 0)),
        stream_depth=int(_nn(ts.get("streamDepth"), 4)),
        pipeline_split=int(_nn(ts.get("pipelineSplit"), 0)),
        backlog_chunk_pods=int(_nn(ts.get("backlogChunkPods"), 0)),
        pallas=bool(_nn(ts.get("pallas"), False)),
        single_shot=SingleShotSection(
            max_rounds=int(ss.get("maxRounds") or 32),
            price_step=int(ss.get("priceStep") or 8),
            top_t=int(ss.get("topT") or 1024),
            # .get-with-default + explicit None check: 0 is meaningful
            # (repair off), so the usual `or`-default shape is wrong,
            # and an explicit YAML null must still default, not
            # TypeError out of int()
            repair_rounds=int(_nn(ss.get("repairRounds"), 16)),
        ),
    )
    if cfg.tpu_solver.tie_break not in ("random", "first"):
        raise ValueError(f"tpuSolver.tieBreak: {cfg.tpu_solver.tie_break!r}")
    if cfg.tpu_solver.stream_depth < 1:
        raise ValueError(
            "tpuSolver.streamDepth must be >= 1 "
            f"(got {cfg.tpu_solver.stream_depth})"
        )
    if cfg.tpu_solver.pipeline_split < 0:
        # 0 is the adaptive mode; a negative would silently behave as
        # adaptive too — reject the ambiguity
        raise ValueError(
            "tpuSolver.pipelineSplit must be >= 0 "
            f"(got {cfg.tpu_solver.pipeline_split})"
        )
    if cfg.tpu_solver.backlog_chunk_pods < 0:
        raise ValueError(
            "tpuSolver.backlogChunkPods must be >= 0 "
            f"(got {cfg.tpu_solver.backlog_chunk_pods})"
        )
    if cfg.tpu_solver.single_shot.repair_rounds < 0:
        # a negative would silently disable the repair phase (the
        # solver gates on > 0) — reject like the rebalance knobs do
        raise ValueError(
            "tpuSolver.singleShot.repairRounds must be >= 0 "
            f"(got {cfg.tpu_solver.single_shot.repair_rounds})"
        )

    rb = data.get("rebalance") or {}
    cfg.rebalance = RebalanceSection(
        enabled=bool(_nn(rb.get("enabled"), False)),
        interval_seconds=float(_nn(rb.get("intervalSeconds"), 60.0)),
        max_moves_per_cycle=int(_nn(rb.get("maxMovesPerCycle"), 512)),
        min_packing_utilization=float(
            _nn(rb.get("minPackingUtilization"), 0.7)
        ),
        min_gain_points=int(_nn(rb.get("minGainPoints"), 1)),
        nominate=bool(_nn(rb.get("nominate"), True)),
    )
    if cfg.rebalance.max_moves_per_cycle < 0:
        raise ValueError(
            "rebalance.maxMovesPerCycle must be >= 0 "
            f"(got {cfg.rebalance.max_moves_per_cycle})"
        )
    if not 0.0 < cfg.rebalance.min_packing_utilization <= 1.0:
        raise ValueError(
            "rebalance.minPackingUtilization must be in (0, 1] "
            f"(got {cfg.rebalance.min_packing_utilization})"
        )
    if cfg.rebalance.interval_seconds <= 0:
        raise ValueError(
            "rebalance.intervalSeconds must be > 0 "
            f"(got {cfg.rebalance.interval_seconds})"
        )
    if cfg.rebalance.min_gain_points < 1:
        # > 0 is what guarantees each move strictly increases packing
        # potential, the termination argument that keeps repeated
        # cycles from thrashing (rebalance/runtime.py)
        raise ValueError(
            "rebalance.minGainPoints must be >= 1 "
            f"(got {cfg.rebalance.min_gain_points})"
        )

    fl = data.get("fleet") or {}
    cfg.fleet = FleetSection(
        replica=str(_nn(fl.get("replica"), "")),
        replicas=[str(r) for r in _nn(fl.get("replicas"), []) or []],
        hub_address=str(_nn(fl.get("hubAddress"), "")),
        mesh_slice=_parse_mesh_slice(fl.get("meshSlice")),
        max_row_age_seconds=float(_nn(fl.get("maxRowAgeSeconds"), 30.0)),
        flush_batch=int(_nn(fl.get("flushBatch"), 0)),
    )
    if cfg.fleet.flush_batch < 0:
        raise ValueError(
            "fleet.flushBatch must be >= 0 (0 = the adapter default; "
            f"got {cfg.fleet.flush_batch})"
        )
    if cfg.fleet.hub_address:
        # one or more comma-separated endpoints (a replicated hub
        # deployment lists primary + standbys); each must be host:port
        # — a typo silently degrading to a private hub is the failure
        # mode this hard validation exists to prevent
        endpoints = [
            t.strip() for t in cfg.fleet.hub_address.split(",")
        ]
        if not all(t and ":" in t for t in endpoints):
            raise ValueError(
                'fleet.hubAddress must be "host:port" (comma-separate '
                f"several for a replicated hub; got "
                f"{cfg.fleet.hub_address!r})"
            )
    if cfg.fleet.max_row_age_seconds <= 0:
        raise ValueError(
            "fleet.maxRowAgeSeconds must be > 0 "
            f"(got {cfg.fleet.max_row_age_seconds})"
        )
    if (
        cfg.fleet.replicas
        or cfg.fleet.hub_address
        or cfg.fleet.mesh_slice is not None
    ) and not cfg.fleet.replica:
        # meshSlice especially: honoring a slice with fleet mode off
        # would silently pin the sole scheduler to a fraction of the
        # devices — exactly the quiet capacity loss this section's
        # hard validation exists to prevent
        raise ValueError(
            "fleet.replica is required when any other fleet key is set "
            "(a replica must know its own identity)"
        )

    tu = data.get("tuning") or {}
    # knobs: an ABSENT key means all knobs; an explicit empty list
    # means "govern nothing" (everything pinned) — the falsy-`or`
    # shape would silently expand [] to all four, the exact quiet
    # misconfiguration the unknown-knob check rejects hard
    knobs_raw = tu.get("knobs")
    cfg.tuning = TuningSection(
        enabled=bool(_nn(tu.get("enabled"), False)),
        eval_batches=int(_nn(tu.get("evalBatches"), 6)),
        hysteresis=float(_nn(tu.get("hysteresis"), 0.05)),
        settle_after=int(_nn(tu.get("settleAfter"), 2)),
        max_probes=int(_nn(tu.get("maxProbes"), 16)),
        shift_threshold=float(_nn(tu.get("shiftThreshold"), 0.75)),
        knobs=(
            list(TUNABLE_KNOBS)
            if knobs_raw is None
            else [str(k) for k in knobs_raw]
        ),
    )
    validate_tuning_params(
        cfg.tuning.eval_batches,
        cfg.tuning.hysteresis,
        cfg.tuning.settle_after,
        cfg.tuning.max_probes,
        cfg.tuning.shift_threshold,
        cfg.tuning.knobs,
    )

    gg = data.get("gang") or {}
    cfg.gang = GangSection(
        enabled=bool(_nn(gg.get("enabled"), False)),
        min_member_timeout_seconds=float(
            _nn(gg.get("minMemberTimeoutSeconds"), 30.0)
        ),
        quarantine_after=int(_nn(gg.get("quarantineAfter"), 3)),
        throughput_weight=int(_nn(gg.get("throughputWeight"), 0)),
        class_throughput=dict(_nn(gg.get("classThroughput"), {}) or {}),
        class_throughput_path=str(_nn(gg.get("classThroughputPath"), "")),
    )
    if cfg.gang.min_member_timeout_seconds <= 0:
        raise ValueError(
            "gang.minMemberTimeoutSeconds must be > 0 "
            f"(got {cfg.gang.min_member_timeout_seconds})"
        )
    if cfg.gang.quarantine_after < 1:
        # 0 would quarantine every gang on its first incomplete round —
        # plausibly intended as "off", so reject the ambiguity hard
        raise ValueError(
            "gang.quarantineAfter must be >= 1 "
            f"(got {cfg.gang.quarantine_after})"
        )
    if cfg.gang.throughput_weight < 0:
        raise ValueError(
            "gang.throughputWeight must be >= 0 (0 = objective off; "
            f"got {cfg.gang.throughput_weight})"
        )
    if cfg.gang.class_throughput and cfg.gang.class_throughput_path:
        # the quiet failure mode: both set, one silently wins
        raise ValueError(
            "gang.classThroughput and gang.classThroughputPath are "
            "mutually exclusive"
        )
    _validate_throughput_table(cfg.gang.class_throughput)
    return cfg


def _validate_throughput_table(table: Mapping) -> None:
    """Hard-validate the inline (workload -> accelerator -> relative
    throughput) matrix — a malformed row silently scoring 0 is exactly
    the quiet capacity loss gang scoring exists to prevent."""
    for wl, per in table.items():
        if not isinstance(per, Mapping):
            raise ValueError(
                f"gang.classThroughput[{wl!r}] must be a mapping of "
                f"accelerator class -> relative throughput (got {per!r})"
            )
        for ac, rel in per.items():
            try:
                val = float(rel)
            except (TypeError, ValueError):
                raise ValueError(
                    f"gang.classThroughput[{wl!r}][{ac!r}] must be a "
                    f"number (got {rel!r})"
                ) from None
            if val < 0:
                raise ValueError(
                    f"gang.classThroughput[{wl!r}][{ac!r}] must be "
                    f">= 0 (got {val})"
                )


def _parse_mesh_slice(value) -> "tuple[int, int] | None":
    """fleet.meshSlice "rank/count" -> (rank, count). Null/empty = no
    slice; anything malformed is a hard error (a typo silently sharing
    devices between replicas is the failure mode this key exists to
    prevent)."""
    if value is None or value == "":
        return None
    try:
        rank_s, count_s = str(value).split("/", 1)
        rank, count = int(rank_s), int(count_s)
    except ValueError:
        raise ValueError(
            'fleet.meshSlice must be "rank/count" (e.g. "0/4"); '
            f"got {value!r}"
        ) from None
    if count < 1 or not 0 <= rank < count:
        raise ValueError(
            f"fleet.meshSlice needs 0 <= rank < count; got {value!r}"
        )
    return (rank, count)


def load_file(path: str) -> KubeSchedulerConfiguration:
    with open(path) as f:
        return load(f.read())


from ..tensorize.plugins import VOLUME_PLUGINS as VOLUME_FILTER_PLUGINS

# filter-point plugin names the solver/tensorizer can actually disable
DISABLEABLE_FILTERS = VOLUME_FILTER_PLUGINS | {
    "NodeResourcesFit", "NodePorts", "NodeName", "NodeUnschedulable",
    "TaintToleration", "NodeAffinity", "PodTopologySpread",
    "InterPodAffinity",
}


def _solver_config(cfg: KubeSchedulerConfiguration, p: Profile):
    from ..solver.exact import ExactSolverConfig

    w = p.score_weights
    # scoringStrategy.resources -> cpu/memory weights (the NonZero scoring
    # pipeline tracks exactly those two; anything else is warned away)
    res_weights = {"cpu": 1, "memory": 1}
    for r in p.scoring_strategy.resources:
        name = r.get("name")
        if name in res_weights:
            res_weights[name] = int(r.get("weight") or 1)
        else:
            cfg.warnings.append(
                f"scoringStrategy resource {name!r}: only cpu/memory are "
                "tracked by the NonZero scoring pipeline; ignored"
            )
    # requestedToCapacityRatio.shape validation
    # (apis/config/validation#validateFunctionShape semantics): every point
    # needs utilization+score, utilization strictly ascending; a malformed
    # shape warns and falls back to LeastAllocated instead of raising, the
    # same degradation already used for the empty-shape case.
    rtc_shape: tuple = ()
    try:
        rtc_shape = tuple(
            (int(s["utilization"]), int(s["score"]))
            for s in p.scoring_strategy.shape
        )
    except (KeyError, TypeError, ValueError) as e:
        cfg.warnings.append(
            "scoringStrategy requestedToCapacityRatio.shape entry is "
            f"malformed ({e!r}); falling back to LeastAllocated"
        )
    if rtc_shape and any(
        b[0] <= a[0] for a, b in zip(rtc_shape, rtc_shape[1:])
    ):
        cfg.warnings.append(
            "scoringStrategy requestedToCapacityRatio.shape utilization "
            "breakpoints must be strictly ascending; falling back to "
            "LeastAllocated"
        )
        rtc_shape = ()
    if p.scoring_strategy.type == "RequestedToCapacityRatio" and not rtc_shape:
        cfg.warnings.append(
            "scoringStrategy RequestedToCapacityRatio without a valid "
            "requestedToCapacityRatio.shape (upstream validation rejects "
            "this); falling back to LeastAllocated"
        )
    disabled = []
    for name in sorted(p.disabled_filters):
        if name in DISABLEABLE_FILTERS:
            disabled.append(name)
            if name in VOLUME_FILTER_PLUGINS:
                cfg.warnings.append(
                    f"filter {name!r} disabled: the volume plugin family is "
                    "fused in the static mask, so all four volume filters "
                    "are disabled together"
                )
        else:
            cfg.warnings.append(f"cannot disable filter {name!r}; ignored")
    added = None
    if p.added_affinity is not None:
        from ..api.objects import NodeAffinity

        added = NodeAffinity.from_dict(p.added_affinity)
    return ExactSolverConfig(
        tie_break=cfg.tpu_solver.tie_break,
        seed=cfg.tpu_solver.seed,
        balanced_fdtype=cfg.tpu_solver.balanced_fdtype,
        group_size=cfg.tpu_solver.group_size,
        scoring_strategy=p.scoring_strategy.type,
        cpu_weight=res_weights["cpu"],
        mem_weight=res_weights["memory"],
        rtc_shape=rtc_shape,
        fit_weight=w.get("NodeResourcesFit", 1),
        balanced_weight=w.get("NodeResourcesBalancedAllocation", 1),
        taint_weight=w.get("TaintToleration", 3),
        node_affinity_weight=w.get("NodeAffinity", 2),
        image_weight=w.get("ImageLocality", 1),
        spread_weight=w.get("PodTopologySpread", 2),
        interpod_weight=w.get("InterPodAffinity", 2),
        hard_pod_affinity_weight=p.hard_pod_affinity_weight,
        disabled_filters=tuple(disabled),
        added_affinity=added,
        spread_defaulting=p.spread_defaulting_type,
    )


def scheduler_config(cfg: KubeSchedulerConfiguration):
    """Build the runtime SchedulerConfig — ALL profiles become solver
    entries so pods route by spec.schedulerName (profile.NewMap)."""
    from ..scheduler import SchedulerConfig

    profiles = {
        p.scheduler_name: _solver_config(cfg, p) for p in cfg.profiles
    }
    # the rebalancer (ROADMAP item 9) and fleet mode (item 8) are not
    # ported: their parsed sections ride along so the Scheduler refuses
    # them at construction instead of running without them
    rebalance = cfg.rebalance if cfg.rebalance.enabled else None
    fleet = cfg.fleet if cfg.fleet.replica else None
    gang = None
    if cfg.gang.enabled:
        from ..gang import GangConfig, load_throughput_table

        table = cfg.gang.class_throughput
        if cfg.gang.class_throughput_path:
            table = load_throughput_table(cfg.gang.class_throughput_path)
            _validate_throughput_table(table)
        gang = GangConfig(
            min_member_timeout=cfg.gang.min_member_timeout_seconds,
            quarantine_after=cfg.gang.quarantine_after,
            throughput_weight=cfg.gang.throughput_weight,
            class_throughput=dict(table),
        )
    tuning = None
    if cfg.tuning.enabled:
        from ..tuning.runtime import TuningConfig

        tuning = TuningConfig(
            eval_batches=cfg.tuning.eval_batches,
            hysteresis=cfg.tuning.hysteresis,
            settle_after=cfg.tuning.settle_after,
            max_probes=cfg.tuning.max_probes,
            shift_threshold=cfg.tuning.shift_threshold,
            knobs=tuple(cfg.tuning.knobs),
        )
    return SchedulerConfig(
        batch_size=cfg.tpu_solver.batch_size,
        enable_preemption=cfg.tpu_solver.enable_preemption,
        mesh_devices=cfg.tpu_solver.mesh_devices,
        mesh_slice=cfg.fleet.mesh_slice,
        stream_depth=cfg.tpu_solver.stream_depth,
        pipeline_split=cfg.tpu_solver.pipeline_split,
        backlog_chunk_pods=cfg.tpu_solver.backlog_chunk_pods,
        solver=profiles[cfg.profiles[0].scheduler_name],
        profiles=profiles,
        # honored, not just parsed: the scheduler consults these via the
        # outbound HTTP client during every solve
        extenders=tuple(cfg.extenders),
        rebalance=rebalance,
        fleet=fleet,
        tuning=tuning,
        gang=gang,
    )
