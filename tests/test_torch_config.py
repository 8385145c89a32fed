"""The port's KubeSchedulerConfiguration bridge against the JAX package's.

The load, validation and mapping cases of ``tests/test_config.py``:
``kubernetes_tpu_torch.config.types.load`` must parse every document as
``kubernetes_tpu.config.types.load`` does (same sections, same warnings,
same errors), and ``scheduler_config`` must give the port a
``SchedulerConfig`` whose fields equal the JAX package's field by field
(the solver configs but the TPU-only ``pallas`` switch; ``fleet`` and
``rebalance`` reach the port as their parsed sections, which its
Scheduler refuses). The cases that schedule build the same cluster in
both packages and must bind alike. ``test_cli_config_command`` becomes a
``load_file`` case (the CLI is ROADMAP item 8); ``test_cli_perf_command``
(the perf runner, item 8) has no counterpart here.
"""

import dataclasses
import json
import textwrap

import pytest
import yaml

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.config import types as ref_ct
from kubernetes_tpu.scheduler import Scheduler as RefScheduler
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.config import types as ct
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig

from _torch_sched_pair import batch_view

REFERENCE_STYLE_YAML = """
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
parallelism: 8
percentageOfNodesToScore: 50
podInitialBackoffSeconds: 2
podMaxBackoffSeconds: 20
profiles:
  - schedulerName: default-scheduler
    pluginConfig:
      - name: NodeResourcesFit
        args:
          scoringStrategy:
            type: MostAllocated
            resources:
              - name: cpu
                weight: 2
              - name: memory
                weight: 1
      - name: InterPodAffinity
        args:
          hardPodAffinityWeight: 10
  - schedulerName: batch-scheduler
    plugins:
      score:
        enabled:
          - name: TaintToleration
            weight: 5
        disabled:
          - name: ImageLocality
extenders:
  - urlPrefix: http://127.0.0.1:10259
    filterVerb: filter
    prioritizeVerb: prioritize
    weight: 2
    nodeCacheCapable: true
    ignorable: true
tpuSolver:
  batchSize: 2048
  tieBreak: first
  meshDevices: 4
"""


def plain(x):
    """A config object as plain data, for comparison across packages."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x) if f.name != "pallas"}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, set):
        return sorted(x)
    if hasattr(x, "to_dict"):
        return x.to_dict()
    return x


def loaded(doc):
    """Both packages' parse of ``doc``: the sections must be equal."""
    port, ref = ct.load(doc), ref_ct.load(doc)
    assert plain(port) == plain(ref)
    return port, ref


def bridged(doc):
    """Both packages' SchedulerConfig for ``doc``, held field by field."""
    port, ref = loaded(doc)
    sc, rsc = ct.scheduler_config(port), ref_ct.scheduler_config(ref)
    assert isinstance(sc, SchedulerConfig)
    assert port.warnings == ref.warnings
    for f in dataclasses.fields(sc):
        if not hasattr(rsc, f.name):
            continue
        a, b = getattr(sc, f.name), getattr(rsc, f.name)
        if f.name in ("fleet", "rebalance"):
            assert (a is None) == (b is None), f.name
        else:
            assert plain(a) == plain(b), f.name
    return sc, port


def test_reference_style_yaml_parses():
    cfg, _ = loaded(REFERENCE_STYLE_YAML)
    assert cfg.parallelism == 8
    assert cfg.pod_initial_backoff_seconds == 2
    assert any("percentageOfNodesToScore" in w for w in cfg.warnings)
    assert len(cfg.profiles) == 2
    p0 = cfg.profile_for("default-scheduler")
    assert p0.scoring_strategy.type == "MostAllocated"
    assert p0.hard_pod_affinity_weight == 10
    p1 = cfg.profile_for("batch-scheduler")
    assert p1.score_weights["TaintToleration"] == 5
    assert p1.score_weights["ImageLocality"] == 0
    assert cfg.extenders[0].node_cache_capable
    assert cfg.tpu_solver.batch_size == 2048
    assert cfg.tpu_solver.tie_break == "first"
    assert cfg.tpu_solver.mesh_devices == 4
    sc, _ = bridged(REFERENCE_STYLE_YAML)
    assert sc.mesh_devices == 4
    with pytest.raises(NotImplementedError, match="item 11"):  # one card
        Scheduler(convert.cluster_state(ClusterState()), sc, device="cpu")


def test_duplicate_profile_rejected():
    bad = {"profiles": [{"schedulerName": "x"}, {"schedulerName": "x"}]}
    for mod in (ct, ref_ct):
        with pytest.raises(ValueError):
            mod.load(bad)


def test_scheduler_config_bridge():
    sc, _ = bridged(REFERENCE_STYLE_YAML)
    assert sc.batch_size == 2048
    assert set(sc.profiles) == {"default-scheduler", "batch-scheduler"}
    batch = sc.profiles["batch-scheduler"]
    assert batch.taint_weight == 5 and batch.image_weight == 0
    assert batch.tie_break == "first"
    assert sc.profiles["default-scheduler"].scoring_strategy == "MostAllocated"


def test_json_text_and_load_file(tmp_path):
    """JSON text loads through the standard library, and ``load_file``
    reads YAML or JSON (``test_cli_config_command``'s round trip)."""
    doc = json.dumps({"tpuSolver": {"batchSize": 2048, "streamDepth": 2, "pipelineSplit": 3,
                                    "backlogChunkPods": 512}, "tuning": {"enabled": True}})
    sc, _ = bridged(doc)
    assert (sc.batch_size, sc.stream_depth, sc.pipeline_split, sc.backlog_chunk_pods) == (2048, 2, 3, 512)
    assert sc.tuning is not None and sc.tuning.eval_batches == 6
    p = tmp_path / "cfg.yaml"
    p.write_text(REFERENCE_STYLE_YAML)
    cfg = ct.load_file(str(p))
    assert cfg.profiles[0].scoring_strategy.type == "MostAllocated"
    assert cfg.tpu_solver.batch_size == 2048
    assert plain(cfg) == plain(ref_ct.load_file(str(p)))
    q = tmp_path / "cfg.json"
    q.write_text(doc)
    assert plain(ct.load_file(str(q))) == plain(ct.load(doc))


def run_both(ref_cs, port_cfg, ref_cfg):
    """One schedule_batch on each package over copies of ``ref_cs``."""
    port_cs = convert.cluster_state(ref_cs)
    ref_cfg.mesh_devices = 1
    ref = RefScheduler(ref_cs, ref_cfg)
    port = Scheduler(port_cs, port_cfg, device="cpu")
    return ref, port, ref_cs, port_cs


def step_both(ref, port):
    r, p = ref.schedule_batch(), port.schedule_batch()
    assert batch_view(p) == batch_view(r)
    return p


def from_yaml(text, ref_cs):
    doc = textwrap.dedent(text)
    sc, cfg = bridged(doc)
    ref, port, _, port_cs = run_both(ref_cs, sc, ref_ct.scheduler_config(ref_ct.load(doc)))
    return ref, port, port_cs, cfg


def both_create(ref_cs, port_cs, pod):
    from kubernetes_tpu_torch.api import objects

    port_cs.create_pod(convert.api_object(pod, objects.Pod))
    ref_cs.create_pod(pod)


def test_multi_profile_routing():
    from kubernetes_tpu.scheduler import SchedulerConfig as RefConfig
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolver
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig

    cs = ClusterState()
    for i in range(4):
        cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj())
    names = ("default-scheduler", "batch-scheduler")
    ref, port, ref_cs, port_cs = run_both(
        cs,
        SchedulerConfig(batch_size=16, profiles={n: ExactSolverConfig(tie_break="first") for n in names}),
        RefConfig(batch_size=16, profiles={n: RefSolver(tie_break="first") for n in names}),
    )
    both_create(ref_cs, port_cs, MakePod().name("a").req({"cpu": "1"}).obj())
    both_create(ref_cs, port_cs, MakePod().name("b").scheduler_name("batch-scheduler").req({"cpu": "1"}).obj())
    both_create(ref_cs, port_cs, MakePod().name("ghost").scheduler_name("other").req({"cpu": "1"}).obj())
    r = step_both(ref, port)
    assert {k for k, _ in r.scheduled} == {"default/a", "default/b"}
    assert port.pending == 0


def test_node_update_precheck_gates_wakeups():
    from kubernetes_tpu.scheduler import SchedulerConfig as RefConfig
    from kubernetes_tpu_torch.api import objects

    cs = ClusterState()
    cs.create_node(MakeNode().name("n0").capacity({"cpu": "1", "memory": "4Gi", "pods": "10"}).obj())
    ref, port, ref_cs, port_cs = run_both(cs, SchedulerConfig(batch_size=4), RefConfig(batch_size=4))
    both_create(ref_cs, port_cs, MakePod().name("big").req({"cpu": "4"}).obj())
    r = step_both(ref, port)
    assert r.unschedulable == ["default/big"]
    for s, c in ((ref, ref_cs), (port, port_cs)):
        assert s.queue.pending_counts()["unschedulable"] == 1
        c.update_node(c.get_node("n0"))  # irrelevant: stays parked
        assert s.queue.pending_counts()["unschedulable"] == 1
    bigger = MakeNode().name("n0").capacity({"cpu": "8", "memory": "4Gi", "pods": "10"}).obj()
    port_cs.update_node(convert.api_object(bigger, objects.Node))
    ref_cs.update_node(bigger)
    counts = [s.queue.pending_counts() for s in (ref, port)]
    assert counts[1] == counts[0]
    assert counts[1]["unschedulable"] == 0
    assert counts[1]["active"] + counts[1]["backoff"] == 1


def test_most_allocated_strategy_parity():
    """MostAllocated (bin-packing) through the port's solver: the pods
    pile onto the loaded node, as the JAX solver places them."""
    from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefCfg
    from kubernetes_tpu.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
    from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig

    nodes = [MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj() for i in range(3)]
    seed = MakePod().name("seed").node("n0").req({"cpu": "2", "memory": "4Gi"}).obj()
    pods = [MakePod().name(f"p{i}").req({"cpu": "1", "memory": "2Gi"}).obj() for i in range(4)]
    vocab = ResourceVocab.build(pods + [seed], nodes)
    ref = RefSolver(RefCfg(tie_break="first", scoring_strategy="MostAllocated")).solve(
        build_node_batch(nodes, {"n0": [seed]}, vocab=vocab), build_pod_batch(pods, vocab)
    )
    nb = convert.node_batch(build_node_batch(nodes, {"n0": [seed]}, vocab=vocab))
    pb = convert.pod_batch(build_pod_batch(pods, vocab))
    got = ExactSolver(ExactSolverConfig(tie_break="first", scoring_strategy="MostAllocated")).solve(
        nb, pb, device="cpu"
    )
    assert list(got) == list(ref)
    assert all(x == 0 for x in got)


def test_disabled_filter_stops_filtering():
    def cluster():
        cs = ClusterState()
        cs.create_node(
            MakeNode().name("tainted").capacity({"cpu": "4", "memory": "8Gi", "pods": "10"})
            .taint("dedicated", "gpu", "NoSchedule").obj()
        )
        return cs

    ref, port, port_cs, _ = from_yaml(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            plugins:
              filter:
                disabled:
                  - name: TaintToleration
        """,
        cs := cluster(),
    )
    both_create(cs, port_cs, MakePod().name("p").req({"cpu": "1"}).obj())
    assert ("default/p", "tainted") in step_both(ref, port).scheduled
    from kubernetes_tpu.scheduler import SchedulerConfig as RefConfig

    ref2, port2, ref_cs2, port_cs2 = run_both(cluster(), SchedulerConfig(batch_size=4), RefConfig(batch_size=4))
    both_create(ref_cs2, port_cs2, MakePod().name("p").req({"cpu": "1"}).obj())
    assert step_both(ref2, port2).unschedulable == ["default/p"]


def test_disabled_fit_filter_overcommits():
    cs = ClusterState()
    cs.create_node(MakeNode().name("tiny").capacity({"cpu": "1", "memory": "1Gi", "pods": "10"}).obj())
    ref, port, port_cs, _ = from_yaml(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            plugins:
              filter:
                disabled:
                  - name: NodeResourcesFit
        """,
        cs,
    )
    both_create(cs, port_cs, MakePod().name("big").req({"cpu": "8"}).obj())
    assert ("default/big", "tiny") in step_both(ref, port).scheduled


def test_rtc_scoring_changes_placement():
    from kubernetes_tpu.scheduler import SchedulerConfig as RefConfig
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolver
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig

    def cluster():
        cs = ClusterState()
        for name, used_cpu in (("empty", 0), ("busy", 6)):
            cs.create_node(MakeNode().name(name).capacity({"cpu": "8", "memory": "16Gi", "pods": "20"}).obj())
            if used_cpu:
                cs.create_pod(
                    MakePod().name(f"filler-{name}").node(name).req({"cpu": str(used_cpu), "memory": "4Gi"}).obj()
                )
        return cs

    ref, port, port_cs, cfg = from_yaml(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            plugins:
              score:
                disabled:
                  - name: NodeResourcesBalancedAllocation
            pluginConfig:
              - name: NodeResourcesFit
                args:
                  scoringStrategy:
                    type: RequestedToCapacityRatio
                    resources:
                      - name: cpu
                        weight: 1
                      - name: memory
                        weight: 1
                    requestedToCapacityRatio:
                      shape:
                        - utilization: 0
                          score: 0
                        - utilization: 100
                          score: 10
        """,
        cs := cluster(),
    )
    assert not any("RequestedToCapacityRatio" in w for w in cfg.warnings)
    both_create(cs, port_cs, MakePod().name("p").req({"cpu": "1", "memory": "1Gi"}).obj())
    assert ("default/p", "busy") in step_both(ref, port).scheduled
    ref2, port2, ref_cs2, port_cs2 = run_both(
        cluster(),
        SchedulerConfig(batch_size=4, solver=ExactSolverConfig(tie_break="first", balanced_weight=0)),
        RefConfig(batch_size=4, solver=RefSolver(tie_break="first", balanced_weight=0)),
    )
    both_create(ref_cs2, port_cs2, MakePod().name("p").req({"cpu": "1", "memory": "1Gi"}).obj())
    assert ("default/p", "empty") in step_both(ref2, port2).scheduled


def test_added_affinity_enforced():
    cs = ClusterState()
    for team in ("blue", "red"):
        cs.create_node(
            MakeNode().name(team).capacity({"cpu": "4", "memory": "8Gi", "pods": "10"}).label("team", team).obj()
        )
    ref, port, port_cs, _ = from_yaml(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            pluginConfig:
              - name: NodeAffinity
                args:
                  addedAffinity:
                    requiredDuringSchedulingIgnoredDuringExecution:
                      nodeSelectorTerms:
                        - matchExpressions:
                            - key: team
                              operator: In
                              values: ["blue"]
        """,
        cs,
    )
    for i in range(4):
        both_create(cs, port_cs, MakePod().name(f"p-{i}").req({"cpu": "1"}).obj())
    r = step_both(ref, port)
    assert len(r.scheduled) == 4 and all(node == "blue" for _, node in r.scheduled)


def test_fit_resource_weights_change_scoring():
    cs = ClusterState()
    for name in ("cpu-idle", "mem-idle"):
        cs.create_node(MakeNode().name(name).capacity({"cpu": "8", "memory": "16Gi", "pods": "20"}).obj())
    cs.create_pod(MakePod().name("mem-hog").node("cpu-idle").req({"memory": "12Gi"}).obj())
    cs.create_pod(MakePod().name("cpu-hog").node("mem-idle").req({"cpu": "6"}).obj())
    ref, port, port_cs, _ = from_yaml(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            plugins:
              score:
                disabled:
                  - name: NodeResourcesBalancedAllocation
            pluginConfig:
              - name: NodeResourcesFit
                args:
                  scoringStrategy:
                    type: LeastAllocated
                    resources:
                      - name: cpu
                        weight: 9
                      - name: memory
                        weight: 1
        """,
        cs,
    )
    both_create(cs, port_cs, MakePod().name("p").req({"cpu": "1", "memory": "1Gi"}).obj())
    assert ("default/p", "cpu-idle") in step_both(ref, port).scheduled


def test_unsupported_scoring_resource_warns():
    _, cfg = bridged(textwrap.dedent(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            pluginConfig:
              - name: NodeResourcesFit
                args:
                  scoringStrategy:
                    type: LeastAllocated
                    resources:
                      - name: nvidia.com/gpu
                        weight: 3
        """
    ))
    assert any("nvidia.com/gpu" in w for w in cfg.warnings)


@pytest.mark.parametrize(
    "shape,warning",
    [
        ("- utilization: 0\n- score: 10", "malformed"),
        ("- utilization: 50\n  score: 5\n- utilization: 50\n  score: 10", "ascending"),
    ],
    ids=["malformed_entry", "non_ascending"],
)
def test_rtc_shape_warns_and_falls_back(shape, warning):
    doc = {
        "profiles": [{
            "schedulerName": "default-scheduler",
            "pluginConfig": [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {
                "type": "RequestedToCapacityRatio",
                "requestedToCapacityRatio": {"shape": yaml.safe_load(shape)},
            }}}],
        }]
    }
    sc, cfg = bridged(doc)
    assert any(warning in w for w in cfg.warnings)
    assert sc.solver.rtc_shape == ()
    assert sc.solver.scoring_strategy == "RequestedToCapacityRatio"


def test_score_disable_independent_of_filter_disable():
    sc, _ = bridged(textwrap.dedent(
        """
        apiVersion: kubescheduler.config.k8s.io/v1
        profiles:
          - schedulerName: default-scheduler
            plugins:
              filter:
                disabled:
                  - name: InterPodAffinity
              score:
                disabled:
                  - name: TaintToleration
        """
    ))
    assert "InterPodAffinity" in sc.solver.disabled_filters
    assert sc.solver.interpod_weight == 2
    assert sc.solver.taint_weight == 0
    assert "TaintToleration" not in sc.solver.disabled_filters


def test_fleet_section_round_trip():
    doc = textwrap.dedent(
        """
        fleet:
          replica: r2
          replicas: [r0, r1, r2, r3]
          hubAddress: "hub.scheduling.svc:9411"
          meshSlice: "2/4"
          maxRowAgeSeconds: 15
        """
    )
    sc, cfg = bridged(doc)
    assert cfg.fleet.replica == "r2"
    assert cfg.fleet.replicas == ["r0", "r1", "r2", "r3"]
    assert cfg.fleet.hub_address == "hub.scheduling.svc:9411"
    assert cfg.fleet.mesh_slice == (2, 4)
    assert cfg.fleet.max_row_age_seconds == 15.0
    assert sc.mesh_slice == (2, 4)
    assert sc.fleet.replica == "r2" and sc.fleet.max_row_age_seconds == 15.0
    with pytest.raises(NotImplementedError, match="item 8"):  # fleet mode is refused
        Scheduler(convert.cluster_state(ClusterState()), sc, device="cpu")
    sc2, cfg2 = bridged("fleet:\n  replica: null\n  meshSlice: null\n  hubAddress: null\n")
    assert cfg2.fleet.replica == "" and cfg2.fleet.mesh_slice is None
    assert sc2.fleet is None
    for bad in (
        'fleet:\n  replica: r0\n  meshSlice: "4/4"',
        'fleet:\n  replica: r0\n  meshSlice: "-1/4"',
        'fleet:\n  replica: r0\n  meshSlice: "x"',
        'fleet:\n  replica: r0\n  hubAddress: "no-port"',
        "fleet:\n  replica: r0\n  maxRowAgeSeconds: 0",
        "fleet:\n  replicas: [a, b]",
        'fleet:\n  meshSlice: "0/4"',
    ):
        for mod in (ct, ref_ct):
            with pytest.raises(ValueError):
                mod.load(bad)


def test_rebalance_section_reaches_the_refused_scheduler():
    sc, _ = bridged("rebalance: {enabled: true, intervalSeconds: 1, maxMovesPerCycle: 4}")
    assert sc.rebalance is not None and sc.rebalance.max_moves_per_cycle == 4
    with pytest.raises(NotImplementedError, match="item 9"):
        Scheduler(convert.cluster_state(ClusterState()), sc, device="cpu")
    for bad in ("rebalance: {maxMovesPerCycle: -1}", "rebalance: {minPackingUtilization: 0}",
                "rebalance: {intervalSeconds: 0}", "rebalance: {minGainPoints: 0}"):
        for mod in (ct, ref_ct):
            with pytest.raises(ValueError):
                mod.load(bad)


def test_gang_and_tuning_sections_map():
    sc, _ = bridged(textwrap.dedent(
        """
        gang: {enabled: true, throughputWeight: 100, classThroughput: {transformer: {a: 1.0, b: 0.3}}}
        tuning: {enabled: true, evalBatches: 3, knobs: [stream_depth]}
        tpuSolver: {streamDepth: 8, pipelineSplit: 2, backlogChunkPods: 256, tieBreak: first}
        """
    ))
    assert sc.gang is not None and sc.gang.throughput_weight == 100
    assert sc.tuning.eval_batches == 3 and sc.tuning.knobs == ("stream_depth",)
    assert (sc.stream_depth, sc.pipeline_split, sc.backlog_chunk_pods) == (8, 2, 256)
    s = Scheduler(convert.cluster_state(ClusterState()), sc, device="cpu")
    assert s.tuner is not None
    for bad in ("tuning: {knobs: [nope]}", "tuning: {hysteresis: 1.5}", "tpuSolver: {streamDepth: 0}",
                "tpuSolver: {pipelineSplit: -1}", "tpuSolver: {tieBreak: best}"):
        for mod in (ct, ref_ct):
            with pytest.raises(ValueError):
                mod.load(bad)
