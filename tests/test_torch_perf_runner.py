"""The port's scheduler_perf runner (``kubernetes_tpu_torch/perf``).

The port's copies of tests/test_perf_runner.py on ``device="cpu"``, the
shipped performance-config.yaml (a verbatim copy of the JAX package's)
run whole on the port, and every testCase of it at reduced params through
both packages' ``PerfRunner`` in "first" mode: ``scheduled``,
``unschedulable`` and the final bindings equal. Timings are not compared.
"""

from __future__ import annotations

import pathlib
import textwrap

import pytest

import kubernetes_tpu.perf.runner as jax_runner_mod
import kubernetes_tpu_torch.perf as perf_pkg
import kubernetes_tpu_torch.perf.runner as runner_mod
from kubernetes_tpu.scheduler import SchedulerConfig as JaxSchedulerConfig
from kubernetes_tpu.solver.exact import ExactSolverConfig as JaxSolverConfig
from kubernetes_tpu_torch.perf.runner import PerfRunner, WorkloadResult
from kubernetes_tpu_torch.scheduler import SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig

SHIPPED = pathlib.Path(perf_pkg.__file__).parent / "performance-config.yaml"


def write_config(tmp_path, text):
    p = tmp_path / "perf.yaml"
    p.write_text(textwrap.dedent(text))
    return p


def runner():
    return PerfRunner(
        SchedulerConfig(
            batch_size=256, solver=ExactSolverConfig(tie_break="first")
        ),
        device="cpu",
    )


def test_shipped_config_is_the_jax_packages_verbatim():
    ref = pathlib.Path(jax_runner_mod.__file__).parent / "performance-config.yaml"
    assert SHIPPED.read_bytes() == ref.read_bytes()


def test_shipped_performance_config_runs():
    """The shipped performance-config.yaml parses and schedules every
    testCase's 500Nodes workload end to end on the port."""
    results = runner().run_file(SHIPPED, workload_filter="500Nodes")
    basic = [r for r in results if r.test_case == "SchedulingBasic"]
    assert basic and basic[0].scheduled == 1500
    assert basic[0].unschedulable == 0
    assert {r.test_case for r in results} == {
        "SchedulingBasic",
        "SchedulingPodAntiAffinity",
        "SchedulingPodTopologySpread",
        "SchedulingWithMixedChurn",
        "SchedulingGatedPods",
        "SteadyStateArrival",
    }
    anti = [r for r in results if r.test_case == "SchedulingPodAntiAffinity"][0]
    assert anti.scheduled == 400


def test_whole_shipped_config_places_every_pod():
    """Every workload of the file at its own sizes, on the port alone
    (thresholds are wall-clock floors and are not asserted on the
    CPU)."""
    results = runner().run_file(SHIPPED)
    by_case = {(r.test_case, r.workload): r for r in results}
    assert len(by_case) == 9
    assert by_case["SchedulingBasic", "1000Nodes"].scheduled == 3000
    assert by_case["SchedulingGatedPods", "500Nodes"].scheduled == 1000
    assert by_case["SteadyStateArrival", "500Nodes"].scheduled == 2000
    # the preemption cases place every victim; their preemptors are left
    # nominated but pending when the drain meets a round that binds
    # nothing, in the JAX package's runner as in this copy (ROADMAP
    # queue 3; test_test_case_matches_jax holds the two equal)
    assert by_case["SchedulingPreemption", "50Nodes"].scheduled >= 200
    assert by_case["SchedulingPreemptionUnderChurn", "50Nodes"].scheduled >= 180


def test_scheduling_basic_shape(tmp_path):
    cfg = write_config(
        tmp_path,
        """
        - name: SchedulingBasic
          workloadTemplate:
            - opcode: createNodes
              countParam: $initNodes
            - opcode: createPods
              countParam: $initPods
            - opcode: barrier
            - opcode: createPods
              countParam: $measurePods
              collectMetrics: true
            - opcode: barrier
          workloads:
            - name: 50Nodes
              params: {initNodes: 50, initPods: 50, measurePods: 100}
        """,
    )
    results = runner().run_file(cfg)
    assert len(results) == 1
    r = results[0]
    assert r.test_case == "SchedulingBasic"
    assert r.workload == "50Nodes"
    assert r.scheduled == 150
    assert r.measured_pods == 100
    assert r.unschedulable == 0
    s = r.throughput_summary()
    assert s["avg"] > 0 and s["p50"] > 0


def test_custom_templates_and_params(tmp_path):
    (tmp_path / "node.yaml").write_text(
        textwrap.dedent(
            """
            metadata:
              name: big-{{.Index}}
              labels: {zone: z0}
            status:
              allocatable: {cpu: "64", memory: 256Gi, pods: "200"}
            """
        )
    )
    cfg = write_config(
        tmp_path,
        """
        - name: CustomTemplates
          workloadTemplate:
            - opcode: createNodes
              count: 3
              nodeTemplatePath: node.yaml
            - opcode: createPods
              count: 10
              podTemplate:
                metadata:
                  generateName: app-
                spec:
                  containers:
                    - name: c
                      resources:
                        requests: {cpu: 500m}
              collectMetrics: true
            - opcode: barrier
          workloads:
            - name: only
              params: {}
        """,
    )
    results = runner().run_file(cfg)
    assert results[0].scheduled == 10
    assert results[0].unschedulable == 0


def test_unschedulable_counted(tmp_path):
    cfg = write_config(
        tmp_path,
        """
        - name: Overload
          workloadTemplate:
            - opcode: createNodes
              count: 1
              nodeTemplate:
                metadata: {name: "tiny-{{.Index}}"}
                status:
                  allocatable: {cpu: "2", memory: 8Gi, pods: "110"}
            - opcode: createPods
              count: 4
            - opcode: barrier
          workloads:
            - name: only
              params: {}
        """,
    )
    r = runner().run_file(cfg)[0]
    assert r.scheduled == 2
    assert r.unschedulable >= 2


def test_threshold_gates_steady_state_not_avg():
    """The threshold gates post-warm-up steady-state pods/s: the first
    measured batch is excluded, time-weighted over the rest."""
    r = WorkloadResult(
        "t", "w", threshold=50.0, measured_pods=200, measure_seconds=11.0
    )
    r.batch_samples = [(10.0, 100), (0.5, 50), (0.5, 50)]
    r.samples = [10.0, 100.0, 100.0]
    r.check_threshold()
    assert r.passed
    assert r.steady_pods_per_sec() == 100.0
    assert r.throughput_summary()["steady"] == 100.0

    r2 = WorkloadResult(
        "t", "w", threshold=50.0, measured_pods=200, measure_seconds=3.0
    )
    r2.batch_samples = [(0.1, 100), (5.0, 50), (5.0, 50)]
    r2.samples = [1000.0, 10.0, 10.0]
    r2.check_threshold()
    assert not r2.passed
    r3 = WorkloadResult(
        "t", "w", threshold=50.0, measured_pods=100, measure_seconds=1.0
    )
    r3.batch_samples = [(1.0, 100)]
    r3.samples = [100.0]
    r3.check_threshold()
    assert r3.passed


def test_runner_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PerfRunner(SchedulerConfig()).run_workload(
            "t", "w", [{"opcode": "createNodes", "count": 1}], {}
        )


# -- the JAX package's PerfRunner on the same cases ----------------------------


def _cases():
    import yaml

    return yaml.safe_load(SHIPPED.read_text())


def _reduced(params: dict) -> dict:
    """The workload's params cut tenfold (each count at least 1)."""
    return {k: max(1, int(v) // 10) for k, v in params.items()}


def _recording(mod, monkeypatch) -> list:
    """Patch ``mod.ClusterState`` so each runner's cluster is kept for
    its final bindings."""
    made = []
    base = mod.ClusterState

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mod, "ClusterState", Recording)
    return made


def _bindings(cluster) -> dict:
    return {p.key: p.node_name for p in cluster.list_pods() if p.node_name}


@pytest.mark.parametrize(
    "case", [c["name"] for c in _cases()], ids=lambda n: n
)
def test_test_case_matches_jax(case, monkeypatch):
    spec = next(c for c in _cases() if c["name"] == case)
    params = _reduced(spec["workloads"][0]["params"])
    ops = spec["workloadTemplate"]
    ours_made = _recording(runner_mod, monkeypatch)
    ref_made = _recording(jax_runner_mod, monkeypatch)
    ours = runner().run_workload(case, "reduced", ops, params, SHIPPED.parent)
    # mesh_devices=1: the JAX package's solve is device-count invariant,
    # and its 8-way CPU mesh (tests/conftest.py) only costs time here
    ref = jax_runner_mod.PerfRunner(
        JaxSchedulerConfig(
            batch_size=256, mesh_devices=1,
            solver=JaxSolverConfig(tie_break="first"),
        )
    ).run_workload(case, "reduced", ops, params, SHIPPED.parent)
    assert ours.scheduled == ref.scheduled
    assert ours.unschedulable == ref.unschedulable
    assert ours.measured_pods == ref.measured_pods
    assert ours.scheduled > 0
    assert _bindings(ours_made[0]) == _bindings(ref_made[0])
