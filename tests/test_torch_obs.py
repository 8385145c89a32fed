"""The port's ported observability: a replay bundle captured by the JAX
package's Scheduler replays bit-identically through the port's
``ExactSolver`` (and a tampered one does not), the compile watcher counts
the port's kernel builds inside a dispatch scope, and the tracing switch
records one ``torch.profiler`` range per scheduling batch.
"""

import json

import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.obs import ObsConfig as RefObsConfig
from kubernetes_tpu.scheduler import Scheduler as RefScheduler
from kubernetes_tpu.scheduler import SchedulerConfig as RefSchedulerConfig
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolverConfig
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu.utils.clock import FakeClock as RefFakeClock
from kubernetes_tpu_torch import build, convert, metrics
from kubernetes_tpu_torch.obs.bundle import replay_bundle
from kubernetes_tpu_torch.obs.compile import WATCHER
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import tracing
from kubernetes_tpu_torch.utils.clock import FakeClock


def _cluster():
    cs = ClusterState()
    for i in range(8):
        cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": "20"})
                       .label("zone", f"z{i % 2}").obj())
    for i in range(24):
        b = MakePod().name(f"p{i}").req({"cpu": "300m"}).label("app", "w")
        if i % 3 == 0:
            b = b.spread_constraint(1, "zone", "DoNotSchedule", {"app": "w"})
        cs.create_pod(b.obj())
    return cs


def _capture(tmp_path):
    sched = RefScheduler(_cluster(), RefSchedulerConfig(
        batch_size=32, mesh_devices=1, obs=RefObsConfig(bundle_dir=str(tmp_path)),
        solver=RefSolverConfig(tie_break="first", balanced_fdtype="float64"),
    ), clock=RefFakeClock())
    sched.schedule_batch()
    path = sched.telemetry.capture("manual")
    assert path is not None
    return path


def test_reference_bundle_replays_bit_identical_on_the_port(tmp_path):
    rep = replay_bundle(_capture(tmp_path), device="cpu")
    assert rep["replayable"] and rep["ok"], rep
    assert rep["detail"] == "assignments bit-identical"
    assert rep["pods"] == 24


def test_tampered_bundle_is_caught(tmp_path):
    path = _capture(tmp_path)
    mpath = f"{path}/manifest.json"
    with open(mpath) as f:
        manifest = json.load(f)
    a = manifest["parts"][0]["assignments"]
    a[0] = (a[0] + 1) % 8
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    rep = replay_bundle(path, device="cpu")
    assert rep["replayable"] and not rep["ok"]
    assert "mismatch" in rep["detail"]


def test_compile_watcher_counts_kernel_builds_in_scope():
    WATCHER.install()
    WATCHER.install()  # idempotent: one listener
    assert build.BUILD_LISTENERS.count(WATCHER._on_build) == 1
    total0 = metrics.xla_compilations_total.value()
    with WATCHER.scope("default:p64xn128:split1:single") as scope:
        for fn in build.BUILD_LISTENERS:
            fn("domain_counts", 2.5)
        assert scope.delta() == (1, 2.5)
    assert metrics.xla_compilations_total.value() == total0 + 1
    assert WATCHER.scope_counts()["default:p64xn128:split1:single"][0] >= 1
    with WATCHER.scope("quiet") as scope:
        pass
    assert scope.delta() == (0, 0.0)


def test_tracing_records_one_range_per_batch(tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "_trace_dir", None)
    monkeypatch.setattr(tracing, "_profiler", None)
    cs = convert.cluster_state(_cluster())
    sched = Scheduler(cs, SchedulerConfig(batch_size=8), clock=FakeClock(), device="cpu")
    assert not tracing.enabled()
    sched.schedule_batch()  # off by default: no session
    assert tracing._profiler is None
    tracing.enable(str(tmp_path))
    try:
        sched.schedule_batch()
        sched.schedule_batch()
    finally:
        path = tracing.stop()
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"schedule_batch#2", "schedule_batch#3"} <= names
    assert tracing.stop() is None


@pytest.mark.parametrize("spans", [True, False])
def test_spans_and_journal_cover_each_pod(spans):
    from kubernetes_tpu_torch.obs import ObsConfig

    cs = convert.cluster_state(_cluster())
    sched = Scheduler(cs, SchedulerConfig(batch_size=32, obs=ObsConfig(spans=spans, journal=True)),
                      clock=FakeClock(), device="cpu")
    sched.run_until_settled()
    records = [json.loads(line) for line in sched.journal.lines]
    assert sorted(r["pod"] for r in records if r["outcome"] == "bound") == sorted(
        p.key for p in cs.list_pods())
    names = [s["name"] for s in map(json.loads, sched.flight.lines()) if "name" in s]
    assert ("dispatch" in names) == spans
    # `obs explain` over the port's journal: the pod's terminal outcome
    from kubernetes_tpu_torch.obs import explain_pod, parse_stream

    decisions, span_recs = parse_stream(sched.flight.lines())
    ex = explain_pod(decisions, "default/p0", spans=span_recs)
    assert ex.found and ex.terminal["outcome"] == "bound"
    assert cs.get_pod("default", "p0").node_name in ex.render()
