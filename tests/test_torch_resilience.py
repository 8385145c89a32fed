"""The port's solve resilience against the JAX package's on the CPU.

The ladder's rungs are torch devices in the port: the scheduler's device,
then the CPU (a distinct rung only when the device is the card), then the
host greedy. A ``_solve_fault`` hook that fails the device tier makes both
schedulers descend the same way: the same tier names in
``resilience.summary()``, the same batch results and bindings
(``_torch_sched_pair.Pair``). Where a test needs the CPU rung, both
schedulers get the three-rung ladder the card would have.
"""

import pytest
import torch

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.resilience import ResilienceConfig as RefResilienceConfig
from kubernetes_tpu.resilience import SolveResilience as RefSolveResilience
from kubernetes_tpu.resilience import SolverFaultError as RefFault
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch.resilience import (
    TIER_CPU,
    TIER_HOST,
    TIER_SINGLE,
    ResilienceConfig,
    SolveResilience,
    SolverFaultError,
    build_ladder,
    tier_device,
)

from _torch_sched_pair import Pair

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


def _cluster(n_nodes=4, n_pods=12):
    cs = ClusterState()
    for i in range(n_nodes):
        cs.create_node(
            MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "110"})
            .label(HOST, f"n{i}").obj()
        )
    for i in range(n_pods):
        cs.create_pod(MakePod().name(f"p{i:03}").req({"cpu": "500m", "memory": "1Gi"}).obj())
    return cs


def _hooks(pair, failing):
    """Fail every solve attempt at a tier in ``failing`` (a mutable set),
    on both schedulers, recording the tiers each one tried."""
    tried = {"ref": [], "port": []}

    def make(side, exc):
        def hook(pods, tier):
            tried[side].append(tier)
            if tier in failing:
                raise exc(f"test: {tier} down")
        return hook

    pair.ref._solve_fault = make("ref", RefFault)
    pair.port._solve_fault = make("port", SolverFaultError)
    return tried


def _three_rungs(pair, open_seconds=30.0):
    ladder = (TIER_SINGLE, TIER_CPU, TIER_HOST)
    pair.ref.resilience = RefSolveResilience(
        RefResilienceConfig(open_seconds=open_seconds), pair.ref_clock, ladder
    )
    pair.port.resilience = SolveResilience(
        ResilienceConfig(open_seconds=open_seconds), pair.clock, ladder
    )


def test_ladder_shape():
    assert build_ladder(torch.device("cuda")) == (TIER_SINGLE, TIER_CPU, TIER_HOST)
    assert build_ladder(torch.device("cpu")) == (TIER_SINGLE, TIER_HOST)
    assert tier_device(TIER_CPU, torch.device("cuda")) == torch.device("cpu")
    assert tier_device(TIER_SINGLE, torch.device("cuda")) == torch.device("cuda")
    pair = Pair(_cluster(1, 0))
    # on the CPU the port's ladder has no separate CPU rung, like the
    # JAX package's on its CPU backend
    assert pair.port.resilience.ladder == pair.ref.resilience.ladder == (TIER_SINGLE, TIER_HOST)


def test_descends_to_cpu_then_host_equal_reference(monkeypatch):
    pair = Pair(_cluster(), batch_size=4)
    _three_rungs(pair)
    failing = {TIER_SINGLE}
    tried = _hooks(pair, failing)
    # the session resets before the solve moves to another device
    resets = []
    solver = pair.port.solver
    real_reset = solver.reset_session
    monkeypatch.setattr(solver, "reset_session", lambda: (resets.append(
        pair.port._tier_last.get("default-scheduler")), real_reset())[1])
    pair.step()
    assert pair.port.resilience.summary() == pair.ref.resilience.summary()
    assert pair.port.resilience.summary()["profiles"]["default-scheduler"]["tier"] == TIER_CPU
    failing.add(TIER_CPU)
    pair.step()
    summary = pair.port.resilience.summary()
    assert summary == pair.ref.resilience.summary()
    assert summary["profiles"]["default-scheduler"]["tier"] == TIER_HOST
    assert summary["profiles"]["default-scheduler"]["open"] == [TIER_CPU, TIER_SINGLE]
    pair.settle()
    pair.assert_equal()
    assert tried["port"] == tried["ref"]
    assert TIER_CPU in tried["port"] and TIER_HOST in tried["port"]
    # reset before the first dispatch, on the rebuild, and before the
    # move to the CPU rung (the tier recorded is the one being left)
    assert TIER_SINGLE in resets
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_device_outage_falls_to_host_and_probes_back():
    pair = Pair(_cluster(n_pods=6), batch_size=8,
                resilience=ResilienceConfig(open_seconds=5.0),
                ref_config={"resilience": RefResilienceConfig(open_seconds=5.0)})
    failing = {TIER_SINGLE}
    _hooks(pair, failing)
    pair.settle()
    assert pair.port.resilience.summary() == pair.ref.resilience.summary()
    assert pair.port.resilience.trips == pair.ref.resilience.trips >= 1
    failing.clear()
    pair.advance(6.0)
    for i in range(6, 10):
        pair.create_pod(MakePod().name(f"p{i:03}").req({"cpu": "500m", "memory": "1Gi"}).obj())
    pair.settle()
    pair.assert_equal()
    assert pair.port.resilience.recloses == pair.ref.resilience.recloses >= 1
    assert pair.port.resilience.tier_index("default-scheduler") == 0


def test_poison_pod_bisected_and_quarantined_equal_reference():
    pair = Pair(_cluster(n_pods=16), batch_size=16)

    def make(exc):
        def hook(pods, tier):
            if any(p.key == "default/p005" for p in pods):
                raise exc("test: poison")
        return hook

    pair.ref._solve_fault = make(RefFault)
    pair.port._solve_fault = make(SolverFaultError)
    r, p = pair.step()
    assert p.quarantined == ["default/p005"]
    assert len(p.scheduled) == 15
    pair.assert_equal()


def test_transient_fault_rebuilds_session_equal_reference():
    pair = Pair(_cluster(n_pods=4), batch_size=8)
    calls = {"ref": 0, "port": 0}

    def make(side, exc):
        def once(pods, tier):
            calls[side] += 1
            if calls[side] == 1:
                raise exc("test: one-off device error")
        return once

    pair.ref._solve_fault = make("ref", RefFault)
    pair.port._solve_fault = make("port", SolverFaultError)
    pair.settle()
    pair.assert_equal()
    assert pair.port.resilience.rebuilds == pair.ref.resilience.rebuilds == 1
    assert pair.port.resilience.trips == 0


@pytest.mark.parametrize("force", [TIER_HOST, TIER_SINGLE])
def test_forced_tier_binds_equal_reference(force):
    pair = Pair(_cluster(n_pods=20), batch_size=8,
                resilience=ResilienceConfig(force_tier=force),
                ref_config={"resilience": RefResilienceConfig(force_tier=force)})
    pair.settle()
    pair.assert_equal()
    assert all(p.node_name for p in pair.cluster.list_pods())


@pytest.mark.parametrize("exc, fault", [
    (lambda: __import__("kubernetes_tpu_torch.build", fromlist=["x"]).KernelError("nvcc failed"), True),
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (lambda: RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (lambda: SolverFaultError("test: injected"), False),
    (lambda: RuntimeError("test: host error"), False),
    (lambda: ValueError("test: bad input"), False),
])
def test_card_fault_classes(exc, fault):
    from kubernetes_tpu_torch.resilience import card_fault

    assert card_fault(exc()) is fault


def test_kernel_build_failure_raises_instead_of_descending(monkeypatch, tmp_path):
    """A ``domain_counts`` kernel that does not build is raised out of
    ``schedule_batch``: neither the CPU rung nor the host rung serves the
    batch, and its pods go back to the queue unbound."""
    import shutil

    from kubernetes_tpu_torch import build
    from kubernetes_tpu_torch import metrics as port_metrics
    from kubernetes_tpu_torch.api.wrappers import MakeNode as PortNode
    from kubernetes_tpu_torch.api.wrappers import MakePod as PortPod
    from kubernetes_tpu_torch.ops import domain_counts as dc
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState as PortCluster
    from kubernetes_tpu_torch.utils.clock import FakeClock

    cs = PortCluster()
    for i in range(4):
        cs.create_node(
            PortNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "110"})
            .label(HOST, f"n{i}").label(ZONE, f"z{i % 2}").obj()
        )
    for i in range(6):
        # zone anti-affinity: the node totals need the kernel's aggregation
        cs.create_pod(
            PortPod().name(f"p{i}").req({"cpu": "500m"}).label("app", "anti")
            .pod_anti_affinity(ZONE, match_labels={"app": "anti"}).obj()
        )
    clock = FakeClock()
    sched = Scheduler(
        cs, SchedulerConfig(solver=ExactSolverConfig(tie_break="first")),
        clock=clock, device="cpu",
    )
    # the ladder a scheduler on the card has
    sched.resilience = SolveResilience(
        ResilienceConfig(), clock, (TIER_SINGLE, TIER_CPU, TIER_HOST)
    )
    tried = []
    sched._solve_fault = lambda pods, tier: tried.append(tier)
    # the wrapper builds its kernel as it does on the card, with a compiler
    # that fails
    monkeypatch.setattr(build, "nvcc", lambda: shutil.which("false"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(dc, "_lib", None)
    monkeypatch.setattr(dc.Aggregation, "__call__", lambda self: dc._load())
    fallback = port_metrics.fallback_solves_total
    before = {t: fallback.labels(t)._value.get() for t in (TIER_CPU, TIER_HOST)}

    with pytest.raises(build.KernelError, match="nvcc failed"):
        sched.schedule_batch()
    assert tried == [TIER_SINGLE]
    summary = sched.resilience.summary()
    assert summary["trips"] == 0 and summary["rebuilds"] == 0
    assert summary["profiles"]["default-scheduler"] == {"tier": "top", "open": []}
    assert {t: fallback.labels(t)._value.get() for t in before} == before
    assert not any(p.node_name for p in cs.list_pods())
    assert len(sched.queue) == 6
