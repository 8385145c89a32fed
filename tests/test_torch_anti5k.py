"""The anti5k deployment (``portbench/configs/anti5k.json``: upstream
scheduler_perf's SchedulingPodAntiAffinity, one required hostname
anti-affinity term per pod that selects every other pod) cut to 640 nodes,
waves of 128 pods and batches of 128, through the port's served path on the
CPU: the ``rollout`` process's stream, every pod in one namespace, created
as events in a ``ClusterState``, and a ``Scheduler`` with the
configuration's settings binding them through ``run_pipelined``, one batch a
call, in a rolling rollout that keeps two waves (40 % of the nodes, as
upstream's 2,000 pods on 5,000 nodes) live, so that the previous wave's 128
pods are bound when a batch starts. Every binding is judged by the
benchmark's plain reference (``portbench/reference.py``), and the
StageProfiler's chunk counters show that anti chunks (grouped kind 3) place
the waves."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path

import pytest

from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from portbench import gen, reference

rollout = importlib.import_module("portbench.processes.rollout")

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "anti5k.json"
NODES, WAVE, BATCH = 640, 128, 128
SEED = 3_037_000_493  # above 2**31, as the benchmark's seeds are
TOP_UPS = 7  # 896 pods, seven waves: from the third on, each top-up deletes the wave two back
CHECKS = ("infeasible_binds", "score_gap", "double_or_unknown_binds", "readback_mismatches")


def _config() -> dict:
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config["node_count"] = NODES
    config["wave_pods"] = WAVE
    config["scheduler"]["batch_size"] = BATCH
    return config


def _drive(config: dict, seed: int) -> dict:
    """The rollout process's loop, by hand: before each loop call of one
    batch whose queue holds no more than that, the stream's next pods are
    created and as many of the wave two back deleted."""
    traffic = rollout.OneNamespace(config, seed)
    pods = gen.StreamPods(traffic)
    node_dicts = gen.node_dicts(config)
    cs = ClusterState()
    cs.create_nodes(Node.from_dict(d) for d in node_dicts)
    sched_cfg = config["scheduler"]
    sched = Scheduler(cs, SchedulerConfig(
        batch_size=BATCH, obs=ObsConfig(profile=True),
        solver=ExactSolverConfig(tie_break=sched_cfg["tie_break"],
                                 balanced_fdtype=sched_cfg["balanced_fdtype"],
                                 seed=seed % 2**31),
    ), device="cpu")
    chunk = BATCH
    events, owners_at_start = [], []
    while pods.created < TOP_UPS * chunk or sched.pending:
        if sched.pending <= chunk and pods.created < TOP_UPS * chunk:
            start = pods.created
            for d in traffic.pods(start, start + chunk):
                cs.create_pod(Pod.from_dict(d))
            pods.created = start + chunk
            old = start - 2 * WAVE
            if old + chunk > 0:
                keys = [traffic.key(j) for j in range(max(old, 0), old + chunk)]
                for key in keys:
                    cs.delete_pod(*key.split("/", 1))
                events += [("delete", key) for key in keys]
        owners_at_start.append(sum(1 for p in cs.list_pods() if p.node_name))
        results = sched.run_pipelined(max_batches=1)
        assert results, "the loop made no progress"
        for r in results:
            assert not r.unschedulable and not r.bind_failures
            events += [("bind", key, node) for key, node in r.scheduled]
    store = {p.key: p.node_name or "" for p in cs.list_pods()}
    nodes = {name: (info.used.get("cpu", 0), info.used.get("memory", 0), list(info.pods))
             for name, info in sched.cache.nodes.items()}
    ledger = sched.telemetry.profiler.snapshot(recent=10**6)["recent"]
    counts = {k: sum(e[k] for e in ledger) for k in ledger[0] if "chunk" in k or "iterations" in k}
    return {"traffic": traffic, "pods": pods, "node_dicts": node_dicts, "events": events,
            "store": store, "nodes": nodes, "counts": counts, "owners_at_start": owners_at_start}


@pytest.fixture(scope="module")
def run() -> dict:
    return _drive(_config(), SEED)


def _binds(events) -> int:
    return sum(1 for e in events if e[0] == "bind")


def test_the_rollout_runs_in_one_namespace_with_the_previous_wave_bound(run):
    keys = [e[1] for e in run["events"]]
    assert {k.split("/", 1)[0] for k in keys} == {rollout.NAMESPACE}
    deleted = [e[1] for e in run["events"] if e[0] == "delete"]
    assert len(deleted) == (TOP_UPS - 2) * BATCH
    assert len(set(keys)) == run["pods"].created  # names unique across the waves
    # from the second batch on, the previous wave is bound when a batch starts
    assert run["owners_at_start"][1:] == [2 * WAVE - BATCH] * (TOP_UPS - 1)


def test_the_port_keeps_every_guarantee(run):
    n = _binds(run["events"])
    assert n == run["pods"].created == TOP_UPS * BATCH
    sample = set(range(0, n, 5)) | {n - 1}
    numbers = reference.judge(run["node_dicts"], run["pods"], run["events"], run["store"],
                              run["nodes"], sample)
    assert {k: numbers[k] for k in CHECKS} == dict.fromkeys(CHECKS, 0)
    assert numbers["_bindings"] == n and numbers["_score_checked"] == len(sample)


def test_anti_chunks_place_the_waves(run):
    c = run["counts"]
    pods = sum(c[f"chunk_pods.{k}"] for k in ("slow", "plain", "spread", "anti"))
    assert pods == run["pods"].created
    assert c["chunk_pods.anti"] >= 0.99 * pods
    assert c["chunks.anti"] >= 0.99 * pods // 64
    assert c["chunk_iterations.anti"] >= c["chunks.anti"]
    assert c["chunk_iterations.plain"] == c["chunk_iterations.spread"] == 0
    assert c["waterfill_iterations"] == 0


def test_a_pod_moved_onto_the_previous_waves_node_breaks_the_anti_affinity(run):
    """A planted fault: the first binding of a wave ``w`` pod made while a
    pod of wave ``w - 1`` is bound is moved onto that pod's node. The
    reference refuses it."""
    traffic, bound, moved, store, done = run["traffic"], {}, [], dict(run["store"]), False
    for e in run["events"]:
        if e[0] == "bind":
            w = traffic.position(e[1]) // WAVE
            prev = [] if done else [
                node for key, node in bound.items() if traffic.position(key) // WAVE == w - 1]
            if prev:
                e = ("bind", e[1], prev[0])
                done = True
                if e[1] in store:
                    store[e[1]] = e[2]
            bound[e[1]] = e[2]
        else:
            bound.pop(e[1], None)
        moved.append(e)
    assert done
    numbers = reference.judge(run["node_dicts"], run["pods"], moved, store, None, set())
    assert numbers["infeasible_binds"] > 0
    assert numbers["double_or_unknown_binds"] == numbers["readback_mismatches"] == 0
