"""The spread5k deployment (``portbench/configs/spread5k.json``: upstream
scheduler_perf's TopologySpreading, one hard zone spread with maxSkew 5 per
pod) cut to 96 nodes, waves of 640 pods and batches of 128, through the port's
served path on the CPU: the generator's dicts created as events in a
``ClusterState``, a ``Scheduler`` with the configuration's settings binding
them through ``run_pipelined`` in a rolling rollout that keeps two waves
live, and every binding judged by the benchmark's plain reference
(``portbench/reference.py``). The StageProfiler's chunk counters show that
spread chunks (grouped kind 2) place the waves."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from portbench import gen, reference

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "spread5k.json"
NODES, WAVE, BATCH, PER_CALL = 96, 640, 128, 4
SEED = 3_037_000_493  # above 2**31, as the benchmark's seeds are
TOP_UPS = 4  # 2,048 pods, into a fourth wave: the third replaces the first, so deletes run
CHECKS = ("infeasible_binds", "score_gap", "double_or_unknown_binds", "readback_mismatches")


def _config() -> dict:
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config["node_count"] = NODES
    config["wave_pods"] = WAVE
    config["scheduler"]["batch_size"] = BATCH
    return config


def _drive(config: dict, seed: int) -> dict:
    """The waves process's rollout, by hand: before each loop call of
    ``PER_CALL`` batches whose queue holds no more than that, the stream's
    next pods are created and as many of the wave two back deleted."""
    traffic = gen.Traffic(config, seed)
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
    chunk = PER_CALL * BATCH
    events = []
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
        results = sched.run_pipelined(max_batches=PER_CALL)
        assert results, "the loop made no progress"
        for r in results:
            assert not r.unschedulable and not r.bind_failures
            events += [("bind", key, node) for key, node in r.scheduled]
    store = {p.key: p.node_name or "" for p in cs.list_pods()}
    nodes = {name: (info.used.get("cpu", 0), info.used.get("memory", 0), list(info.pods))
             for name, info in sched.cache.nodes.items()}
    ledger = sched.telemetry.profiler.snapshot(recent=10**6)["recent"]
    counts = {k: sum(e[k] for e in ledger) for k in ledger[0] if "chunk" in k or "iterations" in k}
    return {"pods": pods, "node_dicts": node_dicts, "events": events, "store": store,
            "nodes": nodes, "counts": counts}


@pytest.fixture(scope="module")
def run() -> dict:
    return _drive(_config(), SEED)


def _binds(events) -> int:
    return sum(1 for e in events if e[0] == "bind")


def test_the_port_keeps_every_guarantee_at_maxskew_five(run):
    n = _binds(run["events"])
    assert n == run["pods"].created == TOP_UPS * PER_CALL * BATCH
    sample = set(range(0, n, 7)) | {n - 1}
    numbers = reference.judge(run["node_dicts"], run["pods"], run["events"], run["store"],
                              run["nodes"], sample)
    assert {k: numbers[k] for k in CHECKS} == dict.fromkeys(CHECKS, 0)
    assert numbers["_bindings"] == n and numbers["_score_checked"] == len(sample)


def test_spread_chunks_place_the_waves(run):
    c = run["counts"]
    pods = sum(c[f"chunk_pods.{k}"] for k in ("slow", "plain", "spread", "anti"))
    assert pods == run["pods"].created
    assert c["chunk_pods.spread"] >= 0.9 * pods
    assert c["chunks.spread"] >= 0.9 * pods // 64
    assert c["chunk_iterations.spread"] >= c["chunks.spread"]
    assert c["waterfill_iterations"] <= c["chunk_iterations.spread"]
    assert c["chunk_iterations.plain"] == c["chunk_iterations.anti"] == 0


def test_bindings_moved_into_one_zone_break_the_spread(run):
    """A planted fault: every binding moved onto a node of zone z0 (in turn,
    so no node runs out of room first). Past maxSkew 5 the reference
    refuses them."""
    zone0 = [d["metadata"]["name"] for d in run["node_dicts"]
             if d["metadata"]["labels"]["topology.kubernetes.io/zone"] == "z0"]
    moved, store, i = [], {}, 0
    for e in run["events"]:
        if e[0] == "bind":
            e = ("bind", e[1], zone0[i % len(zone0)])
            i += 1
            store[e[1]] = e[2]
        else:
            store.pop(e[1], None)
        moved.append(e)
    numbers = reference.judge(run["node_dicts"], run["pods"], moved, store, None, set())
    assert numbers["infeasible_binds"] > 0
    assert numbers["double_or_unknown_binds"] == numbers["readback_mismatches"] == 0
