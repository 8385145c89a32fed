"""The port's CLI (``python -m kubernetes_tpu_torch serve|perf|config``).

``config`` prints the JAX CLI's JSON for the same file; ``serve --device
cpu`` runs as a real subprocess (the port's copies of
tests/test_cli_serve_process.py, with leader election on), answers each
webhook verb with the JSON the JAX ``ExtenderCore`` returns, ingests,
binds and exits cleanly on SIGTERM; ``perf`` gives its exit code and its
per-workload JSON keys (the port's copy of
tests/test_config.py::test_cli_perf_command). Without ``--device`` both
take the card and raise where there is no CUDA.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu.cli import main as jax_main
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.cli import main

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "default": None,
    "tuned": """
        apiVersion: kubescheduler.config.k8s.io/v1
        kind: KubeSchedulerConfiguration
        profiles:
          - schedulerName: default-scheduler
            plugins:
              score:
                disabled: [{name: ImageLocality}]
            pluginConfig:
              - name: NodeResourcesFit
                args:
                  scoringStrategy:
                    type: MostAllocated
        tpuSolver:
          batchSize: 512
          tieBreak: first
          groupSize: 32
          streamDepth: 3
          backlogChunkPods: 2048
        gang:
          enabled: true
          throughputWeight: 10
          classThroughput: {transformer: {gpu-a100: 1.0}}
        tuning:
          enabled: true
          evalBatches: 4
    """,
    "fleet_keys": """
        fleet:
          replica: r0
          replicas: [r0, r1]
          meshSlice: "1/2"
          flushBatch: 64
        rebalance:
          enabled: true
          intervalSeconds: 5
    """,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_prints_the_jax_clis_json(name, tmp_path, capsys):
    argv = ["config"]
    if CONFIGS[name] is not None:
        path = tmp_path / "cfg.yaml"
        path.write_text(textwrap.dedent(CONFIGS[name]))
        argv = ["--config", str(path), "config"]
    assert main(argv) == 0
    ours = capsys.readouterr().out
    assert jax_main(argv) == 0
    ref = capsys.readouterr().out
    assert ours == ref
    json.loads(ours)


def test_module_entry_point_runs_config():
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch", "config"],
        cwd=_REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["tpuSolver"]["batchSize"] == 1024


# -- perf ---------------------------------------------------------------------


def _mini_workload(tmp_path, threshold=None):
    wl = tmp_path / "wl.yaml"
    wl.write_text(
        "- name: Mini\n"
        "  workloadTemplate:\n"
        "    - {opcode: createNodes, count: 4}\n"
        "    - {opcode: createPods, count: 8, collectMetrics: true}\n"
        "    - {opcode: barrier}\n"
        "  workloads:\n"
        "    - name: only\n"
        + (f"      threshold: {threshold}\n" if threshold else "")
        + "      params: {}\n"
    )
    return wl


def test_cli_perf_command(tmp_path, capsys):
    rc = main(["perf", str(_mini_workload(tmp_path)), "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["scheduled"] == 8
    assert set(out) == {
        "testCase", "workload", "scheduled", "unschedulable", "throughput",
        "podLatency", "deviceSolveSeconds",
    }
    assert set(out["throughput"]) == {"avg", "p50", "p90", "p99", "steady"}
    assert set(out["podLatency"]) == {"p50", "p90", "p99"}


def test_cli_perf_threshold_miss_exits_1(tmp_path, capsys):
    rc = main([
        "perf", str(_mini_workload(tmp_path, threshold=1e12)),
        "--device", "cpu",
    ])
    assert rc == 1
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["threshold"] == 1e12 and out["passed"] is False
    assert "FAIL: Mini/only" in cap.err


def test_cli_perf_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["perf", str(_mini_workload(tmp_path))])


# -- serve as a subprocess ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port, method, path, payload=None, timeout=120):
    data = json.dumps(payload).encode() if payload is not None else None
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=data,
        method=method,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get_status(port, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Serve:
    """``python -m kubernetes_tpu_torch serve --device cpu ...`` in a
    subprocess, healthy on entry, stopped with SIGTERM on exit (whose
    return code ``rc`` then holds)."""

    def __init__(self, tmp_path, state: dict, *serve_flags: str,
                 leader_elect: bool = False, mode: str = "scheduler"):
        state_file = tmp_path / "state.json"
        state_file.write_text(json.dumps(state))
        self.port = _free_port()
        self.log_path = tmp_path / "serve.log"
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "kubernetes_tpu_torch",
                *(["--leader-elect"] if leader_elect else []),
                "serve", "--device", "cpu",
                "--state", str(state_file),
                "--mode", mode,
                "--port", str(self.port),
                *serve_flags,
            ],
            cwd=_REPO, stdout=self._log, stderr=subprocess.STDOUT,
        )
        self.rc = None

    def log(self) -> str:
        self._log.flush()
        return self.log_path.read_text()

    def __enter__(self):
        last_err = None
        for _ in range(240):
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/healthz", timeout=5
                ) as resp:
                    assert resp.read() == b"ok"
                return self
            except Exception as e:
                last_err = e
                if self.proc.poll() is not None:
                    pytest.fail("serve exited during startup:\n" + self.log())
                time.sleep(0.5)
        self.__exit__(None, None, None)
        pytest.fail(f"serve never became healthy ({last_err!r}):\n" + self.log())

    def __exit__(self, *exc):
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.rc = self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self._log.close()
        return False


def _nodes(n, pods="20"):
    return [
        MakeNode().name(f"n{i}").label("kubernetes.io/hostname", f"n{i}")
        .label("topology.kubernetes.io/zone", f"z{i % 2}")
        .capacity({"cpu": "8", "memory": "16Gi", "pods": pods}).obj()
        for i in range(n)
    ]


def test_serve_process_end_to_end(tmp_path):
    """Leader election on: the process acquires its lease, comes up,
    answers filter and prioritize with the JSON the JAX package's
    ExtenderCore returns for the same cluster, ingests, binds in its
    background loop, and exits 0 on SIGTERM."""
    from kubernetes_tpu.api.objects import Node as RefNode
    from kubernetes_tpu.api.objects import Pod as RefPod
    from kubernetes_tpu.server.extender import ExtenderCore as RefCore
    from kubernetes_tpu.state.cluster import ClusterState as RefCluster

    nodes = _nodes(4)
    ref_cluster = RefCluster()
    for n in nodes:
        ref_cluster.create_node(RefNode.from_dict(n.to_dict()))
    ref_core = RefCore(ref_cluster)
    probes = [
        MakePod().name("probe").req({"cpu": "4"}).obj(),
        MakePod().name("spread").label("app", "s").req({"cpu": "1"})
        .spread_constraint(
            1, "topology.kubernetes.io/zone", "DoNotSchedule", {"app": "s"}
        ).obj(),
        MakePod().name("anti").label("app", "a").req({"cpu": "1"})
        .pod_anti_affinity("kubernetes.io/hostname", {"app": "a"}).obj(),
    ]
    serve = _Serve(tmp_path, {"nodes": [n.to_dict() for n in nodes]},
                   leader_elect=True)
    with serve:
        assert "leader election: acquired lease" in serve.log()
        assert _req(serve.port, "GET", "/api/state")["nodes"] == 4
        for pod in probes:
            names = {"pod": pod.to_dict(),
                     "nodenames": ["n0", "n1", "n2", "n3", "ghost"]}
            items = {"pod": pod.to_dict(),
                     "nodes": {"items": [n.to_dict() for n in nodes]}}
            ref_pod = RefPod.from_dict(pod.to_dict()).to_dict()
            for verb, args in (("filter", names), ("prioritize", items),
                               ("filter", items)):
                ours = _req(serve.port, "POST", f"/{verb}", args)
                ref = json.loads(json.dumps(
                    getattr(ref_core, verb)(dict(args, pod=ref_pod))
                ))
                assert ours == ref, (verb, pod.name)
        out = _req(serve.port, "POST", "/filter",
                   {"pod": probes[0].to_dict(),
                    "nodenames": ["n0", "n1", "ghost"]})
        assert out["nodenames"] == ["n0", "n1"]
        assert out["failedAndUnresolvableNodes"] == {"ghost": "node not found"}

        pods = {"items": [
            MakePod().name(f"w{i}").req({"cpu": "1"}).obj().to_dict()
            for i in range(6)
        ]}
        assert _req(serve.port, "POST", "/api/pods", pods) == {"applied": 6}
        for _ in range(120):
            st = _req(serve.port, "GET", "/api/state")
            if st["unscheduled"] == 0:
                break
            time.sleep(0.5)
        assert st["unscheduled"] == 0
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{serve.port}/metrics", timeout=5
        ).read().decode()
        assert "scheduler_schedule_attempts_total" in raw
    assert serve.rc == 0, serve.log()


def test_serve_extender_mode_answers_every_verb_as_jax(tmp_path):
    """``serve --mode extender`` (no background loop) on a cluster with
    bound pods: filter, prioritize, preempt and bind (and bind's
    conflict) answer with the JAX ExtenderCore's JSON for the same
    state."""
    from kubernetes_tpu.api.objects import Node as RefNode
    from kubernetes_tpu.api.objects import Pod as RefPod
    from kubernetes_tpu.server.extender import ExtenderCore as RefCore
    from kubernetes_tpu.state.cluster import ClusterState as RefCluster

    nodes = _nodes(4)
    bound = [
        MakePod().name(f"b{i}").label("app", "a").priority(0).node(f"n{i % 4}")
        .req({"cpu": "3"}).obj()
        for i in range(6)
    ]
    ref_cluster = RefCluster()
    for n in nodes:
        ref_cluster.create_node(RefNode.from_dict(n.to_dict()))
    for q in bound:
        ref_cluster.create_pod(RefPod.from_dict(q.to_dict()))
    ref_core = RefCore(ref_cluster)
    names = [n.name for n in nodes]
    vip = MakePod().name("vip").priority(100).req({"cpu": "6"}).obj()
    anti = (MakePod().name("anti").label("app", "a").req({"cpu": "1"})
            .pod_anti_affinity("kubernetes.io/hostname", {"app": "a"}).obj())
    pending = MakePod().name("pend").req({"cpu": "1"}).obj()
    serve = _Serve(
        tmp_path,
        {"nodes": [n.to_dict() for n in nodes],
         "pods": [q.to_dict() for q in bound]},
        mode="extender",
    )
    with serve:
        _req(serve.port, "POST", "/api/pods", pending.to_dict())
        ref_cluster.create_pod(RefPod.from_dict(pending.to_dict()))
        calls = [
            ("filter", {"pod": anti.to_dict(), "nodenames": names}),
            ("prioritize", {"pod": anti.to_dict(), "nodenames": names}),
            ("filter", {"pod": vip.to_dict(), "nodenames": names}),
            ("preempt", {"pod": vip.to_dict(),
                         "nodeNameToVictims": {n: {"pods": []} for n in names}}),
            ("bind", {"podName": "pend", "podNamespace": "default", "node": "n3"}),
            ("bind", {"podName": "pend", "podNamespace": "default", "node": "n2"}),
        ]
        for verb, args in calls:
            ours = _req(serve.port, "POST", f"/{verb}", args)
            ref = json.loads(json.dumps(getattr(ref_core, verb)(args)))
            assert ours == ref, (verb, ours, ref)
        assert "Conflict" in ours["error"]
    assert serve.rc == 0, serve.log()


def test_serve_debug_surfaces_end_to_end(tmp_path):
    """The debug surfaces over a real serve subprocess with the full
    telemetry stack on: status codes, schemas, one consistent read of
    /debug/profile under concurrent scheduling, a manual capture."""
    from kubernetes_tpu_torch.obs.profile import ALL_STAGES

    serve = _Serve(
        tmp_path, {"nodes": [n.to_dict() for n in _nodes(4, pods="40")]},
        "--obs", "--slo", "30", "--telemetry",
    )
    with serve:
        port = serve.port
        status, slo = _get_status(port, "/debug/slo")
        assert status == 200, slo
        for key in ("healthy", "p99_pod_latency_s", "burn_rates"):
            assert key in slo, sorted(slo)
        status, hub = _get_status(port, "/debug/hub")
        assert status == 404
        assert "occupancy hub" in hub["error"]
        status, prof = _get_status(port, "/debug/profile")
        assert status == 200, prof
        assert prof["enabled"] is True
        assert set(prof["profile"]["stage_seconds"]) == set(ALL_STAGES)
        assert "degraded" in prof["sentinel"]
        assert "captures" in prof["bundles"]

        pods = {"items": [
            MakePod().name(f"w{i}").req({"cpu": "1"}).obj().to_dict()
            for i in range(24)
        ]}
        assert _req(port, "POST", "/api/pods", pods) == {"applied": 24}
        last_batches = 0
        for _ in range(120):
            status, prof = _get_status(port, "/debug/profile")
            assert status == 200
            batches = prof["profile"]["batches"]
            assert batches >= last_batches
            assert set(prof["profile"]["stage_seconds"]) == set(ALL_STAGES)
            last_batches = batches
            st = _req(port, "GET", "/api/state")
            if st["unscheduled"] == 0 and batches > 0:
                break
            time.sleep(0.5)
        assert st["unscheduled"] == 0
        assert last_batches > 0
        assert sum(prof["profile"]["stage_seconds"].values()) > 0.0

        status, cap = _get_status(port, "/debug/profile?capture=1")
        assert status == 200
        assert cap["captured"] is True
        assert cap["bundles"]["captures"] >= 1
        assert cap["bundles"]["by_trigger"].get("manual", 0) >= 1
    assert serve.rc == 0, serve.log()


def test_serve_grpc_port_answers_bulk_solves(tmp_path):
    """``serve --grpc-port`` also serves the bulk tensor gRPC path: a
    ``BulkClient`` single-shot solve over the process's ingested nodes
    answers as the JAX package's ``BulkCore`` does over the same nodes, and
    an exact solve (the default "random" tie-break, which the port cannot
    reproduce) places every pod."""
    import numpy as np

    from kubernetes_tpu.api.objects import Node as RefNode
    from kubernetes_tpu.server import tensorcodec as ref_codec
    from kubernetes_tpu.server.bulk import BulkCore as RefBulkCore
    from kubernetes_tpu.state.cluster import ClusterState as RefCluster
    from kubernetes_tpu_torch.server.bulk import BulkClient

    nodes = _nodes(4)
    ref_cluster = RefCluster()
    for n in nodes:
        ref_cluster.create_node(RefNode.from_dict(n.to_dict()))
    ref = RefBulkCore(ref_cluster)
    gport = _free_port()
    serve = _Serve(tmp_path, {"nodes": [n.to_dict() for n in nodes]},
                   "--grpc-port", str(gport), mode="extender")
    with serve:
        client = BulkClient(f"127.0.0.1:{gport}")
        cpu, mem = np.full(12, 1000, np.int64), np.full(12, 1 << 30, np.int64)
        for mode in ("single_shot", "exact"):
            meta, arrays = client.solve(cpu_milli=cpu, mem_bytes=mem, mode=mode)
            assert (arrays["assignments"] >= 0).all()
        rmeta, rarrays = ref_codec.decode(ref.solve(ref_codec.encode(
            {"mode": "single_shot"}, {"cpu_milli": cpu, "mem_bytes": mem})))
        meta, arrays = client.solve(cpu_milli=cpu, mem_bytes=mem, mode="single_shot")
        assert meta == rmeta
        np.testing.assert_array_equal(arrays["assignments"], rarrays["assignments"])
        client.close()
    assert serve.rc == 0, serve.log()


def test_serve_without_device_needs_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch", "serve",
         "--port", str(_free_port())],
        cwd=_REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
