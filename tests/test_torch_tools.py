"""The port's tools: ``python -m kubernetes_tpu_torch.obs`` (validate,
explain, top, replay) and ``python -m kubernetes_tpu_torch.metrics``, and
the structured logging setup ``serve`` uses.

A journal either package wrote validates and explains with the same output
through the other package's tool. ``metrics --check`` holds the port's
registry against docs/METRICS.md and never writes that file (the port's
copies of tests/test_metrics_doc.py use ``--check`` or ``--stdout``).
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys

import pytest

from kubernetes_tpu.obs.__main__ import main as jax_obs_main
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.obs.__main__ import main as obs_main
from kubernetes_tpu_torch.obs.journal import validate_lines
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState


def _journaled_scheduler():
    """tests/test_obs.py's fixture on the port: one pod binds, one is
    unschedulable on 2 nodes of 4 CPU."""
    cs = ClusterState()
    for i in range(2):
        cs.create_node(
            MakeNode().name(f"node-{i}")
            .capacity({"cpu": "4", "memory": "8Gi", "pods": "20"}).obj()
        )
    sched = Scheduler(
        cs,
        SchedulerConfig(
            batch_size=64, solver=ExactSolverConfig(tie_break="first"),
            obs=ObsConfig(spans=True, journal=True),
        ),
        device="cpu",
    )
    cs.create_pod(MakePod().name("win").uid("u-win").req({"cpu": "100m"}).obj())
    cs.create_pod(MakePod().name("lose").uid("u-lose").req({"cpu": "64"}).obj())
    sched.run_until_settled()
    return sched


def test_cli_explain_and_validate(tmp_path, capsys):
    sched = _journaled_scheduler()
    path = tmp_path / "journal.jsonl"
    sched.journal.dump(path)
    assert obs_main(["validate", str(path)]) == 0
    assert "schema OK" in capsys.readouterr().out
    assert obs_main(["explain", "default/lose", "--trace", str(path)]) == 0
    out = capsys.readouterr().out
    assert "unschedulable" in out and "NodeResourcesFit" in out
    assert obs_main(["explain", "ghost", "--trace", str(path)]) == 1
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"k":"dec"}\n')
    assert obs_main(["validate", str(bad)]) == 1


def _sim_journal(package: str) -> list[str]:
    if package == "port":
        from kubernetes_tpu_torch.sim import run_sim

        return run_sim("preemption_pressure", seed=0, cycles=4,
                       device="cpu").journal_lines
    from kubernetes_tpu.sim import run_sim

    return run_sim("preemption_pressure", seed=0, cycles=4).journal_lines


def _scheduler_journal(package: str, tmp_path) -> list[str]:
    if package == "port":
        return list(_journaled_scheduler().journal.lines)
    from kubernetes_tpu.api.wrappers import MakeNode as RefNode
    from kubernetes_tpu.api.wrappers import MakePod as RefPod
    from kubernetes_tpu.obs import ObsConfig as RefObs
    from kubernetes_tpu.scheduler import Scheduler as RefScheduler
    from kubernetes_tpu.scheduler import SchedulerConfig as RefConfig
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefSolver
    from kubernetes_tpu.state.cluster import ClusterState as RefCluster

    cs = RefCluster()
    for i in range(2):
        cs.create_node(RefNode().name(f"node-{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "20"}).obj())
    sched = RefScheduler(cs, RefConfig(
        batch_size=64, mesh_devices=1,
        solver=RefSolver(tie_break="first"),
        obs=RefObs(spans=True, journal=True),
    ))
    cs.create_pod(RefPod().name("win").uid("u-win").req({"cpu": "100m"}).obj())
    cs.create_pod(RefPod().name("lose").uid("u-lose").req({"cpu": "64"}).obj())
    sched.run_until_settled()
    return list(sched.journal.lines)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("source", ["sim", "scheduler"])
def test_journal_reads_the_same_through_both_tools(writer, source, tmp_path,
                                                   capsys):
    lines = (
        _sim_journal(writer) if source == "sim"
        else _scheduler_journal(writer, tmp_path)
    )
    assert lines and validate_lines(lines) == []
    path = tmp_path / "journal.jsonl"
    path.write_text("\n".join(lines) + "\n")
    pods = sorted({json.loads(ln)["pod"] for ln in lines})[:6] + ["ghost"]
    for argv in [["validate", str(path)]] + [
        ["explain", pod, "--trace", str(path)] for pod in pods
    ]:
        assert _run(obs_main, argv, capsys) == _run(jax_obs_main, argv, capsys)


def test_sim_journals_of_both_packages_are_identical():
    assert _sim_journal("port") == _sim_journal("jax")


def test_explain_hub_raises(capsys):
    """``explain --fleet --hub`` (which raised, naming ROADMAP item 8c,
    before the fleet was ported) reads a live occupancy hub's journal
    aggregation over gRPC: a fleet sim's hub journal shipped to the port's
    hub renders a handed-off pod's cross-replica history, and the JAX
    package's tool reading the same hub prints the same."""
    from kubernetes_tpu_torch.fleet import OccupancyExchange
    from kubernetes_tpu_torch.server.bulk import BulkCore, make_grpc_server
    from kubernetes_tpu_torch.sim.fleet import run_fleet_sim

    res = run_fleet_sim("fleet_handoff", seed=0, cycles=6, device="cpu")
    lines = res.hub_journal_lines
    replicas: dict = {}
    for ln in lines:
        rec = json.loads(ln)
        replicas.setdefault(rec["pod"], set()).add(rec.get("replica"))
    handed = sorted(p for p, rs in replicas.items() if len(rs) > 1)
    assert handed, "the handoff profile handed no pod across replicas"
    hub = OccupancyExchange()
    hub.ship_journal("r0", lines)
    server, port = make_grpc_server(BulkCore(ClusterState(), exchange=hub, device="cpu"))
    server.start()
    try:
        argv = ["explain", handed[0], "--fleet", "--hub", f"127.0.0.1:{port}"]
        out = _run(obs_main, argv, capsys)
        assert out == _run(jax_obs_main, argv, capsys)
        assert out[0] == 0 and "replicas:" in out[1] and "->" in out[1]
    finally:
        server.stop(grace=None)


def test_obs_top_cli_renders_snapshot_file(tmp_path):
    from kubernetes_tpu_torch.obs.profile import STAGES

    snap = {
        "enabled": True,
        "profile": {
            "batches": 4, "pods": 32,
            "stage_seconds": {s: 0.1 for s in STAGES},
            "stage_fraction": {s: 1.0 / len(STAGES) for s in STAGES},
            "recent": [{"step": 9, "pods": 8, "wall_s": 0.5,
                        "h2d_bytes": 1024.0, "d2h_bytes": 64.0}],
        },
        "sentinel": {
            "degraded": True, "fired_total": 2, "suppressed_windows": 1,
            "recent_anomalies": [{"signal": "pods_per_sec", "kind": "spike",
                                  "value": 100.0, "baseline": 1000.0,
                                  "window": 7}],
        },
        "bundles": {
            "captures": 2, "missed": 0,
            "by_trigger": {"sentinel": 1, "manual": 1},
            "written": ["/b/bundle-00000-sentinel", "/b/bundle-00001-manual"],
        },
    }
    f = tmp_path / "snap.json"
    f.write_text(json.dumps(snap))
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.obs", "top",
         "--snapshot", str(f)],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "flight telemetry — 4 batches" in out.stdout
    assert "manual=1,sentinel=1" in out.stdout


def test_obs_replay_cli_on_the_cpu(tmp_path, capsys):
    """``obs replay --device cpu``: a manual capture of a synchronous
    batch replays bit-identically (exit 0); a tampered manifest diverges
    (exit 1)."""
    cs = ClusterState()
    for i in range(4):
        cs.create_node(
            MakeNode().name(f"n{i}").label("kubernetes.io/hostname", f"n{i}")
            .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"}).obj()
        )
    for i in range(12):
        cs.create_pod(
            MakePod().name(f"p{i}").label("app", "a").req({"cpu": "1"})
            .pod_anti_affinity("kubernetes.io/hostname", {"app": "a"})
            .obj() if i % 3 == 0 else
            MakePod().name(f"p{i}").req({"cpu": "1"}).obj()
        )
    sched = Scheduler(
        cs,
        SchedulerConfig(
            batch_size=64, solver=ExactSolverConfig(tie_break="first"),
            obs=ObsConfig(journal=True, bundle_dir=str(tmp_path)),
        ),
        device="cpu",
    )
    sched.schedule_batch()
    assert sched.telemetry.capture("manual")
    bundle = sorted(tmp_path.glob("bundle-*"))[0]
    rc, out, _ = _run(obs_main, ["replay", str(bundle), "--device", "cpu"],
                      capsys)
    assert rc == 0, out
    assert "assignments bit-identical" in out
    manifest = bundle / "manifest.json"
    doc = json.loads(manifest.read_text())
    doc["parts"][0]["assignments"][0] += 1
    manifest.write_text(json.dumps(doc))
    rc, out, _ = _run(obs_main, ["replay", str(bundle), "--device", "cpu"],
                      capsys)
    assert rc == 1 and "mismatch" in out


# -- the sim's journal contract (tests/test_obs.py TestSimJournal) ------------


def test_same_seed_byte_identical_journal_and_completeness():
    from kubernetes_tpu_torch.sim.harness import run_sim

    r1 = run_sim("churn_heavy", seed=3, cycles=3, device="cpu")
    r2 = run_sim("churn_heavy", seed=3, cycles=3, device="cpu")
    assert r1.ok and r2.ok
    assert r1.journal_lines == r2.journal_lines
    assert r1.journal_lines
    assert validate_lines(r1.journal_lines) == []
    assert r1.summary["journal_digest"] == r2.summary["journal_digest"]


def test_invariant_violation_dumps_flight_recorder(tmp_path):
    from kubernetes_tpu_torch.sim.harness import SimHarness
    from kubernetes_tpu_torch.sim.invariants import _record

    dump = tmp_path / "flight.jsonl"
    h = SimHarness("churn_heavy", seed=1, cycles=2, flight_dump=str(dump),
                   device="cpu")
    _record(h.violations, "capacity", 0, "synthetic for the test")
    res = h.run()
    assert res.flight_dump == str(dump)
    assert dump.exists()


# -- structured logging (tests/test_obs.py TestStructuredLogging) -------------


class TestStructuredLogging:
    def test_json_formatter_carries_extras(self):
        from kubernetes_tpu_torch.utils.logging import JsonLineFormatter

        fmt = JsonLineFormatter()
        rec = logging.LogRecord(
            "kubernetes_tpu_torch.scheduler", logging.INFO, __file__, 1,
            "bound %d pods", (3,), None,
        )
        rec.step = 12
        rec.pod = "default/p"
        out = json.loads(fmt.format(rec))
        assert out["msg"] == "bound 3 pods"
        assert out["step"] == 12 and out["pod"] == "default/p"
        assert out["level"] == "INFO"

    def test_setup_is_idempotent(self):
        from kubernetes_tpu_torch.utils.logging import setup

        logger = setup("json", logger_name="kubernetes_tpu_torch.test_tools")
        setup("text", logger_name="kubernetes_tpu_torch.test_tools")
        named = [
            h for h in logger.handlers
            if h.get_name() == "kubernetes_tpu_torch.test_tools.structured"
        ]
        assert len(named) == 1

    def test_setup_rejects_unknown_format(self):
        from kubernetes_tpu_torch.utils.logging import setup

        with pytest.raises(ValueError):
            setup("xml")

    def test_default_root_is_the_ports_logger_tree(self):
        from kubernetes_tpu_torch.utils.logging import ROOT_LOGGER

        assert ROOT_LOGGER == "kubernetes_tpu_torch"


# -- tests/test_metrics_doc.py, with --check only -----------------------------


class TestMetricsDoc:
    def test_committed_doc_matches_registry(self, capsys):
        from kubernetes_tpu_torch.metrics.__main__ import (
            doc_path,
            main,
            render_doc,
        )

        path = doc_path()
        before = path.read_bytes()
        assert path.read_text() == render_doc()
        assert main(["--check"]) == 0
        assert "matches the registry" in capsys.readouterr().out
        assert path.read_bytes() == before

    def test_every_registered_series_is_documented(self):
        from kubernetes_tpu_torch import metrics as m
        from kubernetes_tpu_torch.metrics.__main__ import render_doc
        from kubernetes_tpu_torch.metrics.prom import Counter, Gauge, Histogram

        doc = render_doc()
        n = 0
        for attr in dir(m):
            obj = getattr(m, attr)
            if isinstance(obj, (Counter, Gauge, Histogram)):
                name = obj._name
                if isinstance(obj, Counter):
                    name += "_total"
                assert f"`{name}`" in doc, f"{name} missing from doc"
                n += 1
        assert n == 103

    def test_doc_rows_carry_labels(self):
        from kubernetes_tpu_torch.metrics.__main__ import render_doc

        row = next(
            ln for ln in render_doc().splitlines()
            if "`scheduler_slo_error_budget_burn`" in ln
        )
        assert "window" in row

    def test_check_mode_detects_drift(self, tmp_path, monkeypatch):
        import kubernetes_tpu_torch.metrics.__main__ as mm

        stale = tmp_path / "METRICS.md"
        stale.write_text("# stale\n")
        monkeypatch.setattr(mm, "doc_path", lambda: stale)
        assert mm.main(["--check"]) == 1
        stale.write_text(mm.render_doc())
        assert mm.main(["--check"]) == 0

    def test_never_writes_the_doc(self, capsys):
        """The port renders the reference to stdout only: docs/METRICS.md
        is the JAX package's, and the port has no ``--doc``."""
        import kubernetes_tpu_torch.metrics.__main__ as mm

        before = mm.doc_path().read_bytes()
        assert mm.main(["--stdout"]) == 0
        assert capsys.readouterr().out == mm.render_doc()
        assert mm.main([]) == 2
        with pytest.raises(SystemExit):
            mm.main(["--doc"])
        assert mm.doc_path().read_bytes() == before
