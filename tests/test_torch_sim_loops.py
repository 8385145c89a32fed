"""The simulator's drives of the port's loops, on ``device="cpu"``.

The port's copies of tests/test_sim.py, of the sim cases of
test_streaming_shapes.py, test_backlog_drain.py, test_tuning.py
(``TestTuningInvariant``, ``TestSimAcceptance``) and test_telemetry.py
(the anomaly_storm forensic loop), and the ``--tuned-profile`` document
held against the JAX package's.
"""

from __future__ import annotations

import functools
import json

import pytest

from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.obs.bundle import replay_bundle
from kubernetes_tpu_torch.sim import replay_trace as _replay_trace
from kubernetes_tpu_torch.sim import run_sim as _run_sim

run_sim = functools.partial(_run_sim, device="cpu")
replay_trace = functools.partial(_replay_trace, device="cpu")

CYCLES = 6  # small: tier-1 budget; the soak covers depth


# -- tests/test_sim.py ------------------------------------------------------


def test_churn_heavy_deterministic():
    a = run_sim("churn_heavy", seed=0, cycles=CYCLES)
    b = run_sim("churn_heavy", seed=0, cycles=CYCLES)
    assert a.trace.lines == b.trace.lines
    assert a.trace.digest() == b.trace.digest()
    assert a.bindings == b.bindings
    assert a.violations == b.violations == []
    assert a.settled and b.settled


def test_churn_heavy_pipelined_fence_and_backstop():
    """Bind failures and delayed/duplicated watch delivery against
    run_pipelined: zero invariant violations, the fence discarded solves
    and the livelock backstop engaged at least once."""
    res = run_sim("churn_heavy", seed=0, cycles=CYCLES)
    assert res.summary["pipelined"] is True
    assert res.violations == []
    assert res.settled
    assert res.summary["bind_faults"] > 0
    assert res.summary["watch_delivered"] > 0
    assert res.summary["discards"] >= 1
    assert res.summary["pipeline_fallbacks"] >= 1


def test_bind_storms_external_actors():
    res = run_sim("bind_storms", seed=1, cycles=CYCLES)
    assert res.violations == []
    assert res.settled
    assert res.summary["bind_faults"] > 0


def test_trace_replays_to_identical_bindings(tmp_path):
    path = tmp_path / "trace.jsonl"
    rec = run_sim("churn_heavy", seed=5, cycles=CYCLES)
    rec.trace.dump(path)
    rep = replay_trace(path)
    assert rep.replay_divergence is None
    assert rep.bindings == rec.bindings
    assert [v.as_dict() for v in rep.violations] == [
        v.as_dict() for v in rec.violations
    ]


def test_sim_metrics_registered():
    """Every scheduler_sim_* series the sim records is registered."""
    run_sim("node_flaps", seed=2, cycles=3)
    names = {family._name for family in metrics.REGISTRY.collect()}
    for expected in (
        "scheduler_sim_events",
        "scheduler_sim_faults_injected",
        "scheduler_sim_invariant_violations",
        "scheduler_sim_cycles",
    ):
        assert expected in names, expected


def test_crash_restart_acceptance():
    """Kill the scheduler after assume, before bind; a fresh incarnation
    on the same ClusterState brings every pod to a terminal journal
    outcome with zero double-binds, byte-deterministically."""
    a = run_sim("crash_restart", seed=0, cycles=8)
    assert a.violations == []
    assert a.settled
    assert a.summary["crashes"] == 1
    assert a.summary["incarnations"] == 2
    assert a.summary["recovered_records"] >= 1
    b = run_sim("crash_restart", seed=0, cycles=8)
    assert a.trace.lines == b.trace.lines
    assert a.journal_lines == b.journal_lines


# -- the streaming, drain and tuning profiles --------------------------------


def test_sustained_stream_profile_deterministic():
    r1 = run_sim("sustained_stream", seed=3, cycles=4)
    r2 = run_sim("sustained_stream", seed=3, cycles=4)
    assert r1.summary["streaming"] is True
    assert not r1.violations, r1.violations
    assert r1.journal_lines == r2.journal_lines
    assert r1.trace.lines == r2.trace.lines


def test_streaming_dispatcher_override_drives_existing_profiles():
    """--dispatcher streaming re-drives an existing profile through
    run_streaming."""
    before = metrics.pipeline_mode_total.labels("stream")._value.get()
    res = run_sim("preemption_pressure", seed=0, cycles=3, streaming=True)
    assert res.summary["streaming"] is True
    assert not res.violations, res.violations
    assert metrics.pipeline_mode_total.labels("stream")._value.get() > before


def test_backlog_drain_sim_profile_deterministic():
    """backlog_drain drives drain_backlog at cycle 0 (budget split
    forced) and is byte-deterministic across runs."""
    a = run_sim("backlog_drain", seed=3, cycles=3)
    b = run_sim("backlog_drain", seed=3, cycles=3)
    assert a.ok, [str(v) for v in a.violations]
    assert a.summary["backlog"] is not None
    assert a.summary["backlog"]["budget_splits"] >= 1
    assert a.summary["backlog"]["chunks"] >= 2
    assert a.trace.digest() == b.trace.digest()
    assert a.summary["journal_digest"] == b.summary["journal_digest"]


class TestTuningInvariant:
    """Known-bad fixtures for sim/invariants.check_tuning: every clause
    must fire on a summary violating exactly it."""

    GOOD = {
        "probes": 4,
        "moves": 1,
        "max_knob_moves": 1,
        "settled": 1,
        "guardrail_breaches": 0,
        "shifts": 1,
        "batches_since_unsettle": 100,
        "settle_bound": 24,
        "knobs": {"stream_depth": 4},
    }

    def _violations(self, summary, **kw):
        from kubernetes_tpu_torch.sim.invariants import check_tuning

        v = []
        check_tuning(0, v, summary=summary, **kw)
        return v

    def test_clean_summary_passes(self):
        assert self._violations(dict(self.GOOD), expect_shift=True) == []

    def test_never_engaged(self):
        v = self._violations(dict(self.GOOD, probes=0))
        assert len(v) == 1 and "never probed" in v[0].detail

    def test_unsettled(self):
        v = self._violations(dict(self.GOOD, settled=0))
        assert any("unsettled" in x.detail for x in v)
        v2 = self._violations(
            dict(self.GOOD, settled=0, batches_since_unsettle=10)
        )
        assert v2 == []

    def test_guardrail_breach(self):
        v = self._violations(dict(self.GOOD, guardrail_breaches=2))
        assert any("guardrail breach" in x.detail for x in v)

    def test_knob_thrash(self):
        v = self._violations(dict(self.GOOD, max_knob_moves=40))
        assert any("thrash" in x.detail for x in v)

    def test_missed_shift(self):
        v = self._violations(dict(self.GOOD, shifts=0), expect_shift=True)
        assert any("never detected" in x.detail for x in v)
        assert (
            self._violations(dict(self.GOOD, shifts=0), expect_shift=False)
            == []
        )


class TestSimAcceptance:
    # the JAX package marks the first slow; on the port the 24-cycle run
    # takes about a second on the CPU, so it runs in tier-1
    def test_tuning_convergence_profile_settles_and_reconverges(self):
        res = run_sim("tuning_convergence", seed=0, cycles=24)
        assert res.ok, res.violations
        tu = res.summary["tuning"]
        assert tu["settled"] == 1
        assert tu["shifts"] >= 1
        assert tu["guardrail_breaches"] == 0
        assert res.tuned_profile is not None

    def test_tuning_convergence_deterministic(self):
        a = run_sim("tuning_convergence", seed=3, cycles=10)
        b = run_sim("tuning_convergence", seed=3, cycles=10)
        assert a.trace.lines == b.trace.lines
        assert a.journal_lines == b.journal_lines
        assert a.summary["tuning"] == b.summary["tuning"]


def test_tuned_profile_cli_matches_jax(tmp_path):
    """``--tuned-profile`` writes the converged knobs as YAML through the
    port's ``dump_yaml``; the document equals the JAX package's except
    ``tpuSolver.pallas``, a key the port's ``tuned_profile`` leaves out
    (the port has no Pallas switch)."""
    import yaml

    from kubernetes_tpu.sim.__main__ import main as jax_main
    from kubernetes_tpu_torch.config import types as ct
    from kubernetes_tpu_torch.sim.__main__ import main as port_main
    from kubernetes_tpu_torch.tuning.profile import dump_yaml

    ours, ref = tmp_path / "port.yaml", tmp_path / "jax.yaml"
    argv = ["--profile", "tuning_convergence", "--seed", "0", "--cycles", "12"]
    assert port_main(argv + ["--device", "cpu", "--tuned-profile", str(ours)]) == 0
    assert jax_main(argv + ["--tuned-profile", str(ref)]) == 0
    doc, ref_doc = yaml.safe_load(ours.read_text()), yaml.safe_load(ref.read_text())
    assert ref_doc["tpuSolver"].pop("pallas") is False
    assert doc == ref_doc
    assert ours.read_text() == dump_yaml(doc)
    loaded = ct.load(ours.read_text())
    assert loaded.tuning.enabled is False


def test_anomaly_storm_forensic_loop(tmp_path):
    """anomaly_storm drives the sentinel, every fire captures a bundle to
    disk, each carry-clean bundle replays to bit-identical assignments on
    the CPU, and a tampered bundle diverges."""
    r = run_sim("anomaly_storm", seed=0, cycles=12, bundle_dir=str(tmp_path))
    assert r.violations == []
    tel = r.summary["telemetry"]
    assert tel["anomalies"] >= 1
    assert "breaker" in tel["anomaly_signals"]
    assert tel["bundles_captured"] >= 1
    assert sum(tel["bundle_triggers"].values()) == tel["bundles_captured"]

    bundles = sorted(str(p) for p in tmp_path.glob("bundle-*"))
    assert bundles, "sentinel fired but nothing hit disk"
    replayed = []
    for b in bundles:
        rep = replay_bundle(b, device="cpu")
        if rep["replayable"]:
            assert rep["ok"], f"{b}: {rep['detail']}"
            replayed.append(b)
    assert replayed, "no carry-clean bundle — the loop never closed"

    mpath = tmp_path / replayed[0].rsplit("/", 1)[1] / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["parts"][0]["assignments"][0] += 1
    mpath.write_text(json.dumps(manifest))
    rep = replay_bundle(replayed[0], device="cpu")
    assert rep["replayable"] and not rep["ok"]
    assert "mismatch" in rep["detail"]


@pytest.mark.parametrize("dispatcher", ["sync", "pipelined", "streaming"])
def test_dispatcher_override_matches_jax(dispatcher):
    """``--dispatcher`` re-drives churn_heavy through each loop; every
    loop's trace equals the JAX package's."""
    from kubernetes_tpu.sim import run_sim as jax_run_sim

    from test_torch_sim import assert_traces_match

    kw = {"pipelined": dispatcher == "pipelined",
          "streaming": dispatcher == "streaming"}
    ours = run_sim("churn_heavy", seed=1, cycles=CYCLES, **kw)
    ref = jax_run_sim("churn_heavy", seed=1, cycles=CYCLES, **kw)
    assert ours.ok
    assert_traces_match(ours.trace.lines, ref.trace.lines)
