"""The flight telemetry on the port: the cases of ``tests/test_telemetry.py``
that need neither the sim nor ``obs/__main__`` (ring arithmetic, sentinel
rules, capturer lifecycle, ``build_telemetry`` gating, the top renderer),
run on the port's copies of those modules; then a replay bundle captured
by the port's Scheduler replays bit-identically through the JAX package's
``replay_bundle``, and one the JAX package captured replays through the
port's, in "first" mode and in random mode (the port draws the JAX
package's threefry stream).
"""

import dataclasses
import json

import numpy as np
import pytest

from kubernetes_tpu_torch.obs import ObsConfig, build_telemetry
from kubernetes_tpu_torch.obs.bundle import BundleCapturer, replay_bundle
from kubernetes_tpu_torch.obs.profile import ALL_STAGES, STAGES, StageProfiler, render_top
from kubernetes_tpu_torch.obs.sentinel import AnomalySentinel, SentinelConfig
from kubernetes_tpu_torch.obs.timeseries import TimeSeriesRing
from kubernetes_tpu_torch.utils.clock import FakeClock

# -- timeseries ring --------------------------------------------------------


class TestTimeSeriesRing:
    def test_append_means_and_baseline(self):
        ring = TimeSeriesRing(8)
        for v in (10.0, 20.0, 30.0, 40.0, 50.0, 60.0):
            ring.append(t=v, batches=1, pods=1, signals={"x": v})
        assert len(ring) == 6
        assert ring.mean("x", 3) == pytest.approx(50.0)
        # baseline = the 3 windows before the trailing 3
        assert ring.mean_prev("x", 3, skip=3) == pytest.approx(20.0)
        # missing signal reads as 0.0, empty slices too
        assert ring.mean("nope", 3) == 0.0
        assert TimeSeriesRing(4).mean("x", 3) == 0.0

    def test_capacity_bound_keeps_seq_monotone(self):
        ring = TimeSeriesRing(4)
        for i in range(10):
            ring.append(t=float(i), batches=1, pods=0, signals={})
        assert len(ring) == 4
        assert ring.last().seq == 9  # seq counts evictions too

    def test_rejects_degenerate_capacity(self):
        with pytest.raises(ValueError):
            TimeSeriesRing(3)

    def test_snapshot_is_json_ready(self):
        ring = TimeSeriesRing(8)
        ring.append(t=1.23456789, batches=2, pods=5, signals={"x": 0.1})
        snap = ring.snapshot(4)
        json.dumps(snap)
        assert snap[-1]["pods"] == 5


# -- stage profiler ---------------------------------------------------------


class TestStageProfiler:
    def test_ledger_totals_and_fractions(self):
        clock = FakeClock()
        prof = StageProfiler(clock=clock)
        prof.add("tensorize", 0.25)
        prof.add("dispatch", 0.5)
        prof.add("dispatch", 0.25)
        prof.add("bind", 0.0)  # zero attribution is dropped
        clock.advance(2.0)
        entry = prof.observe_batch(step=1, pods=8)
        assert entry["stages"]["dispatch"] == pytest.approx(0.75)
        assert entry["stages"]["bind"] == 0.0
        snap = prof.snapshot()
        assert snap["batches"] == 1 and snap["pods"] == 8
        assert set(snap["stage_seconds"]) == set(ALL_STAGES)
        assert snap["stage_fraction"]["tensorize"] == pytest.approx(0.25)
        assert sum(snap["stage_fraction"].values()) == pytest.approx(1.0)

    def test_wall_is_delta_between_batches(self):
        clock = FakeClock()
        prof = StageProfiler(clock=clock)
        assert prof.observe_batch(step=1, pods=1)["wall_s"] == 0.0
        clock.advance(1.5)
        assert prof.observe_batch(step=2, pods=1)["wall_s"] == (
            pytest.approx(1.5)
        )

    def test_ledger_is_bounded(self):
        prof = StageProfiler(clock=FakeClock(), capacity=16)
        for i in range(40):
            prof.observe_batch(step=i, pods=1)
        snap = prof.snapshot(recent=100)
        assert len(snap["recent"]) == 16
        assert snap["batches"] == 40  # totals outlive the ring


# -- anomaly sentinel -------------------------------------------------------


def _small_cfg(**kw) -> SentinelConfig:
    base = dict(
        window_batches=1, fast_windows=1, slow_windows=3, spike_ratio=2.0,
        drift_ratio=1.5, hysteresis=1, cooldown_windows=4, min_windows=3,
        min_events=1.0, recover_windows=2,
    )
    base.update(kw)
    return SentinelConfig(**base)


def _window(sent, **signals):
    sample = sent.ring.append(
        t=float(len(sent.fired) + len(sent.ring)), batches=1, pods=0,
        signals=signals,
    )
    return sent.observe_window(sample)


class TestAnomalySentinel:
    def test_warmup_silence_then_spike_on_collapse(self):
        sent = AnomalySentinel(_small_cfg())
        for _ in range(4):
            assert _window(sent, pods_per_sec=1000.0) == []
        fired = _window(sent, pods_per_sec=100.0)
        assert [a.kind for a in fired] == ["spike"]
        assert fired[0].signal == "pods_per_sec"
        assert sent.degraded

    def test_hysteresis_needs_consecutive_regressions(self):
        sent = AnomalySentinel(_small_cfg(hysteresis=2))
        for _ in range(4):
            _window(sent, pods_per_sec=1000.0)
        assert _window(sent, pods_per_sec=100.0) == []  # streak 1
        fired = _window(sent, pods_per_sec=100.0)  # streak 2 -> fires
        assert [a.kind for a in fired] == ["spike"]

    def test_cooldown_silences_refire(self):
        sent = AnomalySentinel(_small_cfg())
        for _ in range(4):
            _window(sent, pods_per_sec=1000.0)
        assert _window(sent, pods_per_sec=100.0)
        # still collapsed: the signal is cooling down, not re-firing
        assert _window(sent, pods_per_sec=100.0) == []
        assert sent.fired_total == 1

    def test_degraded_clears_after_clean_recovery_windows(self):
        sent = AnomalySentinel(_small_cfg())
        for _ in range(4):
            _window(sent, pods_per_sec=1000.0)
        _window(sent, pods_per_sec=100.0)
        assert sent.degraded
        _window(sent, pods_per_sec=1000.0)
        assert sent.degraded  # 1 of recover_windows=2
        _window(sent, pods_per_sec=1000.0)
        assert not sent.degraded

    def test_breaker_edge_fires_even_under_tuner_suppression(self):
        sent = AnomalySentinel(_small_cfg())
        sample = sent.ring.append(
            t=0.0, batches=1, pods=0,
            signals={"breaker": 1.0, "pods_per_sec": 0.0},
        )
        fired = sent.observe_window(sample, suppress=True)
        assert [a.kind for a in fired] == ["edge"]
        assert sent.suppressed_windows == 1

    def test_event_floor_gates_near_zero_baseline_rates(self):
        sent = AnomalySentinel(_small_cfg(min_events=3.0))
        for _ in range(4):
            _window(sent, discard_rate=0.0)
        # regressed by ratio but under the absolute floor: noise
        assert _window(sent, discard_rate=2.0) == []
        fired = _window(sent, discard_rate=5.0)
        assert [a.signal for a in fired] == ["discard_rate"]

    def test_drift_catches_slow_degradation_spike_misses(self):
        sent = AnomalySentinel(_small_cfg())
        for v in (1000.0, 1000.0, 1000.0, 650.0, 650.0):
            assert _window(sent, pods_per_sec=v) == []
        # ring now holds 2x slow_windows; slow=650 vs prev slow=1000
        fired = _window(sent, pods_per_sec=650.0)
        assert [a.kind for a in fired] == ["drift"]

    def test_snapshot_schema(self):
        sent = AnomalySentinel(_small_cfg())
        for _ in range(4):
            _window(sent, pods_per_sec=1000.0)
        _window(sent, pods_per_sec=100.0)
        snap = sent.snapshot()
        json.dumps(snap)
        assert snap["fired_total"] == 1
        a = snap["recent_anomalies"][-1]
        assert a["signal"] == "pods_per_sec" and a["kind"] == "spike"

    def test_config_validation(self):
        with pytest.raises(ValueError):
            SentinelConfig(fast_windows=5, slow_windows=3).validate()
        with pytest.raises(ValueError):
            SentinelConfig(spike_ratio=1.0).validate()


# -- bundle capturer lifecycle ---------------------------------------------


@dataclasses.dataclass
class _FakePods:
    """Stands in for PodBatch on the in-memory lifecycle paths (the
    capturer only reads ``num_pods`` and copies ndarray fields there;
    real-schema encode/decode is proven by the e2e replay below)."""

    num_pods: int
    cpu: np.ndarray


def _solve_payload(n=3):
    return dict(
        pods=_FakePods(n, np.arange(n)), step_count=5, split=1,
        session=False, allow_heal=True, chain_occupancy=False,
    )


class TestBundleCapturer:
    def test_arm_capture_complete_record_counts_without_dir(self):
        cap = BundleCapturer(None)
        cap.arm(7, profile="t")
        cap.on_solve_input(**_solve_payload())
        cap.note_assignments(7, 0, [0, 1, 2])
        assert cap.capture("manual", note="x") is None  # no out_dir
        snap = cap.snapshot()
        assert snap["captures"] == 1 and snap["missed"] == 0
        assert snap["by_trigger"] == {"manual": 1}
        assert snap["written"] == []

    def test_trigger_with_nothing_complete_is_a_miss(self):
        cap = BundleCapturer(None)
        assert cap.capture("sentinel") is None
        assert cap.snapshot()["missed"] == 1

    def test_partial_coverage_keeps_record_pending(self):
        cap = BundleCapturer(None)
        cap.arm(9)
        cap.on_solve_input(**_solve_payload(n=3))
        cap.note_assignments(9, 0, [0, 1])
        assert cap.snapshot()["pending"] == 1
        cap.note_assignments(9, 2, [2])
        assert cap.snapshot()["ring_complete"] == 1

    def test_drop_kills_the_armed_record(self):
        cap = BundleCapturer(None)
        cap.arm(4)
        cap.drop(4)
        cap.on_solve_input(**_solve_payload())  # disarmed: ignored
        cap.note_assignments(4, 0, [0, 1, 2])
        assert cap.capture("sentinel") is None
        assert cap.snapshot()["missed"] == 1

    def test_unarmed_solve_input_is_ignored(self):
        cap = BundleCapturer(None)
        cap.on_solve_input(**_solve_payload())
        assert cap.snapshot()["pending"] == 0

    def test_carry_clean_tag(self):
        cap = BundleCapturer(None)
        cap.arm(1)
        cap.on_solve_input(
            **{**_solve_payload(), "session": True, "allow_heal": False}
        )
        cap.note_assignments(1, 0, [0, 1, 2])
        rec = cap._ring[-1]
        assert rec["payload"]["carry_clean"] is False


# -- build_telemetry gating -------------------------------------------------


class TestBuildTelemetry:
    def test_everything_off_returns_none(self):
        assert build_telemetry(None) is None
        assert build_telemetry(ObsConfig(spans=True, journal=True)) is None

    def test_profile_only(self):
        tel = build_telemetry(ObsConfig(profile=True))
        assert tel.profiler is not None
        assert tel.sentinel is None and tel.bundles is None
        assert tel.snapshot() == {
            "enabled": True, "profile": tel.profiler.snapshot(),
        }

    def test_sentinel_implies_profiler_and_memory_capturer(self):
        tel = build_telemetry(ObsConfig(sentinel=SentinelConfig()))
        assert tel.profiler is not None
        assert tel.bundles is not None and tel.bundles.out_dir is None
        assert tel.capture("manual") is None  # counts, writes nothing
        assert tel.bundles.snapshot()["missed"] == 1


# -- obs top renderer -------------------------------------------------------


class TestRenderTop:
    def _snapshot(self):
        return {
            "enabled": True,
            "profile": {
                "batches": 4, "pods": 32,
                "stage_seconds": {s: 0.1 for s in STAGES},
                "stage_fraction": {s: 1.0 / len(STAGES) for s in STAGES},
                "recent": [
                    {"step": 9, "pods": 8, "wall_s": 0.5,
                     "h2d_bytes": 1024.0, "d2h_bytes": 64.0}
                ],
            },
            "sentinel": {
                "degraded": True, "fired_total": 2,
                "suppressed_windows": 1,
                "recent_anomalies": [
                    {"signal": "pods_per_sec", "kind": "spike",
                     "value": 100.0, "baseline": 1000.0, "window": 7}
                ],
            },
            "bundles": {
                "captures": 2, "missed": 0,
                "by_trigger": {"sentinel": 1, "manual": 1},
                "written": ["/tmp/b/bundle-00000-sentinel",
                            "/tmp/b/bundle-00001-manual"],
            },
        }

    def test_full_snapshot_renders_every_section(self):
        out = render_top(self._snapshot())
        assert "flight telemetry — 4 batches, 32 pods" in out
        for s in STAGES:
            assert s in out
        assert "last batch: step=9" in out
        assert "degraded=True fired_total=2" in out
        assert "pods_per_sec (spike)" in out
        # written is a PATH LIST in the snapshot — rendered as a count
        assert "written=2" in out
        assert "manual=1,sentinel=1" in out

    def test_tolerates_partially_enabled_telemetry(self):
        out = render_top({"enabled": True, "profile": {
            "batches": 0, "pods": 0, "stage_seconds": {},
            "stage_fraction": {}, "recent": [],
        }})
        assert "0 batches" in out
        assert "sentinel" not in out and "bundles" not in out


# -- capture on the port's Scheduler, replay across the packages ------------


def _cluster(k, n_nodes=8, n_pods=24):
    """A mixed scenario in package ``k``'s objects: zone spread, hostname
    anti-affinity and hostPorts."""
    cs = k.ClusterState()
    for i in range(n_nodes):
        cs.create_node(k.MakeNode().name(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": "20"})
                       .label("zone", f"z{i % 2}").label("kubernetes.io/hostname", f"n{i}").obj())
    for i in range(n_pods):
        b = k.MakePod().name(f"p{i:02}").req({"cpu": "300m"}).label("app", ("s", "a", "h")[i % 3])
        if i % 3 == 0:
            b = b.spread_constraint(1, "zone", "DoNotSchedule", {"app": "s"})
        elif i % 3 == 1:
            b = b.pod_anti_affinity("kubernetes.io/hostname", {"app": "a"})
        else:
            b = b.host_port(9000 + i % 4)
        cs.create_pod(b.obj())
    return cs


def _side(name):
    import importlib
    import types

    root = "kubernetes_tpu" if name == "jax" else "kubernetes_tpu_torch"

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    wrappers, obs = m("api.wrappers"), m("obs")
    return types.SimpleNamespace(
        name=name, MakeNode=wrappers.MakeNode, MakePod=wrappers.MakePod,
        ClusterState=m("state.cluster").ClusterState, FakeClock=m("utils.clock").FakeClock,
        ObsConfig=obs.ObsConfig, SentinelConfig=obs.SentinelConfig,
        SolverFaultError=m("resilience").SolverFaultError,
        replay=m("obs.bundle").replay_bundle, sched=m("scheduler"),
        solver=m("solver.exact").ExactSolverConfig,
    )


def _scheduler(k, cs, obs, tie="first", **kw):
    cfg = k.solver(tie_break=tie, balanced_fdtype="float64")
    if k.name == "jax":
        return k.sched.Scheduler(cs, k.sched.SchedulerConfig(
            solver=cfg, mesh_devices=1, obs=obs, **kw), clock=k.FakeClock())
    return k.sched.Scheduler(cs, k.sched.SchedulerConfig(solver=cfg, obs=obs, **kw),
                             clock=k.FakeClock(), device="cpu")


def _replay(k, path):
    return k.replay(path) if k.name == "jax" else k.replay(path, device="cpu")


@pytest.mark.parametrize("captured_by,replayed_by", [("port", "jax"), ("jax", "port")])
def test_bundle_replays_bit_identically_across_packages(tmp_path, captured_by, replayed_by):
    k = _side(captured_by)
    sched = _scheduler(k, _cluster(k), k.ObsConfig(bundle_dir=str(tmp_path)), batch_size=16)
    sched.schedule_batch()
    path = sched.telemetry.capture("manual")
    assert path is not None
    for by in (captured_by, replayed_by):
        rep = _replay(_side(by), path)
        assert rep["replayable"] and rep["ok"], (by, rep)
        assert rep["detail"] == "assignments bit-identical" and rep["pods"] == 16


def test_port_bundle_matches_the_reference_bundle(tmp_path):
    """Both packages capture the same batch: the manifests agree on every
    field but the per-package config keys, and the assignments are equal."""
    manifests = {}
    for name in ("jax", "port"):
        k = _side(name)
        sched = _scheduler(k, _cluster(k), k.ObsConfig(bundle_dir=str(tmp_path / name)),
                           batch_size=16)
        sched.schedule_batch()
        path = sched.telemetry.capture("manual")
        with open(f"{path}/manifest.json") as f:
            manifests[name] = json.load(f)
    ref, port = manifests["jax"], manifests["port"]
    assert port["parts"] == ref["parts"]
    assert set(ref["config"]) - set(port["config"]) == {"pallas"}
    for key in ("containers", "step_count", "split", "carry_clean", "num_pods", "trigger"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("captured_by,replayed_by", [("port", "jax"), ("jax", "port")])
def test_random_mode_bundle_replays_across_packages(tmp_path, captured_by, replayed_by):
    """A random-mode bundle captured at the second solve (its solve count
    seeds the key) replays to the same assignments in both packages."""
    k = _side(captured_by)
    sched = _scheduler(k, _cluster(k), k.ObsConfig(bundle_dir=str(tmp_path)), tie="random",
                       batch_size=16)
    sched.schedule_batch()
    sched.schedule_batch()
    path = sched.telemetry.capture("manual")
    for by in (captured_by, replayed_by):
        rep = _replay(_side(by), path)
        assert rep["replayable"] and rep["ok"], (by, rep)
        assert rep["detail"] == "assignments bit-identical" and rep["pods"] == 8


def test_random_mode_bundle_replays_within_the_port(tmp_path):
    k = _side("port")
    sched = _scheduler(k, _cluster(k), k.ObsConfig(bundle_dir=str(tmp_path)), tie="random",
                       batch_size=16)
    sched.schedule_batch()
    sched.schedule_batch()
    rep = _replay(k, sched.telemetry.capture("manual"))
    assert rep["ok"] and rep["detail"] == "assignments bit-identical"


def test_breaker_trip_captures_the_last_complete_batch(tmp_path):
    """A solve fault at the top tier trips the breaker; the trip captures
    the newest complete record (the clean batch before it), on both
    packages alike, and the bundle replays across them."""
    seen = {}
    for name in ("jax", "port"):
        k = _side(name)
        sched = _scheduler(k, _cluster(k), k.ObsConfig(
            bundle_dir=str(tmp_path / name), sentinel=k.SentinelConfig()), batch_size=8)
        sched.schedule_batch()

        def top_tier_fault(pods, tier, k=k):
            if tier not in ("cpu", "host"):
                raise k.SolverFaultError("top tier down")

        sched._solve_fault = top_tier_fault
        sched.run_until_settled()
        snap = sched.telemetry.snapshot()
        seen[name] = (snap["bundles"]["by_trigger"], snap["bundles"]["captures"],
                      {p.key: p.node_name for p in sched.cluster.list_pods()})
        written = snap["bundles"]["written"]
        assert written and "breaker" in written[0]
        seen[name + "_path"] = written[0]
    assert seen["port"] == seen["jax"]
    assert seen["port"][0].get("breaker", 0) >= 1
    for path in (seen["jax_path"], seen["port_path"]):
        for name in ("jax", "port"):
            assert _replay(_side(name), path)["ok"]


def test_debug_profile_capture_on_the_port(tmp_path):
    """``GET /debug/profile?capture=1`` on the port's extender in
    scheduler mode forces a manual capture of the newest complete batch."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from kubernetes_tpu_torch.server.extender import ExtenderCore, make_app

    k = _side("port")
    cs = _cluster(k)
    sched = _scheduler(k, cs, k.ObsConfig(profile=True, sentinel=k.SentinelConfig(),
                                          bundle_dir=str(tmp_path)), batch_size=16)
    sched.schedule_batch()
    app = make_app(ExtenderCore(cs, backend="oracle"), scheduler=sched)

    async def drive():
        async with TestClient(TestServer(app)) as client:
            plain = await (await client.get("/debug/profile")).json()
            forced = await (await client.get("/debug/profile?capture=1")).json()
            return plain, forced

    plain, forced = asyncio.run(drive())
    assert set(plain["profile"]["stage_seconds"]) == set(ALL_STAGES)
    assert "sentinel" in plain and plain["bundles"]["captures"] == 0
    assert forced["captured"] is True
    assert forced["bundles"]["by_trigger"].get("manual") == 1
    assert _replay(k, forced["bundles"]["written"][0])["ok"]
