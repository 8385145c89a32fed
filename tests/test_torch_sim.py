"""The simulator on the port against the JAX package, profile by profile.

Both packages run the same seed and profile on the CPU (the JAX package
under tests/conftest.py; the port with ``device="cpu"``). The port's
trace must match the JAX package's: its event (``"k": "e"``) and
decision (``"k": "d"``) lines byte-identical, its footer's bindings,
unbound pods and violations equal, and its footer summary equal except
for the fields ``EXCUSED_SUMMARY`` names. Traces replay across the two
packages in both directions, and ``--selfcheck`` is deterministic with
every invariant OK. All 24 profiles run on one scheduler, as in the JAX
package; the 7 fleet profiles also run across replicas (``run_fleet_sim``,
``--fleet 2``), where every replica's journal, the hub's aggregated
journal, the bindings and the footer summary equal the JAX package's.
"""

from __future__ import annotations

import json

import pytest

from kubernetes_tpu.sim import replay_trace as jax_replay_trace
from kubernetes_tpu.sim import run_sim as jax_run_sim
from kubernetes_tpu_torch.sim import replay_trace, run_sim
from kubernetes_tpu_torch.sim.__main__ import main as sim_main
from kubernetes_tpu_torch.sim.fleet import run_fleet_sim
from kubernetes_tpu_torch.sim.harness import FLEET_PROFILES, runnable_profiles
from kubernetes_tpu_torch.sim.profiles import PROFILES

# every shipped profile: the port runs all 24
RUNNABLE = runnable_profiles()
# the 7 whose scenario is the multi-replica drive
FLEET = sorted(FLEET_PROFILES)
FLEET_REPLICAS = 2
CYCLES = 6
SEED = 0
# footer summary fields allowed to differ from the JAX package's, each
# with its reason. None on the CPU: both packages' fallback ladders are
# (single, host) there, and every summary field is host arithmetic over
# the virtual clock. (On the card the port's ladder gains a ``cpu`` rung;
# chip_smoke.py phase 9a holds the card against a CPU run given the
# card's ladder, see test_ladder_shape_reaches_only_the_fault_profiles.)
EXCUSED_SUMMARY: dict[str, str] = {}
# the profiles whose injected solver faults draw once per ladder rung, so
# their decisions depend on the ladder's shape
LADDER_DEPENDENT = ("solver_flaky", "poison_pods", "anomaly_storm")

_JAX_RUNS: dict = {}


def _jax(profile: str):
    """The JAX package's run of ``profile`` (cached: the file runs on one
    worker, and the run is deterministic)."""
    if profile not in _JAX_RUNS:
        _JAX_RUNS[profile] = jax_run_sim(profile, seed=SEED, cycles=CYCLES)
    return _JAX_RUNS[profile]


def _split(lines: list[str]):
    recs = [json.loads(line) for line in lines]
    header = [r for r in recs if r["k"] == "h"]
    footer = [r for r in recs if r["k"] == "f"]
    body = [line for line, r in zip(lines, recs) if r["k"] in ("e", "d")]
    assert len(header) == 1 and len(footer) == 1
    return header[0], body, footer[0]


def assert_traces_match(ours: list[str], ref: list[str]) -> None:
    h1, body1, f1 = _split(ours)
    h2, body2, f2 = _split(ref)
    assert h1 == h2
    assert len(body1) == len(body2)
    for i, (a, b) in enumerate(zip(body1, body2)):
        assert a == b, f"event/decision line {i} differs:\n{a}\n{b}"
    for key in ("bindings", "unbound", "violations"):
        assert f1[key] == f2[key], key
    s1 = {k: v for k, v in f1["summary"].items() if k not in EXCUSED_SUMMARY}
    s2 = {k: v for k, v in f2["summary"].items() if k not in EXCUSED_SUMMARY}
    assert s1 == s2


def test_profiles_partition():
    """Every profile runs, none is refused or skipped; the fleet's 7 are
    among them."""
    assert RUNNABLE == tuple(PROFILES) and len(RUNNABLE) == 24
    assert set(FLEET) <= set(RUNNABLE) and len(FLEET) == 7
    assert {"fragmentation", "megaplan"} <= set(RUNNABLE)


@pytest.mark.parametrize("profile", RUNNABLE)
def test_trace_matches_jax(profile):
    ours = run_sim(profile, seed=SEED, cycles=CYCLES, device="cpu")
    ref = _jax(profile)
    assert ours.ok, [v.as_dict() for v in ours.violations]
    assert_traces_match(ours.trace.lines, ref.trace.lines)
    assert ours.journal_lines == ref.journal_lines


@pytest.mark.parametrize("profile", RUNNABLE)
def test_jax_trace_replays_on_port(profile, tmp_path):
    path = tmp_path / "jax.jsonl"
    _jax(profile).trace.dump(path)
    rep = replay_trace(path, device="cpu")
    assert rep.replay_divergence is None
    assert rep.bindings == _jax(profile).bindings


@pytest.mark.parametrize("profile", RUNNABLE)
def test_port_trace_replays_on_jax(profile, tmp_path):
    path = tmp_path / "port.jsonl"
    rec = run_sim(profile, seed=SEED, cycles=CYCLES, device="cpu")
    rec.trace.dump(path)
    rep = jax_replay_trace(path)
    assert rep.replay_divergence is None
    assert rep.bindings == rec.bindings


@pytest.mark.parametrize("profile", RUNNABLE)
def test_selfcheck_cli(profile, capsys):
    rc = sim_main([
        "--device", "cpu", "--profile", profile, "--seed", str(SEED),
        "--cycles", str(CYCLES), "--selfcheck",
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "invariants: OK" in out
    assert "selfcheck: two runs produced byte-identical traces" in out


_JAX_FLEET_RUNS: dict = {}


def _jax_fleet(profile: str):
    if profile not in _JAX_FLEET_RUNS:
        from kubernetes_tpu.sim.fleet import run_fleet_sim as jax_run_fleet_sim

        _JAX_FLEET_RUNS[profile] = jax_run_fleet_sim(
            profile, seed=SEED, cycles=CYCLES, replicas=FLEET_REPLICAS
        )
    return _JAX_FLEET_RUNS[profile]


@pytest.mark.parametrize("profile", FLEET)
def test_unported_profile_raises_naming_its_item(profile):
    """The fleet profiles' multi-replica drive (refused, naming ROADMAP
    item 8c, until the fleet was ported; the name is kept): each
    replica's journal byte for byte, the hub's aggregated journal, the
    bindings and the footer summary equal the JAX package's, with every
    fleet invariant OK."""
    ours = run_fleet_sim(profile, seed=SEED, cycles=CYCLES,
                         replicas=FLEET_REPLICAS, device="cpu")
    ref = _jax_fleet(profile)
    assert ours.ok, [v.as_dict() for v in ours.violations]
    assert ours.journals == ref.journals
    assert ours.journal_digests == ref.journal_digests
    assert ours.hub_journal_lines == ref.hub_journal_lines
    assert ours.bindings == ref.bindings and ours.unbound == ref.unbound
    assert ours.summary == ref.summary


def test_rebalance_and_megaplan_footers_engage():
    """The two profiles this port's rebalancer and relax planner brought in
    engage their features, non-vacuously: migrations within budget and no
    PDB overrun; a valid relax plan that ranked the drain."""
    frag = run_sim("fragmentation", seed=SEED, cycles=CYCLES, device="cpu").summary
    assert frag["rebalance"]["migrations_completed"] >= 1
    assert frag["rebalance"]["over_budget"] == 0 and frag["rebalance"]["pdb_overruns"] == 0
    mega = run_sim("megaplan", seed=SEED, cycles=CYCLES, device="cpu").summary["megaplan"]
    assert mega["plan_valid"] and mega["ranked"] >= 1 and mega["iterations"] >= 1


def test_fleet_flag_raises(capsys):
    """``--fleet`` (which raised, naming ROADMAP item 8c, until the fleet
    was ported; the name is kept) drives the replicas and prints what the
    JAX package's sim CLI prints; ``--selfcheck`` byte-compares two runs'
    per-replica journals, the hub's aggregation and the bindings."""
    from kubernetes_tpu.sim.__main__ import main as jax_sim_main

    argv = ["--profile", "fleet_mixed", "--fleet", "2", "--seed", str(SEED),
            "--cycles", str(CYCLES), "--selfcheck"]
    assert sim_main(["--device", "cpu"] + argv) == 0
    ours = capsys.readouterr().out
    assert jax_sim_main(argv) == 0
    assert ours == capsys.readouterr().out
    assert "invariants: OK" in ours and "selfcheck: two runs produced" in ours
    assert sim_main(["--device", "cpu", "--tuning"] + argv) == 2


def test_mesh_devices_raise(capsys):
    """``--mesh-devices 2`` shards the solve two ways and prints what
    ``--mesh-devices 1`` prints, byte for byte (it once raised)."""
    argv = ["--device", "cpu", "--profile", "node_flaps", "--cycles", "1"]
    assert sim_main(argv + ["--mesh-devices", "2"]) == 0
    sharded = capsys.readouterr().out
    assert sim_main(argv + ["--mesh-devices", "1"]) == 0
    assert sharded == capsys.readouterr().out and "invariants: OK" in sharded


def test_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sim("node_flaps", seed=SEED, cycles=1)


@pytest.mark.parametrize("profile", RUNNABLE)
def test_ladder_shape_reaches_only_the_fault_profiles(profile, monkeypatch):
    """On the card the port's ladder is (single, cpu, host); on the CPU
    it is (single, host). Run each profile on the CPU with the card's
    ladder: the profiles without solver faults keep their trace, and the
    fault profiles (whose injector draws once per rung) still pass every
    invariant with the same events. chip_smoke.py phase 9a compares the
    card against exactly this run."""
    import torch

    import kubernetes_tpu_torch.resilience as rz
    import kubernetes_tpu_torch.scheduler as sm

    card_ladder = rz.build_ladder(torch.device("cuda"))
    assert card_ladder == (rz.TIER_SINGLE, rz.TIER_CPU, rz.TIER_HOST)
    base = run_sim(profile, seed=SEED, cycles=CYCLES, device="cpu")
    monkeypatch.setattr(sm, "build_ladder", lambda device: card_ladder)
    card_shaped = run_sim(profile, seed=SEED, cycles=CYCLES, device="cpu")
    assert card_shaped.ok, [v.as_dict() for v in card_shaped.violations]
    if profile in LADDER_DEPENDENT:
        events = lambda res: [ln for ln in res.trace.lines if '"k":"e"' in ln]
        assert events(card_shaped) == events(base)
        assert card_shaped.trace.lines != base.trace.lines
    else:
        assert card_shaped.trace.lines == base.trace.lines
