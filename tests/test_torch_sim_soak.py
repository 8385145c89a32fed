"""The port's copy of tests/test_sim_soak.py: long sim soaks over every
profile the port runs (the others raise, see test_torch_sim.py), several
seeds, deeper cycle counts, on ``device="cpu"``.

Marked ``slow`` as in the JAX package: tier-1 deselects these
(-m 'not slow'); run them explicitly before touching the scheduling
loop's concurrency story:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sim_soak.py -m slow
"""

import functools

import pytest

from kubernetes_tpu_torch.sim import run_sim as _run_sim

from test_torch_sim import RUNNABLE

pytestmark = pytest.mark.slow

run_sim = functools.partial(_run_sim, device="cpu")


@pytest.mark.parametrize("profile", RUNNABLE)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soak_profile(profile, seed):
    res = run_sim(profile, seed=seed, cycles=25)
    assert res.violations == [], [v.as_dict() for v in res.violations]
    assert res.settled


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_soak_churn_heavy_deep_deterministic(seed):
    a = run_sim("churn_heavy", seed=seed, cycles=40)
    b = run_sim("churn_heavy", seed=seed, cycles=40)
    assert a.trace.digest() == b.trace.digest()
    assert a.bindings == b.bindings
    assert a.violations == [] and a.settled


@pytest.mark.parametrize("seed", [5, 6])
def test_soak_backlog_drain_mega(seed):
    """The backlog_drain profile at soak scale: a 400-pod
    seeded mega-backlog (sim-relative) with the hard-shape mix drained
    through drain_backlog's budget-planned chunked streaming path,
    byte-deterministic across runs, budget auto-split engaged, zero
    invariant violations."""
    import dataclasses

    from kubernetes_tpu_torch.sim import get_profile

    prof = dataclasses.replace(
        get_profile("backlog_drain"),
        backlog=400,
        nodes=24,
        node_cpu="32",
    )
    a = run_sim(prof, seed=seed, cycles=12)
    b = run_sim(prof, seed=seed, cycles=12)
    assert a.violations == [], [v.as_dict() for v in a.violations]
    assert a.settled
    assert a.summary["backlog"]["budget_splits"] >= 1
    assert a.summary["backlog"]["chunks"] >= 10
    assert a.trace.digest() == b.trace.digest()


def test_soak_sync_vs_pipelined_agree_on_quiet_cluster():
    """With no faults or churn racing mid-flight (node_flaps is prompt
    delivery), the pipelined and synchronous loops must settle every
    pod — cross-loop sanity over a long run."""
    a = run_sim("node_flaps", seed=9, cycles=30, pipelined=True)
    b = run_sim("node_flaps", seed=9, cycles=30, pipelined=False)
    assert a.violations == [] and b.violations == []
    assert a.settled and b.settled
    # identical churn stream (same seed) => identical pod population
    assert set(a.bindings) | set(a.unbound) == set(b.bindings) | set(
        b.unbound
    )
