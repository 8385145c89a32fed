"""The port's copy of tests/test_leaderelection.py, on
``kubernetes_tpu_torch.utils.leaderelection``: Lease-based leader election
(client-go tools/leaderelection analog): acquire, renew, challenge, expiry
takeover, and optimistic-concurrency races over the state service's Lease
store."""

import threading

from kubernetes_tpu_torch.state.cluster import ApiError, ClusterState
from kubernetes_tpu_torch.utils.clock import FakeClock
from kubernetes_tpu_torch.utils.leaderelection import Lease, LeaderElector


def mk(cs, ident, clock):
    return LeaderElector(
        cs,
        identity=ident,
        lease_duration=15.0,
        renew_deadline=10.0,
        retry_period=2.0,
        clock=clock,
    )


def test_acquire_renew_and_challenge():
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    b = mk(cs, "b", clock)
    assert a.try_acquire_or_renew() and a.is_leader
    lease = cs.get_lease("kube-system", "kubernetes-tpu-scheduler")
    assert lease.holder_identity == "a"
    # a fresh lease blocks the challenger
    assert not b.try_acquire_or_renew() and not b.is_leader
    # the holder renews: renewTime advances
    clock.advance(5.0)
    t0 = lease.renew_time
    assert a.try_acquire_or_renew()
    assert cs.get_lease("kube-system", "kubernetes-tpu-scheduler").renew_time > t0
    # still blocked (renewal reset the expiry window)
    clock.advance(12.0)
    assert not b.try_acquire_or_renew()


def test_takeover_after_expiry():
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    b = mk(cs, "b", clock)
    assert a.try_acquire_or_renew()
    # a crashes (stops renewing); past leaseDuration the challenger wins
    clock.advance(15.1)
    assert b.try_acquire_or_renew() and b.is_leader
    lease = cs.get_lease("kube-system", "kubernetes-tpu-scheduler")
    assert lease.holder_identity == "b"
    assert lease.acquire_time == clock.now()
    # the old leader's next renew attempt loses
    assert not a.try_acquire_or_renew() and not a.is_leader


def test_update_race_loses_cleanly():
    """A stale-rv update (someone else re-acquired between the read and
    the write) must report not-leader, never raise."""
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    assert a.try_acquire_or_renew()
    # sneak a competing acquisition in with a bumped rv
    lease = cs.get_lease("kube-system", "kubernetes-tpu-scheduler")
    clock.advance(16.0)
    lease.holder_identity = "c"
    lease.renew_time = clock.now()
    cs.update_lease(lease)
    assert not a.try_acquire_or_renew()
    assert cs.get_lease("kube-system", "kubernetes-tpu-scheduler").holder_identity == "c"


def test_creation_race():
    """Two electors racing the initial create: exactly one wins."""
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    # simulate the race by pre-creating the lease between a's NotFound
    # read and its create: create directly, then call a
    cs.create_lease(
        Lease(
            name="kubernetes-tpu-scheduler",
            holder_identity="z",
            lease_duration_seconds=15.0,
            renew_time=clock.now(),
        )
    )
    assert not a.try_acquire_or_renew()


def test_run_loop_active_passive_handover():
    """Elector A leads; when its renewals stop, elector B's run() loop
    takes over and fires on_started_leading."""
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    assert a.try_acquire_or_renew()

    b = mk(cs, "b", clock)
    b.retry_period = 0.01  # fast wall-clock loop; expiry is FakeClock time
    started = threading.Event()
    stop = threading.Event()
    t = threading.Thread(
        target=b.run, args=(stop,), kwargs=dict(on_started_leading=started.set)
    )
    t.start()
    assert not started.wait(timeout=0.3)  # a's lease is fresh
    clock.advance(20.0)  # a expires
    assert started.wait(timeout=10)
    assert b.is_leader
    stop.set()
    t.join(timeout=10)
    assert cs.get_lease("kube-system", "kubernetes-tpu-scheduler").holder_identity == "b"


def test_losing_challenger_cannot_corrupt_store():
    """get_lease returns snapshots: a challenger that mutates its read
    and loses the rv CAS must leave the store showing the real winner
    (review-caught split-brain window)."""
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    assert a.try_acquire_or_renew()
    clock.advance(16.0)  # expired: both challengers see it takeable
    b = mk(cs, "b", clock)
    c = mk(cs, "c", clock)
    # b reads+wins first; c's stale-rv update must fail AND the store
    # must still show b
    stale = cs.get_lease("kube-system", "kubernetes-tpu-scheduler")
    assert b.try_acquire_or_renew() and b.is_leader
    stale.holder_identity = "c"
    stale.renew_time = clock.now()
    try:
        cs.update_lease(stale, expect_rv=stale.resource_version)
    except ApiError:
        pass
    lease = cs.get_lease("kube-system", "kubernetes-tpu-scheduler")
    assert lease.holder_identity == "b"
    # b keeps renewing successfully (no split brain)
    clock.advance(5.0)
    assert b.try_acquire_or_renew()
    assert not c.try_acquire_or_renew()


def test_run_loop_reports_loss_after_renew_deadline():
    """The one remaining protocol branch: a holder whose renewals keep
    failing (lease stolen with a fresh renew_time) fires
    on_stopped_leading once the injected clock passes renew_deadline."""
    cs = ClusterState()
    clock = FakeClock()
    a = mk(cs, "a", clock)
    a.retry_period = 0.01  # fast wall loop; deadline measured on FakeClock
    lost = threading.Event()
    stop = threading.Event()
    t = threading.Thread(
        target=a.run, args=(stop,), kwargs=dict(on_stopped_leading=lost.set)
    )
    t.start()
    # wait for leadership
    for _ in range(500):
        if a.is_leader:
            break
        threading.Event().wait(0.01)
    assert a.is_leader
    # steal the lease with a perpetually-fresh foreign holder
    def keep_fresh():
        while not lost.is_set() and not stop.is_set():
            le = cs.get_lease("kube-system", "kubernetes-tpu-scheduler")
            le.holder_identity = "z"
            le.renew_time = clock.now()
            cs.update_lease(le)
            clock.advance(3.0)  # march time toward a's renew_deadline
            threading.Event().wait(0.01)
    th = threading.Thread(target=keep_fresh)
    th.start()
    assert lost.wait(timeout=30), "loss path never fired"
    assert not a.is_leader
    stop.set()
    t.join(timeout=10)
    th.join(timeout=10)


def test_timing_invariants_validated_at_construction():
    """leaderelection.go#LeaderElectionConfig validation (r4 advisor
    finding): the protocol is only sound with
    leaseDuration > renewDeadline > retryPeriod > 0 — each inversion
    must be rejected before the elector ever touches the store."""
    import pytest

    cs = ClusterState()
    clock = FakeClock()

    def mk_cfg(lease, renew, retry):
        return LeaderElector(
            cs,
            identity="x",
            lease_duration=lease,
            renew_deadline=renew,
            retry_period=retry,
            clock=clock,
        )

    # valid defaults construct fine
    assert mk_cfg(15.0, 10.0, 2.0) is not None
    with pytest.raises(ValueError, match="lease_duration must exceed"):
        mk_cfg(10.0, 10.0, 2.0)  # lease == renew deadline
    with pytest.raises(ValueError, match="lease_duration must exceed"):
        mk_cfg(5.0, 10.0, 2.0)  # lease < renew deadline
    with pytest.raises(ValueError, match="renew_deadline must exceed"):
        mk_cfg(15.0, 2.0, 2.0)  # renew deadline == retry period
    with pytest.raises(ValueError, match="retry_period must be positive"):
        mk_cfg(15.0, 10.0, 0.0)
