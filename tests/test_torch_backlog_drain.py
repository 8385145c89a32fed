"""The port's drain_backlog against the JAX package's on the CPU.

The scenarios of ``tests/test_backlog_drain.py`` but its sim-profile test
(``run_sim("backlog_drain")``, which waits for the sim: ROADMAP queue 1
item 8). Each backlog is built once in the JAX package's ``ClusterState``
and carried across (``_torch_sched_pair.Pair``); both schedulers run on a
``FakeClock`` in ``tie_break="first"`` with float64 balanced scores. The
paired drains pass ``chunk_pods`` and ``budget_bytes`` explicitly, so
both packages plan the same chunks whatever ``WORKSPACE_FACTOR`` is, and
must give the same results in order, bindings, counter deltas and report
counts (chunks, chunk size, splits, chained chunks, the memory model's
estimate).
"""

import json

import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.obs import ObsConfig as RefObsConfig
from kubernetes_tpu.solver import budget as ref_hbm
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.obs import ObsConfig
from kubernetes_tpu_torch.solver import budget as hbm
from kubernetes_tpu_torch.solver.budget import BudgetExceeded

from _torch_sched_pair import PARITY, Pair

ZONE = "topology.kubernetes.io/zone"
BUDGET = 8 << 30  # explicit in every paired drain


def mk_pair(n_pods, n_nodes=12, batch=16, group=8, journal=False, **cfg):
    cs = ClusterState()
    for i in range(n_nodes):
        cs.create_node(
            MakeNode().name(f"n{i:03}").capacity({"cpu": "16", "memory": "64Gi", "pods": "110"})
            .label(ZONE, f"z{i % 3}").label("kubernetes.io/hostname", f"n{i:03}").obj()
        )
    for i in range(n_pods):
        cs.create_pod(spread_pod(i))
    if journal:
        cfg.update(obs=ObsConfig(journal=True), ref_config={"obs": RefObsConfig(journal=True)})
    return Pair(cs, solver=dict(PARITY, group_size=group), batch_size=batch, **cfg)


def spread_pod(i):
    return (
        MakePod().name(f"pod-{i:04}").label("app", "drain").req({"cpu": "100m", "memory": "256Mi"})
        .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "drain"}).obj()
    )


def bindings(cs):
    return sorted((p.name, p.node_name) for p in cs.list_pods())


def test_drain_chains_across_chunks_and_places_everything():
    pair = mk_pair(96)
    _, report = pair.run("drain", chunk_pods=16, budget_bytes=BUDGET)
    pair.assert_equal()
    assert report.pods == 96 and report.drained == 96
    assert report.chunk_pods == 16 and report.chunks == 96 // 16
    assert report.budget_splits == 0
    assert report.stream_chained_batches >= report.chunks - 2
    assert report.chain_fraction >= 0.6
    assert report.measured_h2d_bytes > 0
    assert report.estimated_per_device_bytes > 0
    zones = {}
    for p in pair.cluster.list_pods():
        assert p.node_name, f"{p.name} unbound after drain"
        z = int(p.node_name[1:]) % 3
        zones[z] = zones.get(z, 0) + 1
    assert max(zones.values()) - min(zones.values()) <= 1


def test_drain_budget_auto_split_same_bindings():
    wide = mk_pair(64)
    _, rep_a = wide.run("drain", chunk_pods=16, budget_bytes=BUDGET)
    assert rep_a.budget_splits == 0
    tight_pair = mk_pair(64)
    tight = hbm.estimate(tight_pair.port.drain_shape(16)).per_device_bytes - 1
    assert tight == ref_hbm.estimate(tight_pair.ref.drain_shape(16)).per_device_bytes - 1
    splits0 = metrics.backlog_budget_splits_total._value.get()
    _, rep_b = tight_pair.run("drain", chunk_pods=16, budget_bytes=tight)
    tight_pair.assert_equal()
    assert rep_b.budget_splits >= 1
    assert rep_b.chunk_pods < 16 and rep_b.chunk_pods % 8 == 0
    assert rep_b.drained == 64
    assert metrics.backlog_budget_splits_total._value.get() - splits0 == rep_b.budget_splits
    assert bindings(wide.cluster) == bindings(tight_pair.cluster)


def test_drain_impossible_budget_raises_typed_before_dispatch():
    pair = mk_pair(32)
    s = pair.port
    pending0 = s.pending
    with pytest.raises(BudgetExceeded):
        s.drain_backlog(chunk_pods=16, budget_bytes=1)
    with pytest.raises(ref_hbm.BudgetExceeded):
        pair.ref.drain_backlog(chunk_pods=16, budget_bytes=1)
    assert s.pending == pending0
    assert s.config.batch_size == 16
    _, report = pair.run("drain", chunk_pods=16, budget_bytes=BUDGET)
    pair.assert_equal()
    assert report.drained == 32


def test_drain_chunk_ids_reach_the_journal_then_clear():
    pair = mk_pair(48, journal=True)
    _, report = pair.run("drain", chunk_pods=16, budget_bytes=BUDGET)
    assert report.drained == 48
    s = pair.port
    recs = [json.loads(line) for line in s.journal.lines]
    bound = [r for r in recs if r["outcome"] == "bound"]
    assert bound and all("drain_chunk" in r for r in bound)
    chunk_ids = {r["drain_chunk"] for r in bound}
    assert len(chunk_ids) == report.chunks
    assert min(chunk_ids) >= 1
    ref_bound = [json.loads(line) for line in pair.ref.journal.lines]
    assert [(r["pod"], r["drain_chunk"]) for r in bound] == [
        (r["pod"], r["drain_chunk"]) for r in ref_bound if r["outcome"] == "bound"
    ]
    assert "drain_chunk" not in s.journal.tags
    pair.create_pod(spread_pod(999))
    pair.run("streaming")
    pair.assert_equal()
    post = [json.loads(line) for line in s.journal.lines if "pod-0999" in line]
    assert post and all("drain_chunk" not in r for r in post)


def test_drain_metrics_and_gauge_pair_move():
    chunks0 = metrics.backlog_chunks_total._value.get()
    pair = mk_pair(32)
    _, report = pair.run("drain", chunk_pods=16, budget_bytes=BUDGET)
    pair.assert_equal()
    assert metrics.backlog_chunks_total._value.get() - chunks0 == report.chunks
    assert metrics.backlog_hbm_estimated_bytes._value.get() == report.estimated_h2d_bytes
    assert metrics.backlog_hbm_measured_bytes._value.get() == report.measured_h2d_bytes
    assert report.measured_h2d_bytes <= report.estimated_h2d_bytes * 3
    assert report.estimated_h2d_bytes <= report.measured_h2d_bytes * 10


def test_empty_queue_drain_is_a_noop():
    pair = mk_pair(0)
    _, report = pair.run("drain", budget_bytes=BUDGET)
    assert report.pods == 0 and report.chunks == 0 and report.results == []


def test_warm_start_ranks_before_the_drain():
    """The relax planner's warm start, off by default and asked for per
    call: both packages rank the same number of pods in the same number of
    iterations, then drain with the same results and bindings."""
    pair = mk_pair(48)
    ref, port = pair.run("drain", chunk_pods=16, budget_bytes=BUDGET, warm_start=True)
    assert port.warm_start_ranked == ref.warm_start_ranked == 48
    assert port.relax_iterations == ref.relax_iterations >= 1
    assert port.drained == 48
    r, p = pair.bindings()
    assert p == r


def test_device_budget_bytes_without_a_card_is_the_floor(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hbm.device_budget_bytes() == hbm.DEFAULT_DEVICE_BUDGET_BYTES
    assert hbm.device_budget_bytes(12345) == 12345


@pytest.mark.parametrize(
    "fraction,want",
    [
        (None, 30 + 12 - 4),  # free + (reserved - allocated)
        (1.0, 30 + 12 - 4),  # the fraction's limit (80) is above free + reserved
        (0.25, 20 - 4),  # the allocator may reserve at most a quarter of 80
    ],
)
def test_device_budget_bytes_is_what_the_process_can_allocate(monkeypatch, fraction, want):
    """The budget on a card: its free memory plus the allocator's reserved
    bytes not in use, less nothing else, capped by the per-process memory
    fraction -- never the card's total (the readings are faked)."""
    import torch

    gib = 1 << 30
    seen = []

    def reading(value):
        def read(device=None):
            seen.append(torch.device(device))
            return value
        return read

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", reading((30 * gib, 80 * gib)))
    monkeypatch.setattr(torch.cuda, "memory_reserved", reading(12 * gib))
    monkeypatch.setattr(torch.cuda, "memory_allocated", reading(4 * gib))
    if fraction is None:
        monkeypatch.delattr(torch.cuda, "get_per_process_memory_fraction", raising=False)
    else:
        monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction", reading(fraction),
                            raising=False)
    assert hbm.device_budget_bytes() == want * gib
    assert hbm.device_budget_bytes(device="cuda:0") == want * gib
    assert hbm.device_budget_bytes(device="cuda") == want * gib  # read at the current index
    assert set(seen) == {torch.device("cuda", 0)}
    assert hbm.device_budget_bytes(device="cpu") == hbm.DEFAULT_DEVICE_BUDGET_BYTES
    assert hbm.device_budget_bytes(7, device="cuda:0") == 7
