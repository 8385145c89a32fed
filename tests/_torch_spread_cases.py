"""Spread chunks solved with the fused loop (``ops/grouped_spread.py``) and
with the eager loop (``solver/grouped.py`` ``_Loop``), for the CPU tests
(the kernel's block body on the host, ``tests/_grouped_spread_host.cpp``)
and the card's (``tests/test_torch_grouped_spread.py``). Imports no JAX.

A case is a cluster, pods already bound on it (their spread counts the
chunks start from) and the batch to place; ``solve`` runs it on one solver
and returns, per batch, the assignments, the carried state, the stream's key
and the solve counts (the deferred ones settled: ``settled``), and the
stream's key after every fast chunk."""

from __future__ import annotations

import numpy as np
import pytest

from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.ops import grouped_spread as gs
from kubernetes_tpu_torch.ops import threefry as tf
from kubernetes_tpu_torch.solver import graphs as sg
from kubernetes_tpu_torch.solver import grouped as gp
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu_torch.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu_torch.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu_torch.tensorize.spread import build_spread_tensors

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def nodes(n, *, cpu="4", memory="32Gi", pods="110", varied=False):
    """``n`` nodes, node i in zone z(i mod 3) (spread5k's layout);
    ``varied``: node i has i % 7 more cores, so that ties are fewer."""
    return [MakeNode().name(f"n{i:05}").capacity(
        {"cpu": str(int(cpu) + (i % 7 if varied else 0)), "memory": memory, "pods": pods})
        .label(ZONE, f"z{i % 3}").label(HOST, f"n{i:05}").obj() for i in range(n)]


def mixed_pods(n, *, prefix="m", bad_tail=0):
    """``n`` one-off pods (a chunk the scan steps over), the last
    ``bad_tail`` of them requesting a resource no node has: invalid rows
    whose splits the stream owes the next draw."""
    out = []
    for i in range(n):
        req = {"cpu": f"{150 + 10 * i}m", "memory": "500Mi"}
        if i >= n - bad_tail:
            req["example.com/missing"] = "1"
        out.append(MakePod().name(f"{prefix}{i:03}").req(req).obj())
    return out


def spread_pods(n, *, prefix="p", ns="default", skew=5, cpu="100m", memory="500Mi",
                bad_every=0, key=ZONE):
    """``n`` identical pods of upstream's pod-with-topology-spreading (label
    foo=bar, one DoNotSchedule constraint over it at ``skew`` on the
    topology ``key``, the zone unless given); every ``bad_every``-th
    requests a resource no node has."""
    out = []
    for i in range(n):
        req = {"cpu": cpu, "memory": memory}
        if bad_every and i % bad_every == bad_every - 1:
            req["example.com/missing"] = "1"
        out.append(MakePod().name(f"{prefix}{i:05}").namespace(ns).label("foo", "bar").req(req)
                   .spread_constraint(skew, key, "DoNotSchedule", {"foo": "bar"}).obj())
    return out


def load(cluster, n_pods, seed, *, ns="default"):
    """Pods already bound: ``n_pods`` of the spread shape in ``ns``, on nodes
    drawn from ``seed`` with zone 0 taking more, so that the zones' counts
    differ; node name -> pods."""
    rng = np.random.default_rng(seed)
    weights = np.array([2.0 if i % 3 == 0 else 1.0 for i in range(len(cluster))])
    at = rng.choice(len(cluster), n_pods, p=weights / weights.sum())
    placed: dict = {}
    for k, i in enumerate(at):
        p = spread_pods(1, prefix=f"live{seed}-{k}-", ns=ns)[0]
        placed.setdefault(cluster[int(i)].name, []).append(p)
    return placed


def inputs(cluster, placed, pods):
    """The solver's inputs for ``pods`` on ``cluster`` with ``placed`` bound."""
    vocab = ResourceVocab.build([], cluster)
    nb = build_node_batch(cluster, placed, vocab=vocab)
    pb = build_pod_batch(pods, vocab)
    slots = list(cluster) + [None] * (nb.padded - len(cluster))
    by_slot = {i: placed[n.name] for i, n in enumerate(cluster) if n.name in placed}
    st = build_static_tensors(pods, pb, slots, nb.padded)
    return (nb, pb, st, build_port_tensors(pods, pb, slots, by_slot, nb.padded),
            build_spread_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad),
            build_interpod_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad))


def settled(times) -> dict:
    """A solve call's counts (``timing.SolveTimes``) with the counts the
    card held in its deferred rows added; waits for the card."""
    out = dict(times.counts)
    for d in times.deferred:
        for k, v in d.values().items():
            out[k] += v
    return out


def solve(mp, spec, dev, seed, *, fused, spread_loop=None, graphs=True, group=16):
    """The case's batches on one solver (random mode, float64 balanced
    scores unless the case says otherwise): per batch (assignments,
    carried state, the stream's key, the settled counts), and the stream's
    key after each fast chunk. ``fused``: the spread chunks take the fused
    loop (``spread_loop`` in place of the card's, on the CPU), else the
    eager loop; ``graphs``: whether the card's graphs engage."""
    made, keys = [], []

    class Recorded(tf.Stream):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    real_chunk = gp.fast_chunk

    def chunk(*a, **k):
        out = yield from real_chunk(*a, **k)
        keys.append(k["stream"].key_words())
        return out

    mp.setattr(tf, "Stream", Recorded)
    mp.setattr(gp, "fast_chunk", chunk)
    if not graphs:
        mp.setattr(sg, "engages", lambda *a: False)
    if not fused:
        mp.setattr(gs, "engages", lambda *a: False)
    elif spread_loop is not None:
        mp.setattr(gs, "engages",
                   lambda device, shards, tie, scorer: shards == 1 and tie == "random"
                   and scorer in gs.SCORERS)
        mp.setattr(gs, "spread_loop", spread_loop)
    if "vcnt_less" in spec:
        # the spread chunks place fewer pods than they hold: a partial chunk
        cut = spec["vcnt_less"]

        def partial(mode, *a, **k):
            vcnt = a[4]
            if mode == "spread" and vcnt > cut:
                a = a[:4] + (vcnt - cut,) + a[5:]
            return (yield from chunk(mode, *a, **k))

        mp.setattr(gp, "fast_chunk", partial)

    cluster = nodes(spec["nodes"], **spec.get("node_kw", {}))
    placed = load(cluster, spec.get("live", 0), seed) if spec.get("live") else {}
    if spec.get("live_other"):
        # the other live wave: another namespace's pods, which take
        # resources and do not count in this namespace's spread
        for name, pods in load(cluster, spec["live_other"], seed + 1, ns="wave-1").items():
            placed.setdefault(name, []).extend(pods)
    cfg = ExactSolverConfig(tie_break="random", seed=seed, group_size=group,
                            balanced_fdtype=spec.get("fdtype", "float64"),
                            scoring_strategy=spec.get("scoring", "LeastAllocated"))
    solver = ExactSolver(cfg)
    out = []
    for b, pods in enumerate(spec["batches"](seed)):
        inp = inputs(cluster, placed, pods)
        got = solver.solve(*inp, device=dev)
        state = [getattr(inp[0], k).copy() for k in ("used", "nonzero_used", "pod_count")]
        stream = solver.graphs.stream if solver.graphs is not None else made[-1]
        out.append((got, state, stream.key_words(), settled(solver.times)))
        for p, a in zip(pods, got):
            if a >= 0:
                placed.setdefault(cluster[int(a)].name, []).append(p)
    return out, keys


def assert_same(got, want, case):
    """The fused solves equal the eager ones bit for bit: assignments,
    carried state, the stream's key after every chunk and at the end, the
    iterations and kept water-fills; every spread chunk was fused."""
    (a_out, a_keys), (b_out, b_keys) = got, want
    assert a_keys == b_keys, case
    for (a, sa, ka, ca), (b, sb, kb, cb) in zip(a_out, b_out):
        np.testing.assert_array_equal(a, b, err_msg=case)
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y, err_msg=case)
        assert ka == kb, case
        for k in ("grouped_iterations", "chunk_iterations.spread", "waterfill_iterations",
                  "chunks.spread", "chunk_pods.spread"):
            assert ca[k] == cb[k], (case, k, ca[k], cb[k])
        assert ca["fused_chunks.spread"] == ca["chunks.spread"] > 0, case
        assert cb["fused_chunks.spread"] == 0, case


def spread_cases(n_nodes, n_pods, group):
    """The cases at one scale: ``n_nodes`` nodes, batches of ``n_pods``,
    chunks of ``group``."""
    full = dict(pods="2")
    small = max(n_nodes // 10, 3 * group)
    return {
        # spread5k's shape: maxSkew 5 on a cluster two live waves load
        "skew5_loaded": dict(nodes=n_nodes, live=n_nodes // 2, live_other=n_nodes,
                             batches=lambda s: [spread_pods(n_pods)]),
        "skew1_loaded": dict(nodes=n_nodes, live=n_nodes // 3,
                             batches=lambda s: [spread_pods(n_pods, skew=1)]),
        # from an empty cluster the zones sit level: the water-fill is kept
        "empty": dict(nodes=n_nodes, batches=lambda s: [spread_pods(n_pods, skew=1)]),
        "empty_skew5": dict(nodes=n_nodes, batches=lambda s: [spread_pods(n_pods)]),
        "partial": dict(nodes=n_nodes, live=n_nodes // 2, vcnt_less=group // 4 + 1,
                        batches=lambda s: [spread_pods(n_pods)]),
        # two pods a node: the later chunks find every node full
        "infeasible": dict(nodes=small, node_kw=full,
                           batches=lambda s: [spread_pods(2 * small + 2 * group)]),
        # a slow chunk's last rows are invalid: they owe the stream splits,
        # which the next spread chunk's first split pays
        "owed_splits": dict(nodes=n_nodes, live=n_nodes // 4, batches=lambda s: [
            spread_pods(group, prefix="a") + spread_pods(group, prefix="b", bad_every=3)
            + mixed_pods(group, bad_tail=3) + spread_pods(n_pods, prefix="c")]),
        "varied_two_batches": dict(nodes=n_nodes, node_kw=dict(varied=True), batches=lambda s: [
            spread_pods(n_pods, prefix="a"), spread_pods(n_pods, prefix="b", skew=2)]),
        # hostname spread: a domain a node (d_pad about N), so that every
        # warp owns a run of domains and a node's count is its own
        "hostname_skew1": dict(nodes=n_nodes, live=n_nodes // 2,
                               batches=lambda s: [spread_pods(n_pods, skew=1, key=HOST)]),
        "float32_most_allocated": dict(nodes=n_nodes, live=n_nodes // 2, fdtype="float32",
                                       scoring="MostAllocated",
                                       batches=lambda s: [spread_pods(n_pods, skew=3)]),
    }


@pytest.fixture
def recorded_solve(monkeypatch):
    """``solve`` under a fresh monkeypatch context per call."""

    def run(*a, **k):
        with monkeypatch.context() as mp:
            return solve(mp, *a, **k)

    return run
