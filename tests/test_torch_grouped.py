"""The grouped fast path of the port (solver/grouped.py) against the JAX
package's on the same tensorized inputs, on the CPU.

In tie_break="first" with balanced_fdtype="float64" the port's grouped
solve equals the JAX package's grouped solve and the port's own per-pod
scan bit for bit: assignments, written-back node state and the
executable-dispatch counts (chunk kinds, compact batches). The fixtures are
those of tests/test_grouped_scan.py (uniform runs, one-off pods, hostPort
cap, saturation tail, compact wire) and tests/test_grouped_quota.py
(spread and anti chunks). Random mode draws the JAX package's threefry
stream, so over a handful of seeds its picks equal the JAX package's grouped
solve bit for bit (plain, spread with the water-fill, anti, and batches
that mix the slow kind with the fast ones), and are held to the NumPy
oracle's tie set and the workloads' skew and exclusivity invariants too."""

import dataclasses


import numpy as np
import pytest
import test_grouped_quota as quota
import test_grouped_scan as scan

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.ops.oracle.profile import FullOracle, make_oracle_nodes
from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
from kubernetes_tpu.tensorize.interpod import build_interpod_tensors
from kubernetes_tpu.tensorize.plugins import build_port_tensors, build_static_tensors
from kubernetes_tpu.tensorize.schema import ResourceVocab, build_node_batch, build_pod_batch
from kubernetes_tpu.tensorize.spread import build_spread_tensors
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.solver import grouped as gp
from kubernetes_tpu_torch.solver.exact import ExactSolver

STATE = ("used", "nonzero_used", "pod_count")
ZONE = "topology.kubernetes.io/zone"


def ref_inputs(nodes, pods, *, group, families=False):
    """The JAX package's tensorize of one batch; the pod axis padded to a
    multiple of ``group`` (the grouped dispatch needs it)."""
    vocab = ResourceVocab.build(pods, nodes)
    nb = build_node_batch(nodes, vocab=vocab)
    pad = None
    if group > 1:
        pad = max(-(-len(pods) // group) * group, group)
    pb = build_pod_batch(pods, vocab, pad=pad)
    slots = list(nodes) + [None] * (nb.padded - len(nodes))
    st = build_static_tensors(pods, pb, slots, nb.padded)
    ports = build_port_tensors(pods, pb, slots, {}, nb.padded)
    spr = ipa = None
    if families:
        spr = build_spread_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad)
        ipa = build_interpod_tensors(pods, st.reps, pb, slots, {}, nb.padded, st.c_pad)
    return nb, pb, st, ports, spr, ipa


def _config(group, tie="first", seed=0, compact=True):
    return RefConfig(tie_break=tie, seed=seed, group_size=group, compact_wire=compact,
                     balanced_fdtype="float64")


def ref_solve(nodes, pods, group, families=False, compact=True, tie="first", seed=0):
    inputs = ref_inputs(nodes, pods, group=group, families=families)
    solver = RefSolver(_config(group, tie, seed, compact))
    got = solver.solve(*inputs)
    return got, {k: getattr(inputs[0], k) for k in STATE}, dict(solver.dispatch_counts)


def port_solve(nodes, pods, group, families=False, compact=True, tie="first", seed=0,
               pad_group=None):
    inputs = convert.solve_inputs(
        *ref_inputs(nodes, pods, group=pad_group or group, families=families)
    )
    solver = ExactSolver(convert.solver_config(_config(group, tie, seed, compact)))
    before = dc.LAUNCHES
    got = solver.solve(*inputs, device="cpu")
    assert dc.LAUNCHES == before, "the CPU path launches no kernel"
    return got, {k: getattr(inputs[0], k) for k in STATE}, dict(solver.dispatch_counts)


def assert_same(port, ref, counts=True):
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[0].dtype == np.int32
    for k in STATE:
        np.testing.assert_array_equal(port[1][k], ref[1][k], err_msg=k)
    if counts:
        assert port[2] == ref[2]


def random_solve(nodes, pods, group, families=False, seed=0, compact=True):
    """The port's random-mode solve, equal to the JAX package's bit for
    bit: assignments, written-back node state and dispatch counts."""
    port = port_solve(nodes, pods, group, families, compact, tie="random", seed=seed)
    assert_same(port, ref_solve(nodes, pods, group, families, compact, tie="random", seed=seed))
    return port


def check_first_mode(nodes, pods, group, families=False):
    """Port grouped == JAX grouped (counts included) == port scan on the
    same padded batch. Returns the port's dispatch counts."""
    ref = ref_solve(nodes, pods, group, families)
    port = port_solve(nodes, pods, group, families)
    assert_same(port, ref)
    port_scan = port_solve(nodes, pods, 0, families, pad_group=group)
    assert_same(port_scan, ref, counts=False)
    assert port_scan[2] == {"scan": 1}
    return port[2]


def _uniform_runs():
    rng = np.random.default_rng(7)
    nodes = scan.mk_nodes(24, rng, taint_every=5, label_every=3)
    pods = (
        scan.mk_replica_run("web", 40, 250, 512)
        + scan.mk_replica_run("db", 17, 1000, 2048, affinity=True)
        + scan.mk_replica_run("agent", 23, 100, 128, tolerate=True)
    )
    return nodes, pods


def _mixed_oneoff():
    rng = np.random.default_rng(11)
    nodes = scan.mk_nodes(16, rng, label_every=4)
    pods = []
    for i in range(60):
        b = MakePod().name(f"p-{i:03}")
        if i % 7 == 0:
            b = b.req({"cpu": f"{int(rng.integers(1, 16)) * 50}m",
                       "memory": f"{int(rng.integers(1, 9)) * 256}Mi"})
        else:
            b = b.req({"cpu": "200m", "memory": "256Mi"})
        pods.append(b.obj())
    return nodes, pods


@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("fixture,want", [(_uniform_runs, "kind1"), (_mixed_oneoff, "kind0")],
                         ids=["uniform", "mixed"])
def test_plain_chunks_equal_reference_and_scan(fixture, want, group):
    counts = check_first_mode(*fixture(), group)
    assert counts.get(want, 0) > 0


@pytest.mark.parametrize("group", [4, 8])
def test_host_port_cap(group):
    nodes = scan.mk_nodes(6, np.random.default_rng(3))
    pods = scan.mk_replica_run("lb", 10, 100, 128, port=8080)
    check_first_mode(nodes, pods, group)
    got = port_solve(nodes, pods, group)[0]
    placed = [a for a in got if a >= 0]
    assert len(placed) == len(set(placed)) == 6  # one per node, 4 overflow


@pytest.mark.parametrize("group", [4, 8])
def test_saturation_tail(group):
    nodes = [
        MakeNode().name(f"n-{i}").capacity({"cpu": "1", "memory": "1Gi", "pods": "3"}).obj()
        for i in range(3)
    ]
    pods = scan.mk_replica_run("big", 20, 300, 200)
    check_first_mode(nodes, pods, group)
    assert (port_solve(nodes, pods, group)[0] == -1).sum() > 0


@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("kind,n_nodes,n_pods,want", [
    ("spread", 24, 48, "kind2"), ("anti", 24, 20, "kind3"),
    ("mixed", 32, 0, "kind2"),
])
def test_quota_chunks_equal_reference_and_scan(kind, n_nodes, n_pods, want, group):
    nodes = quota.mk_nodes(n_nodes)
    if kind == "mixed":
        pods = (quota.mk_pods(2 * group, "spread") + quota.mk_pods(group, "anti")
                + quota.mk_pods(group, "plain"))
    else:
        pods = quota.mk_pods(n_pods, kind)
    counts = check_first_mode(nodes, pods, group, families=True)
    assert counts.get(want, 0) > 0


@pytest.mark.parametrize("max_skew,tie", [(2, "first"), (5, "random")])
def test_spread_with_existing_pods_and_skew_two(max_skew, tie):
    """Spread chunks starting from a cluster that already runs matching
    pods (the counts' base rows), with maxSkew 2 in "first" mode (equal to
    the scan too), and with the spread5k deployment's maxSkew 5 in
    "random" mode, where the maxSkew > 1 re-entry gate and the water-fill
    run: equal to the JAX package bit for bit."""
    nodes = quota.mk_nodes(18)
    placed = {nodes[i].name: [MakePod().name(f"old-{i}").label("app", "s2")
                              .node(nodes[i].name).req({"cpu": "250m"}).obj()]
              for i in (0, 3, 6, 1)}
    pods = [MakePod().name(f"p-{i:03}").label("app", "s2").req({"cpu": "250m"})
            .spread_constraint(max_skew, ZONE, "DoNotSchedule", {"app": "s2"}).obj()
            for i in range(24)]

    def inputs():
        vocab = ResourceVocab.build(pods, nodes)
        nb = build_node_batch(nodes, placed, vocab=vocab)
        pb = build_pod_batch(pods, vocab, pad=24)
        slots = list(nodes) + [None] * (nb.padded - len(nodes))
        by_slot = {i: placed[n.name] for i, n in enumerate(nodes) if n.name in placed}
        st = build_static_tensors(pods, pb, slots, nb.padded)
        return (nb, pb, st, build_port_tensors(pods, pb, slots, by_slot, nb.padded),
                build_spread_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad),
                build_interpod_tensors(pods, st.reps, pb, slots, by_slot, nb.padded, st.c_pad))

    ref = RefSolver(_config(8, tie))
    want = ref.solve(*inputs())
    port = ExactSolver(convert.solver_config(_config(8, tie)))
    got = port.solve(*convert.solve_inputs(*inputs()), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert dict(port.dispatch_counts) == dict(ref.dispatch_counts)
    assert port.dispatch_counts["kind2"] == 3
    assert (got >= 0).all()
    if tie == "first":
        scan_got = ExactSolver(convert.solver_config(_config(0))).solve(
            *convert.solve_inputs(*inputs()), device="cpu")
        np.testing.assert_array_equal(scan_got, want)


def test_chunk_kinds_equal_reference():
    group = quota.GROUP
    nodes = quota.mk_nodes(32)
    pods = (quota.mk_pods(group, "spread") + quota.mk_pods(group, "anti")
            + quota.mk_pods(group, "plain"))
    ref = ref_inputs(nodes, pods, group=group, families=True)
    want = RefSolver._chunk_kinds(ref[1], ref[2], ref[3], ref[4], ref[5], group, True, True)
    port = convert.solve_inputs(*ref)
    got = ExactSolver._chunk_kinds(port[1], port[2], port[3], port[4], port[5], group,
                                   True, True)
    assert list(got) == list(want) == [gp.KIND_SPREAD, gp.KIND_ANTI, gp.KIND_PLAIN]


# -- compact wire --------------------------------------------------------------


def test_compact_wire_uniform_partial_tail():
    """42 uniform pods in chunks of 8: the compact upload engages, with a
    partial tail chunk, and equals the full upload and the JAX package."""
    nodes = scan.mk_nodes(12, np.random.default_rng(13), taint_every=4)
    pods = scan.mk_replica_run("web", 42, 250, 512)
    ref = ref_solve(nodes, pods, 8)
    comp = port_solve(nodes, pods, 8)
    full = port_solve(nodes, pods, 8, compact=False)
    assert_same(comp, ref)
    assert_same(full, ref_solve(nodes, pods, 8, compact=False))
    assert comp[2]["compact_batches"] == 1 and "compact_batches" not in full[2]
    np.testing.assert_array_equal(comp[0], full[0])


def test_compact_wire_slow_chunk_broadcast_replay():
    """Uniform pods that defeat the quota kinds (hard zone spread plus a
    preferred node affinity): kind-0 chunks replay the representative row,
    the tail chunk with fewer valid pods than the group included."""
    nodes = [
        MakeNode().name(f"zn-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "30"})
        .label(ZONE, f"z{i % 3}").label("disk", "ssd" if i % 2 == 0 else "hdd").obj()
        for i in range(9)
    ]
    pods = [
        MakePod().name(f"sp-{i:02}").req({"cpu": "500m", "memory": "1Gi"}).label("app", "sp")
        .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "sp"})
        .preferred_node_affinity(5, "disk", ["ssd"]).obj()
        for i in range(26)
    ]
    counts = check_first_mode(nodes, pods, 8, families=True)
    assert counts["kind0"] > 0 and counts["compact_batches"] == 1
    full = port_solve(nodes, pods, 8, families=True, compact=False)
    assert_same(full, ref_solve(nodes, pods, 8, families=True, compact=False))


def test_compact_wire_falls_back_on_mixed_rows():
    rng = np.random.default_rng(23)
    nodes = scan.mk_nodes(8, rng)
    pods = scan.mk_replica_run("a", 12, 200, 256) + scan.mk_replica_run("b", 12, 400, 512)
    pods = [pods[i] for i in rng.permutation(len(pods))]
    counts = check_first_mode(nodes, pods, 8)
    assert "compact_batches" not in counts


@pytest.mark.parametrize("seed", [5, 6])
def test_compact_wire_random_mode_same_draws(seed):
    """Random mode: the compact and the full upload run the same chunk
    kinds and draw the same numbers, so they place identically, as the
    JAX package's compact solve does."""
    rng = np.random.default_rng(17)
    nodes = scan.mk_nodes(10, rng)
    pods = scan.mk_replica_run("app", 30, 300, 256)  # a partial tail chunk
    comp = random_solve(nodes, pods, 8, seed=seed)
    full = port_solve(nodes, pods, 8, tie="random", seed=seed, compact=False)
    np.testing.assert_array_equal(comp[0], full[0])
    assert comp[2]["compact_batches"] == 1


# -- random mode: the JAX package's draws, and the oracle's tie set ------------


def _validate(nodes, pods, assignments, names):
    oracle = FullOracle(make_oracle_nodes(nodes))
    named = [names[a] if a >= 0 else None for a in assignments]
    errors = oracle.validate_assignments(pods, list(assignments), names=named)
    assert not errors, "\n".join(errors[:5])


@pytest.mark.parametrize("seed", range(4))
def test_random_plain_chunks_in_tie_set(seed):
    rng = np.random.default_rng(21 + seed)
    nodes = scan.mk_nodes(20, rng, taint_every=4, label_every=3)
    pods = scan.mk_replica_run("a", 48, 250, 512) + scan.mk_replica_run(
        "b", 30, 500, 1024, tolerate=True)
    got, _, counts = random_solve(nodes, pods, 8, seed=seed)
    assert counts.get("kind1", 0) > 0
    _validate(nodes, pods, got, [n.name for n in nodes])


@pytest.mark.parametrize("seed", range(4))
def test_random_spread_chunks_in_tie_set_and_balanced(seed, monkeypatch):
    nodes = quota.mk_nodes(24)
    pods = quota.mk_pods(48, "spread")
    waterfill = []
    accept = gp._waterfill_accept

    def recorded(*args):
        out = yield from accept(*args)
        waterfill.append(bool(out[2]))
        return out

    monkeypatch.setattr(gp, "_waterfill_accept", recorded)
    got, _, counts = random_solve(nodes, pods, quota.GROUP, families=True, seed=seed)
    assert any(waterfill), "the water-fill's draw was taken"
    assert counts["kind2"] == 3
    assert (got >= 0).all()
    _validate(nodes, pods, got, [n.name for n in nodes])
    zones = np.bincount(got % 3, minlength=3)
    assert zones.max() - zones.min() <= 1


@pytest.mark.parametrize("seed", range(4))
def test_random_anti_chunks_in_tie_set_and_exclusive(seed):
    nodes = quota.mk_nodes(32)
    pods = quota.mk_pods(24, "anti")
    got, _, counts = random_solve(nodes, pods, quota.GROUP, families=True, seed=seed)
    assert counts["kind3"] == 1
    assert (got >= 0).all() and len(set(got.tolist())) == 24
    _validate(nodes, pods, got, [n.name for n in nodes])


def test_random_quota_chunks_at_larger_scale_and_overload():
    """512 nodes with spread and anti chunks (sampled tie-set checks), and
    more anti pods than nodes (exactly one per node places)."""
    nodes = quota.mk_nodes(512)
    group = quota.GROUP
    pods = quota.mk_pods(4 * group, "spread") + quota.mk_pods(4 * group, "anti")
    got = random_solve(nodes, pods, group, families=True, seed=1)[0]
    assert (got >= 0).all()
    oracle = FullOracle(make_oracle_nodes(nodes))
    names = [nodes[a].name for a in got]
    sample = {i for i in range(len(pods)) if i % 8 == 0}
    errors = oracle.validate_assignments(pods, list(got), names=names, sample=sample)
    assert not errors, "\n".join(errors[:5])
    zones = np.bincount(got[: 4 * group] % 3, minlength=3)
    assert zones.max() - zones.min() <= 1
    assert len(set(got[4 * group :].tolist())) == 4 * group

    small = quota.mk_nodes(8)
    over = random_solve(small, quota.mk_pods(12, "anti"), group, families=True)[0]
    assert (over >= 0).sum() == 8 and len(set(over[over >= 0].tolist())) == 8


def test_random_mixed_kinds_equal_the_jax_package():
    """One batch whose chunks mix the slow kind (one-off pods: the per-pod
    scan's one split per row, the padding rows of the last chunk included)
    with the spread, anti and plain kinds (one split per loop iteration):
    the key chain runs through the chunks in order, as the JAX package's
    chunk_step threads it, and the placements equal its own bit for bit."""
    g = quota.GROUP

    def oneoff(n):
        return [MakePod().name(f"odd-{i}").req({"cpu": f"{300 + 100 * (i % 2)}m",
                                                "memory": "1Gi"}).obj() for i in range(n)]

    pods = (quota.mk_pods(2 * g, "spread") + oneoff(g) + quota.mk_pods(g, "anti")
            + quota.mk_pods(g, "plain") + oneoff(3))
    pods = [dataclasses.replace(p, name=f"q-{i:03}") for i, p in enumerate(pods)]
    got, _, counts = random_solve(quota.mk_nodes(48), pods, g, families=True, seed=2,
                                  compact=False)
    assert all(counts[f"kind{k}"] >= 1 for k in range(4)), counts
    assert (got[: 2 * g] >= 0).all()
