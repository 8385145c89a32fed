"""The fused scan step (``ops/scan_step.py``, ``csrc/scan_step.cu``) on the
CPU: its block body run on the host against the torch step, where it
engages, and what it counts.

The kernel's block body is plain C++ under a host shim
(``tests/_cuda_host_shim.h``): one block of std::threads, a barrier for
``__syncthreads``, warps exchanging through a buffer. Built here with g++ and
launched with the wrapper's own packed words on CPU tensors, it takes every
scan step of a solve that otherwise runs the torch step
(``solver/exact.py`` ``_make_step``), eagerly or from an emulated step graph,
and the solve equals the torch step's bit for bit: assignments, the carried
``i64`` / ``i32`` state and the stream's key after every run. The card runs
the same source through nvcc (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.ops import noderesources as nr
from kubernetes_tpu_torch.ops import scan_step as ss
from kubernetes_tpu_torch.parallel.sharding import NodeMesh
from kubernetes_tpu_torch.solver import graphs as sg
from kubernetes_tpu_torch.solver import timing
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig, _fit_scorer

from _torch_scan_step_cases import MIXED, assert_same, build_host_kernel, cases, inputs
from _torch_scan_step_cases import batch, nodes, on_the_host, solve

CASES = cases(48, 64)
# the crowded case's kinds in batch order
CROWDED = ("crowded", "crowded_aff", "spread", "anti") * 16


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's block body built for the host, with the wrapper's
    declarations and the emulated launch."""
    return build_host_kernel(tmp_path_factory.mktemp("scan_step"))


def _pair(monkeypatch, lib, case, seed, *, graphs=False, **kw):
    """The case solved through the torch step, then through the block body
    (``graphs``: from emulated step graphs): (fused, torch)."""
    spec = CASES[case]
    with monkeypatch.context() as mp:
        want = solve(mp, spec, "cpu", seed, fused=False, **kw)
    with monkeypatch.context() as mp:
        on_the_host(mp, lib)
        if graphs:
            mp.setattr(sg, "engages", lambda device, shards, nom: shards == 1 and not nom)
            mp.setattr(sg.StepGraphs, "capture", lambda self, fn: SimpleNamespace(replay=fn))
        got = solve(mp, spec, "cpu", seed, fused=True, graphs=graphs, **kw)
    return got, want


@pytest.mark.parametrize("fdtype", ["float64", "float32"])
@pytest.mark.parametrize("scoring", ["LeastAllocated", "MostAllocated"])
@pytest.mark.parametrize("tie", ["random", "first"])
def test_the_block_body_equals_the_torch_step(monkeypatch, host_kernel, tie, scoring, fdtype):
    """interpod5k's four kinds on a partly filled cluster, invalid rows
    among them: both tie-breaks, both scorers the kernel computes,
    BalancedAllocation in both types."""
    got, want = _pair(monkeypatch, host_kernel, "interpod_loaded", 2_147_483_649,
                      tie=tie, scoring=scoring, fdtype=fdtype)
    assert_same(got, want, f"interpod_loaded {tie} {scoring} {fdtype}")
    assigned = got[0][-1][0][:64]  # the batch's rows, padding left out
    assert (assigned >= 0).sum() > len(assigned) // 2


@pytest.mark.parametrize("tie", ["random", "first"])
@pytest.mark.parametrize("case", ["infeasible", "first_pod", "scores", "crowded"])
def test_the_block_body_on_every_case(monkeypatch, host_kernel, case, tie):
    """Pods no node fits, the required affinity's first pod, the soft
    spread, minDomains, TaintToleration, NodeAffinity and ImageLocality
    scores, and classes of more constraint slots than a group of eight in
    every list."""
    got, want = _pair(monkeypatch, host_kernel, case, 7 + len(case), tie=tie)
    assert_same(got, want, f"{case} {tie}")
    first = got[0][0][0]
    if case == "infeasible":
        assert (first < 0).any() and (first >= 0).any()
    if case == "first_pod":
        # the first affinity pod goes anywhere, every later one to its zone
        aff = [a for a, kind in zip(first[:16], ("aff", "ports") * 8) if kind == "aff"]
        assert aff[0] >= 0 and len({a % 3 for a in aff}) == 1
    if case == "crowded":
        # one crowded pod a node (its anti-affinity to its own kind)
        crowded = first[: len(CROWDED)][[k == "crowded" for k in CROWDED]]
        placed = crowded[crowded >= 0]
        assert placed.size and len(set(placed.tolist())) == placed.size


@pytest.mark.parametrize("case,blocks,threads,smem", [
    pytest.param("interpod_loaded", 1, 32, 0, id="1-32-0"),
    pytest.param("interpod_loaded", 1, 96, 1 << 20, id="1-96-1048576"),
    pytest.param("interpod_loaded", 3, 64, 0, id="3-64-0"),
    pytest.param("interpod_loaded", 3, 32, 1 << 20, id="3-32-1048576"),
    pytest.param("crowded", 2, 64, 1 << 20, id="crowded-2-64-1048576"),
    pytest.param("crowded", 3, 32, 0, id="crowded-3-32-0")])
def test_the_block_body_on_layouts(monkeypatch, host_kernel, case, blocks, threads, smem):
    """One block or a cluster of three, one warp (which also draws) or
    more, the per-node arrays and the hard constraints' minima in the
    blocks' shared memory or in the device workspace (a block may take no
    more than the scratch)."""
    launches = []
    spec = CASES[case]
    with monkeypatch.context() as mp:
        want = solve(mp, spec, "cpu", 31, fused=False)
    with monkeypatch.context() as mp:
        on_the_host(mp, host_kernel, blocks=blocks, threads=threads, smem=smem,
                    launches=launches)
        got = solve(mp, spec, "cpu", 31, fused=True)
    assert_same(got, want, f"{case}: {blocks} blocks of {threads} threads, smem {smem}")
    assert launches and all(s == (smem > 0) for s in launches)


@pytest.mark.parametrize("case,tie", [pytest.param("interpod_loaded", "random", id="random"),
                                      pytest.param("interpod_loaded", "first", id="first"),
                                      pytest.param("crowded", "random", id="crowded-random")])
def test_replayed_steps_equal_the_torch_step(monkeypatch, host_kernel, case, tie):
    """Steps replayed from (emulated) step graphs read their pod, row and
    owed splits at the step table's cursor and advance it: the solve equals
    the torch step's, the warm-up steps run the kernel too, and every
    replayed step is a fused one, a class of more constraint slots than a
    group of eight in every list too."""
    got, want = _pair(monkeypatch, host_kernel, case, 4_000_000_007, tie=tie, graphs=True)
    assert_same(got, want, f"graphs {case} {tie}")
    counts = got[1][0]
    assert counts["graph_replays"] > 0.5 * counts["scan_steps"]
    assert counts["fused_scan_steps"] == counts["scan_steps"]


def test_engages_on_the_card_alone():
    """The card, one shard, no nominated pods and a scorer the kernel
    computes; the CPU, a mesh, nominated pods and RequestedToCapacityRatio
    keep the torch step."""
    least, most = _fit_scorer("LeastAllocated", ()), _fit_scorer("MostAllocated", ())
    rtc = _fit_scorer("RequestedToCapacityRatio", ((0, 0), (100, 10)))
    cuda = torch.device("cuda")
    assert ss.engages(cuda, 1, False, least) and ss.engages(cuda, 1, False, most)
    assert not ss.engages("cpu", 1, False, least)
    assert not ss.engages(cuda, 2, False, least)
    assert not ss.engages(cuda, 1, True, least)
    assert not ss.engages(cuda, 1, False, rtc)
    assert set(ss.SCORERS) == {nr.least_allocated_score, nr.most_allocated_score}


def _nominated_inputs(cluster, pods):
    from kubernetes_tpu_torch.api.wrappers import MakePod
    from kubernetes_tpu_torch.tensorize.schema import ResourceVocab, build_nominated_tensors

    nominee = (MakePod().name("nominee").req({"cpu": "1", "memory": "1Gi"}).priority(10)
               .nominated_node_name(cluster[0].name).obj())
    inp = inputs(cluster, {}, pods)
    vocab = ResourceVocab.build(pods + [nominee], cluster)
    nom = build_nominated_tensors([(nominee, 0)], vocab, inp[0].padded, ports=inp[3])
    return inp, dict(nominated=nom, nominated_slot=np.full(len(pods), -1, np.int32))


@pytest.mark.parametrize("path", ["cpu", "shards", "nominated", "rtc"])
def test_other_paths_keep_the_torch_step(monkeypatch, path):
    """No fused step where it does not engage, though the rule is widened
    to the CPU for all but the CPU case: a two-shard mesh, nominated pods
    and the RTC scorer step through the torch step, and count no fused
    step."""

    def refuse(*a, **k):
        raise AssertionError("the fused step ran")

    if path != "cpu":
        monkeypatch.setattr(ss, "engages", lambda device, shards, nom, scorer: shards == 1
                            and not nom and scorer in ss.SCORERS)
    monkeypatch.setattr(ss, "Step", refuse)
    rtc = ((0, 0), (100, 10)) if path == "rtc" else ()
    cfg = ExactSolverConfig(tie_break="random", seed=3, group_size=1, rtc_shape=rtc,
                            scoring_strategy="RequestedToCapacityRatio" if rtc else
                            "LeastAllocated")
    cluster, pods = nodes(12), batch(16, MIXED)
    kw = dict(device="cpu")
    inp = inputs(cluster, {}, pods)
    if path == "shards":
        kw = dict(mesh=NodeMesh(("cpu", "cpu")))
    elif path == "nominated":
        inp, extra = _nominated_inputs(cluster, pods)
        kw.update(extra)
    solver = ExactSolver(cfg)
    got = solver.solve(*inp, **kw)
    assert (got >= 0).all()
    counts = solver.times.counts
    assert counts["scan_steps"] == len(pods) and counts["fused_scan_steps"] == 0


def test_the_counter_and_its_entries_are_declared():
    assert timing.COUNT_SERIES["fused_scan_steps"] == ("solve_fused_scan_steps_total", None)
    assert "scan_step" in timing.KERNELS
    assert metrics.solve_fused_scan_steps_total in metrics.PORT_SERIES
    assert len(timing.launch_counts()) == len(timing.KERNELS)
    from kubernetes_tpu_torch.obs import profile

    assert "launches.scan_step" in profile._DELTA_READERS


def test_the_counter_advances_once_a_step(monkeypatch, host_kernel):
    """Every fused step, eager or replayed, counts once in the solve's
    counts; the StageProfiler folds them into the registry's series, and
    the wrapper's launch cell counts the same launches."""
    from kubernetes_tpu_torch.obs.profile import StageProfiler

    with monkeypatch.context() as mp:
        on_the_host(mp, host_kernel)
        mp.setattr(sg, "engages", lambda device, shards, nom: shards == 1 and not nom)
        mp.setattr(sg.StepGraphs, "capture", lambda self, fn: SimpleNamespace(replay=fn))
        launches0 = ss.LAUNCHES
        solver = ExactSolver(ExactSolverConfig(tie_break="random", seed=9, group_size=1))
        pods = batch(32, MIXED)
        solver.solve(*inputs(nodes(24), {}, pods), device="cpu")
    counts = solver.times.counts
    assert counts["fused_scan_steps"] == counts["scan_steps"] == len(pods)
    assert counts["graph_replays"] > 0
    assert ss.LAUNCHES - launches0 == len(pods)
    series = metrics.solve_fused_scan_steps_total
    before = series.value()
    prof = StageProfiler()
    prof.add_solve(solver.times)
    entry = prof.observe_batch(step=0, pods=len(pods))
    assert entry["fused_scan_steps"] == len(pods)
    assert series.value() - before == len(pods)


def test_step_checks_its_inputs(monkeypatch, host_kernel):
    """The wrapper refuses what the kernel does not take: another scorer,
    a table of another type."""
    from kubernetes_tpu_torch.solver import exact

    made = {}
    real = exact._Run.fused_step

    def keep(run, tables, st, packed):
        made.update(tables=tables, st=st, packed=packed, kw=run.kw)
        return real(run, tables, st, packed)

    with monkeypatch.context() as mp:
        on_the_host(mp, host_kernel)
        mp.setattr(exact._Run, "fused_step", keep)
        ExactSolver(ExactSolverConfig(group_size=1)).solve(
            *inputs(nodes(12), {}, batch(4, MIXED)), device="cpu")
        args = (made["tables"], made["st"], made["packed"], made["kw"], "random")
        ss.Step(*args, nr.least_allocated_score)
        with pytest.raises(ValueError, match="scorer"):
            ss.Step(*args, _fit_scorer("RequestedToCapacityRatio", ((0, 0), (100, 10))))
        bad = dict(made["tables"], max_pods=made["tables"]["max_pods"].to(torch.int64))
        with pytest.raises(ValueError, match="max_pods"):
            ss.Step(bad, *args[1:], nr.least_allocated_score)
