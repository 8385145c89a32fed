"""The fused spread loop (``ops/grouped_spread.py``, ``csrc/grouped_spread.cu``)
on the CPU: where it engages, what it counts, and its block body run on the
host.

The kernel's block body is plain C++ under a host shim
(``tests/_cuda_host_shim.h``): one block of std::threads, a barrier for
``__syncthreads``, warps exchanging through a buffer. Built here with g++ and
launched with the wrapper's own packed words on CPU tensors, it places each
spread chunk of a solve that otherwise runs the CPU's eager loop, and the
solve equals the eager one bit for bit: assignments, carried state, the
stream's key after every chunk, the iterations and kept water-fills. The
card runs the same source through nvcc (``tests/test_torch_grouped_spread.py``).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch import metrics
from kubernetes_tpu_torch.ops import grouped_spread as gs
from kubernetes_tpu_torch.ops import noderesources as nr
from kubernetes_tpu_torch.solver import timing
from kubernetes_tpu_torch.solver.exact import _fit_scorer

from _torch_spread_cases import assert_same, recorded_solve, spread_cases  # noqa: F401
from _torch_spread_cases import settled, spread_pods

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
GROUP = 16
CASES = spread_cases(48, 96, GROUP)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's block body built for the host, with the wrapper's
    declarations and the emulated launch."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's block body for the host")
    out = tmp_path_factory.mktemp("grouped_spread") / "libgrouped_spread_host.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared", "-fPIC",
           "-include", str(HERE / "_cuda_host_shim.h"),
           "-I", str(ROOT / "kubernetes_tpu_torch" / "csrc"),
           "-o", str(out), str(HERE / "_grouped_spread_host.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = gs._declare(ctypes.CDLL(str(out)))
    lib.grouped_spread_emulate.argtypes = [ctypes.c_void_p]
    lib.grouped_spread_emulate.restype = ctypes.c_int
    return lib


def host_loop(lib, *, threads=64, smem=1 << 20, launches=None):
    """``gs.spread_loop`` for a CPU stream: the kernel's block body on the
    host, on a state row made from the stream's key, which takes the key
    and the subkey it leaves."""

    def spread_loop(stream, **kw):
        state = torch.tensor([*stream.key, 0, 0, 0, 0], dtype=torch.int64)
        launch = gs.Launch(lib, state=state, cur=0, skip=stream.pending, smem=smem,
                           threads=threads, **kw)
        assert lib.grouped_spread_emulate(ctypes.addressof(launch.words)) == 0
        w = state.tolist()
        stream.key, stream.sub = (w[0], w[1]), (w[4], w[5])
        stream.pending, stream.has_sub = 0, True
        if launches is not None:
            launches.append(launch.smem)

    return spread_loop


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_block_body_equals_the_eager_loop(host_kernel, recorded_solve, case):
    spec = CASES[case]
    seed = 2_147_483_648 + len(case)
    want = recorded_solve(spec, "cpu", seed, fused=False, group=GROUP)
    got = recorded_solve(spec, "cpu", seed, fused=True, spread_loop=host_loop(host_kernel),
                         group=GROUP)
    assert_same(got, want, case)
    counts = [c for _, _, _, c in got[0]]
    if case.startswith("empty"):
        assert sum(c["waterfill_iterations"] for c in counts) > 0
    if case == "infeasible":
        assert (got[0][0][0] < 0).any() and (got[0][0][0] >= 0).any()


def _same_on_layout(host_kernel, recorded_solve, case, seed, threads, smem):
    """The case's solves through the block body of ``threads`` threads, its
    arrays in shared memory (``smem`` > 0) or the device workspace, equal
    the eager loop's."""
    spec = CASES[case]
    layouts = []
    want = recorded_solve(spec, "cpu", seed, fused=False, group=GROUP)
    got = recorded_solve(spec, "cpu", seed, fused=True, group=GROUP,
                         spread_loop=host_loop(host_kernel, threads=threads, smem=smem,
                                               launches=layouts))
    assert_same(got, want, f"{case}, seed {seed}")
    assert layouts and all((s > 0) == (smem > 0) for s in layouts)


@pytest.mark.parametrize("seed", [0, 7, 31, 2_400_000_001, 4_294_967_290])
@pytest.mark.parametrize("threads,smem", [(96, 1 << 20), (64, 0)])
def test_the_block_body_on_seeds_and_layouts(host_kernel, recorded_solve, seed, threads, smem):
    """Other seeds, three warps or two, the loop's arrays in the block's
    shared memory or in the device workspace (smem 0)."""
    _same_on_layout(host_kernel, recorded_solve, "skew5_loaded", seed, threads, smem)


@pytest.mark.parametrize("seed", [1, 2_400_000_001])
@pytest.mark.parametrize("threads,smem", [(96, 0), (64, 0), (64, 1 << 20)])
def test_the_hostname_block_body_on_seeds_and_layouts(host_kernel, recorded_solve, seed,
                                                      threads, smem):
    """A hostname spread (a domain a node): warps that own runs of domains,
    one warp with none (96 threads), the loop's arrays in the block's shared
    memory or in the device workspace, as a cluster of thousands of nodes
    takes on the card."""
    _same_on_layout(host_kernel, recorded_solve, "hostname_skew1", seed, threads, smem)


def test_engages_on_the_card_alone():
    """The card, one shard, random mode and a scorer the kernel computes;
    the CPU, a mesh, "first" mode and RequestedToCapacityRatio keep the
    eager loop."""
    least, most = _fit_scorer("LeastAllocated", ()), _fit_scorer("MostAllocated", ())
    rtc = _fit_scorer("RequestedToCapacityRatio", ((0, 0), (100, 10)))
    cuda = torch.device("cuda")
    assert gs.engages(cuda, 1, "random", least) and gs.engages(cuda, 1, "random", most)
    assert not gs.engages("cpu", 1, "random", least)
    assert not gs.engages(cuda, 2, "random", least)
    assert not gs.engages(cuda, 1, "first", least)
    assert not gs.engages(cuda, 1, "random", rtc)
    assert set(gs.SCORERS) == {nr.least_allocated_score, nr.most_allocated_score}


@pytest.mark.parametrize("tie,scoring,kind", [
    ("random", "LeastAllocated", "spread"),  # the CPU
    ("first", "LeastAllocated", "spread"),
    ("random", "RequestedToCapacityRatio", "spread"),
    ("random", "LeastAllocated", "anti"),
])
def test_other_paths_keep_the_eager_loop(monkeypatch, tie, scoring, kind):
    """No fused launch where it does not engage, though the engagement rule
    is widened to the CPU for all but the CPU case: "first" mode, the RTC
    scorer and anti chunks run the eager loop, and count no fused chunk."""
    from kubernetes_tpu_torch.api.wrappers import MakePod
    from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig

    from _torch_spread_cases import HOST, inputs, nodes

    def refuse(*a, **k):
        raise AssertionError("the fused loop ran")

    if (tie, scoring, kind) != ("random", "LeastAllocated", "spread"):
        monkeypatch.setattr(gs, "engages",
                            lambda device, shards, t, scorer: shards == 1 and t == "random"
                            and scorer in gs.SCORERS)
    monkeypatch.setattr(gs, "spread_loop", refuse)
    if kind == "spread":
        pods = spread_pods(48)
    else:
        pods = [MakePod().name(f"a{i:03}").label("app", "a").req({"cpu": "100m"})
                .pod_anti_affinity(HOST, {"app": "a"}).obj() for i in range(32)]
    rtc = ((0, 0), (100, 10)) if scoring == "RequestedToCapacityRatio" else ()
    solver = ExactSolver(ExactSolverConfig(tie_break=tie, seed=3, group_size=GROUP,
                                           scoring_strategy=scoring, rtc_shape=rtc))
    got = solver.solve(*inputs(nodes(48), {}, pods), device="cpu")
    assert (got >= 0).all()
    counts = settled(solver.times)
    assert counts[f"chunks.{kind}"] > 0 and counts["fused_chunks.spread"] == 0
    assert solver.times.deferred == []


def test_the_counter_and_its_entries_are_declared():
    assert timing.COUNT_SERIES["fused_chunks.spread"] == ("solve_fused_chunks_total", "spread")
    assert timing.FUSED_KINDS == ("spread",) and "grouped_spread" in timing.KERNELS
    assert metrics.solve_fused_chunks_total in metrics.PORT_SERIES
    assert len(timing.launch_counts()) == len(timing.KERNELS)
    from kubernetes_tpu_torch.obs import profile

    assert "launches.grouped_spread" in profile._DELTA_READERS


def test_deferred_counts_reach_the_profiler_ledger():
    """A call's device row of counts adds to the batch ledger and to the
    registry, as the host's counts do."""
    from kubernetes_tpu_torch.obs.profile import StageProfiler

    times = timing.SolveTimes()
    times.counts["fused_chunks.spread"] = 2
    times.defer(torch.tensor([9, 1]), (("grouped_iterations", "chunk_iterations.spread"),
                                       ("waterfill_iterations",)))
    assert settled(times)["chunk_iterations.spread"] == 9
    series = metrics.solve_chunk_iterations_total.labels("spread")
    before = series.value()
    prof = StageProfiler()
    prof.add_solve(times)
    entry = prof.observe_batch(step=0, pods=128)
    assert (entry["grouped_iterations"], entry["chunk_iterations.spread"],
            entry["waterfill_iterations"], entry["fused_chunks.spread"]) == (9, 9, 1, 2)
    assert series.value() - before == 9


def test_the_reader_is_silent_off_the_card():
    from types import SimpleNamespace

    from portbench import harness

    ctx = SimpleNamespace(run=SimpleNamespace(sched=SimpleNamespace(device=torch.device("cpu"))))
    assert harness.load_reader("fused_chunk_pct.spread5k").read(ctx) is None


def test_launch_checks_its_inputs(host_kernel):
    n = 8
    i32 = torch.zeros(n, dtype=torch.int32)
    kw = dict(state=torch.zeros(6, dtype=torch.int64), cur=0, skip=0, vcnt=4, group=4, skew=1,
              d_present=1, cap=i32, base=i32, counted_dom=i32, dom=i32,
              hk=torch.ones(n, dtype=torch.bool), present=torch.ones(1, dtype=torch.bool),
              alloc=torch.ones((3, n), dtype=torch.int64),
              nonzero_used=torch.zeros((2, n), dtype=torch.int64),
              nz=torch.ones(2, dtype=torch.int64), fit_weights=torch.ones(2, dtype=torch.int64),
              static_row=None, fit_scorer=nr.least_allocated_score, fdtype=torch.float64,
              w_fit=1, w_balanced=1, m=torch.zeros(n, dtype=torch.int32),
              asg=torch.zeros(4, dtype=torch.int64), counts=torch.zeros(2, dtype=torch.int64),
              smem=0)
    gs.Launch(host_kernel, **kw)
    with pytest.raises(ValueError, match="cap"):
        gs.Launch(host_kernel, **dict(kw, cap=i32.to(torch.int64)))
    with pytest.raises(ValueError, match="scorer"):
        gs.Launch(host_kernel, **dict(kw, fit_scorer=lambda *a: None))
    with pytest.raises(ValueError, match="threads"):
        gs.Launch(host_kernel, **dict(kw, threads=48))
    with pytest.raises(ValueError, match="pods"):
        gs.Launch(host_kernel, **dict(kw, vcnt=5))
