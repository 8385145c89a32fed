"""The port's kernel build cache (``utils/compile_cache.py`` + ``build.py``)
on the CPU, with a fake compiler.

``enable_persistent_cache`` fixes, once per process, the directory the
``nvcc`` builds of ``csrc/*.cu`` go into and load from: its argument, else
``$KUBERNETES_TPU_COMPILE_CACHE``, else ``kubernetes_tpu_torch/_build``. The
fake compiler stands in for ``nvcc`` (``build.nvcc`` and
``subprocess.run``): it writes the output file it is asked for and counts
its runs, so each case sees where a library lands, where it loads from
(``ctypes.CDLL`` is faked too) and whether a build ran. A "second process"
is this process with the cache's state reset. A directory that holds no
library and cannot be created raises ``KernelError`` naming it, and
nothing falls back. The card's own cold / warm / prebuilt builds are in
``tests/test_torch_cuda.py``.
"""

import subprocess

import pytest

from kubernetes_tpu_torch import build
from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.resilience import (
    TIER_CPU,
    TIER_HOST,
    TIER_SINGLE,
    ResilienceConfig,
    SolveResilience,
)
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.evaluate import BatchEvaluator
from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.utils import compile_cache
from kubernetes_tpu_torch.utils.clock import FakeClock

NAME = "domain_counts"


class FakeCompiler:
    def __init__(self, rc=0):
        self.rc = rc
        self.runs = []

    def __call__(self, cmd, capture_output=True, text=True):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"fake library")
        self.runs.append(out)
        return subprocess.CompletedProcess(cmd, self.rc, "", "fake failure" if self.rc else "")


@pytest.fixture
def fresh(monkeypatch):
    """A process with no directory chosen and nothing loaded, the fake
    compiler in place of nvcc, and CDLL recording what it loads."""
    monkeypatch.setattr(build, "BUILD_DIR", None)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    monkeypatch.setattr(build, "nvcc", lambda: "fake-nvcc")
    cc = FakeCompiler()
    monkeypatch.setattr(build.subprocess, "run", cc)
    loaded = []
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path, *a, **k: loaded.append(path) or object())
    built = []
    monkeypatch.setattr(build, "BUILD_LISTENERS", [lambda name, s: built.append(name)])
    return cc, loaded, built


def new_process(monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", None)
    monkeypatch.setattr(build, "_LOADED", {})


def test_relocation_decides_where_the_library_lands_and_loads_from(fresh, tmp_path):
    cc, loaded, built = fresh
    d = tmp_path / "cache"
    assert compile_cache.enable_persistent_cache(d) == str(d)
    path = build.compile_library(NAME)
    assert path.parent == d and path.exists()
    assert cc.runs and built == [NAME]
    build.load(NAME)
    assert loaded == [str(path)]
    assert not list(d.glob("*.tmp")), "the private temporary file is renamed away"


def test_first_call_wins(fresh, tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    assert compile_cache.enable_persistent_cache(a) == str(a)
    assert compile_cache.enable_persistent_cache(b) == str(a)
    monkeypatch.setenv(compile_cache.ENV, str(b))
    assert compile_cache.enable_persistent_cache() == str(a)
    assert build.library_path(NAME).parent == a


def test_environment_variable_is_honoured(fresh, tmp_path, monkeypatch):
    env = tmp_path / "from-env"
    monkeypatch.setenv(compile_cache.ENV, str(env))
    # a launch with no solver in the process fixes the directory too
    assert build.library_path(NAME).parent == env
    assert compile_cache.enable_persistent_cache() == str(env)
    new_process(monkeypatch)
    arg = tmp_path / "from-arg"
    assert compile_cache.enable_persistent_cache(arg) == str(arg)  # the argument first


def test_default_is_the_package_build_directory(fresh):
    assert compile_cache.enable_persistent_cache() == str(build.DEFAULT_BUILD_DIR)
    assert build.DEFAULT_BUILD_DIR == build.CSRC.parent / "_build"


def test_solvers_fix_the_directory_at_construction(fresh, tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "exact"))
    ExactSolver()
    assert build.BUILD_DIR == tmp_path / "exact"
    new_process(monkeypatch)
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "eval"))
    BatchEvaluator(device="cpu")
    assert build.BUILD_DIR == tmp_path / "eval"


def test_second_process_on_a_filled_directory_builds_nothing(fresh, tmp_path, monkeypatch):
    cc, loaded, built = fresh
    d = tmp_path / "shared"
    compile_cache.enable_persistent_cache(d)
    first = build.load(NAME) and build.library_path(NAME)
    assert len(cc.runs) == 1 and built == [NAME]
    new_process(monkeypatch)
    compile_cache.enable_persistent_cache(d)
    build.load(NAME)
    assert len(cc.runs) == 1 and built == [NAME], "a warm directory runs no build"
    assert loaded == [str(first), str(first)]


def test_read_only_prebuilt_directory_needs_no_compiler(fresh, tmp_path, monkeypatch):
    cc, loaded, built = fresh
    d = tmp_path / "prebuilt"
    compile_cache.enable_persistent_cache(d)
    path = build.compile_library(NAME)
    d.chmod(0o555)
    try:
        new_process(monkeypatch)

        def no_compiler():
            raise build.KernelError("no nvcc here")

        monkeypatch.setattr(build, "nvcc", no_compiler)
        compile_cache.enable_persistent_cache(d)
        build.load(NAME)
        assert loaded == [str(path)] and len(cc.runs) == 1
    finally:
        d.chmod(0o755)


def test_unwritable_empty_directory_raises_naming_it(fresh, tmp_path):
    cc, loaded, built = fresh
    blocker = tmp_path / "a-file"
    blocker.write_text("not a directory")
    d = blocker / "cache"  # cannot be created, whoever runs this
    compile_cache.enable_persistent_cache(d)
    with pytest.raises(build.KernelError, match=str(d)):
        build.load(NAME)
    with pytest.raises(build.KernelError, match="cannot be created or written"):
        build.compile_library(NAME)
    assert cc.runs == [] and loaded == [] and built == []
    assert build._LOADED == {}
    assert blocker.read_text() == "not a directory"


def test_unwritable_directory_fails_the_batch_and_falls_back_to_nothing(
    fresh, tmp_path, monkeypatch
):
    """The Scheduler on a card whose build directory cannot be written:
    the wrapper's first launch raises KernelError naming the directory out
    of schedule_batch, no lower rung of the ladder runs, nothing binds."""
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    d = blocker / "cache"
    compile_cache.enable_persistent_cache(d)
    cs = ClusterState()
    zone = "topology.kubernetes.io/zone"
    for i in range(4):
        cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "8", "pods": "110"})
                       .label(zone, f"z{i % 2}").obj())
    for i in range(3):
        # zone anti-affinity: the node totals need the kernel's aggregation
        cs.create_pod(MakePod().name(f"p{i}").req({"cpu": "500m"}).label("app", "anti")
                      .pod_anti_affinity(zone, match_labels={"app": "anti"}).obj())
    clock = FakeClock()
    sched = Scheduler(cs, SchedulerConfig(solver=ExactSolverConfig(tie_break="first")),
                      clock=clock, device="cpu")
    sched.resilience = SolveResilience(
        ResilienceConfig(), clock, (TIER_SINGLE, TIER_CPU, TIER_HOST)
    )
    tried = []
    sched._solve_fault = lambda pods, tier: tried.append(tier)
    # the wrapper loads its kernel as it does on the card
    monkeypatch.setattr(dc, "_lib", None)
    monkeypatch.setattr(dc.Aggregation, "__call__", lambda self: dc._load())
    with pytest.raises(build.KernelError, match=str(d)):
        sched.schedule_batch()
    assert tried == [TIER_SINGLE]
    assert not any(p.node_name for p in cs.list_pods())


def test_a_loaded_library_stays_loaded(fresh, tmp_path):
    cc, loaded, built = fresh
    compile_cache.enable_persistent_cache(tmp_path / "a")
    lib = build.load(NAME)
    build.BUILD_DIR = tmp_path / "b"  # however the directory moves later
    assert build.load(NAME) is lib
    assert len(loaded) == 1 and len(cc.runs) == 1
    assert not (tmp_path / "b").exists()


def test_failed_build_leaves_no_temporary_file(fresh, tmp_path, monkeypatch):
    monkeypatch.setattr(build.subprocess, "run", FakeCompiler(rc=1))
    d = tmp_path / "cache"
    compile_cache.enable_persistent_cache(d)
    with pytest.raises(build.KernelError, match="nvcc failed"):
        build.compile_library(NAME)
    assert list(d.iterdir()) == []
