"""Gate + fixture tests for kubernetes_tpu_torch.analysis, the JAX
package's analyzer copied onto the port's own source.

The gate runs the port's analyzer in-process over the whole port and
fails on ANY unsuppressed finding. The fixture tests are the JAX
package's ``tests/test_static_analysis.py`` carried over as port cases:
the shared rules (LOCK001, LOCK002, FENCE001, RETRY001, MET001, MET002)
on the same fixtures, and TPU001-TPU004 on torch counterparts of each
JAX fixture, with device roots (``registry.DEVICE_ROOTS``) where the JAX
package had ``jax.jit``. Beyond those: the precision refinements of the
torch rules, each pinned by a fixture; the two analyzers giving the same
findings on identical sources for the shared rules; the port's lock
order against ``docs/LOCK_ORDER.md``; every registry entry matching a
real function of the port; and every JAX-package jit and hot root mapped
to a port root or named as having no copy.
"""

import textwrap
from pathlib import Path

import pytest

from kubernetes_tpu import analysis as ref_analysis
from kubernetes_tpu.analysis.callgraph import ModuleGraph as RefModuleGraph
from kubernetes_tpu_torch import analysis
from kubernetes_tpu_torch.analysis import (
    AnalysisContext,
    analyze_source,
    analyze_sources,
    build_project,
    default_context,
    registry,
)
from kubernetes_tpu_torch.analysis.callgraph import ModuleGraph
from kubernetes_tpu_torch.analysis.core import SourceModule
from kubernetes_tpu_torch.analysis.passes import (
    CrossModuleSyncPass,
    DtypeDisciplinePass,
    FencePass,
    HostSyncPass,
    LockDisciplinePass,
    LockOrderPass,
    MetricNamePass,
    MetricsDocPass,
    RetryPass,
    TracedBranchPass,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kubernetes_tpu_torch"


def findings_for(source, passes, ctx=None, filename="snippet.py"):
    return analyze_source(
        textwrap.dedent(source), filename=filename, ctx=ctx, passes=passes
    )


def active(findings, rule=None):
    return [
        f
        for f in findings
        if not f.suppressed and (rule is None or f.rule == rule)
    ]


def device_ctx(*quals, filename="snippet.py", **kw):
    """A context whose device roots are ``quals`` of ``filename`` (the
    port's counterpart of decorating them with ``jax.jit``)."""
    return AnalysisContext(
        device_roots=frozenset((filename, q) for q in quals), **kw
    )


@pytest.fixture(scope="module")
def head():
    """(modules, findings) of the whole port, analyzed once."""
    modules, broken = analysis.load_modules(None)
    assert not broken
    return modules, analysis.analyze_project(modules)


# -- the gate ---------------------------------------------------------------


def test_package_has_zero_unsuppressed_findings(head):
    """python -m kubernetes_tpu_torch.analysis must exit 0."""
    bad = active(head[1])
    assert not bad, "unsuppressed findings:\n" + "\n".join(
        f.render() for f in bad
    )


def test_every_suppression_carries_a_reason(head):
    modules, findings = head
    assert not [f for f in findings if f.rule == "KTPU000"]
    for f in findings:
        if f.suppressed:
            assert f.suppress_reason.strip()
    for m in modules:
        for s in m.suppressions:
            assert s.reason.strip(), f"{m.rel}:{s.line}"
            assert s.used, f"{m.rel}:{s.line} suppresses nothing"


def test_cli_exits_zero_on_the_port(capsys):
    from kubernetes_tpu_torch.analysis.__main__ import main

    assert main(["--ratchet", "--check-lock-order"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_module_paths_key_on_the_port_package(head):
    """Each module's rel names it inside kubernetes_tpu_torch/, and no two
    share one: the JAX package's analyzer keys on ``kubernetes_tpu`` and,
    over the port, falls back to bare filenames, so same-named files
    (``__init__.py``, ``runtime.py``, ...) collide and all but the first
    drop out of the project graph."""
    modules = head[0]
    rels = [m.rel for m in modules]
    assert all(r.startswith("kubernetes_tpu_torch/") for r in rels)
    assert len(set(rels)) == len(rels) == len(list(PORT.rglob("*.py")))
    ref_rels = [
        ref_analysis.SourceModule.parse(m.path, source=m.source).rel for m in modules
    ]
    assert len(set(ref_rels)) < len(ref_rels), "the collision this repairs"


def test_the_two_retry_findings_were_the_path_collision(head):
    """RETRY001 at the resilience ladder's ``while True:`` (scheduler.py)
    and the perf runner's churn loop: with the port's paths each loop's
    calls resolve, through the project graph, to the fleet's jittered
    backoff, so neither fires. The JAX package's analyzer keys paths on
    ``kubernetes_tpu``; over the port, same-named files collide and drop
    out of its graph (fleet/runtime.py behind framework/runtime.py, among
    others), no backoff is reachable, and it reports both. (With
    ops/oracle/scheduler.py in the scan, that file shadows scheduler.py
    itself by the same collision, so it is left out here.)"""
    assert not active([f for f in head[1] if f.rule == "RETRY001"])
    files = [str(p) for p in sorted(PORT.rglob("*.py"))
             if p != PORT / "ops" / "oracle" / "scheduler.py"]
    theirs = active(
        [f for f in ref_analysis.run_paths(files) if f.rule == "RETRY001"]
    )
    where = sorted(str(Path(f.path).relative_to(PORT)) for f in theirs)
    assert where == ["perf/runner.py", "scheduler.py"]
    assert {(str(Path(f.path).relative_to(PORT)), f.line) for f in theirs} <= {
        (str(Path(m.path).relative_to(PORT)), i)
        for m in head[0] for i, line in enumerate(m.source.splitlines(), 1)
        if line.strip() in ("while True:", "for _ in range(number):")
    }


# -- TPU001 host sync in the device scope or on the hot path -----------------

_DEVICE_SYNC = """
    import numpy as np
    import torch

    def leaf(x):
        return np.asarray(x).sum()

    def solve(x):
        return leaf(x) + 1
"""


def test_tpu001_fires_on_np_asarray_reachable_from_device_root():
    fs = findings_for(_DEVICE_SYNC, [HostSyncPass], ctx=device_ctx("solve"))
    assert active(fs, "TPU001"), "np.asarray reachable from a device root missed"
    assert any("leaf" in f.message for f in fs)
    assert not active(findings_for(_DEVICE_SYNC, [HostSyncPass]), "TPU001")


def test_tpu001_fires_on_coercion_and_synchronize():
    fs = findings_for(
        """
        import torch

        def f(x):
            torch.cuda.synchronize()
            y = x.sum()
            return int(y)
        """,
        [HostSyncPass],
        ctx=device_ctx("f"),
    )
    msgs = [f.message for f in active(fs, "TPU001")]
    assert any(".synchronize()" in m for m in msgs)
    assert any("int() coercion" in m for m in msgs)


def test_tpu001_fires_in_registered_hot_function():
    fs = findings_for(
        """
        # the apply path: ktpu: hot
        def apply(batch):
            return batch.assignments.tolist()
        """,
        [HostSyncPass],
    )
    assert active(fs, "TPU001")


def test_tpu001_hot_scope_skips_plain_host_coercions():
    """int()/float() on host values is legitimate outside the device scope."""
    fs = findings_for(
        """
        # ktpu: hot
        def apply(batch):
            return int(batch.count) + float(batch.score)
        """,
        [HostSyncPass],
    )
    assert not active(fs, "TPU001")


def test_tpu001_whitelist_exempts_sanctioned_read_point():
    src = """
        class DeferredAssignments:
            # ktpu: hot
            def get(self):
                self._event.synchronize()
                return self._host.numpy()
    """
    hit = findings_for(src, [HostSyncPass], filename="session.py")
    assert len(active(hit, "TPU001")) == 2, "unwhitelisted read must be flagged"
    ctx = AnalysisContext(
        sanctioned_sync=frozenset({("session.py", "DeferredAssignments.get")})
    )
    ok = findings_for(src, [HostSyncPass], ctx=ctx, filename="session.py")
    assert not active(ok, "TPU001")


def test_tpu001_device_root_by_method_qualname():
    """A device root is named by qualname, so a launch method of a class
    (the scan's ``_Run.__call__``) roots the scope; its nested step body
    inherits it."""
    fs = findings_for(
        """
        class _Run:
            def __call__(self, packed):
                def step(x):
                    return x.item()

                return step(packed)

            def unrelated(self, x):
                return x.item()
        """,
        [HostSyncPass],
        ctx=device_ctx("_Run.__call__"),
    )
    hits = active(fs, "TPU001")
    assert len(hits) == 1 and "'_Run.__call__.step'" in hits[0].message


def test_tpu001_bare_name_resolves_to_module_function_not_sibling_method():
    """A bare name inside a method is the module-level function (a
    sibling method needs `self.`); scope must follow the right callee."""
    fs = findings_for(
        """
        import numpy as np

        def helper(x):
            return np.asarray(x)

        class S:
            def helper(self, x):
                return x  # clean sibling that must NOT shadow the call

            def solve(self, x):
                return helper(x)
        """,
        [HostSyncPass],
        ctx=device_ctx("S.solve"),
    )
    hits = active(fs, "TPU001")
    assert hits and all("'helper'" in f.message for f in hits)


def test_tpu001_sees_functions_defined_in_except_handlers():
    fs = findings_for(
        """
        import numpy as np

        def solve(x):
            try:
                return x
            except Exception:
                def rescue(v):
                    return np.asarray(v)

                return rescue(x)
        """,
        [HostSyncPass],
        ctx=device_ctx("solve"),
    )
    assert active(fs, "TPU001"), "def inside except handler escaped scope"


def test_cli_errors_on_nonexistent_path(tmp_path):
    """A typo'd path must not leave the gate silently green."""
    from kubernetes_tpu_torch.analysis import run_paths
    from kubernetes_tpu_torch.analysis.__main__ import main

    with pytest.raises(FileNotFoundError):
        run_paths([str(tmp_path / "no_such_dir")])
    assert main([str(tmp_path / "no_such_dir")]) == 2


def test_tpu001_suppression_with_reason_is_honored():
    fs = findings_for(
        """
        def f(cfg):
            # ktpu: ignore[TPU001]: cfg.k is a host int from the config
            return int(cfg.k)
        """,
        [HostSyncPass],
        ctx=device_ctx("f"),
    )
    assert not active(fs, "TPU001")
    assert any(f.suppressed for f in fs)


def test_reasonless_suppression_is_its_own_finding():
    fs = findings_for(
        """
        def f(cfg):
            # ktpu: ignore[TPU001]
            return int(cfg.k)
        """,
        [HostSyncPass],
        ctx=device_ctx("f"),
    )
    assert active(fs, "KTPU000"), "reasonless ignore must be rejected"


@pytest.mark.parametrize(
    "expr", ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
             "torch.cuda.synchronize()", "event.synchronize()",
             "torch.cuda.current_stream().synchronize()", "np.array(x)"],
)
def test_tpu001_flags_each_torch_sync_in_both_scopes(expr):
    body = f"""
        import numpy as np
        import torch

        # ktpu: hot
        def hot(x, event):
            return {expr}

        def dev(x, event):
            return {expr}
    """
    fs = active(findings_for(body, [HostSyncPass], ctx=device_ctx("dev")), "TPU001")
    assert sorted(f.message.split("'")[1] for f in fs) == ["dev", "hot"]


def test_tpu001_host_metadata_is_not_a_sync():
    """Refinement: int() of a shape, a size, an element count, a rank or a
    length reads host metadata, never the card."""
    fs = findings_for(
        """
        def dev(x, rows):
            a = int(x.shape[0])
            b = int(x.size(1)) + int(x.numel()) + int(x.dim())
            c = int(len(rows)) + int(x.ndim)
            return a + b + c + int(x.sum())
        """,
        [HostSyncPass],
        ctx=device_ctx("dev"),
    )
    hits = active(fs, "TPU001")
    assert len(hits) == 1 and hits[0].line == 6


# -- TPU002 branch on a card value ------------------------------------------


def test_tpu002_fires_on_python_if_over_torch():
    fs = findings_for(
        """
        import torch

        def f(x):
            if torch.any(x > 0):
                return x
            while torch.sum(x) < 3:
                x = x + 1
            return -x
        """,
        [TracedBranchPass],
        ctx=device_ctx("f"),
    )
    assert len(active(fs, "TPU002")) == 2


def test_tpu002_fires_in_hot_scope_as_implicit_sync():
    """if (rows < 0).any() in HOST hot-path code syncs on every call."""
    fs = findings_for(
        """
        # ktpu: hot
        def apply(rows):
            if (rows < 0).any():
                return None
            return rows
        """,
        [TracedBranchPass],
    )
    hits = active(fs, "TPU002")
    assert len(hits) == 1
    assert "syncs per call" in hits[0].message


def test_tpu002_allows_static_python_branches():
    fs = findings_for(
        """
        def f(x, mode):
            if mode == "fast":
                return x * 2
            return x
        """,
        [TracedBranchPass],
        ctx=device_ctx("f"),
    )
    assert not active(fs, "TPU002")


def test_tpu002_asserts_and_all_reductions_fire():
    fs = findings_for(
        """
        import torch

        def f(x, y):
            assert torch.equal(x, y)
            assert (x >= 0).all()
            return x
        """,
        [TracedBranchPass],
        ctx=device_ctx("f"),
    )
    hits = active(fs, "TPU002")
    assert len(hits) == 2 and all("'assert'" in f.message for f in hits)


def test_tpu002_torch_metadata_is_not_a_card_value():
    """Refinement: a dtype compared with a torch attribute, torch.is_tensor
    and torch.cuda.is_available are host metadata."""
    fs = findings_for(
        """
        import torch

        def f(x):
            if x.dtype == torch.int64 and torch.is_tensor(x):
                x = x + 1
            if torch.cuda.is_available():
                x = x * 2
            return x
        """,
        [TracedBranchPass],
        ctx=device_ctx("f"),
    )
    assert not active(fs, "TPU002")


# -- TPU003 dtype discipline ------------------------------------------------

_DTYPE_CTX = AnalysisContext(dtype_paths=("",))


def test_tpu003_fires_on_missing_dtype_and_float_literal():
    fs = findings_for(
        """
        import torch

        def build(n):
            a = torch.zeros(n)
            b = torch.full((n,), 0.5)
            c = torch.tensor([True])
            d = torch.empty(n, device="cpu")
            e = torch.arange(n)
            f = torch.ones(n)
            return a, b, c, d, e, f
        """,
        [DtypeDisciplinePass],
        ctx=_DTYPE_CTX,
    )
    hits = active(fs, "TPU003")
    assert len(hits) == 6
    assert any("float literal" in f.message for f in hits)


def test_tpu003_accepts_keyword_dtype():
    fs = findings_for(
        """
        import torch

        def build(n, x):
            a = torch.zeros(n, dtype=torch.int32)
            b = torch.full((n,), 0, dtype=torch.int64)
            c = torch.tensor([1], dtype=torch.int32)
            d = torch.zeros_like(x)
            e = torch.arange(n, dtype=x.dtype, device=x.device)
            return a, b, c, d, e
        """,
        [DtypeDisciplinePass],
        ctx=_DTYPE_CTX,
    )
    assert not active(fs, "TPU003")


def test_tpu003_fires_on_narrow_flattened_index():
    # a pod·node flattened index narrowed to int32 in the same expression
    # wraps silently at scale
    fs = findings_for(
        """
        import numpy as np
        import torch

        def flatten(pod_ids, node_ids, n):
            a = (pod_ids * n + node_ids).to(torch.int32)
            b = (pod_ids * n + node_ids).to(dtype=torch.int32)
            c = (pod_ids * n + node_ids).int()
            d = (pod_ids * n + node_ids).astype(np.int32)
            return a, b, c, d
        """,
        [DtypeDisciplinePass],
        ctx=_DTYPE_CTX,
    )
    hits = active(fs, "TPU003")
    assert len(hits) == 4  # .to positional, .to keyword, .int(), numpy astype
    assert all("flattened-index" in f.message for f in hits)


def test_tpu003_narrow_flatten_accepts_int64_and_float_scores():
    fs = findings_for(
        """
        import torch

        MAX_NODE_SCORE = 100

        def ok(pod_ids, node_ids, n, frac):
            wide = (pod_ids.to(torch.int64) * n + node_ids)
            narrow_named = wide.to(torch.int32)  # named, not inline
            score = ((1.0 - frac) * MAX_NODE_SCORE).to(torch.int32)
            ratio = (frac * MAX_NODE_SCORE / 2).to(torch.int32)
            widened = (pod_ids * n + node_ids).to(torch.int64)
            return narrow_named, score, ratio, widened
        """,
        [DtypeDisciplinePass],
        ctx=_DTYPE_CTX,
    )
    assert not active(fs, "TPU003")


def test_tpu003_scoped_to_configured_paths():
    fs = findings_for(
        "import torch\nx = torch.zeros(3)\n",
        [DtypeDisciplinePass],
        ctx=AnalysisContext(dtype_paths=("kubernetes_tpu_torch/ops/",)),
        filename="elsewhere.py",
    )
    assert not active(fs, "TPU003")


# -- LOCK001 lock discipline (the JAX package's fixtures) --------------------

_PREFIX_APPLY_FLIGHT = """
    class Scheduler:
        def __init__(self, cluster):
            self.cluster = cluster
            self._in_flight = {}  # ktpu: guarded-by(cluster.lock)
            self._session_stale = False  # ktpu: guarded-by(cluster.lock)

        def _apply_flight(self, flight):
            try:
                with self.cluster.lock:
                    self._in_flight.update(flight.infos)
            except Exception:
                # exception path: bookkeeping torn down WITHOUT the lock
                for info in flight.infos:
                    self._in_flight.pop(info.key, None)
                self._session_stale = True
                raise
"""

_LOCK001_OK = """
    class Scheduler:
        def __init__(self):
            self._seq = 0  # ktpu: guarded-by(_lock)

        def bump(self):
            with self._lock:
                self._seq += 1

        # watch callbacks fire under the lock: ktpu: holds(_lock)
        def on_event(self, ev):
            self._seq += 1
"""

_LOCK001_FREE = """
    class Scheduler:
        def __init__(self):
            self.counter = 0

        def bump(self):
            self.counter += 1
"""

_LOCK001_GAP = """
    class Scheduler:
        def __init__(self):
            self._in_flight = {}  # ktpu: guarded-by(cluster.lock)

        def _commit_all(self, infos):
            for info in infos:
                self._in_flight.pop(info.key, None)
"""


def test_lock001_catches_prefix_apply_flight_exception_path():
    fs = findings_for(_PREFIX_APPLY_FLIGHT, [LockDisciplinePass])
    hits = active(fs, "LOCK001")
    assert len(hits) == 2
    assert any("_in_flight" in f.message for f in hits)
    assert any("_session_stale" in f.message for f in hits)
    locked_line = next(
        i + 1
        for i, line in enumerate(_PREFIX_APPLY_FLIGHT.splitlines())
        if "update" in line
    )
    assert all(f.line > locked_line for f in hits)


def test_lock001_accepts_with_lock_and_holds_annotation():
    assert not active(findings_for(_LOCK001_OK, [LockDisciplinePass]), "LOCK001")


def test_lock001_unannotated_attrs_are_free():
    assert not active(findings_for(_LOCK001_FREE, [LockDisciplinePass]), "LOCK001")


def test_lock001_flags_real_scheduler_gap_when_annotations_stand():
    assert active(findings_for(_LOCK001_GAP, [LockDisciplinePass]), "LOCK001")


# -- MET001 metric names ----------------------------------------------------

_MET_ATTRS = {
    "solve_latency_seconds": "scheduler_tpu_solve_latency_seconds",
    "render": None,
}
_MET001_SRC = """
    from . import metrics

    def record():
        metrics.solve_latency_seconds.observe(1.0)
        metrics.solve_latency_sconds.observe(1.0)  # typo
        return "scheduler_tpu_solve_latency_secnds"  # typo
"""


def test_met001_fires_on_unknown_attr_and_series_string():
    ctx = AnalysisContext(metric_scan_paths=("",), metric_attrs=dict(_MET_ATTRS))
    hits = active(findings_for(_MET001_SRC, [MetricNamePass], ctx=ctx), "MET001")
    assert len(hits) == 2
    assert any("solve_latency_sconds" in f.message for f in hits)
    assert any("secnds" in f.message for f in hits)


def test_met001_shipped_registry_resolves_real_usage():
    """The port's metrics module exposes every series the scheduler
    records — including the pipeline fallback counter."""
    from kubernetes_tpu_torch.analysis.passes.metricnames import (
        load_metric_registry,
    )

    attrs = load_metric_registry()
    assert attrs["pipeline_fallback_total"] == "scheduler_pipeline_fallback_total"
    assert attrs["solves_discarded_total"] == "scheduler_tpu_solves_discarded_total"


# ===========================================================================
# -- project-wide rules over the cross-module call graph --------------------
# ===========================================================================


def project_findings(sources, project_passes, ctx=None):
    return analyze_sources(
        {name: textwrap.dedent(src) for name, src in sources.items()},
        ctx=ctx,
        project_passes=project_passes,
    )


# -- LOCK002 lock-order deadlocks -------------------------------------------

_LOCK_CYCLE = {
    "registry.py": """
        import threading
        from cache import Cache

        class Registry:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = {}

            def merge(self, cache: Cache):
                with self._lock:
                    cache.invalidate()
    """,
    "cache.py": """
        import threading
        from registry import Registry

        class Cache:
            def __init__(self, registry: Registry):
                self._lock = threading.Lock()
                self.registry = registry

            def invalidate(self):
                with self._lock:
                    pass

            def refresh(self):
                with self._lock:
                    self.registry.merge(self)
    """,
}

_LOCK_ORDERED = {
    "registry.py": """
        import threading
        from cache import Cache

        class Registry:
            def __init__(self):
                self._lock = threading.Lock()

            def merge(self, cache: Cache):
                with self._lock:
                    cache.invalidate()
    """,
    "cache.py": """
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()

            def invalidate(self):
                with self._lock:
                    pass
    """,
}

_LOCK_SELF = {
    "core.py": """
        import threading

        class Core:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """
}

_LOCK_RLOCK = {
    "core.py": """
        import threading

        class Core:
            def __init__(self):
                self.lock = threading.RLock()

            def outer(self):
                with self.lock:
                    self.inner()

            def inner(self):
                with self.lock:
                    pass
    """
}

_LOCK_HOLDS = {
    "a.py": """
        import threading

        class Cluster:
            def __init__(self):
                self.lock = threading.Lock()

        class Watcher:
            def __init__(self, cluster: Cluster):
                self.cluster = cluster
                self._lock = threading.Lock()

            # fires under the cluster lock: ktpu: holds(cluster.lock)
            def on_event(self):
                with self._lock:
                    pass

            def sweep(self):
                with self._lock:
                    with self.cluster.lock:
                        pass
    """
}


def test_lock002_detects_cross_module_cycle():
    fs = project_findings(_LOCK_CYCLE, [LockOrderPass])
    hits = active(fs, "LOCK002")
    assert any("cycle" in f.message for f in hits), [f.render() for f in fs]
    cycle = next(f for f in hits if "cycle" in f.message)
    assert "Registry._lock" in cycle.message
    assert "Cache._lock" in cycle.message


def test_lock002_consistent_order_is_clean_and_proves_an_order():
    fs = project_findings(_LOCK_ORDERED, [LockOrderPass])
    assert not active(fs, "LOCK002")
    from kubernetes_tpu_torch.analysis.passes.lockorder import get_analysis

    modules = [
        SourceModule.parse(n, source=textwrap.dedent(s))
        for n, s in sorted(_LOCK_ORDERED.items())
    ]
    result = get_analysis(build_project(modules, AnalysisContext()))
    assert not result.cycles()
    order = result.order()
    assert order.index("registry.py::Registry._lock") < order.index(
        "cache.py::Cache._lock"
    )


def test_lock002_self_deadlock_on_nonreentrant_lock():
    hits = active(project_findings(_LOCK_SELF, [LockOrderPass]), "LOCK002")
    assert len(hits) == 1
    assert "self-deadlock" in hits[0].message
    assert "re-acquires" in hits[0].message


def test_lock002_rlock_reentry_is_fine():
    assert not active(project_findings(_LOCK_RLOCK, [LockOrderPass]), "LOCK002")


def test_lock002_holds_annotation_contributes_edges():
    fs = project_findings(_LOCK_HOLDS, [LockOrderPass])
    hits = active(fs, "LOCK002")
    assert any("cycle" in f.message for f in hits), [f.render() for f in fs]


def test_lock002_artifact_is_current_at_head(head):
    """kubernetes_tpu_torch/analysis/LOCK_ORDER.md matches what the
    analyzer derives, and the order is cycle-free."""
    from kubernetes_tpu_torch.analysis.__main__ import LOCK_ORDER_PATH
    from kubernetes_tpu_torch.analysis.passes.lockorder import (
        get_analysis,
        lock_order_markdown,
    )

    project = build_project(head[0], default_context())
    assert not get_analysis(project).cycles()
    assert LOCK_ORDER_PATH == PORT / "analysis" / "LOCK_ORDER.md"
    assert LOCK_ORDER_PATH.read_text() == lock_order_markdown(project), (
        "analysis/LOCK_ORDER.md drifted — regenerate: "
        "python -m kubernetes_tpu_torch.analysis --write-lock-order"
    )


# locks only the port declares, each with its reason
PORT_ONLY_LOCKS = {
    # metrics/prom.py replaces prometheus_client, whose locks live outside
    # the JAX package's source
    "metrics/prom.py::CollectorRegistry._lock",
    "metrics/prom.py::_Cell._lock",
    "metrics/prom.py::_Metric._lock",
}


def _doc_table(text, header):
    rows, on = [], False
    for line in text.splitlines():
        if line.startswith("## "):
            on = line == header
        elif on and line.startswith("| ") and "`" in line:
            rows.append([c.strip().strip("`") for c in line.strip("|").split("|")])
    return rows


def test_lock_order_equals_the_reference_with_the_prefix_mapped(head):
    """The port's locks and acquired-while-holding edges are the JAX
    package's (docs/LOCK_ORDER.md) with kubernetes_tpu/ mapped to
    kubernetes_tpu_torch/, plus the locks named in PORT_ONLY_LOCKS; the
    shared locks come in the same order."""
    from kubernetes_tpu_torch.analysis.passes.lockorder import get_analysis

    doc = (ROOT / "docs" / "LOCK_ORDER.md").read_text()
    ref_order = [r[1].replace("kubernetes_tpu/", "", 1)
                 for r in _doc_table(doc, "## Order")]
    ref_edges = {(r[0].replace("kubernetes_tpu/", "", 1), r[1].replace("kubernetes_tpu/", "", 1))
                 for r in _doc_table(doc, "## Observed acquired-while-holding edges")}
    result = get_analysis(build_project(head[0], default_context()))
    strip = lambda lock: lock.replace("kubernetes_tpu_torch/", "", 1)  # noqa: E731
    port_order = [strip(x) for x in result.order()]
    assert set(port_order) == set(ref_order) | PORT_ONLY_LOCKS
    assert [x for x in port_order if x in set(ref_order)] == ref_order
    assert {(strip(a), strip(b)) for a, b in result.edges} == ref_edges


# -- FENCE001 epoch/role fence discipline -----------------------------------

_FENCE_BASE = """
    import threading

    class Hub:
        def __init__(self):
            self._lock = threading.Lock()
            self._rows = {{}}  # ktpu: replicated
            self._role = "standby"

        # ktpu: fence-check
        def _ensure_primary(self):
            if self._role != "primary":
                raise RuntimeError("deposed")

{methods}
"""


def fence_fixture(methods):
    return {
        "hub.py": _FENCE_BASE.format(
            methods=textwrap.indent(textwrap.dedent(methods), "        ")
        )
    }


_FENCE_UNFENCED = """
    def stage(self, key, row):
        with self._lock:
            self._rows[key] = row
"""
_FENCE_MUTATOR = """
    def wipe(self):
        self._rows.clear()
"""
_FENCE_DIRECT = """
    def stage(self, key, row):
        with self._lock:
            self._ensure_primary()
            self._rows[key] = row
"""
_FENCE_HELPER = """
    def _gate(self):
        self._ensure_primary()

    def stage(self, key, row):
        with self._lock:
            self._gate()
            self._rows[key] = row
"""
_FENCE_ANNOTATED = """
    # ktpu: fenced-by-caller
    def _stage_locked(self, key, row):
        self._rows[key] = row

    # ktpu: fence-exempt(replication apply path)
    def install(self, rows):
        self._rows = dict(rows)

    # ktpu: fence-exempt()
    def peek(self):
        return dict(self._rows)
"""
_FENCE_CROSS = {
    "base.py": """
        class Fenced:
            # ktpu: fence-check
            def _ensure_primary(self):
                raise RuntimeError
    """,
    "hub.py": """
        from base import Fenced

        class Hub(Fenced):
            def __init__(self):
                self._rows = {}  # ktpu: replicated

            def stage(self, key, row):
                self._ensure_primary()
                self._rows[key] = row

            def leak(self, key):
                return self._rows.get(key)
    """,
}


def test_fence001_fires_on_unfenced_write():
    hits = active(project_findings(fence_fixture(_FENCE_UNFENCED), [FencePass]), "FENCE001")
    assert len(hits) == 1
    assert "writes replicated state 'self._rows'" in hits[0].message


def test_fence001_mutator_call_counts_as_write():
    hits = active(project_findings(fence_fixture(_FENCE_MUTATOR), [FencePass]), "FENCE001")
    assert len(hits) == 1
    assert "writes" in hits[0].message


def test_fence001_direct_fence_call_satisfies():
    assert not active(project_findings(fence_fixture(_FENCE_DIRECT), [FencePass]), "FENCE001")


def test_fence001_fence_through_helper_satisfies():
    assert not active(project_findings(fence_fixture(_FENCE_HELPER), [FencePass]), "FENCE001")


def test_fence001_annotations_exempt_and_reasonless_exempt_fires():
    hits = active(project_findings(fence_fixture(_FENCE_ANNOTATED), [FencePass]), "FENCE001")
    assert len(hits) == 1
    assert "no reason" in hits[0].message


def test_fence001_cross_module_check_resolves():
    hits = active(project_findings(_FENCE_CROSS, [FencePass]), "FENCE001")
    assert len(hits) == 1
    assert "'Hub.leak' reads" in hits[0].message


# -- RETRY001 retry discipline ----------------------------------------------

_RETRY_SWALLOW = {
    "client.py": """
        class AdmitConflict(Exception):
            pass

        def admit(op):
            for attempt in range(5):
                try:
                    return op()
                except AdmitConflict:
                    continue
    """
}
_RETRY_RERAISE = {
    "client.py": """
        import random
        import time

        class AdmitConflict(Exception):
            pass

        def admit(op):
            for attempt in range(5):
                try:
                    return op()
                except AdmitConflict:
                    raise
                except IOError:
                    time.sleep(random.uniform(0, 0.1 * 2 ** attempt))
    """
}
_RETRY_HELPER = {
    "backoff.py": """
        import random
        import time

        def full_jitter(attempt):
            time.sleep(random.uniform(0, 0.1 * 2 ** attempt))
    """,
    "client.py": """
        from backoff import full_jitter

        def fetch(op):
            for attempt in range(5):
                try:
                    return op()
                except IOError:
                    full_jitter(attempt)
    """,
}
_RETRY_CONSTANT = {
    "client.py": """
        import time

        def fetch(op):
            while True:
                try:
                    return op()
                except IOError:
                    time.sleep(1.0)
    """
}
_RETRY_DRAIN = {
    "drain.py": """
        def flush(self):
            while self._sealed:
                try:
                    self._send_one()
                except IOError:
                    self._requeue()

        def broadcast(replicas, op):
            for replica in replicas:
                try:
                    op(replica)
                except IOError:
                    pass
    """
}


def test_retry001_swallowed_nonretryable_fires():
    hits = active(project_findings(_RETRY_SWALLOW, [RetryPass]), "RETRY001")
    assert any("AdmitConflict" in f.message for f in hits)
    assert any("backoff" in f.message for f in hits)


def test_retry001_reraise_is_the_sanctioned_idiom():
    assert not active(project_findings(_RETRY_RERAISE, [RetryPass]), "RETRY001")


def test_retry001_backoff_through_cross_module_helper():
    assert not active(project_findings(_RETRY_HELPER, [RetryPass]), "RETRY001")


def test_retry001_constant_sleep_is_not_backoff():
    hits = active(project_findings(_RETRY_CONSTANT, [RetryPass]), "RETRY001")
    assert len(hits) == 1
    assert "backoff" in hits[0].message


def test_retry001_work_drain_loops_are_out_of_scope():
    assert not active(project_findings(_RETRY_DRAIN, [RetryPass]), "RETRY001")


# -- TPU004 cross-module host-sync escape -----------------------------------


def test_tpu004_catches_cross_module_item():
    fs = project_findings(
        {
            "apply.py": """
                from readers import scalar_of

                # ktpu: hot
                def apply_assignments(batch):
                    return [scalar_of(x) for x in batch]
            """,
            "readers.py": """
                def scalar_of(x):
                    return x.item()
            """,
        },
        [CrossModuleSyncPass],
    )
    hits = active(fs, "TPU004")
    assert len(hits) == 1
    assert ".item() forces a host sync in 'scalar_of'" in hits[0].message
    assert "apply_assignments -> scalar_of" in hits[0].message


def test_tpu004_cold_barrier_stops_the_scope():
    fs = project_findings(
        {
            "apply.py": """
                from readers import debug_dump

                # ktpu: hot
                def apply_assignments(batch):
                    debug_dump(batch)
            """,
            "readers.py": """
                # ktpu: cold
                def debug_dump(batch):
                    return [x.item() for x in batch]
            """,
        },
        [CrossModuleSyncPass],
    )
    assert not active(fs, "TPU004")


def test_tpu004_typed_method_receiver_resolves():
    fs = project_findings(
        {
            "sched.py": """
                from store import Store

                class Scheduler:
                    def __init__(self, store: Store):
                        self.store = store

                    # ktpu: hot
                    def commit(self, row):
                        self.store.put(row)
            """,
            "store.py": """
                class Store:
                    def put(self, row):
                        self.total = row.cost.cpu()
            """,
        },
        [CrossModuleSyncPass],
    )
    hits = active(fs, "TPU004")
    assert len(hits) == 1
    assert "'Store.put'" in hits[0].message


def test_tpu004_device_root_reaches_across_modules_and_skips_tpu001s_own():
    """A device root's cross-module callee is in TPU004's scope; a sync in
    the root's own module is TPU001's finding and is not reported twice."""
    sources = {
        "launch.py": """
            from readers import exit_test

            def run(x):
                x.synchronize()
                return exit_test(x)
        """,
        "readers.py": """
            def exit_test(x):
                return x.tolist()
        """,
    }
    ctx = device_ctx("run", filename="launch.py")
    hits = active(project_findings(sources, [CrossModuleSyncPass], ctx=ctx), "TPU004")
    assert len(hits) == 1
    assert "'exit_test', reached from a device root via run -> exit_test" in hits[0].message


def test_tpu004_head_is_clean(head):
    assert not active(head[1], "TPU004")


# -- MET002 metrics registry <-> doc drift ----------------------------------

_MET2_REGISTRY = """
    from .prom import Counter, Gauge

    solves = Counter("scheduler_solves", "solve batches")
    depth = Gauge("scheduler_queue_depth", "queue depth")
"""


def met2_ctx(doc_text):
    return AnalysisContext(
        metrics_module_suffix="metrics.py",
        metrics_doc_text=textwrap.dedent(doc_text),
    )


def test_met002_clean_when_registry_matches_doc():
    fs = project_findings(
        {"metrics.py": _MET2_REGISTRY},
        [MetricsDocPass],
        ctx=met2_ctx(
            """
            | metric | help |
            |--------|------|
            | `scheduler_solves_total` | solve batches |
            | `scheduler_queue_depth` | queue depth |
            """
        ),
    )
    assert not active(fs, "MET002")


def test_met002_fires_both_ways():
    fs = project_findings(
        {"metrics.py": _MET2_REGISTRY},
        [MetricsDocPass],
        ctx=met2_ctx(
            """
            | metric | help |
            |--------|------|
            | `scheduler_solves_total` | solve batches |
            | `scheduler_ghost_seconds` | never registered |
            """
        ),
    )
    hits = active(fs, "MET002")
    assert len(hits) == 2
    missing = next(f for f in hits if "queue_depth" in f.message)
    assert "missing from docs/METRICS.md" in missing.message
    assert missing.path == "metrics.py"
    stale = next(f for f in hits if "ghost" in f.message)
    assert "not registered" in stale.message
    assert stale.path == "docs/METRICS.md"


def test_met002_counter_total_suffix_normalized():
    fs = project_findings(
        {"metrics.py": _MET2_REGISTRY},
        [MetricsDocPass],
        ctx=met2_ctx(
            """
            | `scheduler_solves` | wrong: raw registration name |
            | `scheduler_queue_depth` | queue depth |
            """
        ),
    )
    hits = active(fs, "MET002")
    assert any("scheduler_solves_total" in f.message for f in hits)
    assert any("'scheduler_solves' is not registered" in f.message for f in hits)


def test_met002_head_registry_matches_shipped_doc(head):
    """The port's registry is found by its path (the JAX package's
    analyzer misses it over the port) and matches docs/METRICS.md."""
    assert default_context().metrics_module_suffix == "kubernetes_tpu_torch/metrics/__init__.py"
    assert any(m.rel == "kubernetes_tpu_torch/metrics/__init__.py" for m in head[0])
    assert not active(head[1], "MET002")
    stale = dict(default_context().__dict__, metrics_doc_text="| `scheduler_ghost` | x |\n")
    fs = analysis.analyze_project(
        head[0], ctx=AnalysisContext(**stale), passes=(), project_passes=[MetricsDocPass]
    )
    assert len(active(fs, "MET002")) > 100  # every registered series, and the ghost


# -- suppression-debt ratchet -----------------------------------------------


def test_ratchet_holds_at_head(head):
    from kubernetes_tpu_torch.analysis.ratchet import (
        BASELINE_PATH,
        check_ratchet,
        count_suppressions,
        load_baseline,
    )

    assert BASELINE_PATH == PORT / "analysis" / "suppression_baseline.json"
    baseline = load_baseline()
    assert baseline is not None, (
        "missing analysis/suppression_baseline.json — write one: "
        "python -m kubernetes_tpu_torch.analysis --write-baseline"
    )
    counts = count_suppressions(head[0])
    assert not check_ratchet(counts, baseline)
    assert counts == baseline, "the committed baseline is current"


def test_ratchet_fails_on_growth_per_rule_and_total():
    from kubernetes_tpu_torch.analysis.ratchet import check_ratchet

    counts = {"total": 3, "rules": {"TPU001": 2, "FENCE001": 1}}
    msgs = check_ratchet(counts, {"total": 3, "rules": {"TPU001": 3, "FENCE001": 0}})
    assert any("FENCE001" in m for m in msgs)
    assert not any("total" in m and "grew" in m for m in msgs)
    msgs = check_ratchet(counts, {"total": 2, "rules": counts["rules"]})
    assert any("count grew" in m for m in msgs)
    assert not check_ratchet(counts, counts)


def test_missing_baseline_is_a_violation():
    from kubernetes_tpu_torch.analysis.ratchet import check_ratchet

    assert check_ratchet({"total": 0, "rules": {}}, None)


# -- SARIF + stable output --------------------------------------------------


def test_sarif_carries_suppressions_and_all_rules(head):
    import json

    from kubernetes_tpu_torch.analysis.sarif import render_sarif

    doc = json.loads(render_sarif(head[1]))
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "ktpu-analysis"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    for rid in ("LOCK002", "FENCE001", "RETRY001", "TPU004", "MET002"):
        assert rid in rule_ids
    suppressed = [r for r in run["results"] if r.get("suppressions")]
    assert suppressed, "suppressed findings must survive into SARIF"
    for r in suppressed:
        assert r["level"] == "warning"
        assert r["suppressions"][0]["justification"].strip()
    for r in run["results"]:
        if not r.get("suppressions"):
            assert r["level"] == "error"


def test_findings_are_stable_sorted(head):
    key = [(f.path, f.line, f.rule, f.message) for f in head[1]]
    assert key == sorted(key)


# ===========================================================================
# -- the port against the JAX package's analyzer ----------------------------
# ===========================================================================

_SHARED_MODULE_CASES = {
    "lock001_prefix_apply_flight": _PREFIX_APPLY_FLIGHT,
    "lock001_ok": _LOCK001_OK,
    "lock001_free": _LOCK001_FREE,
    "lock001_gap": _LOCK001_GAP,
    "met001": _MET001_SRC,
}
_SHARED_PROJECT_CASES = {
    "lock002_cycle": _LOCK_CYCLE,
    "lock002_ordered": _LOCK_ORDERED,
    "lock002_self": _LOCK_SELF,
    "lock002_rlock": _LOCK_RLOCK,
    "lock002_holds": _LOCK_HOLDS,
    "fence001_unfenced": fence_fixture(_FENCE_UNFENCED),
    "fence001_mutator": fence_fixture(_FENCE_MUTATOR),
    "fence001_direct": fence_fixture(_FENCE_DIRECT),
    "fence001_helper": fence_fixture(_FENCE_HELPER),
    "fence001_annotated": fence_fixture(_FENCE_ANNOTATED),
    "fence001_cross": _FENCE_CROSS,
    "retry001_swallow": _RETRY_SWALLOW,
    "retry001_reraise": _RETRY_RERAISE,
    "retry001_helper": _RETRY_HELPER,
    "retry001_constant": _RETRY_CONSTANT,
    "retry001_drain": _RETRY_DRAIN,
}
# the message text names each package's own metrics module
_RENAME = ("kubernetes_tpu_torch/", "kubernetes_tpu/")


def _comparable(findings):
    return [
        (f.rule, f.path, f.line, f.message.replace(*_RENAME), f.suppressed)
        for f in findings
    ]


@pytest.mark.parametrize("case", sorted(_SHARED_MODULE_CASES))
def test_parity_with_reference_on_module_rules(case):
    from kubernetes_tpu.analysis import AnalysisContext as RefContext
    from kubernetes_tpu.analysis.passes import LockDisciplinePass as RefLock
    from kubernetes_tpu.analysis.passes import MetricNamePass as RefMet

    src = textwrap.dedent(_SHARED_MODULE_CASES[case])
    kw = dict(metric_scan_paths=("",), metric_attrs=dict(_MET_ATTRS))
    ours = analyze_source(src, ctx=AnalysisContext(**kw),
                          passes=[LockDisciplinePass, MetricNamePass])
    theirs = ref_analysis.analyze_source(src, ctx=RefContext(**kw),
                                         passes=[RefLock, RefMet])
    assert _comparable(ours) == _comparable(theirs)
    assert case.endswith(("ok", "free")) or ours, "the case must produce findings"


@pytest.mark.parametrize("case", sorted(_SHARED_PROJECT_CASES))
def test_parity_with_reference_on_project_rules(case):
    from kubernetes_tpu.analysis.passes import FencePass as RefFence
    from kubernetes_tpu.analysis.passes import LockOrderPass as RefOrder
    from kubernetes_tpu.analysis.passes import RetryPass as RefRetry

    sources = {n: textwrap.dedent(s) for n, s in _SHARED_PROJECT_CASES[case].items()}
    ours = analyze_sources(sources, project_passes=[LockOrderPass, FencePass, RetryPass])
    theirs = ref_analysis.analyze_sources(
        sources, project_passes=[RefOrder, RefFence, RefRetry]
    )
    assert _comparable(ours) == _comparable(theirs)


# ===========================================================================
# -- the registry against the port's source ---------------------------------
# ===========================================================================


def _functions(rel):
    return set(ModuleGraph(SourceModule.parse(ROOT / rel)).functions)


@pytest.mark.parametrize(
    "pair",
    sorted(registry.SANCTIONED_SYNC_POINTS | registry.DEVICE_ROOTS),
    ids=lambda p: f"{p[0].split('/', 1)[1]}::{p[1]}",
)
def test_registry_entry_names_a_real_function(pair):
    rel, qual = pair
    assert (ROOT / rel).is_file(), rel
    assert qual in _functions(rel), f"{rel} has no function {qual}"


@pytest.mark.parametrize("prefix", registry.DTYPE_PATHS + registry.METRIC_SCAN_PATHS)
def test_registry_path_names_a_real_file_or_directory(prefix):
    p = ROOT / prefix
    assert p.is_dir() if prefix.endswith("/") else p.is_file(), prefix


def test_device_scope_reaches_the_solve_pipeline(head):
    """The device roots' scope holds the per-pod step, the grouped chunk,
    the ops it calls every step and the kernel's launch."""
    device, hot, _ = build_project(head[0], default_context()).global_scopes()
    names = {(r.split("/", 1)[1], q) for r, q in device}
    for want in [
        ("solver/exact.py", "_make_step.step"),
        ("solver/exact.py", "_mask_and_score"),
        ("solver/grouped.py", "fast_chunk"),
        ("ops/interpod.py", "filter_and_score_g"),
        ("ops/interpod.py", "node_totals_g"),
        ("ops/noderesources.py", "fit_mask"),
        ("ops/spread.py", "hard_violations_g"),
        ("ops/domain_counts.py", "Aggregation.__call__"),
        ("solver/evaluate.py", "_interpod"),
    ]:
        assert want in names, want


# the JAX package's seven jax.jit roots and seventeen hot roots, each
# with the port's counterpart, or None where the port has no copy (the
# per-step ops' counterparts are their shard-protocol generators, which
# the solve runs; the plain-named functions drive them on one shard)
JIT_ROOTS = {
    ("ops/pallas_kernels.py", "domain_counts_pallas"): ("ops/domain_counts.py", "domain_counts"),
    ("solver/evaluate.py", "_eval_jit"): ("solver/evaluate.py", "BatchEvaluator.evaluate_tensors"),
    ("solver/exact.py", "_run_packed"): ("solver/exact.py", "_Run.__call__"),
    ("solver/exact.py", "_heal"): ("solver/session.py", "_heal"),
    ("solver/preemption.py", "_preempt_scan"): ("solver/preemption.py", "_preempt_scan"),
    ("solver/relax.py", "_relax"): ("solver/relax.py", "_relax"),
    ("solver/single_shot.py", "_single_shot"): ("solver/single_shot.py", "_single_shot"),
}
HOT_ROOTS = {
    ("ops/fastmath.py", "floor_div_exact"): None,  # the port divides exactly
    ("ops/interpod.py", "domain_counts"): ("ops/interpod.py", "node_totals_g"),
    ("ops/interpod.py", "filter_and_score"): ("ops/interpod.py", "filter_and_score_g"),
    ("ops/interpod.py", "normalize"): ("ops/interpod.py", "normalize_g"),
    ("ops/noderesources.py", "balanced_allocation_score"):
        ("ops/noderesources.py", "balanced_allocation_score"),
    ("ops/noderesources.py", "fit_mask"): ("ops/noderesources.py", "fit_mask"),
    ("ops/noderesources.py", "least_allocated_score"):
        ("ops/noderesources.py", "least_allocated_score"),
    ("ops/noderesources.py", "most_allocated_score"):
        ("ops/noderesources.py", "most_allocated_score"),
    ("ops/noderesources.py", "rtc_score"): ("ops/noderesources.py", "rtc_score"),
    ("ops/spread.py", "hard_violations"): ("ops/spread.py", "hard_violations_g"),
    ("ops/spread.py", "soft_scores"): ("ops/spread.py", "soft_scores_g"),
    ("scheduler.py", "Scheduler._apply_flight"): ("scheduler.py", "Scheduler._apply_flight"),
    ("scheduler.py", "Scheduler._completion_loop"): ("scheduler.py", "Scheduler._completion_loop"),
    ("scheduler.py", "_InFlightSolve.assignments"): ("scheduler.py", "_InFlightSolve.assignments"),
    ("server/extender.py", "ExtenderCore._score_rows"):
        ("server/extender.py", "ExtenderCore._score_rows"),
    ("solver/exact.py", "DeferredAssignments.get"): ("solver/session.py", "DeferredAssignments.get"),
    ("solver/exact.py", "DeferredAssignments.wait"):
        ("solver/session.py", "DeferredAssignments.wait"),
}


def _roots(pkg, graph_cls, attr):
    out = set()
    for path in sorted((ROOT / pkg).rglob("*.py")):
        if "analysis" in path.parts:
            continue
        mod = (ref_analysis if pkg == "kubernetes_tpu" else analysis).SourceModule.parse(path)
        rel = str(path.relative_to(ROOT / pkg))
        out |= {(rel, q) for q in getattr(graph_cls(mod), attr)}
    return out


def test_every_reference_jit_root_has_a_port_device_root():
    assert _roots("kubernetes_tpu", RefModuleGraph, "_jit_roots") == set(JIT_ROOTS)
    port_roots = {(r.split("/", 1)[1], q) for r, q in registry.DEVICE_ROOTS}
    for ref, port in JIT_ROOTS.items():
        assert port in port_roots, (ref, port)


def test_every_reference_hot_root_has_a_port_hot_root():
    assert _roots("kubernetes_tpu", RefModuleGraph, "_hot_roots") == set(HOT_ROOTS)
    port_hot = _roots("kubernetes_tpu_torch", ModuleGraph, "_hot_roots")
    assert len(HOT_ROOTS) == 17 and len(port_hot) == 16
    assert port_hot == {p for p in HOT_ROOTS.values() if p is not None}
    assert not (PORT / "ops" / "fastmath.py").exists()
