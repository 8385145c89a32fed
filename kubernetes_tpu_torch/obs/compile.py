"""Compile observability: make the port's kernel builds visible per
dispatch scope, so a build on the hot path shows up in metrics and on the
dispatch span instead of only in a wall-clock mystery.

The JAX package counts XLA compilations through ``jax.monitoring``. The
port has no XLA: the one thing it compiles on the card's path is the
``nvcc`` build of ``csrc/*.cu`` in ``build.py``, at first use of each
kernel. So ``install`` hooks ``build.BUILD_LISTENERS``, and every build
counts as one compile (and one retrace) with its ``nvcc`` seconds.
Attribution is the JAX package's: the scheduler brackets each solver
dispatch with ``CompileWatcher.scope(key)`` — ``key`` is the dispatch's
shape/static fingerprint — and any build firing inside the bracket counts
against that key; builds outside any bracket count under ``"other"``.

Exported under the JAX package's series names: the gauge pair
``scheduler_xla_compile_cache_keys`` and ``scheduler_xla_recompilations``
(compiles beyond the first per scope), plus the raw
``scheduler_xla_compilations_total`` /
``scheduler_xla_compile_seconds_total`` counters.

Ported from ``kubernetes_tpu/obs/compile.py``.
"""

from __future__ import annotations

import threading

from .. import metrics

OTHER_SCOPE = "other"


class CompileWatcher:
    """Process-wide compile counter with scope attribution. All state
    is lock-guarded: compiles fire on whichever thread dispatched."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        # scope key -> [compiles, retraces, seconds]
        self.by_scope: dict[str, list] = {}
        self.compiles = 0
        self.retraces = 0
        self.compile_seconds = 0.0
        self._installed = False

    # -- scope bracketing --

    def scope(self, key: str):
        return _Scope(self, key)

    def _current(self) -> str:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else OTHER_SCOPE

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- the build listener --

    def _on_build(self, name: str, seconds: float) -> None:
        with self._lock:
            self.compiles += 1
            self.retraces += 1
            self.compile_seconds += seconds
            row = self.by_scope.setdefault(self._current(), [0, 0, 0.0])
            row[0] += 1
            row[1] += 1
            row[2] += seconds
        metrics.xla_compilations_total.inc()
        metrics.xla_compile_seconds_total.inc(seconds)
        self._export()

    def _export(self) -> None:
        with self._lock:
            keys = len(self.by_scope)
            compiled = sum(r[0] for r in self.by_scope.values())
            known = sum(1 for r in self.by_scope.values() if r[0])
        metrics.xla_compile_cache_keys.set(keys)
        # recompilations = compiles beyond the first per scope: a
        # steady-state loop re-paying a compile for a shape it already
        # compiled is exactly the silent hot-path killer
        metrics.xla_recompilations.set(max(compiled - known, 0))

    def install(self) -> None:
        """Register the build listener once (idempotent)."""
        with self._lock:
            if self._installed:
                return
            self._installed = True
        from .. import build

        build.BUILD_LISTENERS.append(self._on_build)

    # -- reads (tests, spans, /debug) --

    def totals(self) -> tuple[int, int, float]:
        with self._lock:
            return self.compiles, self.retraces, self.compile_seconds

    def scope_counts(self) -> dict[str, tuple]:
        with self._lock:
            return {k: tuple(v) for k, v in self.by_scope.items()}


class _Scope:
    __slots__ = ("_w", "_key", "compiles0", "seconds0")

    def __init__(self, watcher: CompileWatcher, key: str) -> None:
        self._w = watcher
        self._key = key
        self.compiles0 = 0
        self.seconds0 = 0.0

    def __enter__(self) -> "_Scope":
        self._w._stack().append(self._key)
        self.compiles0, _, self.seconds0 = self._w.totals()
        return self

    def __exit__(self, *exc) -> bool:
        stack = self._w._stack()
        if stack and stack[-1] == self._key:
            stack.pop()
        return False

    def delta(self) -> tuple[int, float]:
        """(compiles, seconds) attributed since __enter__ — the
        dispatch span's attribution read."""
        c, _, s = self._w.totals()
        return c - self.compiles0, s - self.seconds0


WATCHER = CompileWatcher()
