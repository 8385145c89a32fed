"""A small metric registry with the surface of ``prometheus_client`` that
the scheduler's modules use, so the port needs no third-party package.

``Counter``, ``Gauge`` and ``Histogram`` take the same constructor
arguments as ``prometheus_client``'s (name, documentation, label names,
``registry=``, ``buckets=``). A labelled metric hands out one child per
label tuple through ``labels(...)``; an unlabelled one is its own child.
Children count with ``inc`` / ``dec`` / ``set`` / ``observe``; a counter or
gauge child reads back with ``value()`` (and through ``_value.get()``, the
internal read the copied modules use), a histogram child with ``count()``
and ``sum()``. ``generate_latest(registry)`` renders the Prometheus text
exposition format (version 0.0.4).
"""

from __future__ import annotations

import math
import threading

_INF = float("inf")


class _Cell:
    """One float guarded by a lock (``prometheus_client``'s value class)."""

    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class CollectorRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if metric._name in self._metrics:
                raise ValueError(f"duplicated metric name: {metric._name}")
            self._metrics[metric._name] = metric

    def collect(self) -> list["_Metric"]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> "_Metric | None":
        with self._lock:
            return self._metrics.get(name)


class _Metric:
    _type = ""

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames=(),
        registry: CollectorRegistry | None = None,
        buckets=None,
        _labelvalues: tuple = (),
    ) -> None:
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._labelvalues = _labelvalues
        self._buckets = self._bucket_bounds(buckets)
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Metric] = {}
        if not self._labelnames or self._labelvalues:
            self._init_value()
        if registry is not None and not self._labelvalues:
            registry.register(self)

    @staticmethod
    def _bucket_bounds(buckets):
        return None

    def _init_value(self) -> None:
        self._value = _Cell()

    def _is_parent(self) -> bool:
        return bool(self._labelnames) and not self._labelvalues

    def labels(self, *values, **kwvalues) -> "_Metric":
        if not self._is_parent():
            raise ValueError(f"{self._name} has no labels")
        if kwvalues:
            if values:
                raise ValueError("pass label values by position or by name")
            values = tuple(kwvalues[n] for n in self._labelnames)
        if len(values) != len(self._labelnames):
            raise ValueError(
                f"{self._name} takes {len(self._labelnames)} label values, "
                f"got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._metrics.get(key)
            if child is None:
                child = type(self)(
                    self._name, self._documentation, self._labelnames,
                    buckets=self._buckets, _labelvalues=key,
                )
                self._metrics[key] = child
            return child

    def _check_child(self) -> None:
        if self._is_parent():
            raise ValueError(f"{self._name} is labelled: call labels() first")

    def children(self) -> list[tuple[tuple, "_Metric"]]:
        """(label values, child) pairs; one pair ``((), self)`` when the
        metric has no labels."""
        if not self._is_parent():
            return [((), self)]
        with self._lock:
            return sorted(self._metrics.items())

    def value(self) -> float:
        self._check_child()
        return self._value.get()


class Counter(_Metric):
    """A counter's name is kept without its ``_total`` suffix, which the
    exposition adds back (as ``prometheus_client`` does)."""

    _type = "counter"

    def __init__(self, name: str, *args, **kwargs) -> None:
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(name, *args, **kwargs)

    def inc(self, amount: float = 1) -> None:
        self._check_child()
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        self._value.inc(amount)


class Gauge(_Metric):
    _type = "gauge"

    def inc(self, amount: float = 1) -> None:
        self._check_child()
        self._value.inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._check_child()
        self._value.inc(-amount)

    def set(self, value: float) -> None:
        self._check_child()
        self._value.set(value)


_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    7.5, 10.0,
)


class Histogram(_Metric):
    _type = "histogram"

    @staticmethod
    def _bucket_bounds(buckets):
        bounds = [float(b) for b in (buckets or _DEFAULT_BUCKETS)]
        if bounds != sorted(bounds):
            raise ValueError("buckets not in sorted order")
        if not bounds or bounds[-1] != _INF:
            bounds.append(_INF)
        return tuple(bounds)

    def _init_value(self) -> None:
        self._sum = _Cell()
        self._counts = [_Cell() for _ in self._buckets]

    def observe(self, amount: float) -> None:
        self._check_child()
        self._sum.inc(amount)
        for bound, cell in zip(self._buckets, self._counts):
            if amount <= bound:
                cell.inc(1)
                break

    def count(self) -> float:
        self._check_child()
        return sum(c.get() for c in self._counts)

    def sum(self) -> float:
        self._check_child()
        return self._sum.get()

    def value(self) -> float:
        return self.count()


def _fmt(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(names, values, extra: tuple = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{n}="{_escape(v)}"' for n, v in pairs) + "}"


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry in the Prometheus text exposition format."""
    lines: list[str] = []
    for m in registry.collect():
        base = m._name
        doc = m._documentation.replace("\\", "\\\\").replace("\n", "\\n")
        # prometheus_client names a counter's family by its sample name
        family = f"{base}_total" if m._type == "counter" else base
        lines.append(f"# HELP {family} {doc}")
        lines.append(f"# TYPE {family} {m._type}")
        for values, child in m.children():
            if m._type == "counter":
                lines.append(
                    f"{base}_total{_labels(m._labelnames, values)} "
                    f"{_fmt(child._value.get())}"
                )
            elif m._type == "gauge":
                lines.append(
                    f"{base}{_labels(m._labelnames, values)} "
                    f"{_fmt(child._value.get())}"
                )
            else:
                acc = 0.0
                for bound, cell in zip(child._buckets, child._counts):
                    acc += cell.get()
                    lines.append(
                        f"{base}_bucket"
                        f"{_labels(m._labelnames, values, (('le', _fmt(bound)),))} "
                        f"{_fmt(acc)}"
                    )
                lines.append(
                    f"{base}_count{_labels(m._labelnames, values)} {_fmt(acc)}"
                )
                lines.append(
                    f"{base}_sum{_labels(m._labelnames, values)} "
                    f"{_fmt(child._sum.get())}"
                )
    return ("\n".join(lines) + "\n").encode()
