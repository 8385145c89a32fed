"""The reader of fused_step_pct.backlog on a fabricated registry: the share
of the scan's steps that ran in one launch of the fused step kernel, None
where the scan took no step, and None where the program has no such
counter, as a program that predates the fused step has not."""

from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch import metrics
from portbench import harness

METRIC = "fused_step_pct.backlog"


def _counter(v):
    return SimpleNamespace(value=lambda: v)


def _steps(scan):
    return SimpleNamespace(labels=lambda kind: _counter(scan if kind == "scan_steps" else 7.0))


@pytest.mark.parametrize("fused,scan,expected", [
    (1020.0, 1024.0, 99.609375),
    (0.0, 512.0, 0.0),
    (4096.0, 4096.0, 100.0),
])
def test_reader_reads_the_share_of_fused_steps(monkeypatch, fused, scan, expected):
    monkeypatch.setattr(metrics, "solve_fused_scan_steps_total", _counter(fused), raising=False)
    monkeypatch.setattr(metrics, "solve_steps_total", _steps(scan))
    assert harness.load_reader(METRIC).read(None) == pytest.approx(expected)


def test_reader_is_silent_where_the_scan_took_no_step(monkeypatch):
    monkeypatch.setattr(metrics, "solve_fused_scan_steps_total", _counter(0.0), raising=False)
    monkeypatch.setattr(metrics, "solve_steps_total", _steps(0.0))
    assert harness.load_reader(METRIC).read(None) is None


@pytest.mark.parametrize("counter", ["solve_fused_scan_steps_total", "solve_steps_total"])
def test_reader_is_silent_without_the_counters(monkeypatch, counter):
    monkeypatch.delattr(metrics, counter, raising=False)
    assert harness.load_reader(METRIC).read(None) is None


def test_the_metric_is_declared_for_the_scan_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert m == {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "solve", "moves": "pods_per_s", "workloads": ["interpod5k.backlog"]}
