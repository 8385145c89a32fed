"""The reader of ``graph_step_pct.backlog`` on a fabricated registry: the
share of the scan's steps that replayed a CUDA graph, None where the scan
took no step, and None where the program has no such counter, as a program
that predates the step graphs has not."""

from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch import metrics
from portbench import harness

METRIC = "graph_step_pct.backlog"


def _counter(v):
    return SimpleNamespace(value=lambda: v)


def _steps(scan):
    return SimpleNamespace(labels=lambda kind: _counter(scan if kind == "scan_steps" else 7.0))


@pytest.mark.parametrize("replays,scan,expected", [
    (990.0, 1000.0, 99.0),
    (0.0, 512.0, 0.0),
    (4096.0, 4096.0, 100.0),
])
def test_reader_reads_the_share_of_replayed_steps(monkeypatch, replays, scan, expected):
    monkeypatch.setattr(metrics, "solve_graph_replays_total", _counter(replays))
    monkeypatch.setattr(metrics, "solve_steps_total", _steps(scan))
    assert harness.load_reader(METRIC).read(None) == pytest.approx(expected)


def test_reader_is_silent_where_the_scan_took_no_step(monkeypatch):
    monkeypatch.setattr(metrics, "solve_graph_replays_total", _counter(0.0))
    monkeypatch.setattr(metrics, "solve_steps_total", _steps(0.0))
    assert harness.load_reader(METRIC).read(None) is None


def test_reader_is_silent_without_the_counter(monkeypatch):
    monkeypatch.delattr(metrics, "solve_graph_replays_total")
    assert harness.load_reader(METRIC).read(None) is None


def test_the_metric_is_declared_for_the_scan_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    m = {e["name"]: e for e in bench["per_layer"]}[METRIC]
    assert m == {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "solve", "moves": "pods_per_s", "workloads": ["interpod5k.backlog"]}
    # appended after the accepted entries of its time, before spread5k's
    assert [e["name"] for e in bench["per_layer"]].index(METRIC) == 11
