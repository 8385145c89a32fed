"""The reader of grouped_graph_pct.spread5k on a fabricated registry: the
share of the spread chunks' loop iterations that replayed a CUDA graph of
the iteration, None where the run is not on the card, where the program has
no such counter (as a program that predates the quota iterations' graphs
has not) or where no spread chunk iterated."""

from types import SimpleNamespace

import pytest
import torch

from kubernetes_tpu_torch import metrics
from portbench import harness

METRIC = "grouped_graph_pct.spread5k"


def _ctx(device: str = "cuda"):
    return SimpleNamespace(run=SimpleNamespace(sched=SimpleNamespace(device=torch.device(device))))


def _by_kind(values: dict):
    return SimpleNamespace(labels=lambda kind: SimpleNamespace(value=lambda: values.get(kind, 0.0)))


@pytest.mark.parametrize("replays,iterations,expected", [
    ({"spread": 14_400.0, "anti": 30.0}, {"spread": 14_530.0, "plain": 90.0}, 99.10529938059188),
    ({"spread": 0.0}, {"spread": 352.0}, 0.0),
    ({"anti": 64.0}, {"spread": 22.0, "anti": 64.0}, 0.0),
    ({"spread": 22.0}, {"spread": 22.0}, 100.0),
])
def test_grouped_graph_pct(monkeypatch, replays, iterations, expected):
    monkeypatch.setattr(metrics, "solve_grouped_graph_replays_total", _by_kind(replays))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total", _by_kind(iterations))
    assert harness.load_reader(METRIC).read(_ctx()) == pytest.approx(expected)


def test_the_reader_is_silent_without_spread_iterations(monkeypatch):
    monkeypatch.setattr(metrics, "solve_grouped_graph_replays_total", _by_kind({"anti": 5.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total", _by_kind({"plain": 4.0}))
    assert harness.load_reader(METRIC).read(_ctx()) is None


@pytest.mark.parametrize("counter", ["solve_grouped_graph_replays_total",
                                     "solve_chunk_iterations_total"])
def test_the_reader_is_silent_without_the_counters(monkeypatch, counter):
    monkeypatch.delattr(metrics, counter)
    assert harness.load_reader(METRIC).read(_ctx()) is None


def test_the_reader_is_silent_off_the_card(monkeypatch):
    monkeypatch.setattr(metrics, "solve_grouped_graph_replays_total", _by_kind({"spread": 0.0}))
    monkeypatch.setattr(metrics, "solve_chunk_iterations_total", _by_kind({"spread": 352.0}))
    assert harness.load_reader(METRIC).read(_ctx("cpu")) is None


def test_the_metric_is_declared_for_the_spread_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert m == {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "solve", "moves": "pods_per_s", "workloads": ["spread5k.backlog"]}
    assert bench["per_layer"][-1] == m  # appended after the accepted entries
