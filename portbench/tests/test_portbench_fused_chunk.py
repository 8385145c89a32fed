"""The reader of fused_chunk_pct.spread5k on a fabricated registry: the share
of the spread chunks whose whole random loop ran in one launch of the fused
kernel, None where the run is not on the card, where the program has no such
counter (as a program that predates the fused loop has not) or where no
spread chunk ran."""

from types import SimpleNamespace

import pytest
import torch

from kubernetes_tpu_torch import metrics
from portbench import harness

METRIC = "fused_chunk_pct.spread5k"


def _ctx(device: str = "cuda"):
    return SimpleNamespace(run=SimpleNamespace(sched=SimpleNamespace(device=torch.device(device))))


def _by_kind(values: dict):
    return SimpleNamespace(labels=lambda kind: SimpleNamespace(value=lambda: values.get(kind, 0.0)))


@pytest.mark.parametrize("fused,chunks,expected", [
    ({"spread": 640.0}, {"spread": 640.0, "slow": 3.0}, 100.0),
    ({"spread": 636.0}, {"spread": 640.0}, 99.375),
    ({}, {"spread": 640.0}, 0.0),
])
def test_fused_chunk_pct(monkeypatch, fused, chunks, expected):
    monkeypatch.setattr(metrics, "solve_fused_chunks_total", _by_kind(fused))
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind(chunks))
    assert harness.load_reader(METRIC).read(_ctx()) == pytest.approx(expected)


def test_the_reader_is_silent_without_spread_chunks(monkeypatch):
    monkeypatch.setattr(metrics, "solve_fused_chunks_total", _by_kind({}))
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind({"plain": 40.0}))
    assert harness.load_reader(METRIC).read(_ctx()) is None


@pytest.mark.parametrize("counter", ["solve_fused_chunks_total", "solve_chunks_total"])
def test_the_reader_is_silent_without_the_counters(monkeypatch, counter):
    monkeypatch.delattr(metrics, counter)
    assert harness.load_reader(METRIC).read(_ctx()) is None


def test_the_reader_is_silent_off_the_card(monkeypatch):
    monkeypatch.setattr(metrics, "solve_fused_chunks_total", _by_kind({"spread": 4.0}))
    monkeypatch.setattr(metrics, "solve_chunks_total", _by_kind({"spread": 4.0}))
    assert harness.load_reader(METRIC).read(_ctx("cpu")) is None


def test_the_metric_is_declared_for_the_spread_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert m == {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "solve", "moves": "card_us_per_pod",
                 "workloads": ["spread5k.backlog"]}
