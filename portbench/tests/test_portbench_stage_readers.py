"""The readers of the program's own stages (enqueue, upload, issue, card_read,
gc) on a fabricated ``harness.Context``: the value each gives from the
window's StageProfiler seconds, and None where the program has no such
stage, as a program that predates the stage has not."""

from types import SimpleNamespace

import pytest

from portbench import harness

WINDOW = {"t0": 100.0, "t1": 150.0}  # a 50 s window
STAGES = {"tensorize": 5.0, "dispatch": 20.0, "upload": 2.5, "prepare": 1.0, "issue": 15.0,
          "card_read": 0.5, "enqueue": 4.0, "gc": 3.0}
BOUND = 20_000


def _ctx(stages: dict, bound: int = BOUND) -> harness.Context:
    run = SimpleNamespace(cell={"name": "basic10k.backlog"}, config={}, extra={}, slice=None,
                          slice_keys=[], pods={}, bound_in_window=bound)
    return harness.Context(run, WINDOW, stages)


CASES = [
    ("enqueue_share.backlog", "enqueue", 100.0 * 4.0 / 50.0),
    ("upload_share.backlog", "upload", 100.0 * 2.5 / 50.0),
    ("issue_us_per_pod.backlog", "issue", 1e6 * 15.0 / BOUND),
    ("card_read_share.backlog", "card_read", 100.0 * 0.5 / 50.0),
    ("gc_share.backlog", "gc", 100.0 * 3.0 / 50.0),
]


@pytest.mark.parametrize("metric,stage,expected", CASES)
def test_reader_reads_its_stage(metric, stage, expected):
    assert harness.load_reader(metric).read(_ctx(STAGES)) == pytest.approx(expected)


@pytest.mark.parametrize("metric,stage,expected", CASES)
def test_reader_is_silent_without_its_stage(metric, stage, expected):
    without = {k: v for k, v in STAGES.items() if k != stage}
    assert harness.load_reader(metric).read(_ctx(without)) is None
    # the profiler off: no stage at all
    assert harness.load_reader(metric).read(_ctx({})) is None


def test_issue_per_pod_is_silent_with_no_pod_bound():
    assert harness.load_reader("issue_us_per_pod.backlog").read(_ctx(STAGES, bound=0)) is None


def test_each_new_metric_is_declared_for_the_cells_that_have_its_stage():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, _, _ in CASES:
        m = entries[metric]
        assert m["moves"] == "pods_per_s" and m["better"] == "lower"
    assert entries["card_read_share.backlog"]["workloads"] == ["basic10k.backlog"]
    assert entries["gc_share.backlog"]["source"] == "program_counter"
    assert entries["issue_us_per_pod.backlog"]["unit"] == "us/pod"


def test_a_traced_cpu_run_reads_every_program_stage_share():
    """A whole traced run on the CPU at a small size: the program's stages
    exist there, so each reader of a stage reads, beside the three shares
    the benchmark had; only the device trace's metrics stay silent."""
    from portbench.tests.small import run_small

    out = run_small("basic10k.backlog", trace=True)
    assert out["correct"] is True
    assert set(out["metrics"]) == {
        "tensorize_share.backlog", "commit_share.backlog", "solve_share.backlog",
        "enqueue_share.backlog", "upload_share.backlog", "issue_us_per_pod.backlog",
        "card_read_share.backlog", "gc_share.backlog"}
    shares = {k: v["value"] for k, v in out["metrics"].items()}
    # the solve's parts sit inside the solve's share
    assert shares["upload_share.backlog"] + shares["card_read_share.backlog"] < shares["solve_share.backlog"]
    assert out["metrics"]["issue_us_per_pod.backlog"]["unit"] == "us/pod"
