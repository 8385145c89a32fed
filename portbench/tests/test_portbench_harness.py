"""Whole runs on the CPU at a small size: the result's schema, the rollout's
bound on live pods, the files found by name, and the check reading planted
faults and the controls as not correct. The benchmark itself refuses the CPU; these drive
``harness.run_cell`` past that look."""

import json

import pytest

from portbench import harness
from portbench.control import VARIANTS
from portbench.tests.small import run_small, small_cell

CHECKS = list(harness.LIMITS)


def test_result_line_schema_backlog():
    out = run_small("interpod5k.backlog")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}
    assert out["metrics"]["pods_per_s"]["unit"] == "pods/s" and out["metrics"]["pods_per_s"]["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(out["checks"]) == CHECKS
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.loads(json.dumps(out))
    assert all(line.startswith("check ") and "(limit 0)" in line for line in harness.check_lines(out))


def test_result_line_schema_traced():
    out = run_small("basic10k.backlog", trace=True)
    assert out["correct"] is True
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    allowed = {m["name"] for m in bench["per_layer"] if harness.applies(m, "basic10k.backlog")}
    assert set(out["metrics"]) <= allowed
    # the CPU has no device trace: only the program's own stage seconds read
    assert set(out["metrics"]) == {"tensorize_share.backlog", "commit_share.backlog", "solve_share.backlog"}
    assert "pods_per_s" not in out["metrics"] and "setup_s" not in out["metrics"]
    assert "busy_s" not in out["device"] and "breakdown" not in out


def test_a_rollout_never_holds_more_than_two_waves(monkeypatch):
    seen = []
    process = harness.load_process("waves")
    top_up = process.top_up

    def counting(self):
        top_up(self)
        seen.append((len(self.cs.list_pods()), self.pods.created))

    monkeypatch.setattr(process, "top_up", counting)
    monkeypatch.setattr(harness, "load_process", lambda name: process)
    out = run_small("basic10k.backlog", seconds=3.0, wave=256)
    assert out["correct"] is True
    # the stream ran past two whole waves, so deletes ran, and the live pods
    # never passed two waves' worth
    assert seen[-1][1] > 3 * 256 and max(n for n, _ in seen) <= 2 * 256


def test_files_are_found_by_name():
    assert harness.load_process("waves").__name__ == "Process"
    # a metric named <quantity>.<cells> reads with its quantity's reader
    assert harness.load_reader("tensorize_share.backlog").__file__.endswith("metrics/tensorize_share.py")
    assert harness.load_reader("domain_counts_roofline").__file__.endswith("metrics/domain_counts_roofline.py")


def test_fault_state_left_unchanged(monkeypatch):
    from kubernetes_tpu_torch.state import cache

    def add_pod(self, pod):
        self.pods[pod.key] = pod

    def remove_pod(self, key):
        return self.pods.pop(key)

    monkeypatch.setattr(cache.HostNodeInfo, "add_pod", add_pod)
    monkeypatch.setattr(cache.HostNodeInfo, "remove_pod", remove_pod)
    out = run_small("interpod5k.backlog")
    assert out["correct"] is False
    assert out["checks"]["readback_mismatches"]["value"] > 0


def test_fault_half_of_each_batch_left_out(monkeypatch):
    from kubernetes_tpu_torch.scheduler import Scheduler

    orig = Scheduler.run_pipelined

    def halved(self, *a, **k):
        results = orig(self, *a, **k)
        for r in results:
            del r.scheduled[len(r.scheduled) // 2:]
        return results

    monkeypatch.setattr(Scheduler, "run_pipelined", halved)
    out = run_small("interpod5k.backlog")
    assert out["correct"] is False
    assert out["checks"]["readback_mismatches"]["value"] > 0


def test_fault_answer_altered_where_it_is_produced(monkeypatch):
    from kubernetes_tpu_torch.state.cluster import ClusterState

    orig = ClusterState.bind

    def moved(self, namespace, name, node_name, fence=None):
        names = sorted(self._nodes)
        return orig(self, namespace, name, names[(names.index(node_name) + 1) % len(names)], fence)

    monkeypatch.setattr(ClusterState, "bind", moved)
    out = run_small("interpod5k.backlog")
    assert out["correct"] is False
    assert out["checks"]["readback_mismatches"]["value"] > 0


@pytest.mark.parametrize("variant,correct", [
    ("most_allocated", False),
    ("no_filters", False),
    # upstream's widths: k pods take k/40 of a node's cpu and 125k/8192 of
    # its memory, so BalancedAllocation's 100 - 3990k/8192 lies at least
    # 1/8192 off a whole number; float32 errs by under 1e-5 and truncates
    # alike: the lower precision moves no answer here (PERF.md)
    ("float32", True),
])
def test_controls(variant, correct):
    out = run_small("interpod5k.backlog", solver_overrides=VARIANTS[variant])
    assert out["correct"] is correct
    if variant == "most_allocated":
        assert out["checks"]["score_gap"]["value"] > 0
    if variant == "no_filters":
        assert out["checks"]["infeasible_binds"]["value"] > 0


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    from portbench import run

    assert run.main(["--workload", "interpod5k.backlog", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", "interpod5k.backlog",
                        "--seed", "3", "--seconds", "3", "--trace", "1"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and "breakdown" in out
