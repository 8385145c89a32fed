"""The window's device trace: the card's busy seconds are the union of the
device intervals the profiler recorded, and an untraced run profiles its
window only in a cell with an end-to-end metric of the device trace."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import harness, trace


def _event(start: int, end: int, device=DeviceType.CUDA, name: str = "k"):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                           device_type=lambda: device)


def _stopped(events) -> trace.WindowTrace:
    wt = trace.WindowTrace(SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None)))
    wt.prof = SimpleNamespace(stop=lambda: None,
                              profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    wt.stop()
    return wt


def test_busy_time_is_the_union_of_the_device_intervals():
    wt = _stopped([_event(1_000, 1_010), _event(1_005, 1_020), _event(1_030, 1_040),
                   _event(900, 2_000, device=DeviceType.CPU)])
    assert wt.events == 3 and wt.prof is None
    assert wt.busy_s == 30 / 1e9


def test_no_device_event_reads_nothing():
    wt = _stopped([_event(0, 5, device=DeviceType.CPU)])
    assert wt.events == 0 and wt.busy_s is None


def test_only_the_spread_cell_profiles_its_window():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    profiled = [w["name"] for w in bench["workloads"]
                if any(m["source"] == "device_trace" and harness.applies(m, w["name"])
                       for m in bench["end_to_end"])]
    assert profiled == ["spread5k.backlog"]


def test_the_profiler_start_is_timed(monkeypatch):
    import time

    import torch.profiler

    class SlowStart:
        def __init__(self, activities):
            self.activities = activities

        def start(self):
            time.sleep(0.05)

    monkeypatch.setattr(torch.profiler, "profile", SlowStart)
    wt = trace.WindowTrace(SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None)))
    wt.start()
    assert wt.start_s >= 0.05 and isinstance(wt.prof, SlowStart)
