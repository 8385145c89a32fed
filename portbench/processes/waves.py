"""``waves``: a rolling rollout over the stream of waves.

Each loop call takes ``batches_per_call`` batches. Before a call, when the
queue holds no more than that many pods, the stream's next pods are created,
as many as a call takes, and as many of the pods two waves back are
deleted, position for position: wave ``w`` replaces wave ``w - 2`` a chunk
at a time, as a Deployment's rolling update replaces an old revision, and
the cluster never holds more than two waves' pods. Creates, deletes and the
session heals they cause are measured work, spread evenly over the
window, so that how far a run gets does not decide how much of its window
went to them.
"""

from __future__ import annotations

import time

from portbench.harness import Run


class Process(Run):
    def warmup(self) -> None:
        self.chunk = self.per_call * self.batch
        self.top_ups: list[float] = []
        self.top_up()
        self.call(int(self.params["warmup_batches"]), False)
        self.top_ups.clear()

    def top_up(self) -> None:
        t = time.perf_counter()
        start = self.pods.created
        self.create(self.chunk)
        old = start - 2 * self.traffic.wave_pods
        if old + self.chunk > 0:
            self.delete(max(old, 0), old + self.chunk)
        if self.t1 is None:
            self.top_ups.append(time.perf_counter() - t)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds and not self.closing(now):
                break
            if self.sched.pending <= self.chunk:
                self.top_up()
            self.call(self.per_call, self.t1 is None)
        t1 = self.t1
        self.extra["top-ups in the window"] = (
            f"{len(self.top_ups)} of {self.chunk} pods, {sum(self.top_ups):.3f} s creating and deleting; "
            f"the stream reached wave {(self.pods.created - 1) // self.traffic.wave_pods}")
        return {"t0": t0, "t1": t1, "attempted": self.attempted_in_window,
                "failed": self.failed_in_window,
                "e2e": {"pods_per_s": self.bound_in_window / (t1 - t0)}}
