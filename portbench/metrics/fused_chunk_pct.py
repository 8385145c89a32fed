"""Solve (ops/grouped_spread.py): the share of the spread chunks whose whole
random loop ran in one launch of the fused kernel,
100 x scheduler_solve_fused_chunks_total{kind="spread"} over
scheduler_solve_chunks_total{kind="spread"}, both read from the program's
registry (the whole run, as the StageProfiler folds them once a batch).
None where the run is not on the card (the kernel runs there alone), where
the program has no such counters, or where no spread chunk ran."""


def read(ctx):
    from kubernetes_tpu_torch import metrics

    if getattr(getattr(ctx.run.sched, "device", None), "type", None) != "cuda":
        return None
    fused = getattr(metrics, "solve_fused_chunks_total", None)
    chunks = getattr(metrics, "solve_chunks_total", None)
    if fused is None or chunks is None:
        return None
    n = chunks.labels("spread").value()
    if not n:
        return None
    return 100.0 * fused.labels("spread").value() / n
