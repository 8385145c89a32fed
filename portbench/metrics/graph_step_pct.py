"""Solve (solver/graphs.py): the share of the scan's steps that replayed a
CUDA graph of the step, 100 x scheduler_solve_graph_replays_total over
scheduler_solve_steps_total{kind="scan_steps"}, both read from the
program's registry, so that the two count the same batches (the whole run,
as the StageProfiler folds them once a batch). None where the program has
no such counter, or the scan took no step."""


def read(ctx):
    from kubernetes_tpu_torch import metrics

    replays = getattr(metrics, "solve_graph_replays_total", None)
    steps = getattr(metrics, "solve_steps_total", None)
    if replays is None or steps is None:
        return None
    n = steps.labels("scan_steps").value()
    if not n:
        return None
    return 100.0 * replays.value() / n
