"""Solve (solver/graphs.py): the share of the anti chunks' loop iterations
that replayed a CUDA graph of the iteration,
100 x scheduler_solve_grouped_graph_replays_total{kind="anti"} over
scheduler_solve_chunk_iterations_total{kind="anti"}, both read from the
program's registry (the whole run, as the StageProfiler folds them once a
batch). None where the run is not on the card (graphs are captured there
alone), where the program has no such counters, or where no anti chunk
iterated."""


def read(ctx):
    from kubernetes_tpu_torch import metrics

    if getattr(getattr(ctx.run.sched, "device", None), "type", None) != "cuda":
        return None
    replays = getattr(metrics, "solve_grouped_graph_replays_total", None)
    iterations = getattr(metrics, "solve_chunk_iterations_total", None)
    if replays is None or iterations is None:
        return None
    n = iterations.labels("anti").value()
    if not n:
        return None
    return 100.0 * replays.labels("anti").value() / n
