"""Solve (solver/grouped.py): iterations of the grouped loop per anti chunk,
scheduler_solve_chunk_iterations_total{kind="anti"} over
scheduler_solve_chunks_total{kind="anti"}, read from the program's registry
(the whole run, as the StageProfiler folds it once a batch). In random mode
each iteration ends in one blocking card read. None where the program has no
such counters, or no anti chunk ran."""


def read(ctx):
    from kubernetes_tpu_torch import metrics

    chunks = getattr(metrics, "solve_chunks_total", None)
    iterations = getattr(metrics, "solve_chunk_iterations_total", None)
    if chunks is None or iterations is None:
        return None
    n = chunks.labels("anti").value()
    if not n:
        return None
    return iterations.labels("anti").value() / n
