"""Solve (solver/grouped.py): the share of the grouped path's chunk pods that
anti chunks (kind 3, a quota of one pod an empty domain) placed, 100 x
scheduler_solve_chunk_pods_total{kind="anti"} over the same counter summed
over every kind, read from the program's registry (the whole run, as the
StageProfiler folds it once a batch). None where the program has no such
counter, or no chunk held a pod."""

KINDS = ("slow", "plain", "spread", "anti")


def read(ctx):
    from kubernetes_tpu_torch import metrics

    pods = getattr(metrics, "solve_chunk_pods_total", None)
    if pods is None:
        return None
    total = sum(pods.labels(k).value() for k in KINDS)
    if not total:
        return None
    return 100.0 * pods.labels("anti").value() / total
