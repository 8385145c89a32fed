"""Solve (ops/scan_step.py): the share of the scan's steps that ran in one
launch of the fused step kernel, 100 x scheduler_solve_fused_scan_steps_total
over scheduler_solve_steps_total{kind="scan_steps"}, both read from the
program's registry, so that the two count the same batches (the whole run,
as the StageProfiler folds them once a batch). None where the program has
no such counter, as a program that predates the fused step has not, or the
scan took no step."""


def read(ctx):
    from kubernetes_tpu_torch import metrics

    fused = getattr(metrics, "solve_fused_scan_steps_total", None)
    steps = getattr(metrics, "solve_steps_total", None)
    if fused is None or steps is None:
        return None
    n = steps.labels("scan_steps").value()
    if not n:
        return None
    return 100.0 * fused.value() / n
