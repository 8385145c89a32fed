"""Solve (solver/graphs.py, timed by solver/timing.py): the StageProfiler's
capture seconds, the CUDA graph captures of the scan's steps and of the
quota chunks' iterations (nested in the solve's issue), as a share of the
window's wall. None where the program has no such stage."""


def read(ctx):
    if "capture" not in ctx.stage_s:
        return None
    return 100.0 * ctx.stage_s["capture"] / ctx.window_s
