"""Solve (solver/exact.py ExactSolver.solve): the StageProfiler's upload
seconds, the session's sync and heals, the class tables and the batch and
pod rows put on the card, as a share of the window's wall. None where the
program has no such stage."""


def read(ctx):
    if "upload" not in ctx.stage_s:
        return None
    return 100.0 * ctx.stage_s["upload"] / ctx.window_s
