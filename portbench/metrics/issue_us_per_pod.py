"""Solve (solver/exact.py _Run.__call__, _solve_chain): the StageProfiler's
issue seconds, the host's issue of the scan's steps or the grouped loop's
chunks and iterations, in microseconds per pod bound in the window. None
where the program has no such stage, or no pod was bound."""


def read(ctx):
    if "issue" not in ctx.stage_s or not ctx.run.bound_in_window:
        return None
    return 1e6 * ctx.stage_s["issue"] / ctx.run.bound_in_window
