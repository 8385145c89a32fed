"""Solve (solver/exact.py, solver/grouped.py): the StageProfiler's dispatch
and deferred-read seconds as a share of the window's wall."""


def read(ctx):
    return ctx.stage_share("dispatch", "deferred_read")
