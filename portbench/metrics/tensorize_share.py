"""Scheduler host layer (scheduler.py _tensorize_group, tensorize/*): the
StageProfiler's tensorize seconds as a share of the window's wall."""


def read(ctx):
    return ctx.stage_share("tensorize")
