"""Scheduler host layer (scheduler.py _apply_group, _commit_all): the
StageProfiler's validate, apply and bind seconds as a share of the window's
wall."""


def read(ctx):
    return ctx.stage_share("validate", "apply", "bind")
