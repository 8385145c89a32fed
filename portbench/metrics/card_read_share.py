"""Solve (solver/grouped.py _read_placed, through the solver's timed read):
the StageProfiler's card_read seconds, the blocking device-to-host reads
inside the solve's issue, as a share of the window's wall. None where the
program has no such stage."""


def read(ctx):
    if "card_read" not in ctx.stage_s:
        return None
    return 100.0 * ctx.stage_s["card_read"] / ctx.window_s
