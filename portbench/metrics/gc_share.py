"""Host process: the StageProfiler's gc seconds, the interpreter's
collector pauses (the program's gc.callbacks entry), as a share of the
window's wall. None where the program has no such stage."""


def read(ctx):
    if "gc" not in ctx.stage_s:
        return None
    return 100.0 * ctx.stage_s["gc"] / ctx.window_s
