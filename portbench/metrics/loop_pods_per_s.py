"""Loop and queue: pods bound per second of the window, counted as the
end-to-end ``pods_per_s`` counts them (the window's bindings over its
seconds), here in a traced run, with the StageProfiler and the span
wrappers on; for a cell whose own end-to-end metric is another."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.run.bound_in_window:
        return None
    return ctx.run.bound_in_window / ctx.window_s
