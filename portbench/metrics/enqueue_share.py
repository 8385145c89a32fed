"""Ingest (scheduler.py _on_event, _ingest_event): the StageProfiler's
enqueue seconds, the watch handler timed on every event (the waves' creates
and deletes, and the bind confirmations), as a share of the window's wall.
None where the program has no such stage."""


def read(ctx):
    if "enqueue" not in ctx.stage_s:
        return None
    return 100.0 * ctx.stage_s["enqueue"] / ctx.window_s
