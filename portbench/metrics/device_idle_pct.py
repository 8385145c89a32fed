"""Device: the share of the traced slice's wall in which no operation ran on
the card (torch.profiler's device events, their union taken)."""


def read(ctx):
    s = ctx.slice
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (s["window_s"] - s["busy_s"]) / s["window_s"]
