"""Solve: device launches in the traced slice (every device event but copies
and fills, as chip_rates.py counts them) per pod bound in it."""


def read(ctx):
    s = ctx.slice
    if not s or not s["pods"]:
        return None
    return s["launches"] / s["pods"]
