"""Kernel (ops/domain_counts.py, csrc/domain_counts.cu): the least time of the
domain aggregations the pods bound in the traced slice need, as a share of
the device time of the kernels below in that slice. The least time is
bytes at the card's bandwidth, counted by portbench/roofline.py from the
configuration's node count, each pod's term rows and the domain counts, not
from the program's launches."""

from portbench import roofline

KERNELS = ("domain_counts_kernel",)


def read(ctx):
    s = ctx.slice
    if not s or not ctx.slice_pods:
        return None
    device_s = sum(v for k, v in s["device_s_by_name"].items() if any(n in k for n in KERNELS))
    need = sum(roofline.domain_aggregation_bytes(p, ctx.config) for p in ctx.slice_pods)
    if device_s <= 0 or need <= 0:
        return None
    return 100.0 * roofline.least_seconds(need) / device_s
