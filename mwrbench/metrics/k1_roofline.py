"""K1's share of its roofline [%] in forward_batch: its bound by need (frozen
counts, published peaks) over its device time in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds

SYMBOLS = ("absorption_points_kernel",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, bounds.lbl_call(ctx.workload, ctx.config)["k1"])
