"""K2's share of its roofline [%] in forward_batch: its bound by need over the
device time of the downwelling kernels in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds

SYMBOLS = ("downwelling",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, bounds.lbl_call(ctx.workload, ctx.config)["k2"])
