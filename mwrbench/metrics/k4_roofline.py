"""K4's share of its roofline [%] in the K-matrix: its bound by need over its
device time in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds

SYMBOLS = ("absorption_tangents_kernel",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, bounds.kmatrix_call(ctx.workload, ctx.config)["k4"])
