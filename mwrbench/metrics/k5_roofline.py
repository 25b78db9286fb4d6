"""K5a + K5b's share of their roofline [%] in the K-matrix: both bounds by need
over the device time of the kmatrix kernels in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds

SYMBOLS = ("kmatrix_kernel",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, bounds.kmatrix_call(ctx.workload, ctx.config)["k5"])
