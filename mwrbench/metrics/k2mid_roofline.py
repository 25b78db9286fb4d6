"""K2 with `alpha_is_mid` (the fast forward's RTE on layer-mean extinction)
as a share of its roofline [%] in the retrieval: its bound by need, one
launch a pass, over the device time of the downwelling kernels in the traced
slice."""

from mwrbench import traceread
from mwrbench.rooflines import oem

SYMBOLS = ("downwelling",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, oem.oem_call(ctx.workload, ctx.config)["k2mid"])
