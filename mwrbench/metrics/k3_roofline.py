"""K3's share of its roofline [%] in the spectrum: every chunk's bound by need
over the device time of the downwelling kernels in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds

SYMBOLS = ("downwelling",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, bounds.spectral_call(ctx.workload, ctx.config)["k3"])
