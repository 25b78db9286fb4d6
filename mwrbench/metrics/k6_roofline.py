"""K6's share of its roofline [%] in the spectrum: every chunk's bound by need
over the device time of its state and main passes in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds

SYMBOLS = ("line_state_kernel", "spectral_kernel")


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, bounds.spectral_call(ctx.workload, ctx.config)["k6"])
