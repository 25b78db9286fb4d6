"""The whole spectrum call's share of the card's peaks [%]: every chunk's K6 +
K3 by need (the frozen counts) over the time per call outside the profiled
slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds


def read(ctx):
    return traceread.step_mfu_pct(
        ctx, bounds.all_of(bounds.spectral_call(ctx.workload, ctx.config)))
