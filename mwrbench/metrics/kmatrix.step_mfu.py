"""The whole K-matrix call's share of the card's peaks [%]: K4 + K5a + K5b by
need (the frozen counts) over the time per call outside the profiled slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds


def read(ctx):
    return traceread.step_mfu_pct(
        ctx, bounds.all_of(bounds.kmatrix_call(ctx.workload, ctx.config)))
