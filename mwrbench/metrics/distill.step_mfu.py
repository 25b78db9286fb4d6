"""The whole training step's share of the card's peaks [%]: the forward
product, K2 on layer-mean extinction, K2v and the backward product, by need
(`rooflines/distill.py`), over the time per call outside the profiled
slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds, distill


def read(ctx):
    return traceread.step_mfu_pct(
        ctx, bounds.all_of(distill.distill_call(ctx.workload, ctx.config)))
