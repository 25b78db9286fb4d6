"""The whole retrieval call's share of the card's peaks [%]: the products,
factorisations and solves, K2-mid and the fast K's least bytes, by need
(`rooflines/oem.py`), over the time per call outside the profiled slice."""

from mwrbench import traceread
from mwrbench.rooflines import bounds, oem


def read(ctx):
    return traceread.step_mfu_pct(
        ctx, bounds.all_of(oem.oem_call(ctx.workload, ctx.config)))
