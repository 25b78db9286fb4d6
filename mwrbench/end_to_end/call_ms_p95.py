"""The 95th percentile [ms] of the latency of every call in the window,
each from its issue to the device synchronise that ends it (host clock)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s), 95.0)) * 1e3
