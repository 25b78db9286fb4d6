"""The device time [ms] of one forward_stage call: the union of its
kernels' and copies' intervals in the traced slice, per call."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return ctx.trace.busy_s / ctx.trace.calls * 1e3
