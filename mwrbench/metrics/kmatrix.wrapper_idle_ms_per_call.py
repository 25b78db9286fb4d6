"""Device idle time [ms] per call of the kmatrix cell's traced slice while the
host was in a `cuda.*` span: inside the wrappers of K4, K5a and K5b."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, spanread.WRAPPER)
