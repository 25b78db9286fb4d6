"""Device idle time [ms] per call of the spectral cell's traced slice while
the host was in a `cuda.*` span: inside the wrappers of K6 and K3."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, spanread.WRAPPER)
