"""Device idle time [ms] per call of the lbl cell's traced slice while the host
was in a `cuda.*` span: inside the ctypes wrappers of K1 and K2."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, spanread.WRAPPER)
