"""Device idle time [ms] per call of the traced slice while the host was in
a `spectral.*` span (forward_spectral's layouts, slant geometry and chunks,
and srf_convolve) and in no `cuda.*` span."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "spectral.")
