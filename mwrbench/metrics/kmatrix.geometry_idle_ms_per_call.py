"""Device idle time [ms] per call of the traced slice while the host was in
`kmatrix.slant_geometry`: the float64 geometry the K entry dispatches op by
op (a part of kmatrix.glue_idle_ms_per_call)."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "kmatrix.slant_geometry")
