"""Device idle time [ms] per call of the traced slice while the host was in
a `kmatrix.*` span of models.jacobians.kmatrix_batch_fast and in no `cuda.*`
span: the K entry's glue, the float64 slant geometry included."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "kmatrix.")
