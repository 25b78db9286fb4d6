"""Device idle time [ms] per call of the traced slice while the host was in
a `fastk.*` span: the fast operator's closed-form K
(models.jacobians.kmatrix_fast_adjoint_batch), plain torch op by op."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "fastk.")
