"""Device idle time [ms] per call of the traced slice while the host was in
a `fast.*` span and in no `cuda.*` span: the fast operator's forward
(models.fast.fast_forward_batch) outside its K2 launch, once a step."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "fast.")
