"""Device idle time [ms] per call of the traced slice while the host was in
an `lbl.*` span of models.lbl.forward_batch and in no `cuda.*` kernel-wrapper
span: the LBL entry's own glue (layouts, refractive index, output permutes)."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "lbl.")
