"""K2 with `alpha_is_mid` (the training step's forward RTE on layer-mean
extinction) as a share of its roofline [%] in the distillation: its bound
by need (`rooflines/distill.py`, `counts`' K2 count on layer means), one
launch a training step, over the device time of the downwelling kernels in
the traced slice.  None where the step launches no such kernel (the plain
path)."""

from mwrbench import traceread
from mwrbench.rooflines import distill

SYMBOLS = ("downwelling",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, distill.distill_call(ctx.workload, ctx.config)["k2mid"])
