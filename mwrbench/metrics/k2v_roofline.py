"""K2v (`rte_vjp_kernel`, the backward of K2 on layer-mean extinction) as a
share of its roofline [%] in the distillation: its bound by need
(`rooflines/distill.py::k2v_roofline`), one launch a training step, over
the device time of the kernel in the traced slice.  None where the step
launches no such kernel (the plain path)."""

from mwrbench import traceread
from mwrbench.rooflines import distill

SYMBOLS = ("rte_vjp_kernel",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, distill.distill_call(ctx.workload, ctx.config)["k2v"])
