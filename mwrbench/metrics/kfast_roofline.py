"""The fast-K kernel (`fastk_adjoint_kernel`, the fast operator's RTE
adjoint and assembly) as a share of its roofline [%] in the retrieval: the
fast K's least bytes, one pass a Gauss-Newton step and one at the prior,
over the device time of the kernel in the traced slice."""

from mwrbench import traceread
from mwrbench.rooflines import oem

SYMBOLS = ("fastk_adjoint_kernel",)


def read(ctx):
    return traceread.roofline_pct(
        ctx, SYMBOLS, oem.oem_call(ctx.workload, ctx.config)["fastk"])
