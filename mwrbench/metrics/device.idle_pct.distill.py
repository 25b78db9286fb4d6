"""The share [%] of the traced slice of the distillation cell in which no
operation ran on the device."""

from mwrbench import traceread


def read(ctx):
    return traceread.idle_pct(ctx)
