"""Device operations (kernels, copies, sets) per call of
models.fast.train_step, the distillation's training step, from the traced
slice: the host's launches for the forward, the loss, the backward and the
optimizer."""

from mwrbench import traceread


def read(ctx):
    return traceread.launches_per_call(ctx)
