"""Device operations (kernels, copies, sets) per call of
models.retrieval.retrieve_batch, from the traced slice: the host's
launches."""

from mwrbench import traceread


def read(ctx):
    return traceread.launches_per_call(ctx)
