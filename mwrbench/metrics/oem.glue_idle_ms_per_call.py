"""Device idle time [ms] per call of the traced slice while the host was in
an `oem.*` span of models.retrieval.retrieve_batch and in no `fast.*`,
`fastk.*` or `cuda.*` span: the retrieval's own glue (the prior, the state's
chain rule, the products, factorisations and solves, the cost and the
choice of state, the DFS)."""

from mwrbench import spanread


def read(ctx):
    return spanread.idle_ms_per_call(ctx, "oem.")
