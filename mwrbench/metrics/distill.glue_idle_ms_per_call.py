"""Device idle time [ms] per call of the traced slice while the host was in
a `distill.*` span of models.fast.train_step (the step, the loss, the
backward, the optimizer) or a `fast.*` span of the fast forward inside it,
and in no `cuda.*` span: the training step's own glue.  None where the
program has no `distill.*` span."""

from mwrbench import spanread


def read(ctx):
    spans = spanread.of(ctx)
    if spans is None or not any(n.startswith("distill.")
                                for n in spans.names):
        return None
    idle = spans.idle_under("distill.") + spans.idle_under("fast.")
    return 1e3 * idle / spans.calls
