"""Device operations per call of the traced slice launched with a `fastk.*`
program span innermost: the launches of the fast operator's closed-form K."""

from mwrbench import spanread


def read(ctx):
    return spanread.launches_per_call(ctx, "fastk.")
