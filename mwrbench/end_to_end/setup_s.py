"""Set-up [s]: from the process's start to the first timed call (imports,
the kernels' load or build, the inputs on the card, the warm-up)."""


def read(ctx):
    return ctx.setup_s
