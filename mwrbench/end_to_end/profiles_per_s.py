"""Profiles whose whole K-matrix was completed in the window, over its
seconds."""


def read(ctx):
    n = ctx.work.get("profiles")
    return None if n is None else n / ctx.window_s
