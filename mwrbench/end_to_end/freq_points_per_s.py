"""Profile x frequency points of the monochromatic spectrum completed in
the window (folded with the channels' SRFs), over its seconds, in
millions."""


def read(ctx):
    n = ctx.work.get("freq_points")
    return None if n is None else n / ctx.window_s * 1e-6
