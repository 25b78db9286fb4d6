"""LBL spectra completed in the window over its seconds.  A spectrum is one
(profile, elevation, absorption release) -> the channels' TBs."""


def read(ctx):
    n = ctx.work.get("spectra")
    return None if n is None else n / ctx.window_s
