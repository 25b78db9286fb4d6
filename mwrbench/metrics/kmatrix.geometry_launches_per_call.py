"""Device operations per call of the traced slice launched with
`kmatrix.slant_geometry` the innermost program span: the launches of the K
entry's float64 geometry."""

from mwrbench import spanread


def read(ctx):
    return spanread.launches_per_call(ctx, "kmatrix.slant_geometry")
