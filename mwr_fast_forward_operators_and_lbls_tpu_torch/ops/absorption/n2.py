"""Dry-air (N2-dominated collision-induced) continuum absorption, in torch."""

from ..tensors import promote


def n2_absorption(f_ghz, p_hpa, t_k, variant: str = "R98"):
    """Collision-induced dry continuum [Np/km] (Rosenkranz `absn2`).

    R98 and R03:  alpha = 6.4e-14 * p^2 * f^2 * theta^3.55
    R16 onwards:  alpha = 6.5e-14 * fdep * p^2 * f^2 * theta^3.6,
                  fdep = 0.5 + 0.5/(1+(f/450)^2)

    p is the *dry-air* partial pressure [hPa]; callers pass p - e.
    """
    f, p, t = promote(f_ghz, p_hpa, t_k)
    th = 300.0 / t
    if variant in ("R98", "R03"):
        return 6.4e-14 * p * p * f * f * th ** 3.55
    fdep = 0.5 + 0.5 / (1.0 + (f / 450.0) ** 2)
    return 6.5e-14 * fdep * p * p * f * f * th ** 3.6
