"""Ozone absorption (pure-rotational lines, VVW shape), in torch."""

import torch

from ...constants import o3_lines
from ..tensors import promote


def o3_absorption(f_ghz, p_hpa, t_k, o3_ppmv, lines=o3_lines):
    """Ozone absorption [Np/km] at f [GHz], p [hPa], T [K] and O3 [ppmv];
    `lines` holds the line table (O3_FL, O3_S1, O3_B2, O3_W3, O3_X)."""
    f, p, t, q = (a[..., None] for a in promote(f_ghz, p_hpa, t_k, o3_ppmv))

    def tab(a):
        return torch.as_tensor(a, dtype=f.dtype, device=f.device)

    fl, s1, b2, w3, x = (tab(a) for a in (lines.O3_FL, lines.O3_S1,
                                          lines.O3_B2, lines.O3_W3,
                                          lines.O3_X))
    ti = 300.0 / t
    # O3 number density [molec/cm^3]: n = 7.2429e18 * p/T * q*1e-6.
    den = 7.2429e12 * p * q / t

    width = w3 * p * ti ** x
    wsq = width * width
    s = s1 * ti ** 2.5 * torch.exp(b2 * (1.0 - ti))

    df1 = f - fl
    df2 = f + fl
    res = width / (df1 * df1 + wsq) + width / (df2 * df2 + wsq)
    line_sum = torch.sum(s * res * (f / fl) ** 2, dim=-1)
    return 0.3183e-4 * den[..., 0] * line_sum
