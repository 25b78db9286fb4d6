"""Molecular-oxygen absorption (Rosenkranz 60-GHz complex), in torch.

Term for term the JAX package's `ops/absorption/o2.py`: per-release line
tables with first-order (R98/R03/R16/R17) or second-order (R19/R20/R24)
line mixing, the nonresonant Debye term, and the clamp at zero.
"""

import torch

from ...constants.o2_lines import O2_MODELS, O2Model
from ..tensors import promote


def o2_absorption(f_ghz, p_hpa, t_k, rho_gm3,
                  model: O2Model = O2_MODELS["R98"]):
    """O2 absorption [Np/km], clipped at zero (mixing can drive band wings
    slightly negative); broadcast shape of the inputs."""
    f, p, t, rho = (a[..., None] for a in promote(f_ghz, p_hpa, t_k, rho_gm3))

    def tab(a):
        return torch.as_tensor(a, dtype=f.dtype, device=f.device)

    f0, s300, be, w300, y0, y1 = (tab(getattr(model, k)) for k in
                                  ("f", "s300", "be", "w300", "y0", "y1"))

    th = 300.0 / t
    th1 = th - 1.0
    b = th ** model.x
    preswv = rho * t / 217.0
    presda = p - preswv
    den = 0.001 * (presda * b + model.h2o_factor * preswv * th)
    pe2 = den * den

    # Nonresonant Debye (pressure-induced) term.
    dfnr = model.wb300 * den
    f_ = f[..., 0]
    nonres = (model.nonres_coeff * f_ * f_ * dfnr[..., 0]
              / (th[..., 0] * (f_ * f_ + dfnr[..., 0] * dfnr[..., 0])))

    df = w300 * den
    ybase = 0.001 * p * b if model.mixing_basis == "p" else den
    y = ybase * (y0 + y1 * th1)
    strength = s300 * torch.exp(-be * th1)

    if model.has_second_order:
        g0, g1, dnu0, dnu1 = (tab(getattr(model, k)) for k in
                              ("g0", "g1", "dnu0", "dnu1"))
        gfac = 1.0 + pe2 * (g0 + g1 * th1)
        dnu = pe2 * (dnu0 + dnu1 * th1)
    else:
        gfac = 1.0
        dnu = 0.0

    # The pressure shift moves the line centre of both halves.
    d1 = f - f0 - dnu
    d2 = f + f0 + dnu
    sf1 = (df * gfac + d1 * y) / (d1 * d1 + df * df)
    sf2 = (df * gfac - d2 * y) / (d2 * d2 + df * df)
    line_sum = torch.sum(strength * (sf1 + sf2) * (f / f0) ** 2, dim=-1)

    total = nonres + line_sum
    alpha = model.scale * total * presda[..., 0] * th[..., 0] ** 3
    return torch.clamp_min(alpha, 0.0)
