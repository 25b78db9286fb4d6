"""Water-vapor absorption (Rosenkranz line-by-line + continuum), in torch.

Term for term the JAX package's `ops/absorption/h2o.py`: Van Vleck-Weisskopf
resonances with Clough's 750-GHz local-line cutoff, the quadratic
speed-dependent (qSD) near term of the R19SD/R20SD releases, and the
foreign/self continuum.  Inputs broadcast; the line sum runs over an internal
trailing axis.
"""

import numpy as np
import scipy.special
import torch

from ...constants.h2o_lines import H2O_MODELS, H2OModel
from ..tensors import promote

# 16-node generalized Gauss-Laguerre rule (alpha = 1/2): the qSD profile is
# (2/sqrt(pi)) * sum_i w_i / (C + G2*x_i) on these nodes.  The JAX module
# hard-codes the same numbers; they are recomputed here so the port does not
# import it.
_GL_X, _gl_w = scipy.special.roots_genlaguerre(16, 0.5)
_GL_W = _gl_w * (2.0 / np.sqrt(np.pi))


def _qsd_resonance(df, gamma0, gamma2):
    """pi x quadratic-speed-dependent Lorentzian at detuning df [GHz].

    Reduces to gamma0/(df^2+gamma0^2) as gamma2 -> 0.
    """
    x = torch.as_tensor(_GL_X, dtype=gamma0.dtype, device=gamma0.device)
    w = torch.as_tensor(_GL_W, dtype=gamma0.dtype, device=gamma0.device)
    cr = (gamma0 - 1.5 * gamma2)[..., None] + gamma2[..., None] * x
    ci = df[..., None]
    return torch.sum(w * cr / (cr * cr + ci * ci), dim=-1)


def h2o_absorption(f_ghz, p_hpa, t_k, rho_gm3,
                   model: H2OModel = H2O_MODELS["R98"]):
    """Water-vapor absorption [Np/km] at frequency f [GHz], pressure p [hPa],
    temperature T [K] and vapor density rho [g/m^3]; broadcast shape."""
    f, p, t, rho = (a[..., None] for a in promote(f_ghz, p_hpa, t_k, rho_gm3))

    def tab(a):
        return torch.as_tensor(a, dtype=f.dtype, device=f.device)

    fl, s1, b2, w3, x, ws, xs = (tab(getattr(model, k)) for k in
                                 ("fl", "s1", "b2", "w3", "x", "ws", "xs"))

    ti = 300.0 / t
    pvap = rho * t / 217.0  # vapor partial pressure [hPa]
    pda = p - pvap          # dry-air partial pressure [hPa]
    den = 3.344e16 * rho
    ti2 = ti ** 2.5

    width = w3 * pda * ti ** x + ws * pvap * ti ** xs
    wsq = width * width
    s = s1 * ti2 * torch.exp(b2 * (1.0 - ti))

    df1 = f - fl
    df2 = f + fl
    base = width / (model.cutoff_ghz ** 2 + wsq)  # Clough local-line base
    near1 = width / (df1 * df1 + wsq)
    if model.has_sd:
        gamma2 = (tab(model.w2) * pda * ti ** x
                  + tab(model.ws2) * pvap * ti ** xs)
        sd_mask = torch.as_tensor((model.w2 != 0.0) | (model.ws2 != 0.0),
                                  device=f.device)
        near1 = torch.where(sd_mask, _qsd_resonance(df1, width, gamma2), near1)
    res = (torch.where(torch.abs(df1) < model.cutoff_ghz, near1 - base, 0.0)
           + torch.where(torch.abs(df2) < model.cutoff_ghz,
                         width / (df2 * df2 + wsq) - base, 0.0))
    line_sum = torch.sum(s * res * (f / fl) ** 2, dim=-1)

    ti_, f_, pvap_, pda_ = ti[..., 0], f[..., 0], pvap[..., 0], pda[..., 0]
    con = (model.cf * ti_ ** model.xcf * pda_
           + model.cs * ti_ ** model.xcs * pvap_) * pvap_ * f_ * f_
    return 0.3183e-4 * den[..., 0] * line_sum + con
