"""The plain physics of the LBL forward operator, in the dtype it is given.

A frozen copy of the port's plain torch path (its `ops/absorption`,
`ops/thermo`, `ops/geometry` and `ops/rte`) with the imports rewritten to
this folder's tables.  One change: every function computes in the dtype of
its inputs, with no float32 floor, so the same code gives the float64
reference and the lower-precision control.

Levels are on the LAST axis everywhere (ground -> top); the line sums run
over one more trailing axis, as in the port's plain path.
"""

import numpy as np
import scipy.special
import torch

from . import physics_constants as phys
from .h2o_lines import H2O_MODELS, H2OModel
from .o2_lines import O2_MODELS, O2Model

# 16-node generalized Gauss-Laguerre rule (alpha = 1/2) of the qSD profile.
_GL_X, _gl_w = scipy.special.roots_genlaguerre(16, 0.5)
_GL_W = _gl_w * (2.0 / np.sqrt(np.pi))

# Rueeger (2002) 'best average' refractivity coefficients
_K1, _K2, _K3 = 77.6890, 71.2952, 375463.0


def _tab(a, like):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                           device=like.device)


# ---- absorption [Np/km] ----------------------------------------------------

def _qsd_resonance(df, gamma0, gamma2):
    x, w = _tab(_GL_X, gamma0), _tab(_GL_W, gamma0)
    cr = (gamma0 - 1.5 * gamma2)[..., None] + gamma2[..., None] * x
    ci = df[..., None]
    return torch.sum(w * cr / (cr * cr + ci * ci), dim=-1)


def h2o_absorption(f, p, t, rho, model: H2OModel):
    f, p, t, rho = (a[..., None] for a in (f, p, t, rho))
    fl, s1, b2, w3, x, ws, xs = (_tab(getattr(model, k), f) for k in
                                 ("fl", "s1", "b2", "w3", "x", "ws", "xs"))
    ti = 300.0 / t
    pvap = rho * t / 217.0
    pda = p - pvap
    den = 3.344e16 * rho
    ti2 = ti ** 2.5
    width = w3 * pda * ti ** x + ws * pvap * ti ** xs
    wsq = width * width
    s = s1 * ti2 * torch.exp(b2 * (1.0 - ti))
    df1 = f - fl
    df2 = f + fl
    base = width / (model.cutoff_ghz ** 2 + wsq)
    near1 = width / (df1 * df1 + wsq)
    if model.has_sd:
        gamma2 = (_tab(model.w2, f) * pda * ti ** x
                  + _tab(model.ws2, f) * pvap * ti ** xs)
        sd_mask = torch.as_tensor((model.w2 != 0.0) | (model.ws2 != 0.0),
                                  device=f.device)
        near1 = torch.where(sd_mask, _qsd_resonance(df1, width, gamma2),
                            near1)
    res = (torch.where(torch.abs(df1) < model.cutoff_ghz, near1 - base, 0.0)
           + torch.where(torch.abs(df2) < model.cutoff_ghz,
                         width / (df2 * df2 + wsq) - base, 0.0))
    line_sum = torch.sum(s * res * (f / fl) ** 2, dim=-1)
    ti_, f_, pvap_, pda_ = ti[..., 0], f[..., 0], pvap[..., 0], pda[..., 0]
    con = (model.cf * ti_ ** model.xcf * pda_
           + model.cs * ti_ ** model.xcs * pvap_) * pvap_ * f_ * f_
    return 0.3183e-4 * den[..., 0] * line_sum + con


def o2_absorption(f, p, t, rho, model: O2Model):
    f, p, t, rho = (a[..., None] for a in (f, p, t, rho))
    f0, s300, be, w300, y0, y1 = (_tab(getattr(model, k), f) for k in
                                  ("f", "s300", "be", "w300", "y0", "y1"))
    th = 300.0 / t
    th1 = th - 1.0
    b = th ** model.x
    preswv = rho * t / 217.0
    presda = p - preswv
    den = 0.001 * (presda * b + model.h2o_factor * preswv * th)
    pe2 = den * den
    dfnr = model.wb300 * den
    f_ = f[..., 0]
    nonres = (model.nonres_coeff * f_ * f_ * dfnr[..., 0]
              / (th[..., 0] * (f_ * f_ + dfnr[..., 0] * dfnr[..., 0])))
    df = w300 * den
    ybase = 0.001 * p * b if model.mixing_basis == "p" else den
    y = ybase * (y0 + y1 * th1)
    strength = s300 * torch.exp(-be * th1)
    if model.has_second_order:
        g0, g1, dnu0, dnu1 = (_tab(getattr(model, k), f) for k in
                              ("g0", "g1", "dnu0", "dnu1"))
        gfac = 1.0 + pe2 * (g0 + g1 * th1)
        dnu = pe2 * (dnu0 + dnu1 * th1)
    else:
        gfac = 1.0
        dnu = 0.0
    d1 = f - f0 - dnu
    d2 = f + f0 + dnu
    sf1 = (df * gfac + d1 * y) / (d1 * d1 + df * df)
    sf2 = (df * gfac - d2 * y) / (d2 * d2 + df * df)
    line_sum = torch.sum(strength * (sf1 + sf2) * (f / f0) ** 2, dim=-1)
    alpha = (model.scale * (nonres + line_sum) * presda[..., 0]
             * th[..., 0] ** 3)
    return torch.clamp_min(alpha, 0.0)


def n2_absorption(f, pda, t, variant: str):
    th = 300.0 / t
    if variant in ("R98", "R03"):
        return 6.4e-14 * pda * pda * f * f * th ** 3.55
    fdep = 0.5 + 0.5 / (1.0 + (f / 450.0) ** 2)
    return 6.5e-14 * fdep * pda * pda * f * f * th ** 3.6


def liquid_absorption(f, t, lwc):
    theta1 = 1.0 - 300.0 / t
    eps0 = 77.66 - 103.3 * theta1
    eps1 = 0.0671 * eps0
    eps2 = 3.52
    fp = 20.1 * torch.exp(7.88 * theta1)
    fs = 39.8 * fp
    u = f / fp
    v = f / fs
    re = eps2 + (eps0 - eps1) / (1.0 + u * u) + (eps1 - eps2) / (1.0 + v * v)
    im = -(eps0 - eps1) * u / (1.0 + u * u) - (eps1 - eps2) * v / (1.0 + v * v)
    aimag = 3.0 * im / ((re + 2.0) ** 2 + im * im)
    return -0.06286 * aimag * f * lwc


def total_absorption(f, p, t, rho, lwc, model: str):
    """H2O lines and continuum, O2 lines and nonresonant term, the dry
    continuum and cloud liquid; the inputs broadcast."""
    e = rho * t / 217.0
    return (h2o_absorption(f, p, t, rho, H2O_MODELS[model])
            + o2_absorption(f, p, t, rho, O2_MODELS[model])
            + n2_absorption(f, p - e, t, model)
            + liquid_absorption(f, t, lwc))


# ---- refraction and slant paths --------------------------------------------

def rho_to_e(rho, t):
    """Vapor density [g/m^3] -> vapor pressure [hPa]."""
    return rho * t * phys.RV / 1e5


def refractive_index(p, t, e):
    pd = p - e
    return 1.0 + 1e-6 * (_K1 * pd / t + _K2 * e / t + _K3 * e / (t * t))


def chord_lengths(z, n, cos_el):
    """Per-layer slant path [km]: z, n (..., L) levels on the last axis,
    cos_el broadcasting against (...)."""
    r = phys.EARTH_RADIUS + z
    k = n[..., :1] * r[..., :1] * cos_el[..., None]
    n_layer = 0.5 * (n[..., :-1] + n[..., 1:])
    rk = k / n_layer
    r_bot, r_top = r[..., :-1], r[..., 1:]
    seg_top = torch.sqrt(torch.clamp_min((r_top - rk) * (r_top + rk), 0.0))
    seg_bot = torch.sqrt(torch.clamp_min((r_bot - rk) * (r_bot + rk), 0.0))
    dz = z[..., 1:] - z[..., :-1]
    ds_m = dz * (r_top + r_bot) / torch.clamp_min(seg_top + seg_bot, 1.0)
    return ds_m * 1e-3


# ---- radiative transfer ----------------------------------------------------

def planck_tb(t, f):
    x = phys.HK_GHZ * f
    return x / torch.expm1(x / t)


def inverse_planck_tb(b, f):
    x = phys.HK_GHZ * f
    return x / torch.log1p(x / b)


def _emission_factors(dtau):
    """Linear-in-tau layer emission weights (g_bot, g_top); the series below
    2e-4 in float64 and 0.03 in lower precisions, as the port's plain path
    takes it."""
    small = dtau < (2e-4 if dtau.dtype == torch.float64 else 0.03)
    d = torch.where(small, 1.0, dtau)
    em = torch.exp(-d)
    g_top_exact = (1.0 - (1.0 + d) * em) / d
    g_top_series = dtau * (0.5 - dtau / 3.0 + dtau * dtau / 8.0)
    g_top = torch.where(small, g_top_series, g_top_exact)
    g_total_series = dtau * (1.0 - dtau * (0.5 - dtau / 6.0))
    g_total = torch.where(small, g_total_series, 1.0 - em)
    return g_total - g_top, g_top


def downwelling_from_dtau(dtau, t, f):
    """Downwelling TB at the ground from layer opacities dtau (..., L-1),
    t (..., L), f broadcasting against (...).  Returns tb, tau_total (...)
    and trans_level (..., L), the transmittance from the ground to each
    level."""
    ctau = torch.cumsum(dtau, dim=-1)
    trans_below = torch.exp(-(ctau - dtau))
    fl = f[..., None]
    b = planck_tb(t, fl)
    g_bot, g_top = _emission_factors(dtau)
    atm = torch.sum((g_bot * b[..., :-1] + g_top * b[..., 1:]) * trans_below,
                    dim=-1)
    tau_total = ctau[..., -1]
    cosmic = planck_tb(torch.full_like(f, phys.T_COSMIC), f) * torch.exp(
        -tau_total)
    trans_level = torch.exp(-torch.cat([torch.zeros_like(ctau[..., :1]),
                                        ctau], dim=-1))
    return inverse_planck_tb(atm + cosmic, f), tau_total, trans_level


def downwelling_tb(alpha, ds, t, f):
    """Downwelling TB at the ground: alpha (..., L) at levels, ds (..., L-1)
    [km], t (..., L), f broadcasting against (...).  Returns tb (...)."""
    dtau = 0.5 * (alpha[..., :-1] + alpha[..., 1:]) * ds
    return downwelling_from_dtau(dtau, t, f)[0]
