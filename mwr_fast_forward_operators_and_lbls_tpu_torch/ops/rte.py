"""Non-scattering downwelling microwave radiative transfer, in torch.

Torch counterpart of the JAX package's `ops/rte.py`: thermal emission of each
layer with a linear-in-tau source, attenuated to the ground-based radiometer,
plus the cosmic background attenuated by the whole column.  Planck radiance
throughout, converted to brightness temperature at the end.  The frequency
axis is the leading axis of `alpha`.  The closed-form adjoint gives the
K-matrix its dTB/d(alpha, t, ds).
"""

import torch

from ..constants import physics as phys


def planck_tb(t_k, f_ghz):
    """Planck radiance in temperature units [K]: (hf/k) / expm1(hf/kT)."""
    x = phys.HK_GHZ * f_ghz
    return x / torch.expm1(x / t_k)


def inverse_planck_tb(b, f_ghz):
    """Invert `planck_tb`: brightness temperature [K] from radiance-in-K."""
    x = phys.HK_GHZ * f_ghz
    return x / torch.log1p(x / b)


def layer_opacities(alpha, ds_km):
    """Trapezoidal layer opacities [nepers]: alpha (..., L) [Np/km] at levels,
    ds_km (..., L-1) [km] -> (..., L-1)."""
    return 0.5 * (alpha[..., :-1] + alpha[..., 1:]) * ds_km


def _small_dtau(dtau):
    """Where the emission factors take their series: below 0.03 in float32
    and 2e-4 in float64 (see _emission_factors)."""
    return dtau < (2e-4 if dtau.dtype == torch.float64 else 0.03)


def _emission_factors(dtau):
    """Linear-in-tau layer emission weights (g_bot, g_top).

    For a layer of opacity d whose source varies linearly from B_bot to B_top,
    the emission reaching the layer bottom is g_bot*B_bot + g_top*B_top with
        g_bot = 1 - e^-d - g_top,   g_top = (1 - (1+d) e^-d) / d.
    The exact numerator cancels below d ~ 0.03 in float32 and ~2e-4 in
    float64; a 3-term Taylor series takes over there.  The float64 threshold
    keeps the analytic anchors at round-off.
    """
    small = _small_dtau(dtau)
    d = torch.where(small, 1.0, dtau)  # avoid 0/0 in the untaken branch
    em = torch.exp(-d)
    g_top_exact = (1.0 - (1.0 + d) * em) / d
    g_top_series = dtau * (0.5 - dtau / 3.0 + dtau * dtau / 8.0)
    g_top = torch.where(small, g_top_series, g_top_exact)
    g_total_series = dtau * (1.0 - dtau * (0.5 - dtau / 6.0))
    g_total = torch.where(small, g_total_series, 1.0 - em)
    return g_total - g_top, g_top


def downwelling_tb(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Downwelling brightness temperature at the ground.

    alpha (F, L) [Np/km] at levels ground -> top; ds_km (L-1,) or (F, L-1);
    t_k (L,); f_ghz (F,).  Returns tb, tau_total, t_mr (F,) and
    trans_level (F, L).
    """
    return downwelling_tb_from_dtau(layer_opacities(alpha, ds_km), t_k, f_ghz,
                                    t_cosmic)


def downwelling_tb_from_dtau(dtau, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Downwelling TB from per-layer slant opacities dtau (F, L-1)."""
    f = f_ghz[:, None] if f_ghz.ndim else f_ghz
    ctau = torch.cumsum(dtau, dim=-1)
    tau_below = ctau - dtau
    tau_total = tau_below[..., -1] + dtau[..., -1]
    trans_below = torch.exp(-tau_below)
    trans_level = torch.exp(-torch.cat([torch.zeros_like(dtau[..., :1]), ctau],
                                       dim=-1))

    b = planck_tb(t_k, f)
    g_bot, g_top = _emission_factors(dtau)
    layer_emission = g_bot * b[..., :-1] + g_top * b[..., 1:]

    atm = torch.sum(layer_emission * trans_below, dim=-1)
    cosmic = planck_tb(t_cosmic, f_ghz) * torch.exp(-tau_total)
    tb = inverse_planck_tb(atm + cosmic, f_ghz)
    # Mean radiating temperature: atmospheric radiance / (1 - e^-tau).
    t_mr = inverse_planck_tb(
        atm / torch.clamp_min(-torch.expm1(-tau_total), 1e-10), f_ghz)
    return {"tb": tb, "tau_total": tau_total, "trans_level": trans_level,
            "t_mr": t_mr}


def downwelling_tb_lb_multi(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC,
                            want_trans_level=True):
    """Multi-elevation downwelling RTE in the (F, L, B) layout.

    alpha (F, L, B) [Np/km] at levels; ds_km (E, L-1, B); t_k (L, B);
    f_ghz (F,).  Returns tb, tau_total, t_mr (E, F, B) and, when
    want_trans_level, trans_level (E, F, L, B).
    """
    alpha_mid = 0.5 * (alpha[:, :-1] + alpha[:, 1:])
    return downwelling_tb_lb_from_alpha_mid(alpha_mid, ds_km, t_k, f_ghz,
                                            t_cosmic, want_trans_level)


def downwelling_tb_lb_from_alpha_mid(alpha_mid, ds_km, t_k, f_ghz,
                                     t_cosmic=phys.T_COSMIC,
                                     want_trans_level=True):
    """Multi-elevation RTE from layer-mean extinction alpha_mid (F, L-1, B).

    ds_km (E, L-1, B); t_k (L, B); f_ghz (F,).  The cumulative opacity is a
    plain cumulative sum over the layer axis.
    """
    f = f_ghz[:, None, None]
    fb = f_ghz[:, None]
    b = planck_tb(t_k[None], f)                                  # (F, L, B)
    b_bot, b_top = b[:, :-1], b[:, 1:]
    cosmic0 = planck_tb(t_cosmic, fb)

    dtau = alpha_mid[None] * ds_km[:, None]                      # (E,F,L-1,B)
    ctau = torch.cumsum(dtau, dim=2)
    e_ctau = torch.exp(-ctau)
    # Transmittance to the *bottom* of layer l is exp(-ctau_{l-1}).
    trans_below = torch.cat([torch.ones_like(e_ctau[:, :, :1]),
                             e_ctau[:, :, :-1]], dim=2)
    tau_total = ctau[:, :, -1]                                   # (E, F, B)
    trans_total = e_ctau[:, :, -1]

    g_bot, g_top = _emission_factors(dtau)
    atm = torch.sum((g_bot * b_bot[None] + g_top * b_top[None]) * trans_below,
                    dim=2)                                       # (E, F, B)

    tb = inverse_planck_tb(atm + cosmic0 * trans_total, fb)
    t_mr = inverse_planck_tb(atm / torch.clamp_min(1.0 - trans_total, 1e-10),
                             fb)
    out = {"tb": tb, "tau_total": tau_total, "t_mr": t_mr}
    if want_trans_level:
        out["trans_level"] = torch.cat(
            [torch.ones_like(e_ctau[:, :, :1]), e_ctau], dim=2)
    return out


def _planck_dT(t_k, f):
    """d planck_tb / dT = (x/T)^2 e^{x/T} / expm1(x/T)^2."""
    x = phys.HK_GHZ * f
    u = x / t_k
    em = torch.expm1(u)
    return u * u * (em + 1.0) / (em * em)


def _inverse_planck_dB(b, f):
    """d inverse_planck_tb / dB = x^2 / (b (b+x) log1p(x/b)^2)."""
    x = phys.HK_GHZ * f
    lg = torch.log1p(x / b)
    return x * x / (b * (b + x) * lg * lg)


def _emission_factor_derivs(dtau):
    """(dg_bot/dd, dg_top/dd) of `_emission_factors`.

    Exact: g_top' = e^-d - g_top/d and g_bot' = g_top/d, with the series
    below the same dtype-dependent threshold as the forward.
    """
    small = _small_dtau(dtau)
    d = torch.where(small, 1.0, dtau)
    em = torch.exp(-d)
    g_top_over_d = torch.where(small, 0.5 - dtau / 3.0 + dtau * dtau / 8.0,
                               (1.0 - (1.0 + d) * em) / (d * d))
    dg_top = torch.where(small,
                         0.5 - (2.0 / 3.0) * dtau + 0.375 * dtau * dtau,
                         em - g_top_over_d)
    return g_top_over_d, dg_top


def downwelling_tb_adjoint(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Closed-form adjoint of the downwelling RTE: exact dTB/d(alpha, t, ds)
    for every (batch, elevation, frequency) in one vectorized pass.

    With E_k = g_bot B_k + g_top B_{k+1}, T_k the transmittance from the
    ground to the bottom of layer k, S_k = sum_{j>k} E_j T_j and Ttot the
    column transmittance,

        W_k = dR/d(dtau_k) = E'_k T_k - S_k - B(T_cosmic) Ttot,
        dTB/dalpha_l = dtb/dR (W ds)/2 gathered from layers l-1 and l,
        dTB/dt_l     = dtb/dR (g_bot_l T_l + g_top_{l-1} T_{l-1}) B'(t_l),
        dTB/dds_k    = dtb/dR W_k alpha_mid_k.

    alpha (B, F, L) [Np/km] at levels; ds_km (B, E, L-1); t_k (B, L);
    f_ghz (F,).  Returns g_alpha (B, E, F, L), g_t (B, E, F, L), the Planck
    path only, and g_ds (B, E, F, L-1).
    """
    alpha_mid = 0.5 * (alpha[..., :-1] + alpha[..., 1:])
    g_mid, g_t, g_ds = downwelling_tb_adjoint_mid(alpha_mid, ds_km, t_k,
                                                  f_ghz, t_cosmic)
    half = 0.5 * g_mid
    zeros = torch.zeros_like(half[..., :1])
    g_alpha = torch.cat([half, zeros], -1) + torch.cat([zeros, half], -1)
    return g_alpha, g_t, g_ds


def downwelling_tb_adjoint_mid(alpha_mid, ds_km, t_k, f_ghz,
                               t_cosmic=phys.T_COSMIC):
    """`downwelling_tb_adjoint` for layer-mean extinction alpha_mid
    (B, F, K=L-1); ds_km (B, E, K), t_k (B, L), f_ghz (F,).  Returns
    g_alpha_mid (B, E, F, K), g_t (B, E, F, L) and g_ds (B, E, F, K).

    S_k is taken as atm - cumsum, as in the JAX package, for parity; that
    form cancels near the column top in float32, and the CUDA kernel sums
    the suffix directly instead.
    """
    f = f_ghz[None, None, :, None]
    dtau = alpha_mid[:, None] * ds_km[:, :, None, :]       # (B, E, F, K)
    ctau = torch.cumsum(dtau, dim=-1)
    t_below = torch.exp(-(ctau - dtau))
    trans_total = torch.exp(-ctau[..., -1:])

    b = planck_tb(t_k[:, None, None, :], f)                # (B, 1, F, L)
    g_bot, g_top = _emission_factors(dtau)
    et = (g_bot * b[..., :-1] + g_top * b[..., 1:]) * t_below
    atm = torch.sum(et, dim=-1, keepdim=True)
    suffix = atm - torch.cumsum(et, dim=-1)
    ctt = planck_tb(t_cosmic, f) * trans_total
    dtb_dr = _inverse_planck_dB(atm + ctt, f)              # (B, E, F, 1)

    dg_bot, dg_top = _emission_factor_derivs(dtau)
    e_prime = dg_bot * b[..., :-1] + dg_top * b[..., 1:]
    w = e_prime * t_below - suffix - ctt

    g_alpha_mid = dtb_dr * w * ds_km[:, :, None, :]
    zeros = torch.zeros_like(w[..., :1])
    bprime = _planck_dT(t_k[:, None, None, :], f)
    g_t = dtb_dr * (torch.cat([g_bot * t_below, zeros], -1)
                    + torch.cat([zeros, g_top * t_below], -1)) * bprime
    g_ds = dtb_dr * w * alpha_mid[:, None]
    return g_alpha_mid, g_t, g_ds


def upwelling_tb(alpha, ds_km, t_k, f_ghz, t_surface=None, emissivity=1.0,
                 t_cosmic=phys.T_COSMIC):
    """Upwelling TB at the column top (satellite view) over a specular
    surface of the given emissivity; t_surface defaults to the lowest level
    temperature.  Shapes as in `downwelling_tb`; returns tb, tau_total."""
    dtau = layer_opacities(alpha, ds_km)
    tau_total = torch.sum(dtau, dim=-1)
    # opacity from each layer's top to the column top
    tau_above = torch.flip(torch.cumsum(torch.flip(dtau, (-1,)), -1),
                           (-1,)) - dtau
    trans_above = torch.exp(-tau_above)

    f = f_ghz[:, None] if f_ghz.ndim else f_ghz
    b = planck_tb(t_k, f)
    # looking down, the layer top takes the g_bot role
    g_bot, g_top = _emission_factors(dtau)
    atm_up = torch.sum((g_bot * b[..., 1:] + g_top * b[..., :-1])
                       * trans_above, dim=-1)

    ts = t_k[..., 0] if t_surface is None else t_surface
    down = downwelling_tb(alpha, ds_km, t_k, f_ghz, t_cosmic)
    surface = (emissivity * planck_tb(ts, f_ghz)
               + (1.0 - emissivity) * planck_tb(down["tb"], f_ghz)) \
        * torch.exp(-tau_total)
    return {"tb": inverse_planck_tb(atm_up + surface, f_ghz),
            "tau_total": tau_total}
