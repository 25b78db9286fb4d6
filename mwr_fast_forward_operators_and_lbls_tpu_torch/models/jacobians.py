"""K-matrix (Jacobian) of the LBL forward operator, in torch.

dTB/d(p, T, rho, LWC) per level and channel: (F, L) per profile and
elevation, stacked to (B, E, F, L) for a batch, as in the JAX package's
`models/jacobians.py`.

`kmatrix_single` and `kmatrix_batch` differentiate `lbl.forward_single` with
`torch.func.jacrev`, vmapped over profiles and elevations.
`kmatrix_batch_fast` uses the structure of the problem instead:

  1. absorption is local in level, so dalpha/dx is diagonal and one
     forward-mode pass seeded with ones gives it (dalpha/dLWC is liquid
     absorption at unit content: cloud absorption is linear in LWC);
  2. the RTE adjoint is closed form (`rte.downwelling_tb_adjoint`);
  3. the slant-path Jacobian is tridiagonal plus a rank-one level-0 column
     (`geometry.chord_sensitivities`),

and assembles K_x[e, f, l] = dTB/dalpha[e, f, l] dalpha[f, l]/dx[l] plus the
direct Planck (t) and refraction-geometry (t, rho, p) terms.  On CUDA float32
profiles with wrt within {t, rho, lwc} it runs the kernels: K4 gives alpha
and both tangent fields in one dual-number pass, K5 the adjoint with the
assembly folded in.

The fast operator (`models/fast.py`) has the same structure with layer-mean
extinction in place of level absorption: `kmatrix_fast_single` and
`kmatrix_fast_batch` differentiate it with `torch.func.jacrev`;
`kmatrix_fast_adjoint_batch` (and `..._single`) is its closed form, which the
retrieval calls once per Gauss-Newton step.
"""

import functools

import torch

from ..constants import physics as phys
from ..ops import geometry, rte, thermo
from ..ops.absorption import liquid_absorption
from ..ops.tensors import constant_vector
from ..ops.cuda.absorption import (absorption_partials_lb,
                                   absorption_tangents_lb)
from ..ops.cuda.adjoint import (kmatrix_assembled_lb,
                                kmatrix_assembled_reference,
                                kmatrix_assembled_rho_lwc_lb)
from . import fast as fast_mod
from . import lbl
from .lbl import LBLConfig

# the variables the kernels' pipeline differentiates
LANES_WRT = frozenset({"t", "rho", "lwc"})


def kmatrix_single(z_m, p_hpa, t_k, rho_gm3, lwc_gm3, f_ghz, elevation_deg,
                   model: str = "R24", wrt=("t", "rho", "lwc", "p")):
    """Jacobians of TB (F,) in the (L,) profile variables named in `wrt`,
    by `torch.func.jacrev` through `lbl.forward_single`.  Returns
    {name: (F, L)}; rho is vapor density [g/m^3]."""
    args = {"p": p_hpa, "t": t_k, "rho": rho_gm3, "lwc": lwc_gm3}

    def tb_of(name, value):
        merged = {**args, name: value}
        return lbl.forward_single(z_m, merged["p"], merged["t"],
                                  merged["rho"], merged["lwc"], f_ghz,
                                  elevation_deg, model)["tb"]

    return {name: torch.func.jacrev(functools.partial(tb_of, name))(
        args[name]) for name in wrt}


def kmatrix_batch(profiles: dict, config: LBLConfig = LBLConfig(),
                  wrt=("t", "rho", "lwc")):
    """Batched `kmatrix_single`: dict of (B, L) profiles ->
    {name: (B, E, F, L)}, vmapped over profiles and elevations."""
    lev = lbl.level_major_profiles(profiles, config)
    like = lev["t"]
    f = torch.tensor(config.freqs_ghz, dtype=like.dtype, device=like.device)
    elevs = torch.tensor(config.elevations_deg, dtype=like.dtype,
                         device=like.device)

    def one(z, p, t, rho, lwc):
        return torch.func.vmap(lambda el: kmatrix_single(
            z, p, t, rho, lwc, f, el, config.model, wrt))(elevs)

    return torch.func.vmap(one)(*(lev[k].T for k in ("z", "p", "t", "rho",
                                                      "lwc")))


def kmatrix_batch_fast(profiles: dict, config: LBLConfig = LBLConfig(),
                       wrt=("t", "rho", "lwc"), fused=None, tables=None):
    """Batched K-matrix through the closed-form adjoint: dict of (B, L)
    profiles -> {name: (B, E, F, L)} for each name of `wrt` in
    {"t", "rho", "lwc", "p"}.

    fused=None takes the kernels' pipeline (`_kmatrix_batch_fused_lanes`)
    for CUDA profiles with `config.use_kernels` and wrt within {t, rho,
    lwc}, and the plain closed-form path otherwise (on any device, and
    always when wrt has "p").  fused=True runs the pipeline on any device:
    on CPU tensors its wrappers take their plain versions.  The kernels are
    float32 only: CUDA profiles in another dtype need use_kernels=False.
    `tables` is the packed line table of K4 (`line_tables(model, False,
    device)`), built and cached when None.
    """
    lev = lbl.level_major_profiles(profiles, config)
    on_card = lev["t"].is_cuda and config.use_kernels
    if on_card and lev["t"].dtype != torch.float32:
        raise ValueError(f"the CUDA kernels are float32 only; got dtype "
                         f"{config.dtype!r} (use_kernels=False runs the plain "
                         f"closed form in any dtype)")
    if fused is None:
        fused = on_card and set(wrt) <= LANES_WRT
    if fused:
        if not set(wrt) <= LANES_WRT:
            raise ValueError(f"the fused K-matrix takes wrt within "
                             f"{sorted(LANES_WRT)}, got {wrt}")
        if not config.use_kernels:
            raise ValueError("the fused K-matrix runs the kernels' wrappers; "
                             "use_kernels=False takes the plain closed form")
        k = _kmatrix_batch_fused_lanes(lev, config, wrt, tables)
    else:
        k = _kmatrix_batch_closed_form(lev, config, wrt)
    # (E, F, L, B) -> the public (B, E, F, L)
    return {name: k[name].permute(3, 0, 1, 2).contiguous() for name in wrt}


def _dalpha_dlwc(config: LBLConfig, t):
    """dalpha/dLWC (F, L, B): liquid absorption at unit content."""
    f = constant_vector(config.freqs_ghz, t.dtype, t.device)
    return liquid_absorption(f[:, None, None], t[None],
                             torch.ones_like(t)[None])


def _slant_geometry(lev: dict, config: LBLConfig, names) -> dict:
    """Slant paths ds and their sensitivities dds_dnl, dds_dk
    (E, L-1, B), r0cos = (R_E + z_0) cos(el) (E, B), and dn
    {name: d(refractive index)/d(name) (L, B)} for each of `names` in
    {"t", "rho", "p"}, through e = rho T Rv / 1e5.

    Computed in float64 and returned in the profiles' dtype: at low
    elevations the chords hang on r - rk, and float32 quantizes r = R_E + z
    to half a metre, which put 1.2e-3 of max |K| into k_t at 4.2 degrees.
    The arrays are E x L x B, small beside the kernels' work.
    """
    dtype = lev["t"].dtype
    z, p, t, rho = (lev[k].double() for k in ("z", "p", "t", "rho"))
    e = thermo.rho_to_e(rho, t)
    n = geometry.refractive_index(p, t, e)
    dn_dp, dn_dt, dn_de = geometry.refractive_index_partials(p, t, e)
    # e = rho T Rv / 1e5: de/dT = e(rho, 1), de/drho = e(1, T)
    dn = {"p": dn_dp, "t": dn_dt + dn_de * thermo.rho_to_e(rho, 1.0),
          "rho": dn_de * thermo.rho_to_e(1.0, t)}
    dn = {name: dn[name].to(dtype) for name in names}
    cos_el = torch.cos(torch.deg2rad(constant_vector(
        config.elevations_deg, torch.float64, t.device)))
    # all elevations at once: levels on axis 0, then (E, B)
    zb, nb, cb = z[:, None], n[:, None], cos_el[:, None]

    def elevation_major(a):                     # (L-1, E, B) -> (E, L-1, B)
        return a.transpose(0, 1).to(dtype).contiguous()

    dds_dnl, dds_dk = geometry.chord_sensitivities(zb, nb, cb)
    r0cos = (phys.EARTH_RADIUS + z[0])[None, :] * cos_el[:, None]
    return dict(ds=elevation_major(geometry.chord_lengths(zb, nb, cb)),
                dds_dnl=elevation_major(dds_dnl),
                dds_dk=elevation_major(dds_dk), r0cos=r0cos.to(dtype), dn=dn)


def _kmatrix_batch_fused_lanes(lev: dict, config: LBLConfig, wrt, tables):
    """The kernels' K-matrix pipeline in the level-major (L, B) layout.

    One dual-number pass of K4 gives alpha and its T and rho tangents; the
    geometry terms come from plain torch; K5 then writes each requested K
    (E, F, L, B) with the closed-form adjoint and both direct terms folded
    in: t alone, and rho with lwc from one shared adjoint core when all
    three are asked for.  On CPU tensors the wrappers run their plain
    versions.
    """
    freqs, t = config.freqs_ghz, lev["t"]
    alpha, da_t, da_rho = absorption_tangents_lb(
        freqs, lev["p"], t, lev["rho"], lev["lwc"], config.model,
        tables=tables)
    da = {"t": da_t, "rho": da_rho}
    if "lwc" in wrt:
        da["lwc"] = _dalpha_dlwc(config, t)
    g = _slant_geometry(lev, config, [n for n in wrt if n != "lwc"])
    geo = (g["dds_dnl"], g["dds_dk"])
    if set(wrt) == LANES_WRT:
        k_t = kmatrix_assembled_lb(freqs, "t", alpha, da["t"], g["ds"], t,
                                   *geo, g["dn"]["t"], g["r0cos"])
        k_rho, k_lwc = kmatrix_assembled_rho_lwc_lb(
            freqs, alpha, da["rho"], da["lwc"], g["ds"], t, *geo,
            g["dn"]["rho"], g["r0cos"])
        return {"t": k_t, "rho": k_rho, "lwc": k_lwc}
    return {name: kmatrix_assembled_lb(freqs, name, alpha, da[name],
                                       g["ds"], t)
            if name == "lwc" else
            kmatrix_assembled_lb(freqs, name, alpha, da[name], g["ds"], t,
                                 *geo, g["dn"][name], g["r0cos"])
            for name in wrt}


def _kmatrix_batch_closed_form(lev: dict, config: LBLConfig, wrt) -> dict:
    """The plain closed-form K-matrix, {name: (E, F, L, B)}: the absorption
    partials from one jvp per variable, then the adjoint computed once and
    assembled for every variable of `wrt`, "p" included."""
    geo_wrt = [n for n in wrt if n != "lwc"]
    alpha, da = absorption_partials_lb(config.freqs_ghz, lev["p"], lev["t"],
                                       lev["rho"], lev["lwc"], config.model,
                                       geo_wrt)
    if "lwc" in wrt:
        da["lwc"] = _dalpha_dlwc(config, lev["t"])
    g = _slant_geometry(lev, config, geo_wrt)
    return kmatrix_assembled_reference(
        config.freqs_ghz, alpha, {n: da[n] for n in wrt}, g["ds"], lev["t"],
        g["dds_dnl"], g["dds_dk"], g["dn"], g["r0cos"])


def kmatrix_ppmv_from_rho(k_rho, p_hpa, t_k):
    """Convert dTB/d(rho [g/m^3]) (..., F, L) to dTB/d(ppmv), by the chain
    rule through e = rho Rv T (`thermo.rho_to_e`) and ppmv ~ 1e6 e / p."""
    de_drho = thermo.rho_to_e(torch.ones_like(p_hpa), t_k)  # [hPa per g/m^3]
    dppmv_drho = 1e6 * de_drho / p_hpa
    return k_rho / dppmv_drho[..., None, :]


# ---------------------------------------------------------------------------
# K-matrix of the fast operator
# ---------------------------------------------------------------------------

def kmatrix_fast_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                        elevation_deg, config=None,
                        wrt=("t", "rho", "lwc")):
    """K-matrix of the fast operator for one profile and elevation, by
    `torch.func.jacrev` through the feature map, the regression product, the
    slant geometry and the RTE.  Returns {name: (C, L)}."""
    config = config or fast_mod.FastConfig()
    args = {"p": p_hpa, "t": t_k, "rho": rho_gm3, "lwc": lwc_gm3}

    def tb_of(name, value):
        merged = {**args, name: value}
        return fast_mod.fast_forward_single(
            params, z_m, merged["p"], merged["t"], merged["rho"],
            merged["lwc"], elevation_deg, config)["tb"]

    return {name: torch.func.jacrev(functools.partial(tb_of, name))(
        args[name]) for name in wrt}


def kmatrix_fast_batch(params, profiles: dict, config=None,
                       wrt=("t", "rho", "lwc")):
    """Batched `kmatrix_fast_single`: dict of (B, L) profiles ->
    {name: (B, E, C, L)}, vmapped over profiles and elevations."""
    config = config or fast_mod.FastConfig()
    a = fast_mod.batch_arrays(profiles, getattr(torch, config.dtype))
    elevs = constant_vector(config.elevations_deg, a["t"].dtype,
                            a["t"].device)

    def one(z, p, t, rho, lwc):
        return torch.func.vmap(lambda el: kmatrix_fast_single(
            params, z, p, t, rho, lwc, el, config, wrt))(elevs)

    return torch.func.vmap(one)(*(a[k] for k in ("z", "p", "t", "rho",
                                                 "lwc")))


def _spread(a):
    """Layer field (..., K) -> level field (..., K + 1): each level takes
    half of the layers around it, as x_mid = (x_l + x_{l+1}) / 2."""
    zeros = torch.zeros_like(a[..., :1])
    return 0.5 * (torch.cat([a, zeros], -1) + torch.cat([zeros, a], -1))


def kmatrix_fast_adjoint_batch(params, profiles: dict, config=None,
                               wrt=("t", "rho")):
    """Closed-form fast-operator K for a batch: every (elevation, channel)
    row of every profile in about three forward-shaped passes.

      1. The regression extinction is layer-local, so d(alpha_mid)/d(T_mid,
         rho_mid) is diagonal over layers; `fast.extinction_partials` gives
         it in closed form (the features are monomials times hats of p).
      2. The RTE adjoint is closed form (`rte.downwelling_tb_adjoint_mid`):
         dTB/d(alpha_mid), the direct Planck term and dTB/d(ds).
      3. The refraction geometry's Jacobian is tridiagonal plus a rank-one
         Snell-invariant column (`geometry.slant_path_sensitivities`).

    profiles: dict of (B, L) tensors, in their own dtype and on their own
    device.  Returns {name: (B, E, C, L)} for name in `wrt`, a subset of
    {"t", "rho"}.
    """
    config = config or fast_mod.FastConfig()
    a = fast_mod.batch_arrays(profiles, getattr(torch, config.dtype))
    z, p, t, rho, lwc = (a[k] for k in ("z", "p", "t", "rho", "lwc"))
    f = constant_vector(config.freqs_ghz, t.dtype, t.device)
    elevs = constant_vector(config.elevations_deg, t.dtype, t.device)

    e_hpa = thermo.rho_to_e(rho, t)
    n_lev = geometry.refractive_index(p, t, e_hpa)                # (B, L)
    cos_el = torch.cos(torch.deg2rad(elevs))
    ds = torch.movedim(geometry.chord_lengths(
        z.T[:, :, None], n_lev.T[:, :, None], cos_el), 0, -1)     # (B, E, K)

    alpha_mid, d_tm, d_rm = fast_mod.extinction_partials(params, p, t, rho,
                                                         lwc)     # (B, K, C)
    g_mid, g_t, g_ds = rte.downwelling_tb_adjoint_mid(
        alpha_mid.transpose(1, 2), ds, t, f)                      # (B,E,C,.)

    out = {}
    if "t" in wrt:
        out["t"] = _spread(g_mid * d_tm.transpose(1, 2)[:, None]) + g_t
    if "rho" in wrt:
        out["rho"] = _spread(g_mid * d_rm.transpose(1, 2)[:, None])

    # ds depends on (t, rho) through refraction; e = rho T Rv / 1e5
    _, dn_dt, dn_de = geometry.refractive_index_partials(p, t, e_hpa)
    dn = {"t": dn_dt + dn_de * thermo.rho_to_e(rho, 1.0),
          "rho": dn_de * thermo.rho_to_e(1.0, t)}                 # (B, L)
    dds_dnl, dds_dk = geometry.slant_path_sensitivities(
        z[:, None], n_lev[:, None], elevs)                        # (B, E, K)
    c = _spread(g_ds * dds_dnl[:, :, None])                       # (B,E,C,L)
    s_k = torch.sum(g_ds * dds_dk[:, :, None], dim=-1)            # (B, E, C)
    r0cos = (phys.EARTH_RADIUS + z[:, :1]) * cos_el[None]         # (B, E)
    for name in out:
        g = c * dn[name][:, None, None, :]
        g[..., 0] += s_k * (r0cos * dn[name][:, :1])[:, :, None]
        out[name] = out[name] + g
    return out


def kmatrix_fast_adjoint_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                                config=None, wrt=("t", "rho")):
    """`kmatrix_fast_adjoint_batch` for one profile of (L,) tensors.
    Returns {name: (E, C, L)}."""
    profile = {"z": z_m[None], "p": p_hpa[None], "t": t_k[None],
               "rho": rho_gm3[None], "lwc": lwc_gm3[None]}
    out = kmatrix_fast_adjoint_batch(params, profile, config, wrt)
    return {name: k[0] for name, k in out.items()}
