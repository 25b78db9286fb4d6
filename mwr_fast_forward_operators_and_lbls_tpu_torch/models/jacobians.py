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
direct Planck (t) and refraction-geometry (t, rho, p) terms.  For wrt within
{t, rho, lwc} it runs the kernels' pipeline: K4 gives alpha, both tangent
fields and, with lwc in wrt, dalpha/dLWC in one dual-number pass, one more
kernel the float64 slant geometry, K5 the adjoint with the assembly folded
in, each kernel or its plain version by the rule of `ops.cuda.launches`;
wrt with "p" takes the plain closed form.

The fast operator (`models/fast.py`) has the same structure with layer-mean
extinction in place of level absorption: `kmatrix_fast_single` and
`kmatrix_fast_batch` differentiate it with `torch.func.jacrev`;
`kmatrix_fast_adjoint_batch` (and `..._single`) is its closed form, which the
retrieval calls once per Gauss-Newton step; from the profiles to K it is
one kernel (`ops/cuda/fastk.py`).
"""

import functools

import torch

from ..constants import physics as phys
from ..ops import geometry, thermo
from ..ops.tensors import constant_vector
from ..ops.cuda.absorption import (absorption_partials_lb,
                                   absorption_tangents_lb, dalpha_dlwc_lb)
from ..ops.cuda.adjoint import (kmatrix_assembled_lb,
                                kmatrix_assembled_reference,
                                kmatrix_assembled_rho_lwc_lb)
from ..ops.cuda.fastk import fastk_adjoint
from ..ops.cuda.geometry import slant_geometry_lb
from ..ops.spans import span
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
                       wrt=("t", "rho", "lwc"), tables=None):
    """Batched K-matrix through the closed-form adjoint: dict of (B, L)
    profiles -> {name: (B, E, F, L)} for each name of `wrt` in
    {"t", "rho", "lwc", "p"}.

    wrt within {t, rho, lwc} takes the kernels' pipeline
    (`_kmatrix_batch_fused_lanes`), each stage its kernel or its plain
    version by `config.use_kernels`; wrt with "p" takes the plain closed
    form (`_kmatrix_batch_closed_form`).  `tables` is the packed line table
    of K4 (`line_tables(model, False, device)`), built and cached when None.
    """
    with span("kmatrix.kmatrix_batch_fast"):
        with span("kmatrix.layout"):
            lev = lbl.level_major_profiles(profiles, config)
        if set(wrt) <= LANES_WRT:
            k = _kmatrix_batch_fused_lanes(lev, config, wrt, tables)
        else:
            k = _kmatrix_batch_closed_form(lev, config, wrt)
        # (E, F, L, B) -> the public (B, E, F, L)
        with span("kmatrix.output_layout"):
            return {name: k[name].permute(3, 0, 1, 2).contiguous()
                    for name in wrt}


def _dalpha_dlwc(config: LBLConfig, t):
    """dalpha/dLWC (F, L, B): liquid absorption at unit content."""
    return dalpha_dlwc_lb(config.freqs_ghz, t)


def _kmatrix_batch_fused_lanes(lev: dict, config: LBLConfig, wrt, tables):
    """The kernels' K-matrix pipeline in the level-major (L, B) layout.

    One dual-number pass of K4 gives alpha, its T and rho tangents and,
    with lwc in `wrt`, dalpha/dLWC; the geometry kernel the chords and
    their sensitivities;
    K5 then writes each requested K (E, F, L, B) with the closed-form
    adjoint and both direct terms folded in: t alone, and rho with lwc from
    one shared adjoint core when all three are asked for.
    """
    freqs, t, kern = config.freqs_ghz, lev["t"], config.use_kernels
    alpha, *partials = absorption_tangents_lb(
        freqs, lev["p"], t, lev["rho"], lev["lwc"], config.model,
        tables=tables, use_kernels=kern, with_lwc="lwc" in wrt)
    da = dict(zip(("t", "rho", "lwc"), partials))
    with span("kmatrix.slant_geometry"):
        g = slant_geometry_lb(config.elevations_deg, lev["z"], lev["p"], t,
                              lev["rho"], [n for n in wrt if n != "lwc"],
                              use_kernels=kern)
    geo = (g["dds_dnl"], g["dds_dk"])
    if set(wrt) == LANES_WRT:
        k_t = kmatrix_assembled_lb(freqs, "t", alpha, da["t"], g["ds"], t,
                                   *geo, g["dn"]["t"], g["r0cos"],
                                   use_kernels=kern)
        k_rho, k_lwc = kmatrix_assembled_rho_lwc_lb(
            freqs, alpha, da["rho"], da["lwc"], g["ds"], t, *geo,
            g["dn"]["rho"], g["r0cos"], use_kernels=kern)
        return {"t": k_t, "rho": k_rho, "lwc": k_lwc}
    return {name: kmatrix_assembled_lb(freqs, name, alpha, da[name],
                                       g["ds"], t, use_kernels=kern)
            if name == "lwc" else
            kmatrix_assembled_lb(freqs, name, alpha, da[name], g["ds"], t,
                                 *geo, g["dn"][name], g["r0cos"],
                                 use_kernels=kern)
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
        with span("kmatrix.dalpha_dlwc"):
            da["lwc"] = _dalpha_dlwc(config, lev["t"])
    with span("kmatrix.slant_geometry"):
        g = slant_geometry_lb(config.elevations_deg, lev["z"], lev["p"],
                              lev["t"], lev["rho"], geo_wrt,
                              use_kernels=config.use_kernels)
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

    All of it is `ops.cuda.fastk.fastk_adjoint`, from the profiles and the
    weights: one launch of its kernel, or its plain version
    (`fast_k_inputs`, then the adjoint and assembly), by
    `config.use_kernels`.

    profiles: dict of (B, L) tensors, in their own dtype and on their own
    device.  Returns {name: (B, E, C, L)} for name in `wrt`, a subset of
    {"t", "rho"}.
    """
    config = config or fast_mod.FastConfig()
    with span("fastk.kmatrix_fast_adjoint_batch"):
        a = fast_mod.batch_arrays(profiles, getattr(torch, config.dtype))
        return fastk_adjoint(config.freqs_ghz, config.elevations_deg,
                             fast_mod._weights(params, a["t"]), **a,
                             wrt=wrt, use_kernels=config.use_kernels)


def fast_k_inputs(params, a: dict, elevations) -> dict:
    """What the fast K's plain adjoint and assembly take
    (`fastk.fastk_adjoint_reference`), from the (B, L) arrays z, p, t, rho,
    lwc of `a` at the `elevations` [deg], in their dtype: the slant geometry
    and the refractive-index partials (span fastk.geometry), then the
    layer-mean extinction and its partials (fastk.partials).  The plain
    route of `fastk.fastk_adjoint`; its kernel computes the same in its
    preamble."""
    z, p, t, rho, lwc = (a[k] for k in ("z", "p", "t", "rho", "lwc"))
    elevs = constant_vector(elevations, t.dtype, t.device)
    with span("fastk.geometry"):
        e_hpa = thermo.rho_to_e(rho, t)
        n_lev = geometry.refractive_index(p, t, e_hpa)            # (B, L)
        cos_el = torch.cos(torch.deg2rad(elevs))
        ds = torch.movedim(geometry.chord_lengths(
            z.T[:, :, None], n_lev.T[:, :, None], cos_el), 0,
            -1)                                                   # (B, E, K)
        # ds depends on (t, rho) through refraction; e = rho T Rv / 1e5
        _, dn_dt, dn_de = geometry.refractive_index_partials(p, t, e_hpa)
        dn_t = dn_dt + dn_de * thermo.rho_to_e(rho, 1.0)          # (B, L)
        dn_rho = dn_de * thermo.rho_to_e(1.0, t)
        dds_dnl, dds_dk = geometry.slant_path_sensitivities(
            z[:, None], n_lev[:, None], elevs)                    # (B, E, K)
        r0cos = (phys.EARTH_RADIUS + z[:, :1]) * cos_el[None]      # (B, E)
    with span("fastk.partials"):
        alpha_mid, d_tm, d_rm = fast_mod.extinction_partials(
            params, p, t, rho, lwc)                               # (B, K, C)
    return dict(alpha_mid=alpha_mid, d_tm=d_tm, d_rm=d_rm, ds=ds,
                dds_dnl=dds_dnl, dds_dk=dds_dk, t=t, dn_t=dn_t,
                dn_rho=dn_rho, r0cos=r0cos)


def kmatrix_fast_adjoint_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                                config=None, wrt=("t", "rho")):
    """`kmatrix_fast_adjoint_batch` for one profile of (L,) tensors.
    Returns {name: (E, C, L)}."""
    profile = {"z": z_m[None], "p": p_hpa[None], "t": t_k[None],
               "rho": rho_gm3[None], "lwc": lwc_gm3[None]}
    out = kmatrix_fast_adjoint_batch(params, profile, config, wrt)
    return {name: k[0] for name, k in out.items()}
