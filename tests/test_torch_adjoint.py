"""The port's closed-form RTE adjoint, slant-path sensitivities and the
module of kernel K5 (`ops/cuda/adjoint.py`), held against the JAX package's
XLA functions, reverse-mode AD through the port's own forward, and the JAX
Pallas adjoint kernel (interpret mode, at its smallest shape)."""

import functools

import jax
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.ops import geometry as jgeo
from mwr_fast_forward_operators_and_lbls_tpu.ops import rte as jrte
from mwr_fast_forward_operators_and_lbls_tpu.ops.pallas import (
    adjoint_kernel as jk5)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import jacobians
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (geometry, rte,
                                                               thermo)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    _build, _mirrors, adjoint as k5)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (
    absorption_tangents_lb_reference)

torch.set_num_threads(1)

F4 = (22.24, 31.4, 54.94, 58.0)
DTYPES = {"float64": (torch.float64, np.float64),
          "float32": (torch.float32, np.float32)}


def _adjoint_inputs(ndt, b_n=2, e_n=3, l_n=24, seed=3):
    """The random inputs of the JAX package's adjoint test:
    alpha (B, F, L), ds (B, E, L-1), t (B, L), f (F,)."""
    rng = np.random.default_rng(seed)
    alpha = np.abs(rng.normal(0.05, 0.02, (b_n, len(F4), l_n)))
    ds = np.abs(rng.normal(0.4, 0.1, (b_n, e_n, l_n - 1)))
    t = rng.normal(260.0, 20.0, (b_n, l_n))
    return [a.astype(ndt) for a in (alpha, ds, t, np.asarray(F4))]


def _close(got, want, rtol, floor):
    """|got - want| <= rtol |want| + floor * max |want|."""
    want = np.asarray(want)
    bound = rtol * np.abs(want) + floor * np.abs(want).max()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= bound), \
        np.max(np.abs(got - want) / (np.abs(want) + 1e-300))


# float32: S_k = atm - cumsum cancels near the column top in both packages,
# and B'(T) takes expm1 of an argument near 1e-3; the two libraries round
# both differently, by up to 3.3e-5 of the largest entry of g_t.
TOLS = {"float64": (1e-10, 0.0), "float32": (1e-4, 1e-4)}


@pytest.mark.parametrize("mid", [False, True], ids=["level", "mid"])
@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_adjoint_matches_jax(dtype_name, mid):
    tdt, ndt = DTYPES[dtype_name]
    alpha, ds, t, f = _adjoint_inputs(ndt)
    if mid:
        alpha = (0.5 * (alpha[..., :-1] + alpha[..., 1:])).astype(ndt)
    with jax.enable_x64(dtype_name == "float64"):
        fn = jrte.downwelling_tb_adjoint_mid if mid else \
            jrte.downwelling_tb_adjoint
        want = [np.asarray(v) for v in fn(alpha, ds, t, f)]
    tfn = rte.downwelling_tb_adjoint_mid if mid else rte.downwelling_tb_adjoint
    got = tfn(*(torch.from_numpy(a) for a in (alpha, ds, t, f)))
    rtol, floor = TOLS[dtype_name]
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _close(g.numpy(), w, rtol, floor)


def test_adjoint_matches_autodiff_of_the_forward():
    """The closed form equals reverse-mode AD through the port's own
    downwelling RTE, per (batch, elevation, channel), in float64."""
    alpha, ds, t, f = (torch.from_numpy(a)
                       for a in _adjoint_inputs(np.float64))
    g_alpha, g_t, g_ds = rte.downwelling_tb_adjoint(alpha, ds, t, f)
    for b in range(alpha.shape[0]):
        for e in range(ds.shape[1]):
            for c in range(len(F4)):
                def tb(a, tt, d):
                    return rte.downwelling_tb(a[None], d, tt, f[c:c + 1])[
                        "tb"][0]
                r_a, r_t, r_d = torch.func.grad(tb, argnums=(0, 1, 2))(
                    alpha[b, c], t[b], ds[b, e])
                torch.testing.assert_close(g_alpha[b, e, c], r_a, rtol=1e-10,
                                           atol=1e-14)
                torch.testing.assert_close(g_t[b, e, c], r_t, rtol=1e-10,
                                           atol=1e-14)
                torch.testing.assert_close(g_ds[b, e, c], r_d, rtol=1e-10,
                                           atol=1e-14)


def test_derivative_helpers_are_derivatives():
    f = torch.tensor(F4, dtype=torch.float64)[:, None]
    t = torch.linspace(200.0, 300.0, 7, dtype=torch.float64)[None]
    want = torch.func.jvp(lambda v: rte.planck_tb(v, f), (t,),
                          (torch.ones_like(t),))[1]
    torch.testing.assert_close(rte._planck_dT(t, f), want, rtol=1e-12,
                               atol=0)
    b = rte.planck_tb(t, f)
    want = torch.func.jvp(lambda v: rte.inverse_planck_tb(v, f), (b,),
                          (torch.ones_like(b),))[1]
    torch.testing.assert_close(rte._inverse_planck_dB(b, f), want,
                               rtol=1e-12, atol=0)
    for dtype, rtol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        d = torch.tensor([1e-5, 1e-4, 3e-4, 0.01, 0.029, 0.031, 0.5, 3.0],
                         dtype=dtype)
        got = rte._emission_factor_derivs(d)
        want = torch.func.jvp(rte._emission_factors, (d.double(),),
                              (torch.ones_like(d.double()),))[1]
        for g, w in zip(got, want):
            torch.testing.assert_close(g.double(), w, rtol=rtol, atol=1e-7)


@pytest.fixture(scope="module")
def levels():
    """(L, B) float64 levels of demo_batch(3, 40) and their refractive
    index."""
    prof = lbl.level_major_profiles(lbl.demo_batch(3, 40, device="cpu"),
                                    lbl.LBLConfig(dtype="float64"))
    prof["n"] = geometry.refractive_index(
        prof["p"], prof["t"], thermo.rho_to_e(prof["rho"], prof["t"]))
    return prof


@pytest.mark.parametrize("dtype_name,rtol", [("float64", 1e-10),
                                             ("float32", 2e-4)])
def test_slant_path_sensitivities_match_jax(levels, dtype_name, rtol):
    """Leading-batch layout, (B, 1, L) profiles against (1, E) elevations,
    as the K-matrix calls it."""
    tdt, ndt = DTYPES[dtype_name]
    z, n = (levels[k].T.numpy().astype(ndt) for k in ("z", "n"))
    el = np.asarray([90.0, 30.0, 4.2], ndt)
    with jax.enable_x64(dtype_name == "float64"):
        want = [np.asarray(v) for v in jgeo.slant_path_sensitivities(
            z[:, None], n[:, None], el[None, :])]
    got = geometry.slant_path_sensitivities(
        torch.from_numpy(z)[:, None], torch.from_numpy(n)[:, None],
        torch.from_numpy(el)[None, :])
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == (3, 3, 39)
        _close(g.numpy(), w, rtol, 1e-7 if ndt == np.float32 else 0.0)
    # at zenith rk = r0 cos(90 deg) is round-off, and so is the sensitivity
    assert float(got[0][:, 0].abs().max()) < \
        1e-6 * float(got[0][:, 2].abs().max())


def test_chord_sensitivities_are_the_derivatives(levels):
    """d ds = dds_dnl d(n_layer) + dds_dk d(k) for any tangent of n."""
    z, n = levels["z"], levels["n"]
    dn = 1e-6 * torch.from_numpy(
        np.random.default_rng(1).normal(size=tuple(n.shape)))
    for elev in (30.0, 4.2):
        cos_el = torch.cos(torch.deg2rad(torch.tensor(elev,
                                                      dtype=torch.float64)))
        want = torch.func.jvp(lambda v: geometry.chord_lengths(z, v, cos_el),
                              (n,), (dn,))[1]
        dnl, dk = geometry.chord_sensitivities(z, n, cos_el)
        got = (dnl * 0.5 * (dn[:-1] + dn[1:])
               + dk * dn[:1] * (6_371_000.0 + z[:1]) * cos_el)
        torch.testing.assert_close(got, want, rtol=1e-8,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["p", "t", "rho"])
def test_refractive_index_partials_are_the_derivatives(levels, name):
    """The closed-form partials, chained through e = rho T Rv / 1e5 as the
    K-matrix chains them, against torch.func.jvp of the refractive index."""
    state = {k: levels[k] for k in ("p", "t", "rho")}

    def n_of(v):
        s = {**state, name: v}
        return geometry.refractive_index(s["p"], s["t"],
                                         thermo.rho_to_e(s["rho"], s["t"]))

    want = torch.func.jvp(n_of, (state[name],),
                          (torch.ones_like(state[name]),))[1]
    g = jacobians._slant_geometry(levels, lbl.LBLConfig(), (name,))
    torch.testing.assert_close(g["dn"][name], want, rtol=1e-12, atol=0)


def _k5_inputs(levels, freqs, elevs, dtype=torch.float64):
    """alpha, tangents and geometry of the fused K-matrix, (E, F, L, B)
    inputs of K5, from the port's own K-matrix helpers."""
    lev = {k: v.to(dtype) for k, v in levels.items()}
    cfg = lbl.LBLConfig(freqs_ghz=freqs, elevations_deg=elevs,
                        dtype=str(dtype).split(".")[1])
    alpha, da_t, da_rho = absorption_tangents_lb_reference(
        freqs, lev["p"], lev["t"], lev["rho"], lev["lwc"], "R24")
    da = {"t": da_t, "rho": da_rho,
          "lwc": jacobians._dalpha_dlwc(cfg, lev["t"])}
    g = jacobians._slant_geometry(lev, cfg, ("t", "rho"))
    return alpha, da, g, lev["t"]


@pytest.mark.parametrize("which", ["t", "rho", "lwc"])
def test_assembled_reference_matches_the_closed_form(levels, which):
    """One variable at a time equals the shared-core result, and
    rho_lwc equals the two single-variable calls."""
    freqs, elevs = (22.24, 58.0), (90.0, 4.2)
    alpha, da, g, t = _k5_inputs(levels, freqs, elevs)
    geo = (() if which == "lwc" else
           (g["dds_dnl"], g["dds_dk"], g["dn"][which], g["r0cos"]))
    got = k5.kmatrix_assembled_lb_reference(freqs, which, alpha, da[which],
                                            g["ds"], t, *geo)
    assert got.shape == (2, 2, 40, 3)
    both = k5.kmatrix_assembled_rho_lwc_lb_reference(
        freqs, alpha, da["rho"], da["lwc"], g["ds"], t, g["dds_dnl"],
        g["dds_dk"], g["dn"]["rho"], g["r0cos"])
    if which != "t":
        torch.testing.assert_close(both[("rho", "lwc").index(which)], got,
                                   rtol=0, atol=0)
    # the wrapper takes the plain version on the CPU
    wrapped = k5.kmatrix_assembled_lb(freqs, which, alpha, da[which],
                                      g["ds"], t, *geo)
    assert k5.kmatrix_assembled_lb.launches == 0
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_rho_lwc_wrapper_takes_the_plain_version_on_cpu(levels):
    freqs, elevs = (31.4,), (90.0, 14.4)
    alpha, da, g, t = _k5_inputs(levels, freqs, elevs, torch.float32)
    args = (freqs, alpha, da["rho"], da["lwc"], g["ds"], t, g["dds_dnl"],
            g["dds_dk"], g["dn"]["rho"], g["r0cos"])
    got = k5.kmatrix_assembled_rho_lwc_lb(*args)
    assert k5.kmatrix_assembled_rho_lwc_lb.launches == 0
    for a, b in zip(got, k5.kmatrix_assembled_rho_lwc_lb_reference(*args)):
        assert a.dtype == torch.float32 and a.shape == (2, 1, 40, 3)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_refuse_bad_arguments(levels):
    alpha, da, g, t = _k5_inputs(levels, (31.4,), (90.0,))
    with pytest.raises(ValueError, match="which"):
        k5.kmatrix_assembled_lb((31.4,), "p", alpha, da["t"], g["ds"], t)
    with pytest.raises(ValueError, match="needs dds_dnl"):
        k5.kmatrix_assembled_lb((31.4,), "rho", alpha, da["rho"], g["ds"], t)


@pytest.mark.parametrize("which", ["t", "rho", "lwc", "rho_lwc"])
def test_assembled_reference_matches_the_jax_kernel(which):
    """Against the JAX Pallas adjoint kernel in interpret mode, at the shape
    of the JAX package's own fused smoke test: one profile padded to 128
    lanes, 16 levels, one channel, one elevation.  The plain version runs
    in float64 on the same float32 inputs: in float32 its S_k = atm - cumsum
    cancels near the column top (7 % of k_lwc there), which is why both
    kernels sum the suffix directly.  The Pallas kernel sums in bf16 hi/lo
    splits on its matrix unit, so the bound is the JAX package's own for its
    fused K path against XLA: 5e-3 relative, with a floor of 1e-3 of the
    largest entry."""
    freqs, elevs = (54.94,), (30.0,)
    prof = lbl.level_major_profiles(
        {k: v.repeat(128, 1)
         for k, v in lbl.demo_batch(1, 16, device="cpu").items()},
        lbl.LBLConfig())
    alpha, da, g, t = _k5_inputs(prof, freqs, elevs, torch.float32)
    geo = [] if which == "lwc" else [
        g["dds_dnl"], g["dds_dk"], g["dn"]["t" if which == "t" else "rho"],
        g["r0cos"]]
    if which == "rho_lwc":
        args = [alpha, da["rho"], da["lwc"], g["ds"], t, *geo]
        want = jk5.kmatrix_assembled_rho_lwc_lb(
            freqs, *(a.numpy() for a in args))
        got = k5.kmatrix_assembled_rho_lwc_lb_reference(
            freqs, *(a.double() for a in args))
    else:
        args = [alpha, da[which], g["ds"], t, *geo]
        want = [jk5.kmatrix_assembled_lb(freqs, which,
                                         *(a.numpy() for a in args))]
        got = [k5.kmatrix_assembled_lb_reference(
            freqs, which, *(a.double() for a in args))]
    for k, w in zip(got, want):
        w = np.asarray(w)
        assert k.shape == w.shape == (1, 1, 16, 128)
        scale = np.maximum(np.abs(w), 1e-3 * np.abs(w).max())
        assert np.max(np.abs(k.numpy() - w) / scale) < 5e-3


def test_chunk_warps_are_the_kernels():
    """The as-coded count (`profiling.k5_roofline`) splits the walk as the
    kernel does: `adjoint.CHUNK_WARPS` is csrc/adjoint.cu's `kChunkWarps`."""
    src = (_build.CSRC / "adjoint.cu").read_text()
    assert f"constexpr int kChunkWarps = {k5.CHUNK_WARPS};\n" in src


@functools.cache
def _chunk_inputs(n_levels):
    """float64 inputs of K5 at 4 channels x 2 elevations x 3 profiles."""
    prof = lbl.level_major_profiles(
        lbl.demo_batch(3, n_levels, device="cpu"),
        lbl.LBLConfig(dtype="float64"))
    return _k5_inputs(prof, F4, (90.0, 4.2))


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("n_levels", [2, 3, 24, 96])
@pytest.mark.parametrize("chunks", [1, 2, 7, "per_layer"])
@pytest.mark.parametrize("mode", ["t", "rho", "lwc", "rho_lwc"])
def test_chunked_walk_matches_the_closed_form(mode, chunks, n_levels,
                                               dtype_name):
    """K5's walk split into chunks of layers (`_mirrors.kmatrix_chunked`,
    the kernel's algebra in plain torch) against the plain closed form in
    float64: one chunk, chunks of one layer, an uneven last chunk, and more
    chunks asked for than there are layers.  In float64 to 1e-12 of the
    largest entry: the order of the sums is all that differs, and an
    entrywise relative bound would gauge the plain version's own
    S = atm - cumsum, which cancels near the column top.  In float32 to the
    K-matrix's bound, 1e-3 relative floored at 1e-3 of the largest entry."""
    _check_chunked(mode, n_levels - 1 if chunks == "per_layer" else chunks,
                   n_levels, dtype_name)


@pytest.mark.parametrize("mode", ["t", "rho_lwc"])
def test_chunked_walk_at_the_kernels_split(mode):
    """The split the kernel makes at the K-matrix's depth: 180 levels in
    `adjoint.CHUNK_WARPS` chunks of 22 and 23 layers, in float32."""
    _check_chunked(mode, k5.CHUNK_WARPS, 180, "float32")


def _check_chunked(mode, chunks, n_levels, dtype_name):
    alpha, da, g, t = _chunk_inputs(n_levels)
    names = ("rho", "lwc") if mode == "rho_lwc" else (mode,)
    geo = [n for n in names if n != "lwc"]
    want = k5.kmatrix_assembled_reference(
        F4, alpha, {n: da[n] for n in names}, g["ds"], t, g["dds_dnl"],
        g["dds_dk"], {n: g["dn"][n] for n in geo} or None, g["r0cos"])
    tdt = DTYPES[dtype_name][0]
    geo_args = {} if not geo else dict(
        dds_dnl=g["dds_dnl"].to(tdt), dds_dk=g["dds_dk"].to(tdt),
        dn=g["dn"][geo[0]].to(tdt), r0cos=g["r0cos"].to(tdt))
    got = _mirrors.kmatrix_chunked(
        F4, mode, alpha.to(tdt), da[names[0]].to(tdt), g["ds"].to(tdt),
        t.to(tdt), da2=da["lwc"].to(tdt) if mode == "rho_lwc" else None,
        chunks=chunks, **geo_args)
    assert len(got) == len(names)
    for k, name in zip(got, names):
        w = want[name]
        assert k.dtype == tdt and k.shape == w.shape == (2, 4, n_levels, 3)
        if tdt == torch.float64:
            assert float((k - w).abs().max()) <= 1e-12 * float(w.abs().max())
        else:
            scale = torch.clamp_min(w.abs(), 1e-3 * w.abs().max())
            assert float(((k.double() - w).abs() / scale).max()) <= 1e-3
