"""The port's geometry and RTE ops and the module of kernel K2
(`ops/cuda/rte.py`), held against the JAX package's XLA functions on the same
inputs and against exact analytic solutions."""

import jax
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.ops import geometry as jgeo
from mwr_fast_forward_operators_and_lbls_tpu.ops import rte as jrte
from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import physics
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (geometry,
                                                               rte, thermo)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    _mirrors as mirrors)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import rte as k2
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (
    absorption_lb_reference)

torch.set_num_threads(1)

FREQS = lbl.LBLConfig().freqs_ghz
ELEVS = (90.0, 30.0, 4.2)
DTYPES = {"float64": (torch.float64, np.float64),
          "float32": (torch.float32, np.float32)}


def _levels(batch=3, n_levels=60, seed=5):
    """(L, B) float64 numpy levels of demo profiles and their alpha."""
    prof = {k: v.T.contiguous().double()
            for k, v in lbl.demo_batch(batch, n_levels, seed,
                                       device="cpu").items()}
    alpha = absorption_lb_reference(FREQS, prof["p"], prof["t"], prof["rho"],
                                    prof["lwc"], "R24")
    e = thermo.rho_to_e(prof["rho"], prof["t"])
    return {**{k: v.numpy() for k, v in prof.items()}, "e": e.numpy(),
            "alpha": alpha.numpy()}


@pytest.fixture(scope="module")
def levels():
    return _levels()


def _jax_x64(dtype_name):
    return jax.enable_x64(dtype_name == "float64")


@pytest.mark.parametrize("dtype_name,rtol", [("float64", 1e-12),
                                             ("float32", 1e-5)])
@pytest.mark.parametrize("elev", ELEVS)
def test_slant_paths_match_jax(levels, dtype_name, rtol, elev):
    tdt, ndt = DTYPES[dtype_name]
    args = [levels[k].astype(ndt) for k in ("z", "p", "t", "e")]
    with _jax_x64(dtype_name):
        want_lb = np.asarray(jgeo.slant_path_lengths_lb(*args, elev))
        want_1 = np.asarray(jgeo.slant_path_lengths(*(a[:, 0] for a in args),
                                                    elev))
    targs = [torch.from_numpy(a) for a in args]
    got_lb = geometry.slant_path_lengths_lb(*targs, elev).numpy()
    got_1 = geometry.slant_path_lengths(*(a[:, 0] for a in targs),
                                        elev).numpy()
    assert got_lb.dtype == ndt and got_lb.shape == want_lb.shape
    np.testing.assert_allclose(got_lb, want_lb, rtol=rtol, atol=0)
    np.testing.assert_allclose(got_1, want_1, rtol=rtol, atol=0)


def test_zenith_slant_path_equals_dz():
    z = torch.linspace(0.0, 20000.0, 50, dtype=torch.float64)
    p = 1013.0 * torch.exp(-z / 7800.0)
    t = torch.full((50,), 270.0, dtype=torch.float64)
    ds = geometry.slant_path_lengths(z, p, t, 0.01 * p, 90.0)
    np.testing.assert_allclose(ds.numpy(), np.diff(z.numpy()) * 1e-3,
                               rtol=1e-9)


def _slant_stack(levels, ndt):
    args = [levels[k].astype(ndt) for k in ("z", "p", "t", "e")]
    return np.stack([np.asarray(jgeo.slant_path_lengths_lb(*args, el))
                     for el in ELEVS])


@pytest.mark.parametrize("alpha_is_mid", [False, True], ids=["level", "mid"])
@pytest.mark.parametrize("dtype_name,atol", [("float64", 1e-9),
                                             ("float32", 2e-3)])
def test_lb_rte_matches_jax(levels, dtype_name, atol, alpha_is_mid):
    """Same alpha and ds into both packages: TBs agree to 1e-9 K in fp64 and
    2e-3 K in fp32."""
    tdt, ndt = DTYPES[dtype_name]
    alpha = levels["alpha"].astype(ndt)
    if alpha_is_mid:
        alpha = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).astype(ndt)
    t = levels["t"].astype(ndt)
    f = np.asarray(FREQS, ndt)
    with _jax_x64(dtype_name):
        ds = _slant_stack(levels, ndt)
        fn = (jrte.downwelling_tb_lb_from_alpha_mid if alpha_is_mid
              else jrte.downwelling_tb_lb_multi)
        want = {k: np.asarray(v) for k, v in fn(alpha, ds, t, f).items()}
    tfn = (rte.downwelling_tb_lb_from_alpha_mid if alpha_is_mid
           else rte.downwelling_tb_lb_multi)
    got = tfn(*(torch.from_numpy(a) for a in (alpha, ds, t, f)))
    assert set(got) == set(want)
    for k in ("tb", "t_mr"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(got["tau_total"].numpy(), want["tau_total"],
                               rtol=1e-12 if ndt == np.float64 else 1e-5)
    np.testing.assert_allclose(got["trans_level"].numpy(),
                               want["trans_level"],
                               atol=1e-12 if ndt == np.float64 else 1e-6)


def test_single_profile_rte_matches_jax(levels):
    alpha = levels["alpha"][:, :, 0]
    t = levels["t"][:, 0]
    f = np.asarray(FREQS)
    with jax.enable_x64(True):
        ds = np.asarray(jgeo.slant_path_lengths(
            *(levels[k][:, 0] for k in ("z", "p", "t", "e")), 11.4))
        want = {k: np.asarray(v)
                for k, v in jrte.downwelling_tb(alpha, ds, t, f).items()}
    got = rte.downwelling_tb(*(torch.tensor(a) for a in (alpha, ds, t, f)))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-12, atol=1e-9,
                                   err_msg=k)


def test_emission_factor_threshold_follows_dtype():
    d = torch.tensor([1e-3, 0.01, 0.5])
    for dtype in (torch.float32, torch.float64):
        g_bot, g_top = rte._emission_factors(d.to(dtype))
        dd = d.double()
        exact_top = (1 - (1 + dd) * torch.exp(-dd)) / dd
        exact_bot = 1 - torch.exp(-dd) - exact_top
        tol = 1e-7 if dtype == torch.float32 else 1e-13
        torch.testing.assert_close(g_top.double(), exact_top, rtol=0, atol=tol)
        torch.testing.assert_close(g_bot.double(), exact_bot, rtol=0, atol=tol)


def test_rte_isothermal_closed_form():
    """Isothermal atmosphere: radiance = B(T)(1-e^-tau) + B(Tc) e^-tau
    exactly, for any layering."""
    t0, f = 275.0, 31.4
    n = 60
    alpha = torch.full((1, n), 0.012, dtype=torch.float64)
    ds = torch.from_numpy(np.geomspace(0.05, 3.0, n - 1))
    t = torch.full((n,), t0, dtype=torch.float64)
    fr = torch.tensor([f], dtype=torch.float64)
    out = rte.downwelling_tb(alpha, ds, t, fr)
    tau = float(torch.sum(0.5 * (alpha[0, :-1] + alpha[0, 1:]) * ds))
    b = float(rte.planck_tb(torch.tensor(t0, dtype=torch.float64), fr))
    bc = float(rte.planck_tb(physics.T_COSMIC, fr))
    rad = b * (1 - np.exp(-tau)) + bc * np.exp(-tau)
    want = float(rte.inverse_planck_tb(torch.tensor(rad, dtype=torch.float64),
                                       fr))
    assert abs(float(out["tb"][0]) - want) < 1e-9
    assert abs(float(out["tau_total"][0]) - tau) < 1e-12


def test_rte_linear_source_closed_form():
    """Source linear in cumulative opacity: the layered linear-in-tau scheme
    integrates B(tau) = B0 + c*tau exactly."""
    f = torch.tensor([52.28], dtype=torch.float64)
    n = 40
    dtau = torch.from_numpy(np.linspace(0.002, 0.35, n - 1))
    tau_lev = torch.cat([torch.zeros(1, dtype=torch.float64),
                         torch.cumsum(dtau, 0)])
    b0, c = 210.0, 14.0
    t_lev = rte.inverse_planck_tb(b0 + c * tau_lev, f)
    out = rte.downwelling_tb_from_dtau(dtau[None, :], t_lev, f,
                                       t_cosmic=1e-8)
    tt = float(tau_lev[-1])
    rad_exact = b0 * (1 - np.exp(-tt)) + c * (1 - (1 + tt) * np.exp(-tt))
    got = float(rte.planck_tb(out["tb"][0], f))
    assert abs(got - rad_exact) < 1e-9


@pytest.mark.parametrize("want_trans", [False, True], ids=["tb", "trans"])
def test_forward_lb_reference_matches_jax(levels, want_trans):
    """The plain version of K2 (chords from the refractive index, then the
    RTE) against JAX's slant_path_lengths_lb + downwelling_tb_lb_multi."""
    z, p, t, e = (levels[k] for k in ("z", "p", "t", "e"))
    n = geometry.refractive_index(*(torch.from_numpy(a) for a in (p, t, e)))
    got = k2.forward_lb_reference(FREQS, ELEVS, torch.from_numpy(
        levels["alpha"]), torch.from_numpy(z), n, torch.from_numpy(t),
        want_trans_level=want_trans)
    with jax.enable_x64(True):
        want = jrte.downwelling_tb_lb_multi(
            levels["alpha"], _slant_stack(levels, np.float64), t,
            np.asarray(FREQS), want_trans_level=want_trans)
    assert set(got) == set(want)
    assert got["tb"].shape == (len(ELEVS), len(FREQS), z.shape[1])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-12,
                                   atol=1e-9, err_msg=k)


def test_forward_lb_reference_alpha_is_mid(levels):
    """Layer-mean input gives the same result as the level alpha it was
    averaged from."""
    alpha = torch.from_numpy(levels["alpha"])
    z, t = (torch.from_numpy(levels[k]) for k in ("z", "t"))
    n = geometry.refractive_index(*(torch.from_numpy(levels[k])
                                    for k in ("p", "t", "e")))
    lvl = k2.forward_lb_reference(FREQS, ELEVS, alpha, z, n, t,
                                  want_trans_level=True)
    mid = k2.forward_lb_reference(FREQS, ELEVS,
                                  0.5 * (alpha[:, :-1] + alpha[:, 1:]), z, n,
                                  t, alpha_is_mid=True, want_trans_level=True)
    for k in lvl:
        torch.testing.assert_close(mid[k], lvl[k], rtol=1e-13, atol=1e-12)
    assert mid["trans_level"].shape == (len(ELEVS), len(FREQS),
                                        z.shape[0], z.shape[1])
    assert bool((mid["trans_level"][:, :, 0] == 1).all())


def test_wrapper_takes_the_plain_version_on_cpu(levels):
    args = [torch.from_numpy(levels[k]).float() for k in ("alpha", "z")]
    n = geometry.refractive_index(*(torch.from_numpy(levels[k]).float()
                                    for k in ("p", "t", "e")))
    t = torch.from_numpy(levels["t"]).float()
    got = k2.forward_lb(FREQS, ELEVS, *args, n, t, want_trans_level=True)
    assert k2.forward_lb.launches == 0
    want = k2.forward_lb_reference(FREQS, ELEVS, *args, n, t,
                                   want_trans_level=True)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("elev", [30.0, 4.2])
def test_airmass_and_local_zenith_match_jax(levels, elev):
    args = [levels[k][:, 1] for k in ("z", "p", "t", "e")]
    with jax.enable_x64(True):
        want_am = float(jgeo.airmass(*args, elev))
        want_za = np.asarray(jgeo.local_zenith_angles(*args, elev))
    targs = [torch.from_numpy(a) for a in args]
    am = geometry.airmass(*targs, elev)
    za = geometry.local_zenith_angles(*targs, elev)
    assert abs(float(am) - want_am) <= 1e-12 * want_am
    np.testing.assert_allclose(za.numpy(), want_za, rtol=1e-12, atol=1e-10)
    # over the curved Earth the ray steepens against the local vertical
    assert bool((torch.diff(za) < 0).all())


@pytest.mark.parametrize("emissivity", [1.0, 0.6])
def test_upwelling_matches_jax(levels, emissivity):
    alpha = levels["alpha"][:, :, 0]
    t = levels["t"][:, 0]
    f = np.asarray(FREQS)
    with jax.enable_x64(True):
        ds = np.asarray(jgeo.slant_path_lengths(
            *(levels[k][:, 0] for k in ("z", "p", "t", "e")), 90.0))
        want = {k: np.asarray(v) for k, v in jrte.upwelling_tb(
            alpha, ds, t, f, emissivity=emissivity).items()}
    got = rte.upwelling_tb(*(torch.tensor(a) for a in (alpha, ds, t, f)),
                           emissivity=emissivity)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-12, atol=1e-9,
                                   err_msg=k)


def test_upwelling_opaque_limit():
    """An opaque isothermal column seen from the top radiates its own
    temperature."""
    f = torch.tensor([60.0], dtype=torch.float64)
    n = 30
    alpha = torch.full((1, n), 5.0, dtype=torch.float64)
    ds = torch.full((n - 1,), 1.0, dtype=torch.float64)
    t = torch.full((n,), 250.0, dtype=torch.float64)
    up = rte.upwelling_tb(alpha, ds, t, f, t_surface=torch.tensor(
        300.0, dtype=torch.float64))
    assert abs(float(up["tb"][0]) - 250.0) < 1e-6


@pytest.fixture(scope="module")
def k3_inputs():
    """The shape of the JAX package's fused-RTE test: F=5, L=60, B=128,
    E=3, float32."""
    rng = np.random.default_rng(0)
    nf, n_lev, batch, n_el = 5, 60, 128, 3
    return {"alpha": np.abs(rng.normal(0.05, 0.05, (nf, n_lev, batch)))
            .astype("f4"),
            "ds": np.abs(rng.normal(0.5, 0.1, (n_el, n_lev - 1, batch)))
            .astype("f4"),
            "t": (250 + 40 * rng.random((n_lev, batch))).astype("f4"),
            "freqs": tuple(np.linspace(20.0, 60.0, nf).tolist())}


def test_downwelling_lb_matches_jax_fused_kernel(k3_inputs):
    """K3's wrapper (its plain version on the CPU) against the JAX K3 in
    interpret mode, whose scan is a bf16 hi/lo matrix product: 2e-3 K."""
    from mwr_fast_forward_operators_and_lbls_tpu.ops.pallas.rte_kernel import (
        downwelling_lb_fused)
    a, ds, t, freqs = (k3_inputs[k] for k in ("alpha", "ds", "t", "freqs"))
    want = downwelling_lb_fused(freqs, a, ds, t)
    got = k2.downwelling_lb(freqs, *(torch.from_numpy(v) for v in (a, ds, t)))
    assert k2.downwelling_lb.launches == 0
    assert set(got) == {"tb", "tau_total", "t_mr"}
    for k in got:
        assert got[k].shape == (3, 5, 128)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("dtype_name,atol", [("float64", 1e-9),
                                             ("float32", 5e-4)])
@pytest.mark.parametrize("alpha_is_mid", [False, True], ids=["level", "mid"])
def test_downwelling_lb_matches_jax_xla(k3_inputs, dtype_name, atol,
                                        alpha_is_mid):
    """K3's plain version against JAX's downwelling_tb_lb_multi (or
    ..._from_alpha_mid) on the same inputs: 1e-9 K in float64; in float32
    5e-4 K, since each library's float32 TB lies 2-3e-4 K from its float64
    value at this shape."""
    tdt, ndt = DTYPES[dtype_name]
    a, ds, t = (k3_inputs[k].astype(ndt) for k in ("alpha", "ds", "t"))
    if alpha_is_mid:
        a = (0.5 * (a[:, :-1] + a[:, 1:])).astype(ndt)
    f = np.asarray(k3_inputs["freqs"], ndt)
    with _jax_x64(dtype_name):
        fn = (jrte.downwelling_tb_lb_from_alpha_mid if alpha_is_mid
              else jrte.downwelling_tb_lb_multi)
        want = {k: np.asarray(v) for k, v in fn(a, ds, t, f).items()}
    got = k2.downwelling_lb(k3_inputs["freqs"],
                            *(torch.from_numpy(v) for v in (a, ds, t)),
                            alpha_is_mid=alpha_is_mid, want_trans_level=True)
    assert set(got) == set(want) and got["tb"].dtype == tdt
    for k in ("tb", "t_mr"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(got["tau_total"].numpy(), want["tau_total"],
                               rtol=1e-12 if ndt == np.float64 else 2e-6)
    np.testing.assert_allclose(got["trans_level"].numpy(),
                               want["trans_level"],
                               atol=1e-12 if ndt == np.float64 else 1e-6)


def test_downwelling_lb_reference_is_forward_lb_on_its_chords(levels):
    """K3's plain version on the chords of K2's plain version gives K2's
    result: K3 is K2 with the slant paths as input."""
    alpha = torch.from_numpy(levels["alpha"])
    z, t = (torch.from_numpy(levels[k]) for k in ("z", "t"))
    n = geometry.refractive_index(*(torch.from_numpy(levels[k])
                                    for k in ("p", "t", "e")))
    ds = torch.stack([geometry.chord_lengths(z, n, c) for c in
                      torch.cos(torch.deg2rad(torch.tensor(
                          ELEVS, dtype=torch.float64)))])
    want = k2.forward_lb_reference(FREQS, ELEVS, alpha, z, n, t,
                                   want_trans_level=True)
    got = k2.downwelling_lb_reference(torch.tensor(FREQS, dtype=torch.float64),
                                      alpha, ds, t, want_trans_level=True)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-14, atol=1e-12)


# ---- K2's staged body: the block-level chord and Planck's series ----------

@pytest.fixture(scope="module")
def levels96():
    """(L, B) float32 levels of the 96-level demo_batch(4), their refractive
    index and R24 absorption."""
    prof = {k: v.T.contiguous()
            for k, v in lbl.demo_batch(4, 96, device="cpu").items()}
    prof["n"] = geometry.refractive_index(
        prof["p"], prof["t"], thermo.rho_to_e(prof["rho"], prof["t"]))
    prof["alpha"] = absorption_lb_reference(FREQS, prof["p"], prof["t"],
                                            prof["rho"], prof["lwc"], "R24")
    return prof


def _chords64(elevs, z, n):
    """`geometry.chord_lengths` in float64 on the float32 z and n."""
    cos_el = torch.cos(torch.deg2rad(torch.tensor(elevs,
                                                  dtype=torch.float64)))
    return torch.stack([geometry.chord_lengths(z.double(), n.double(), c)
                        for c in cos_el])


@pytest.mark.parametrize("float64,elev,rtol", [
    (True, 90.0, 1.2e-7), (True, 4.2, 1.2e-7),
    (False, 90.0, 1.2e-7), (False, 4.2, 2e-4)],
    ids=["f64-zenith", "f64-4.2", "f32-zenith", "f32-4.2"])
def test_staged_chords_against_float64(levels96, float64, elev, rtol):
    """The chord as K2 forms it against float64: in float64
    arithmetic it is float64 rounded once (6e-8); in float32 it is exact at
    zenith (dz comes from z), and at 4.2 degrees r = R_E + z rounds to half
    a metre of the 17 km that r - r_k comes to, which the square root
    halves: some 2e-5 of a chord, 2e-4 allowed."""
    z, n = levels96["z"], levels96["n"]
    got = mirrors.staged_chords((elev,), z, n, float64=float64)
    want = _chords64((elev,), z, n)
    assert got.dtype == torch.float32 and got.shape == (1, 95, 4)
    rel = float(((got.double() - want).abs() / want).max())
    assert rel <= rtol, rel
    if elev == 4.2 and not float64:
        assert rel > 1.2e-7         # the loss the float64 chord removes
    if float64 is True:
        assert torch.equal(got, mirrors.staged_chords((elev,), z, n))   # default


@pytest.mark.parametrize("elev", [90.0, 4.2])
def test_float64_chords_bring_tb_closer_to_float64(levels96, elev):
    """The float32 RTE on float64 chords against on float32 chords, both
    held to the plain version in float64 on the same float32 inputs: at 4.2
    degrees the float64 chords are the closer, and within 1e-3 K; at zenith
    the two agree."""
    alpha, z, n, t = (levels96[k] for k in ("alpha", "z", "n", "t"))
    want = k2.forward_lb_reference(FREQS, (elev,), alpha.double(), z.double(),
                                   n.double(), t.double())["tb"]
    err = {}
    for float64 in (False, True):
        ds = mirrors.staged_chords((elev,), z, n, float64=float64)
        got = k2.downwelling_lb_reference(FREQS, alpha, ds, t)["tb"]
        err[float64] = float((got.double() - want).abs().max())
    assert err[True] <= 1e-3
    if elev == 4.2:
        assert err[True] < err[False] <= 5e-3, err
    else:
        assert err[False] <= 1e-3


@pytest.mark.parametrize("t_low", [180.0, 60.0])
def test_planck_series_against_expm1(t_low):
    """Planck's series t (1 - u / 2 + u^2 / 12 - u^4 / 720) in float32
    against x / expm1(x / t) in float64, for the 14 channels and up to
    300 GHz, wherever u = x / t < 0.25: 1 ulp of t and the u^6 / 30240 term
    (under 1e-8 t) apart, 1e-4 K allowed."""
    f = torch.tensor(FREQS + (150.0, 300.0))[:, None]
    t = torch.linspace(t_low, 320.0, 200)[None, :]
    x = physics.HK_GHZ * f
    ok = x / t < 0.25
    assert bool(ok[:14].all()) and bool(ok.any(dim=1).all())
    got = mirrors.planck_series(x, t)
    want = rte.planck_tb(t.double(), f.double())
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs()[ok].max()) <= 1e-4
    # past u = 0.25 the staged body takes expm1f: the series drifts
    far = mirrors.planck_series(torch.tensor(48.0), torch.tensor(30.0))
    assert abs(float(far) - 48.0 / np.expm1(1.6)) > 1e-2


def test_forward_lb_body_names_the_plain_version_on_cpu(levels96):
    assert k2.forward_lb_body(levels96["alpha"], 10) == "plain"
