"""The port's humidity and thermodynamic conversions (`ops/thermo.py`) against
the JAX package's on the same inputs, in float64."""

import jax
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.ops import thermo as jthermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import thermo

torch.set_num_threads(1)

_RNG = np.random.default_rng(11)
N = 50
INPUTS = {
    "t": _RNG.uniform(200.0, 310.0, N),
    "p": _RNG.uniform(50.0, 1050.0, N),
    "e": _RNG.uniform(0.01, 30.0, N),
    "rh": _RNG.uniform(1.0, 100.0, N),
    "mr": _RNG.uniform(0.01, 20.0, N),
    "q": _RNG.uniform(0.01, 20.0, N),
    "ppmv": _RNG.uniform(10.0, 30000.0, N),
    "rho": _RNG.uniform(0.01, 25.0, N),
}

# function name -> the names of its arguments in INPUTS
UNARY = {
    "es_clausius_clapeyron": ("t",), "es_magnus": ("t",), "es_ice": ("t",),
    "rh_to_e": ("rh", "t"), "e_to_rh": ("e", "t"), "e_to_mr": ("e", "p"),
    "mr_to_e": ("mr", "p"), "rh_to_mr": ("rh", "p", "t"),
    "mr_to_rh": ("mr", "p", "t"), "mr_to_ppmv": ("mr",),
    "ppmv_to_mr": ("ppmv",), "e_to_rho": ("e", "t"), "rho_to_e": ("rho", "t"),
    "mr_to_rho": ("mr", "p", "t"), "specific_to_mr": ("q",),
    "mr_to_specific": ("mr",), "virtual_temperature": ("t", "mr"),
    "density_moist": ("p", "t", "mr"), "potential_temperature": ("t", "p"),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_conversion_matches_jax(name):
    args = [INPUTS[k] for k in UNARY[name]]
    with jax.enable_x64(True):
        want = np.asarray(getattr(jthermo, name)(*args))
    got = getattr(thermo, name)(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_rh_to_e_over_ice_mask():
    t = torch.from_numpy(INPUTS["t"])
    rh = torch.from_numpy(INPUTS["rh"])
    mask = t < 260.0
    got = thermo.rh_to_e(rh, t, over_ice=mask)
    with jax.enable_x64(True):
        want = np.asarray(jthermo.rh_to_e(INPUTS["rh"], INPUTS["t"],
                                          over_ice=jax.numpy.asarray(
                                              mask.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    torch.testing.assert_close(thermo.rh_to_e(rh, t, over_ice=True),
                               thermo.rh_to_e(rh, t, over_ice=torch.ones_like(
                                   mask)), rtol=0, atol=0)


def test_profile_diagnostics_match_jax():
    rng = np.random.default_rng(2)
    z = np.cumsum(rng.uniform(50.0, 300.0, (3, 40)), axis=1)
    rho = rng.uniform(0.1, 15.0, (3, 40))
    t = 290.0 - 6.5e-3 * z
    p = 1013.0 * np.exp(-z / 7800.0)
    mr = rng.uniform(0.1, 12.0, (3, 40))
    u, v = rng.normal(0, 5, (3, 40)), rng.normal(0, 5, (3, 40))
    with jax.enable_x64(True):
        want_iwv = np.asarray(jthermo.iwv_from_profile(rho, z))
        want_iwv0 = np.asarray(jthermo.iwv_from_profile(rho.T, z.T, axis=0))
        want_ri = np.asarray(jthermo.bulk_richardson(z, t, p, mr, u, v))
        want_p = np.asarray(jthermo.barometric_pressure(1013.0, t, 0.0, z))
    tt = {k: torch.from_numpy(a) for k, a in
          dict(z=z, rho=rho, t=t, p=p, mr=mr, u=u, v=v).items()}
    np.testing.assert_allclose(
        thermo.iwv_from_profile(tt["rho"], tt["z"]).numpy(), want_iwv,
        rtol=1e-12)
    np.testing.assert_allclose(
        thermo.iwv_from_profile(tt["rho"].T, tt["z"].T, axis=0).numpy(),
        want_iwv0, rtol=1e-12)
    np.testing.assert_allclose(
        thermo.bulk_richardson(tt["z"], tt["t"], tt["p"], tt["mr"], tt["u"],
                               tt["v"]).numpy(), want_ri, rtol=1e-10,
        atol=1e-12)
    np.testing.assert_allclose(
        thermo.barometric_pressure(1013.0, tt["t"], 0.0, tt["z"]).numpy(),
        want_p, rtol=1e-12)


def test_round_trips_and_magnitudes():
    t = torch.tensor([250.0, 273.15, 300.0], dtype=torch.float64)
    p = torch.tensor([500.0, 850.0, 1000.0], dtype=torch.float64)
    e = thermo.rh_to_e(torch.full_like(t, 60.0), t)
    torch.testing.assert_close(thermo.e_to_rh(e, t), torch.full_like(t, 60.0))
    torch.testing.assert_close(thermo.mr_to_e(thermo.e_to_mr(e, p), p), e)
    torch.testing.assert_close(thermo.rho_to_e(thermo.e_to_rho(e, t), t), e)
    torch.testing.assert_close(
        thermo.mr_to_specific(thermo.specific_to_mr(torch.tensor(8.0))),
        torch.tensor(8.0))
    # 6.11 hPa at the triple point
    assert abs(float(thermo.es_clausius_clapeyron(torch.tensor(273.15)))
               - 6.1078) < 1e-4
    assert bool((thermo.virtual_temperature(t, torch.full_like(t, 10.0))
                 > t).all())
