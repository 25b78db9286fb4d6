"""The port's 1D-Var retrieval against the benchmark's plain reference.

`models.retrieval.retrieve_batch` (the plain path, on the CPU) and
`mwrbench/reference/oem.py` on inputs made as the benchmark's retrieval
cell makes them (`mwrbench/drivers/oem.py::make_inputs`: seeded truth, the
float64 LBL of it plus noise, priors the truth plus a draw from Sa, the
frozen ridge fit),
at 3 profiles x 48 levels x 3 elevations x 14 channels and 3 Gauss-Newton
steps.  Numbers are the cell's own (`Driver.check`), against the limits of
`mwrbench/workloads/hatpro_oem_b1024.json`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mwrbench import run
from mwrbench.reference import oem as ref_oem
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import retrieval

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "hatpro_oem_b1024"
SMALL = {"batch": 3, "pool": 1, "n_levels": 48,
         "elevations_deg": [90.0, 30.0, 4.2], "n_iter": 3,
         "fast_fit_profiles": 32, "samples": 1}
SEED = 2**31 + 2021
KEYS = ("t", "rho", "tb_fit", "dofs")


@pytest.fixture(scope="module")
def cell():
    """(driver, limits, the float64 reference of batch 0)."""
    spec, config = run.cell_spec(CELL, SMALL)
    driver = run.make_driver(spec, config, SEED, CPU)
    return driver, spec["limits"], driver.control(0, CPU, torch.float64)


def _port(driver, dtype):
    """The port's retrieval of batch 0 in `dtype` (that of its inputs), as
    float64 tensors."""
    b = {k: v.to(dtype) for k, v in driver.pool[0].items()}
    out = retrieval.retrieve_batch(
        {"w": driver.params["w"].to(dtype)}, b["y"], b["z"], b["p"],
        b["t_prior"], b["rho_prior"], driver.cfg, b["lwc"])
    return {k: out[k].double() for k in KEYS}


@pytest.fixture(scope="module")
def port64(cell):
    return _port(cell[0], torch.float64)


@pytest.mark.parametrize("key", KEYS)
def test_the_float64_port_is_the_reference(cell, port64, key):
    """Both in float64: the same update, K by the closed form against
    autograd, the port's LAPACK Cholesky against the reference's loops.
    Rounding at 1e-16 through a system whose condition number is about
    1e5 here, over three steps, leaves 1e-11 (t 2.7e-11 K, the DFS 1e-12
    when written); 1e-8 keeps three decades of room and stays five below
    the float32 gaps."""
    _, _, ref = cell
    np.testing.assert_allclose(port64[key].numpy(), ref[key].numpy(),
                               rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def numbers32(cell):
    driver, _, _ = cell
    return driver.check([(0, driver.keep(driver.call(0)))], CPU)


@pytest.mark.parametrize("number", ("t_max_abs_k", "lnrho_max_abs",
                                    "tb_fit_max_abs_k", "dofs_max_abs",
                                    "t_p99_abs_k", "lnrho_p99_abs",
                                    "tb_fit_p99_abs_k", "nan_mismatch"))
def test_the_float32_port_is_within_the_cells_limits(cell, numbers32,
                                                     number):
    _, limits, _ = cell
    assert np.isfinite(numbers32[number])
    assert numbers32[number] <= limits[number], numbers32


def test_the_reference_in_bfloat16_is_not_correct(cell):
    """The control: one precision below the configuration's float32."""
    driver, limits, _ = cell
    numbers = driver.check([(0, driver.keep(driver.control(
        0, CPU, torch.bfloat16)))], CPU)
    assert numbers.keys() == limits.keys()
    assert any(not numbers[k] <= limits[k] for k in limits), numbers


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_the_references_cholesky_and_solve_are_lapacks(dtype):
    gen = torch.Generator().manual_seed(3)
    k = torch.randn((2, 12, 20), generator=gen, dtype=torch.float64)
    a = (k @ k.transpose(1, 2) + 0.25 * torch.eye(12)).to(dtype)
    rhs = torch.randn((2, 12, 5), generator=gen, dtype=torch.float64).to(
        dtype)
    low = ref_oem.cholesky(a)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(low, torch.linalg.cholesky(a), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(ref_oem.cholesky_solve(rhs, low),
                               torch.cholesky_solve(rhs, low), rtol=tol,
                               atol=tol)


def test_a_profile_whose_system_fails_is_nan_alone(cell):
    """A profile whose system has no finite factor (here a NaN prior at one
    level) takes no step: it comes out at its prior, NaN where that is,
    with a NaN DFS, and the batch's other profiles come out as they do
    without it."""
    driver, _, _ = cell
    b = driver.pool[0]
    params = driver.params

    def run_rows(rows, t_prior):
        return retrieval.retrieve_batch(
            params, b["y"][rows], b["z"][rows], b["p"][rows], t_prior[rows],
            b["rho_prior"][rows], driver.cfg, b["lwc"][rows])

    bad = b["t_prior"].clone()
    bad[1, 5] = float("nan")
    got = run_rows(slice(None), bad)
    alone = run_rows([0, 2], b["t_prior"])
    torch.testing.assert_close(got["t"][1], bad[1], rtol=0, atol=0,
                               equal_nan=True)
    assert not torch.isfinite(got["dofs"][1])
    for key in KEYS:
        torch.testing.assert_close(got[key][[0, 2]], alone[key], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("sigma, corr_len", ((3.0, 8.0), (0.4, 8.0),
                                             (1.0, 1.5)))
def test_the_prior_cost_is_the_dense_inverses(sigma, corr_len):
    """d^T Sa^-1 d from the tridiagonal inverse of the exponential
    correlation against the dense inverse, in float64."""
    gen = torch.Generator().manual_seed(5)
    d = torch.randn((4, 30), generator=gen, dtype=torch.float64)
    sa = retrieval._prior_covariance(30, sigma, corr_len)
    want = torch.einsum("bi,ij,bj->b", d, torch.linalg.inv(sa), d)
    torch.testing.assert_close(retrieval._prior_cost(d, sigma, corr_len),
                               want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("scale", (1.0, 3.0))
def test_the_retrieval_holds_back_the_steps_that_raise_the_cost(cell,
                                                                 scale):
    """From the cell's priors, and from priors three times as far from the
    truth, every profile ends finite, at a cost no higher than its prior's
    raised by the band of each step taken: a step that would raise the cost
    by more is not taken, so no profile diverges."""
    driver, _, _ = cell
    b = {k: v.double() for k, v in driver.pool[0].items()}
    params = {"w": driver.params["w"].double()}
    cfg = driver.cfg
    floor = cfg.rho_floor

    def lnrho(rho):
        return torch.log(torch.clamp_min(rho, 0.0) + floor)

    t_prior = b["t"] + scale * (b["t_prior"] - b["t"])
    rho_prior = torch.exp(lnrho(b["rho"]) + scale * (
        lnrho(b["rho_prior"]) - lnrho(b["rho"]))) - floor
    out = retrieval.retrieve_batch(params, b["y"], b["z"], b["p"], t_prior,
                                   rho_prior, cfg, b["lwc"])
    at_prior = retrieval.retrieve_batch(
        params, b["y"], b["z"], b["p"], t_prior, rho_prior,
        dataclasses.replace(cfg, n_iter=0), b["lwc"])
    lev = t_prior.shape[1]

    def cost(res):
        r = (b["y"] - res["tb_fit"]).reshape(len(t_prior), -1)
        return (torch.sum(r * r, dim=1) / cfg.obs_error_k ** 2
                + retrieval._prior_cost(res["t"] - t_prior, cfg.sigma_t_k,
                                        cfg.corr_length_levels)
                + retrieval._prior_cost(lnrho(res["rho"]) - lnrho(rho_prior),
                                        cfg.sigma_lnrho,
                                        cfg.corr_length_levels))

    assert out["t"].shape[1] == lev
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    bound = (1.0 + retrieval.COST_RISE_TAKEN) ** cfg.n_iter * cost(at_prior)
    assert bool((cost(out) <= bound).all()), (cost(out), cost(at_prior))
