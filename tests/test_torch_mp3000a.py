"""The Radiometrics MP-3000A's 22 channels (`mwrbench/configs/
mp3000a_l180.json`) on the CPU: the archive cell's own driver and check
(`mwrbench/drivers/lbl_forward.py`, against `mwrbench/reference/forward.py::
lbl_tb`) at 3 profiles x 48 levels x 3 elevations x 22 channels, numbers
against the limit of `mwrbench/workloads/mp3000a_archive_b4096.json`; and
the port's entry points at those channels, past the 16 that K1 and K4 took
before, against the JAX package's XLA path on the same inputs."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mwrbench import control, run
from mwrbench.drivers import batch_of
from mwr_fast_forward_operators_and_lbls_tpu.models import jacobians as jjac
from mwr_fast_forward_operators_and_lbls_tpu.models import lbl as jlbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (jacobians,
                                                                  lbl)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    absorption)

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "mp3000a_archive_b4096"
SMALL = {"batch": 3, "pool": 1, "n_levels": 48,
         "elevations_deg": [90.0, 19.2, 4.2], "samples": 1}
SEED = 2**31 + 2025


@pytest.fixture(scope="module")
def cell():
    """(driver, limits) of the cell at the small size."""
    spec, config = run.cell_spec(CELL, SMALL)
    return run.make_driver(spec, config, SEED, CPU), spec["limits"]


@pytest.fixture(scope="module")
def host(cell):
    """Batch 0 of the cell's pool: numpy (B, L) float32 arrays."""
    return batch_of(cell[0].host, 0)


def _torch(host, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in host.items()}


def test_the_channels_are_past_sixteen(cell):
    """22 channels: within the kernels' ceiling, past the 16 they took
    before; K4 takes them in three groups of 8 slots."""
    n = len(cell[0].freqs)
    assert 16 < n == 22 <= absorption.MAX_CHANNELS
    assert absorption.tangent_groups(n) == (3, 8)


def test_the_float64_port_is_the_reference(cell, host):
    """The port's plain path in float64 and the cell's reference agree to
    rounding: the reference is the port's plain physics, copied."""
    driver, _ = cell
    cfg = dataclasses.replace(driver.cfg, dtype="float64", use_kernels=False)
    port = lbl.forward_batch(_torch(host, torch.float64), cfg)["tb"]
    want = driver.control(0, CPU, torch.float64)
    assert port.shape == want.shape == (3, 3, 22)
    assert float((port - want).abs().max()) < 1e-9


def test_the_float32_port_is_within_the_cells_limit(cell):
    driver, limits = cell
    numbers = driver.check([(0, driver.keep(driver.call(0)))], CPU)
    assert numbers.keys() == limits.keys()
    assert numbers["tb_max_abs_k"] <= limits["tb_max_abs_k"], numbers


def test_the_reference_in_bfloat16_is_not_correct(cell):
    numbers = control.control_numbers(CELL, 7, torch.bfloat16, CPU, SMALL)
    assert numbers["tb_max_abs_k"] > cell[1]["tb_max_abs_k"], numbers


def _jax_cfg(driver, **kw):
    return jlbl.LBLConfig(model=driver.model, freqs_ghz=driver.freqs,
                          elevations_deg=driver.elevations, **kw)


def test_forward_batch_matches_jax_xla_in_float32(cell, host):
    """The bound of the HATPRO forward's test (test_torch_lbl.py)."""
    driver, _ = cell
    got = lbl.forward_batch(_torch(host, torch.float32), driver.cfg)["tb"]
    want = np.asarray(jlbl.forward_batch(host, _jax_cfg(driver))["tb"])
    assert got.shape == want.shape == (3, 3, 22)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def test_forward_batch_matches_jax_xla_in_float64(cell, host):
    driver, _ = cell
    cfg = dataclasses.replace(driver.cfg, dtype="float64")
    got = lbl.forward_batch(_torch(host, torch.float64), cfg)["tb"]
    with jax.enable_x64(True):
        want = np.asarray(jlbl.forward_batch(
            {k: v.astype(np.float64) for k, v in host.items()},
            _jax_cfg(driver, dtype="float64"))["tb"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def test_forward_all_models_matches_jax_xla(cell, host):
    driver, _ = cell
    models = ("R98", "R17")
    got = lbl.forward_all_models(_torch(host, torch.float32), driver.cfg,
                                 models)
    want = jlbl.forward_all_models(host, _jax_cfg(driver), models)
    assert set(got) == set(want) == set(models)
    for m in models:
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   rtol=0, atol=2e-2, err_msg=m)


def test_kmatrix_matches_jax_xla(cell, host):
    """wrt (t, rho, lwc) through K4's plain version on the CPU, float32,
    against the JAX XLA K-matrix: the JAX package's own fast-vs-jacrev
    bound, 2e-4 * max(scale, 1), as for HATPRO (test_torch_jacobians.py)."""
    driver, _ = cell
    wrt = ("t", "rho", "lwc")
    got = jacobians.kmatrix_batch_fast(_torch(host, torch.float32),
                                       driver.cfg, wrt=wrt)
    want = jjac.kmatrix_batch_fast(host, _jax_cfg(driver), wrt=wrt)
    for name in wrt:
        a, b = np.asarray(want[name]), got[name].numpy()
        assert b.shape == a.shape == (3, 3, 22, 48)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=2e-4 * max(np.abs(a).max(), 1.0),
                                   err_msg=name)
