"""The port's CUDA kernels against their plain torch versions on the card.

The tests marked `cuda` need an NVIDIA GPU and nvcc; elsewhere they skip.
`python3 chip_smoke.py` runs the same checks at the production shape.
"""

import dataclasses

import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import geometry, thermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import _build
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (
    absorption_lb, absorption_lb_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
    forward_lb, forward_lb_reference)

torch.set_num_threads(1)

FREQS = lbl.LBLConfig().freqs_ghz
ELEVS = lbl.LBLConfig().elevations_deg


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _levels(batch, n_levels, device):
    return {k: v.T.contiguous()
            for k, v in lbl.demo_batch(batch, n_levels, device=device).items()}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.cuda
@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
@pytest.mark.parametrize("model", sorted(H2O_MODELS))
def test_absorption_kernel_matches_plain(device, model, with_o3):
    prof = _levels(67, 180, device)
    o3 = lbl._afgl_o3(prof["z"]) if with_o3 else None
    args = (FREQS, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
    before = absorption_lb.launches
    got = absorption_lb(*args, o3=o3)
    assert absorption_lb.launches == before + 1
    want = absorption_lb_reference(*args, o3=o3)
    torch.cuda.synchronize()
    err = (got - want).abs().amax(dim=(1, 2))
    scale = want.abs().amax(dim=(1, 2))
    assert bool((err <= 1e-4 * scale).all()), (err / scale).max()


@pytest.mark.cuda
@pytest.mark.parametrize("alpha_is_mid", [False, True], ids=["level", "mid"])
@pytest.mark.parametrize("want_trans", [False, True], ids=["tb", "trans"])
@pytest.mark.parametrize("batch", [3, 200])
def test_rte_kernel_matches_plain(device, batch, want_trans, alpha_is_mid):
    prof = _levels(batch, 180, device)
    alpha = absorption_lb(FREQS, prof["p"], prof["t"], prof["rho"],
                          prof["lwc"], "R24")
    if alpha_is_mid:
        alpha = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).contiguous()
    n = geometry.refractive_index(prof["p"], prof["t"],
                                  thermo.rho_to_e(prof["rho"], prof["t"]))
    args = (FREQS, ELEVS, alpha, prof["z"], n, prof["t"], alpha_is_mid,
            want_trans)
    before = forward_lb.launches
    got = forward_lb(*args)
    assert forward_lb.launches == before + 1
    want = forward_lb_reference(*args)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    assert float((got["tb"] - want["tb"]).abs().max()) <= 5e-3
    torch.testing.assert_close(got["tau_total"], want["tau_total"],
                               rtol=1e-4, atol=0)
    if want_trans:
        assert float((got["trans_level"] - want["trans_level"])
                     .abs().max()) <= 1e-5


@pytest.mark.cuda
def test_main_path_launches_both_kernels(device):
    profiles = lbl.demo_batch(130, 180, device=device)
    cfg = lbl.LBLConfig(outputs=("tb", "trans_level"))
    before = (absorption_lb.launches, forward_lb.launches)
    got = lbl.forward_batch(profiles, cfg)
    assert (absorption_lb.launches, forward_lb.launches) == \
        (before[0] + 1, before[1] + 1)
    want = lbl.forward_batch(profiles, dataclasses.replace(cfg,
                                                           use_kernels=False))
    assert float((got["tb"] - want["tb"]).abs().max()) <= 1e-2
    assert float((got["trans_level"] - want["trans_level"])
                 .abs().max()) <= 1e-5


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    prof = _levels(4, 20, device)
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    with pytest.raises(TypeError):
        absorption_lb(FREQS, args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        absorption_lb(FREQS, args[0][:, :2], *args[1:])
    with pytest.raises(ValueError):
        absorption_lb(FREQS + FREQS, *args)
    with pytest.raises(ValueError, match="float32 only"):
        lbl.forward_batch(lbl.demo_batch(2, 20, device=device),
                          lbl.LBLConfig(dtype="float64"))
    alpha = absorption_lb(FREQS, *args)
    with pytest.raises(ValueError):
        forward_lb(FREQS, ELEVS, alpha[:, :-1], prof["z"], prof["p"],
                   prof["t"])
