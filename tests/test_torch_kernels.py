"""The port's CUDA kernels against their plain torch versions on the card.

The tests marked `cuda` need an NVIDIA GPU and nvcc; elsewhere they skip.
`python3 chip_smoke.py` runs the same checks at the production shape.
"""

import dataclasses

import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (jacobians,
                                                                  lbl)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import geometry, thermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import _build
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (
    absorption_lb, absorption_lb_reference, absorption_tangents_lb,
    absorption_tangents_lb_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.adjoint import (
    kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
    kmatrix_assembled_rho_lwc_lb, kmatrix_assembled_rho_lwc_lb_reference)
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


def k_error(got, ref):
    """max |got - ref| / max(|ref|, 1e-3 max |ref|): relative, with a floor
    where K crosses zero."""
    ref = ref.to(got.device, torch.float64)
    floor = 1e-3 * ref.abs().max()
    return float(((got.double() - ref).abs()
                  / torch.clamp_min(ref.abs(), floor)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(H2O_MODELS))
def test_tangent_kernel_matches_plain(device, model):
    """K4 against two jvp passes of the plain absorption: alpha to 1e-4 and
    each tangent to 1e-3 of its channel's largest value."""
    prof = _levels(67, 180, device)
    args = (FREQS, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
    before = absorption_tangents_lb.launches
    got = absorption_tangents_lb(*args)
    assert absorption_tangents_lb.launches == before + 1
    want = absorption_tangents_lb_reference(*args)
    torch.cuda.synchronize()
    for g, w, bound in zip(got, want, (1e-4, 1e-3, 1e-3)):
        assert g.shape == (len(FREQS), 180, 67) and g.is_contiguous()
        err = (g - w).abs().amax(dim=(1, 2))
        scale = w.abs().amax(dim=(1, 2))
        assert bool((err <= bound * scale).all()), (err / scale).max()


def _k5_inputs(batch, device):
    prof = _levels(batch, 180, device)
    cfg = lbl.LBLConfig()
    alpha, da_t, da_rho = absorption_tangents_lb(
        FREQS, prof["p"], prof["t"], prof["rho"], prof["lwc"], "R24")
    da = {"t": da_t, "rho": da_rho,
          "lwc": jacobians._dalpha_dlwc(cfg, prof["t"])}
    return alpha, da, jacobians._slant_geometry(prof, cfg, ("t", "rho")), \
        prof["t"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["t", "rho", "lwc", "rho_lwc"])
@pytest.mark.parametrize("batch", [3, 200])
def test_kmatrix_kernel_matches_plain(device, batch, which):
    """K5 against its plain version run in float64 on the same float32
    inputs (in float32 the plain S_k = atm - cumsum cancels near the column
    top): 1e-3 relative, floored at 1e-3 of the largest entry."""
    alpha, da, g, t = _k5_inputs(batch, device)
    geo = [g["dds_dnl"], g["dds_dk"], g["dn"]["t" if which == "t" else "rho"],
           g["r0cos"]]
    if which == "rho_lwc":
        args = [alpha, da["rho"], da["lwc"], g["ds"], t, *geo]
        before = kmatrix_assembled_rho_lwc_lb.launches
        got = kmatrix_assembled_rho_lwc_lb(FREQS, *args)
        assert kmatrix_assembled_rho_lwc_lb.launches == before + 1
        want = kmatrix_assembled_rho_lwc_lb_reference(
            FREQS, *(a.double() for a in args))
    else:
        args = [alpha, da[which], g["ds"], t,
                *([] if which == "lwc" else geo)]
        before = kmatrix_assembled_lb.launches
        got = [kmatrix_assembled_lb(FREQS, which, *args)]
        assert kmatrix_assembled_lb.launches == before + 1
        want = [kmatrix_assembled_lb_reference(
            FREQS, which, *(a.double() for a in args))]
    torch.cuda.synchronize()
    for k, w in zip(got, want):
        assert k.shape == (len(ELEVS), len(FREQS), 180, batch)
        assert bool(torch.isfinite(k).all())
        assert k_error(k, w) <= 1e-3


@pytest.mark.cuda
def test_kmatrix_path_launches_each_kernel_once(device):
    profiles = lbl.demo_batch(130, 180, device=device)
    counters = (absorption_tangents_lb, kmatrix_assembled_lb,
                kmatrix_assembled_rho_lwc_lb)
    before = [c.launches for c in counters]
    got = jacobians.kmatrix_batch_fast(profiles, lbl.LBLConfig(),
                                       wrt=("t", "rho", "lwc"))
    assert [c.launches for c in counters] == [b + 1 for b in before]
    want = jacobians.kmatrix_batch_fast(
        {k: v.double() for k, v in profiles.items()},
        lbl.LBLConfig(dtype="float64", use_kernels=False),
        wrt=("t", "rho", "lwc"))
    for name, k in got.items():
        assert k.shape == (130, len(ELEVS), len(FREQS), 180)
        assert k_error(k, want[name]) <= 1e-3, name
    # the reference's own routing: "p" and use_kernels=False stay plain
    before = [c.launches for c in counters]
    jacobians.kmatrix_batch_fast(profiles, lbl.LBLConfig(), wrt=("t", "p"))
    jacobians.kmatrix_batch_fast(profiles, lbl.LBLConfig(use_kernels=False))
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="fused K-matrix"):
        jacobians.kmatrix_batch_fast(profiles, lbl.LBLConfig(),
                                     wrt=("t", "p"), fused=True)
    with pytest.raises(ValueError, match="fused K-matrix"):
        jacobians.kmatrix_batch_fast(profiles,
                                     lbl.LBLConfig(use_kernels=False),
                                     fused=True)


@pytest.mark.cuda
def test_kmatrix_wrappers_refuse_what_the_kernels_do_not_take(device):
    prof = _levels(4, 20, device)
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    with pytest.raises(TypeError):
        absorption_tangents_lb(FREQS, args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        absorption_tangents_lb(FREQS, args[0][:, :2], *args[1:])
    with pytest.raises(ValueError):
        absorption_tangents_lb(FREQS + FREQS, *args)
    alpha, da, g, t = _k5_inputs(4, device)
    with pytest.raises(TypeError):
        kmatrix_assembled_lb(FREQS, "lwc", alpha.double(), da["lwc"],
                             g["ds"], t)
    with pytest.raises(ValueError):
        kmatrix_assembled_lb(FREQS, "lwc", alpha, da["lwc"], g["ds"][:, 1:],
                             t)
    with pytest.raises(ValueError):
        kmatrix_assembled_rho_lwc_lb(FREQS, alpha, da["rho"], da["lwc"][:2],
                                     g["ds"], t, g["dds_dnl"], g["dds_dk"],
                                     g["dn"]["rho"], g["r0cos"])
    profiles = lbl.demo_batch(2, 20, device=device)
    for fused in (None, True):
        with pytest.raises(ValueError, match="float32 only"):
            jacobians.kmatrix_batch_fast(profiles,
                                         lbl.LBLConfig(dtype="float64"),
                                         fused=fused)
