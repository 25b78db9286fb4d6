"""The port's CUDA kernels against their plain torch versions on the card.

The tests marked `cuda` need an NVIDIA GPU and nvcc; elsewhere they skip.
`python3 chip_smoke.py` runs the same checks at the production shape.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (fast,
                                                                  jacobians,
                                                                  lbl,
                                                                  retrieval,
                                                                  spectral)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import geometry, thermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.absorption import (
    n2_absorption)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import _build
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (
    absorption_lb, absorption_lb_float64, absorption_lb_reference,
    absorption_tangents_lb, absorption_tangents_lb_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.adjoint import (
    kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
    kmatrix_assembled_rho_lwc_lb, kmatrix_assembled_rho_lwc_lb_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.chain import (
    OPS as CHAIN_OPS, chain, chain_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
    downwelling_lb, downwelling_lb_reference, forward_lb, forward_lb_body,
    forward_lb_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    spectral as k6)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.spectral import (
    absorption_spectral, absorption_spectral_reference)
from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import profiling

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
        # the kernel forms its chords in float64 and is held to the plain
        # version in float64 on the same inputs; the plain float32 version
        # itself is 1.2e-5 off that at 4.2 degrees
        want = forward_lb_reference(
            FREQS, ELEVS, alpha.double(), prof["z"].double(), n.double(),
            prof["t"].double(), alpha_is_mid, want_trans)
        assert float((got["trans_level"].double() - want["trans_level"])
                     .abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
@pytest.mark.parametrize("model", ["R24", "R20SD", "R03"])
@pytest.mark.parametrize("n_channels", [1, 7, 14, 16])
def test_absorption_kernel_channel_counts(device, n_channels, model, with_o3):
    """K1 at F channels on 37 x 67 points (not a multiple of the block's 128
    nor of 32), against its plain version (1e-4 of each channel's largest
    alpha) and against the function in float64 on the float32 tables
    (5e-6)."""
    prof = _levels(67, 37, device)
    freqs = tuple(torch.linspace(22.24, 58.0, n_channels).tolist())
    o3 = lbl._afgl_o3(prof["z"]) if with_o3 else None
    args = (freqs, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
    got = absorption_lb(*args, o3=o3)
    want = absorption_lb_reference(*args, o3=o3)
    want64 = absorption_lb_float64(*args, o3=o3)
    torch.cuda.synchronize()
    assert got.shape == (n_channels, 37, 67)
    assert bool(torch.isfinite(got).all())
    scale = want64.abs().amax(dim=(1, 2))
    assert bool(((got - want).abs().amax(dim=(1, 2)) <= 1e-4 * scale).all())
    err64 = (got.double() - want64).abs().amax(dim=(1, 2))
    assert bool((err64 <= 5e-6 * scale).all()), (err64 / scale).max()


@pytest.mark.cuda
def test_absorption_kernel_outside_the_cutoff(device):
    """A channel beyond the 750 GHz cutoff of some lines: every channel then
    takes the halves apart."""
    prof = _levels(5, 60, device)
    args = ((22.24, 183.31, 900.0), prof["p"], prof["t"], prof["rho"],
            prof["lwc"])
    for model in ("R24", "R19SD"):
        got = absorption_lb(*args, model)
        want64 = absorption_lb_float64(*args, model)
        scale = want64.abs().amax(dim=(1, 2))
        err = (got.double() - want64).abs().amax(dim=(1, 2))
        assert bool((err <= 5e-6 * scale).all()), (model, err / scale)


def _unaligned(a):
    """A contiguous copy of `a` that starts 4 bytes into its storage."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


WIDE, NARROW = "staged", "staged, 4-byte copies"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,alpha_is_mid,want_trans,aligned,body", [
    ((10, 14, 64, 180), False, False, True, WIDE),     # the retrieval's
    ((10, 14, 64, 180), True, True, True, WIDE),
    ((3, 14, 28, 37), False, True, True, WIDE),        # a tile part empty
    ((2, 16, 8, 6), True, False, True, WIDE),          # a block's 16
    ((2, 18, 20, 9), False, True, True, WIDE),         # blocks of 10 and 8
    ((1, 5, 4, 2), False, False, True, WIDE),          # one layer, odd F
    ((10, 14, 3, 180), False, True, True, NARROW),     # B not a multiple
    ((3, 14, 30, 37), True, False, True, NARROW),      # of 4
    ((2, 15, 17, 11), True, True, True, NARROW),       # one profile past 16
    ((3, 14, 28, 37), False, False, False, NARROW),    # alpha off 16 bytes
    ((3, 14, 28, 37), True, True, False, NARROW),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_forward_bodies_match_plain(device, shape, alpha_is_mid, want_trans,
                                    aligned, body):
    """K2 with both sizes of its asynchronous copies, over shapes that take
    each: tb within 5e-3 K of the plain float32 version; its chords are
    float64, so it is held to the plain version in float64 on the same inputs
    (tb 2e-3 K, trans_level 1e-5).  Where alpha lies changes the copies and
    not one bit of the result."""
    n_el, nf, batch, n_lev = shape
    elevs = ELEVS[-n_el:]                  # the lowest ones: 4.2 degrees is in
    prof = _levels(batch, n_lev, device)
    freqs = tuple(torch.linspace(22.24, 58.0, nf).tolist())
    # K6 takes any number of frequencies (K1 at most 16)
    owned = absorption_spectral(freqs, prof["p"], prof["t"], prof["rho"],
                                prof["lwc"], "R24")
    if alpha_is_mid:
        owned = (0.5 * (owned[:, :-1] + owned[:, 1:])).contiguous()
    alpha = owned if aligned else _unaligned(owned)
    n = geometry.refractive_index(prof["p"], prof["t"],
                                  thermo.rho_to_e(prof["rho"], prof["t"]))
    z, t = prof["z"], prof["t"]
    assert forward_lb_body(alpha, n_el, alpha_is_mid) == body
    before = forward_lb.launches
    got = forward_lb(freqs, elevs, alpha, z, n, t, alpha_is_mid, want_trans)
    assert forward_lb.launches == before + 1
    want = forward_lb_reference(freqs, elevs, alpha, z, n, t, alpha_is_mid,
                                want_trans)
    want64 = forward_lb_reference(freqs, elevs, alpha.double(), z.double(),
                                  n.double(), t.double(), alpha_is_mid,
                                  want_trans)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    assert got["tb"].shape == (n_el, nf, batch)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    assert float((got["tb"] - want["tb"]).abs().max()) <= 5e-3
    assert float((got["tb"].double() - want64["tb"]).abs().max()) <= 2e-3
    torch.testing.assert_close(got["tau_total"].double(),
                               want64["tau_total"], rtol=2e-6, atol=0)
    if want_trans:
        assert got["trans_level"].shape == (n_el, nf, n_lev, batch)
        assert float((got["trans_level"].double() - want64["trans_level"])
                     .abs().max()) <= 1e-5
    if not aligned:
        same = forward_lb(freqs, elevs, owned, z, n, t, alpha_is_mid,
                          want_trans)
        assert forward_lb_body(owned, n_el, alpha_is_mid) == (
            WIDE if batch % 4 == 0 else NARROW)
        assert all(torch.equal(got[k], same[k]) for k in got)


@pytest.mark.cuda
def test_forward_lb_refuses_more_levels_than_shared_memory_holds(device):
    lev, batch = 2000, 4
    z = torch.linspace(0.0, 25e3, lev, device=device)[:, None].repeat(1, batch)
    t = torch.full_like(z, 250.0)
    n = torch.ones_like(z)
    alpha = torch.full((2, lev, batch), 1e-3, device=device)
    with pytest.raises(ValueError, match="L=2000"):
        forward_lb_body(alpha, 1)
    before = forward_lb.launches
    with pytest.raises(ValueError, match="L=2000"):
        forward_lb((22.24, 31.4), (90.0,), alpha, z, n, t)
    assert forward_lb.launches == before
    long = forward_lb((22.24, 31.4), (90.0,), alpha[:, :1500].contiguous(),
                      z[:1500], n[:1500], t[:1500])
    want = forward_lb_reference((22.24, 31.4), (90.0,),
                                alpha[:, :1500].contiguous(), z[:1500],
                                n[:1500], t[:1500])
    assert float((long["tb"] - want["tb"]).abs().max()) <= 5e-3


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
    # K2's chords are float64: trans_level is held to the plain path in
    # float64 (the plain float32 path is 1.2e-5 off that at 4.2 degrees)
    want64 = lbl.forward_batch(
        {k: v.double() for k, v in profiles.items()},
        dataclasses.replace(cfg, dtype="float64", use_kernels=False))
    assert float((got["trans_level"].double() - want64["trans_level"])
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
@pytest.mark.parametrize("model,n_channels", [
    *((m, len(FREQS)) for m in sorted(H2O_MODELS)), ("R24", 16), ("R24", 1),
    ("R20SD", 9)])
def test_tangent_kernel_matches_plain(device, model, n_channels):
    """K4 against two jvp passes of the plain absorption: alpha to 1e-4 and
    each tangent to 1e-3 of its channel's largest value.  The HATPRO
    channels are two groups of 7; 16 channels two full groups of 8, one
    channel a group of one, 9 channels groups of 5 and 4 (one slot of
    padding)."""
    prof = _levels(67, 180, device)
    freqs = (FREQS if n_channels == len(FREQS) else
             tuple(torch.linspace(22.24, 58.0, n_channels).tolist()))
    args = (freqs, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
    before = absorption_tangents_lb.launches
    got = absorption_tangents_lb(*args)
    assert absorption_tangents_lb.launches == before + 1
    want = absorption_tangents_lb_reference(*args)
    torch.cuda.synchronize()
    for g, w, bound in zip(got, want, (1e-4, 1e-3, 1e-3)):
        assert g.shape == (n_channels, 180, 67) and g.is_contiguous()
        err = (g - w).abs().amax(dim=(1, 2))
        scale = w.abs().amax(dim=(1, 2))
        assert bool((err <= bound * scale).all()), (err / scale).max()


def _k5_inputs(batch, device, n_levels=180):
    prof = _levels(batch, n_levels, device)
    cfg = lbl.LBLConfig()
    alpha, da_t, da_rho = absorption_tangents_lb(
        FREQS, prof["p"], prof["t"], prof["rho"], prof["lwc"], "R24")
    da = {"t": da_t, "rho": da_rho,
          "lwc": jacobians._dalpha_dlwc(cfg, prof["t"])}
    return alpha, da, jacobians._slant_geometry(prof, cfg, ("t", "rho")), \
        prof["t"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["t", "rho", "lwc", "rho_lwc"])
@pytest.mark.parametrize("batch,n_levels", [(3, 180), (200, 180), (33, 180),
                                            (33, 2), (33, 20)])
def test_kmatrix_kernel_matches_plain(device, batch, n_levels, which):
    """K5 against its plain version run in float64 on the same float32
    inputs (in float32 the plain S_k = atm - cumsum cancels near the column
    top): 1e-3 relative, floored at 1e-3 of the largest entry.  B=33 leaves
    one lane of the last group of 32 profiles; L=2 is one layer, one warp a
    block; L=20 splits 19 layers into chunks of two and three."""
    alpha, da, g, t = _k5_inputs(batch, device, n_levels)
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
        assert k.shape == (len(ELEVS), len(FREQS), n_levels, batch)
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


def _grid(nf, device):
    """nf frequencies over 20-64 GHz: 8-frequency tiles and a tail."""
    return torch.linspace(20.0, 64.0, nf, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(H2O_MODELS))
def test_spectral_kernel_matches_plain(device, model):
    """K6 against its plain version on (L, B) points (39 groups of 32 and a
    tail of 12) and a grid of 8-wide tiles plus a tail of 5: 1e-4 of each
    frequency's largest alpha."""
    prof = _levels(7, 180, device)
    f = _grid(101, device)
    args = (f, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
    before = absorption_spectral.launches
    got = absorption_spectral(*args)
    assert absorption_spectral.launches == before + 1
    want = absorption_spectral_reference(*args)
    torch.cuda.synchronize()
    assert got.shape == (101, 180, 7) and bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(dim=(1, 2))
    scale = want.abs().amax(dim=(1, 2))
    assert bool((err <= 1e-4 * scale).all()), (err / scale).max()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["R24", "R20SD"])
def test_spectral_state_pass_matches_plain(device, model):
    """K6's first pass against `line_state` in float64, row by row: 1e-5 of
    each row's largest value (R20SD has the three rows more of the qSD
    lines)."""
    prof = _levels(7, 180, device)
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    before = absorption_spectral.launches
    state = k6.line_state_pass(*args, model)
    assert absorption_spectral.launches == before
    want = k6.line_state(*(a.reshape(-1).double() for a in args), model)
    h2o_rows = ("wsq", "sw", "sb", "sn", "c0", "gamma2")[:k6.h2o_slots(model)]
    rows = torch.stack(
        [want["scalars"][k] for k in k6.STATE_SCALARS]
        + [want["h2o"][k][:, line]
           for line in range(want["h2o"]["sw"].shape[1]) for k in h2o_rows]
        + [want["o2"][k][:, line]
           for line in range(want["o2"]["dnu"].shape[1])
           for k in ("dnu", "c2", "dfsq", "k2", "k3")])
    torch.cuda.synchronize()
    assert tuple(state.shape) == (k6.n_state(model), 180 * 7)
    err = (state.double() - rows).abs().amax(dim=1)
    scale = rows.abs().amax(dim=1).clamp_min(1e-300)
    assert bool((err <= 1e-5 * scale).all()), (err / scale).max()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["R03", "R20SD", "R24"])
def test_spectral_kernel_holds_float64(device, model):
    """K6 on the 50k grid's spacing across the
    51-54 GHz window and the 60.3 GHz line, points up to 41 hPa: 5e-6 of
    each frequency's largest alpha against the function in float64 on the
    kernel's float32 tables."""
    prof = _levels(5, 180, device)
    step = 44.0 / 49_999
    f = torch.cat([51.0 + step * torch.arange(203, device=device),
                   60.2 + step * torch.arange(250, device=device)])
    args = (f, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
    got = absorption_spectral(*args)
    want = k6.absorption_spectral_float64(*args)
    torch.cuda.synchronize()
    assert float(prof["p"].min()) < 45.0
    err = (got.double() - want).abs().amax(dim=(1, 2))
    scale = want.abs().amax(dim=(1, 2))
    assert bool((err <= 5e-6 * scale).all()), (err / scale).max()


@pytest.mark.cuda
def test_spectral_kernel_r03_has_the_1998_continuum(device):
    """Cold dry air at 1000 hPa, 20-45 GHz, where the dry continuum shows:
    K6's R03 is the plain R03, which has the 1998 continuum, to 2e-5 at
    every point, and the 2017 form would be off by more than 1e-4."""
    p = torch.full((64,), 1000.0, device=device)
    t = torch.full((64,), 220.0, device=device)
    rho = torch.full((64,), 0.05, device=device)
    lwc = torch.zeros(64, device=device)
    f = torch.linspace(20.0, 45.0, 33, device=device)
    got = absorption_spectral(f, p, t, rho, lwc, "R03")
    want = absorption_spectral_reference(f, p, t, rho, lwc, "R03")
    pda = (p - rho * t / 217.0)[None]
    dry = (n2_absorption(f[:, None], pda, t[None], "R98")
           - n2_absorption(f[:, None], pda, t[None], "R16"))
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2e-5 * want.abs()).all())
    assert bool((dry.abs() > 1e-4 * want.abs()).all())


@pytest.mark.cuda
def test_spectral_kernel_refuses_what_it_does_not_take(device):
    prof = _levels(4, 20, device)
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    f = _grid(40, device)
    with pytest.raises(ValueError, match="outside f_range"):
        absorption_spectral(f, *args, f_range=(30.0, 64.0))
    with pytest.raises(TypeError):
        absorption_spectral(f, args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        absorption_spectral(f, args[0][:, :2], *args[1:])
    with pytest.raises(ValueError, match="unknown absorption model"):
        absorption_spectral(f, *args, "R99")
    got = absorption_spectral(f.cpu().numpy(), *args)
    torch.testing.assert_close(got, absorption_spectral(f, *args), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha_is_mid", [False, True], ids=["level", "mid"])
@pytest.mark.parametrize("want_trans", [False, True], ids=["tb", "trans"])
@pytest.mark.parametrize("batch", [3, 200])
def test_downwelling_kernel_matches_plain(device, batch, want_trans,
                                          alpha_is_mid):
    """K3 on the chords K2 would compute, with the frequencies as a device
    tensor: tb to 5e-3 K and trans_level to 1e-5 of its plain version, and
    the same as K2 on the same paths."""
    prof = _levels(batch, 180, device)
    f = _grid(37, device)
    alpha = absorption_spectral(f, prof["p"], prof["t"], prof["rho"],
                                prof["lwc"])
    if alpha_is_mid:
        alpha = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).contiguous()
    n = geometry.refractive_index(prof["p"], prof["t"],
                                  thermo.rho_to_e(prof["rho"], prof["t"]))
    ds = torch.stack([geometry.slant_path_lengths_lb(
        prof["z"], prof["p"], prof["t"],
        thermo.rho_to_e(prof["rho"], prof["t"]), el) for el in ELEVS])
    args = (f, alpha, ds, prof["t"], alpha_is_mid, want_trans)
    before = downwelling_lb.launches
    got = downwelling_lb(*args)
    assert downwelling_lb.launches == before + 1
    want = downwelling_lb_reference(*args)
    k2 = forward_lb(f.tolist(), ELEVS, alpha, prof["z"], n, prof["t"],
                    alpha_is_mid, want_trans)
    torch.cuda.synchronize()
    assert set(got) == set(want) == set(k2)
    assert got["tb"].shape == (len(ELEVS), 37, batch)
    assert float((got["tb"] - want["tb"]).abs().max()) <= 5e-3
    assert float((got["tb"] - k2["tb"]).abs().max()) <= 5e-3
    torch.testing.assert_close(got["tau_total"], want["tau_total"],
                               rtol=1e-4, atol=0)
    if want_trans:
        assert float((got["trans_level"] - want["trans_level"])
                     .abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,alpha_is_mid,staged", [
    ((1, 100, 32, 180), False, True),    # the spectral chunk's tile
    ((3, 50, 28, 37), False, True),      # a tile part empty, ragged stages
    ((2, 17, 4, 2), False, True),        # one layer
    ((1, 33, 8, 6), True, True),         # layer means, one ragged stage
    ((2, 40, 64, 9), True, True),        # two tiles of profiles
    ((3, 50, 30, 37), False, False),     # B not a multiple of 4
    ((1, 33, 7, 6), True, False),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_downwelling_bodies_match_plain(device, shape, alpha_is_mid, staged):
    """Both bodies of K3 on seeded synthetic columns (opacities on both
    sides of the 0.03 series threshold), frequencies from 20 GHz to 3 THz so
    that the staged body's Planck series and its expm1f branch both run: tb
    to 5e-3 K of the plain version, tau_total to 1e-5 relative."""
    n_el, nf, batch, n_lev = shape
    assert staged == (batch % 4 == 0)
    gen = torch.Generator().manual_seed(sum(shape))
    rows = n_lev - 1 if alpha_is_mid else n_lev
    alpha = (10.0 ** (3.0 * torch.rand((nf, rows, batch), generator=gen)
                      - 3.0)).to(device)
    ds = (0.05 + 0.3 * torch.rand((n_el, n_lev - 1, batch),
                                  generator=gen)).to(device)
    t = (180.0 + 120.0 * torch.rand((n_lev, batch), generator=gen)).to(device)
    f = torch.cat([torch.linspace(20.0, 200.0, nf - 3),
                   torch.tensor([900.0, 1500.0, 3000.0])]).to(device)
    args = (f, alpha, ds, t, alpha_is_mid)
    before = downwelling_lb.launches
    got = downwelling_lb(*args)
    assert downwelling_lb.launches == before + 1
    want = downwelling_lb_reference(*args)
    torch.cuda.synchronize()
    assert set(got) == set(want) == {"tb", "tau_total", "t_mr"}
    assert got["tb"].shape == (n_el, nf, batch)
    assert bool(torch.isfinite(got["tb"]).all())
    assert float((got["tb"] - want["tb"]).abs().max()) <= 5e-3
    torch.testing.assert_close(got["tau_total"], want["tau_total"],
                               rtol=1e-5, atol=0)
    # the other body on the same inputs (it also writes trans_level)
    other = downwelling_lb(*args, want_trans_level=True)
    assert float((got["tb"] - other["tb"]).abs().max()) <= 5e-3


@pytest.mark.cuda
def test_downwelling_wrapper_refuses_what_the_kernel_does_not_take(device):
    prof = _levels(4, 20, device)
    alpha = absorption_lb(FREQS, prof["p"], prof["t"], prof["rho"],
                          prof["lwc"])
    ds = torch.ones((2, 19, 4), device=device)
    with pytest.raises(TypeError):
        downwelling_lb(FREQS, alpha.double(), ds, prof["t"])
    with pytest.raises(ValueError):
        downwelling_lb(FREQS, alpha, ds[:, 1:], prof["t"])
    with pytest.raises(ValueError):
        downwelling_lb(FREQS[:3], alpha, ds, prof["t"])
    with pytest.raises(ValueError):
        downwelling_lb(torch.tensor(FREQS, dtype=torch.float64,
                                    device=device), alpha, ds, prof["t"])


@pytest.mark.cuda
def test_spectral_path_launches_both_kernels_per_chunk(device):
    """forward_spectral launches K6 and K3 once per chunk and agrees with
    the plain path on the card to 1e-2 K; float64 with kernels raises."""
    profiles = lbl.demo_batch(5, 180, device=device)
    f = torch.linspace(20.0, 64.0, 1000)
    before = (absorption_spectral.launches, downwelling_lb.launches)
    got = spectral.forward_spectral(profiles, f, (90.0, 30.0), "R24",
                                    freq_chunk=300)
    assert (absorption_spectral.launches, downwelling_lb.launches) == \
        (before[0] + 4, before[1] + 4)
    want = spectral.forward_spectral(profiles, f, (90.0, 30.0), "R24",
                                     freq_chunk=300, use_kernels=False)
    assert got["tb"].shape == (5, 2, 1000)
    assert float((got["tb"] - want["tb"]).abs().max()) <= 1e-2
    torch.testing.assert_close(got["tau_total"], want["tau_total"],
                               rtol=1e-4, atol=0)
    with pytest.raises(ValueError, match="float32 only"):
        spectral.forward_spectral({k: v.double() for k, v in
                                   profiles.items()}, f)


def _chain_inputs(device, n=100_003):
    """Half uniform in [0, 1), half log-uniform in [1e-9, 1e-7), where the
    fma chain's 1e-9 a step changes the value many times over."""
    gen = torch.Generator(device).manual_seed(5)
    small = 10.0 ** (-9.0 + 2.0 * torch.rand(n - n // 2, device=device,
                                              generator=gen))
    return torch.cat([torch.rand(n // 2, device=device, generator=gen),
                      small])


@pytest.mark.cuda
@pytest.mark.parametrize("double_k", [False, True], ids=["k", "2k"])
@pytest.mark.parametrize("op", sorted(CHAIN_OPS))
def test_chain_kernel_matches_plain(device, op, double_k):
    x = _chain_inputs(device)
    k = CHAIN_OPS[op][1] * (2 if double_k else 1)
    before = chain.launches
    got = chain(x, op, k)
    assert chain.launches == before + 1
    want = chain_reference(x, op, k)
    want64 = chain_reference(x.double(), op, k)
    torch.cuda.synchronize()
    # Against the float64 recurrence on the same float32 constants, each of
    # the fma chain's k steps, the scaling and the seven additions of the
    # sum rounds once, at most 2^-24 relative, and all terms are positive;
    # the plain version rounds twice a step.  One step more or less moves
    # the small half of the inputs by over 1e-3.  The div and exp chains
    # contract to a fixed point: their values hold the primitive's form,
    # not k; the approximate intrinsics are good to ~1e-6.
    u = 2.0 ** -24
    rtol64 = {"fma": (k + 8) * u, "div_fast": 1e-4, "exp_fast": 1e-4}.get(
        op, 1e-6)
    rtol = {"fma": (3 * k + 16) * u}.get(op, rtol64)
    torch.testing.assert_close(got.double(), want64, rtol=rtol64, atol=0)
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.cuda
def test_fma_chain_kernel_applies_k_steps(device):
    """out(2k) - out(k) on the small inputs is 8 k b to 1e-4: a chain cut
    short by one step of 96 would be off by 1e-2."""
    x = _chain_inputs(device)
    small = x < 1e-7
    k = CHAIN_OPS["fma"][1]
    got = (chain(x, "fma", 2 * k).double() - chain(x, "fma", k).double())
    want = (chain_reference(x.double(), "fma", 2 * k)
            - chain_reference(x.double(), "fma", k))
    torch.testing.assert_close(got[small], want[small], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_chain_kernel_refuses_what_it_was_not_built_for(device):
    x = torch.rand(1000, device=device)
    with pytest.raises(ValueError, match="built for k"):
        chain(x, "fma", 7)
    with pytest.raises(TypeError, match="float32"):
        chain(x.double(), "fma")
    with pytest.raises(ValueError, match="out of range"):
        chain(x, "fma", threads=100)
    y = chain(x, "div", threads=32)
    torch.testing.assert_close(y, chain_reference(x, "div"), rtol=1e-6,
                               atol=0)


@pytest.mark.cuda
def test_measure_peaks_launches_the_chain_kernel(device):
    before = chain.launches
    peaks = profiling.measure_peaks(device)
    assert chain.launches > before
    assert set(peaks) == {"fma", "div", "exp", "hbm"}
    for name, rate in peaks.items():
        assert 0.02 * profiling.DEFAULT_PEAKS[name] < rate \
            <= 1.05 * profiling.DEFAULT_PEAKS[name], name
    seconds = profiling.device_time(lambda a: a * 2.0,
                                    (torch.ones(1 << 20, device=device),))
    assert 0.0 < seconds < 1e-2


@pytest.mark.cuda
def test_fast_serving_path_launches_the_rte_kernel_once(device):
    profiles = lbl.demo_batch(130, 180, device=device)
    cfg = fast.FastConfig()
    before = absorption_lb.launches
    params = fast.fit_closed_form({k: v[:32] for k, v in profiles.items()},
                                  cfg)
    assert absorption_lb.launches == before + 1
    assert params["w"].is_cuda and params["w"].dtype == torch.float32
    before = (forward_lb.launches, absorption_lb.launches)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fast.fast_forward_batch(params, profiles, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert (forward_lb.launches, absorption_lb.launches) == \
        (before[0] + 1, before[1])
    want = fast.fast_forward_batch(
        params, profiles, dataclasses.replace(cfg, use_kernels=False))
    torch.cuda.synchronize()
    assert set(got) == set(want)
    assert got["trans_level"].shape == (130, 10, 14, 180)
    assert float((got["tb"] - want["tb"]).abs().max()) <= 1e-2
    # K2's chords are float64: trans_level is held to the plain version in
    # float64 on the extinction and the levels the kernel was given (the
    # plain float32 path is 1.2e-5 off that at 4.2 degrees)
    lev = _levels(130, 180, device)
    a_mid = fast.serving_extinction(params, lev["p"], lev["t"], lev["rho"],
                                    lev["lwc"])
    n = geometry.refractive_index(lev["p"], lev["t"],
                                  thermo.rho_to_e(lev["rho"], lev["t"]))
    want64 = forward_lb_reference(
        cfg.freqs_ghz, cfg.elevations_deg, a_mid.double(), lev["z"].double(),
        n.double(), lev["t"].double(), True, True)["trans_level"]
    assert float((got["trans_level"].double() - want64.permute(3, 0, 1, 2))
                 .abs().max()) <= 1e-5
    teacher = lbl.forward_batch(profiles, lbl.LBLConfig(outputs=("tb",)))
    assert float((got["tb"] - teacher["tb"]).pow(2).mean().sqrt()) < 0.05
    with pytest.raises(ValueError, match="float32 only"):
        fast.fast_forward_batch(params, profiles,
                                dataclasses.replace(cfg, dtype="float64"))


@pytest.mark.cuda
def test_retrieval_on_the_card_runs_the_rte_kernel_each_step(device):
    profiles = lbl.demo_batch(8, 60, device=device)
    cfg = fast.FastConfig(outputs=("tb",))
    params = fast.fit_closed_form(profiles, cfg)
    tb_obs = fast.fast_forward_batch(params, profiles, cfg)["tb"]
    ocfg = retrieval.OEMConfig(n_iter=3)
    args = (params, tb_obs, profiles["z"], profiles["p"],
            profiles["t"] + 1.5, profiles["rho"] * 0.8)
    before = forward_lb.launches
    got = retrieval.retrieve_batch(*args, ocfg, profiles["lwc"])
    assert forward_lb.launches == before + ocfg.n_iter + 1
    # the same retrieval on CPU copies takes the plain forward
    want = retrieval.retrieve_batch(
        *({k: v.cpu() for k, v in a.items()} if isinstance(a, dict)
          else a.cpu() for a in args), ocfg, profiles["lwc"].cpu())
    torch.cuda.synchronize()
    assert float((got["t"].cpu() - want["t"]).abs().max()) <= 0.05
    assert float((got["tb_fit"] - tb_obs).abs().mean()) < 0.5
    k_closed = jacobians.kmatrix_fast_adjoint_batch(params, profiles, cfg)
    k_auto = jacobians.kmatrix_fast_batch(params, profiles, cfg,
                                          wrt=("t", "rho"))
    for name in ("t", "rho"):
        assert float((k_closed[name] - k_auto[name]).abs().max()) <= \
            2e-3 * float(k_auto[name].abs().max())


@pytest.mark.cuda
def test_forward_stage_on_the_card(device, tmp_path):
    """The campaign stage on a synthetic campaign of 3 sondes, in chunks of
    2 (the last chunk holds one): the launches of every kernel of its path,
    its TBs against the plain path, and the same outputs in one chunk of
    all three: the LBL TBs and the K-matrices to the bit (their kernels
    compute each profile alone), the fast operator's within 1e-4 K and 1e-6
    (cuBLAS may order the 72-deep product otherwise at another batch)."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
        preprocess, synthetic)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward_stage)

    sondes, l1 = [], []
    for i in range(3):
        sondes.append(synthetic.write_sonde_nc_arms(
            str(tmp_path / f"2024080{5 + i}_102936.nc"), seed=i))
        l1.append(synthetic.write_mwr_l1(
            str(tmp_path / f"mwr_l1_{i}.nc"),
            np.datetime64(f"2024-08-0{5 + i}T10:29:36"), seed=10 + i))
    # times without an instrument's TBs are dropped
    ds = preprocess.preprocess_files(sondes, "Vital", "Juelich",
                                     {"joyhat": l1})
    assert ds.dims["time"] == 3
    params = fast.distill_on_dataset(ds, device=device)
    models = ("R24", "R17")
    wrappers = (absorption_lb, forward_lb, absorption_tangents_lb,
                kmatrix_assembled_lb, kmatrix_assembled_rho_lwc_lb)
    for fn in wrappers:
        fn.launches = 0
    out = forward_stage(ds.copy(), models, params, with_jacobians=True,
                        batch_size=2, device=device)
    chunks = 2 * 2
    assert [fn.launches for fn in wrappers] == [
        len(models) * chunks, (len(models) + 1) * chunks, chunks, chunks,
        chunks]
    names = [k for k in out.variables
             if k.startswith(("TBs_LBL_", "TBs_Fast", "ttrans_", "levtrans_",
                              "Jacobian_"))]
    assert len(names) == len(models) + 6
    assert all(np.isfinite(out[k].data).all() for k in names)
    plain = forward_stage(ds.copy(), models, params, batch_size=2,
                          fused=False, device=device)
    for name in ("TBs_LBL_R24", "TBs_LBL_R17", "TBs_Fast"):
        np.testing.assert_allclose(out[name].data, plain[name].data,
                                   rtol=0, atol=1e-2, err_msg=name)
    whole = forward_stage(ds.copy(), models, params, with_jacobians=True,
                          device=device)
    for name in names:
        if name.endswith("_Fast"):
            atol = 1e-4 if name.startswith("TBs_") else 1e-6
            np.testing.assert_allclose(out[name].data, whole[name].data,
                                       rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(out[name].data, whole[name].data,
                                          err_msg=name)
