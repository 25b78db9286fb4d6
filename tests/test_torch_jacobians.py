"""The port's K-matrix (`models/jacobians.py`) as a whole: the closed-form
path and the kernels' pipeline (on the CPU through the kernels' plain
versions) against the JAX package's XLA K-matrix, against the port's own
jacrev, and against finite differences of the forward."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.models import jacobians as jjac
from mwr_fast_forward_operators_and_lbls_tpu.models import lbl as jlbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (jacobians,
                                                                  lbl)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    absorption, adjoint, geometry, launches)

torch.set_num_threads(1)

F_SUB = (22.24, 31.4, 54.94)
CFG = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 14.4, 4.2),
                    freqs_ghz=F_SUB)
WRT = ("t", "rho", "lwc")


@pytest.fixture(scope="module")
def batch():
    return lbl.demo_batch(3, 32, device="cpu")


@pytest.fixture(scope="module")
def batch64(batch):
    return {k: v.double() for k, v in batch.items()}


@pytest.fixture(scope="module")
def k64(batch64):
    return jacobians.kmatrix_batch_fast(
        batch64, dataclasses.replace(CFG, dtype="float64"))


@pytest.fixture(scope="module")
def closed64(batch64):
    """The closed form, which a wrt with "p" takes."""
    return jacobians.kmatrix_batch_fast(
        batch64, dataclasses.replace(CFG, dtype="float64"),
        wrt=WRT + ("p",))


@pytest.mark.parametrize("wrt", [WRT + ("p",), WRT], ids=["closed", "lanes"])
def test_fp32_matches_jax_xla(batch, wrt):
    """Both routes, float32, against the JAX XLA K-matrix with the same wrt
    on the same profiles: the JAX package's own fast-vs-jacrev bound,
    2e-4 * max(scale, 1)."""
    want = jjac.kmatrix_batch_fast(
        {k: v.numpy() for k, v in batch.items()},
        jlbl.LBLConfig(model="R24", elevations_deg=CFG.elevations_deg,
                       freqs_ghz=F_SUB), wrt=wrt)
    got = jacobians.kmatrix_batch_fast(batch, CFG, wrt=wrt)
    assert set(got) == set(wrt)
    for name in wrt:
        a, b = np.asarray(want[name]), got[name].numpy()
        assert b.shape == a.shape == (3, 3, 3, 32) and b.dtype == np.float32
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=2e-4 * max(scale, 1.0), err_msg=name)


def test_pressure_matches_jax_xla(batch):
    """wrt=("p",): the closed-form route with the pressure seed and its
    geometry term, R98, one profile at 30 degrees."""
    one = {k: v[:1] for k, v in batch.items()}
    kw = dict(model="R98", elevations_deg=(30.0,), freqs_ghz=F_SUB)
    want = np.asarray(jjac.kmatrix_batch_fast(
        {k: v.numpy() for k, v in one.items()}, jlbl.LBLConfig(**kw),
        wrt=("p",))["p"])
    got = jacobians.kmatrix_batch_fast(one, lbl.LBLConfig(**kw),
                                       wrt=("p",))["p"].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * max(np.abs(want).max(), 1.0))


def test_jacrev_matches_fast_fp64(batch64, k64):
    """Brute-force jacrev through `forward_single`, vmapped over profiles
    and elevations, against the closed form: the same derivative, so 1e-8
    of max |K| in float64."""
    cfg = dataclasses.replace(CFG, dtype="float64")
    ref = jacobians.kmatrix_batch(batch64, cfg, wrt=WRT)
    for name in WRT:
        assert ref[name].shape == (3, 3, 3, 32)
        scale = float(ref[name].abs().max())
        torch.testing.assert_close(k64[name], ref[name], rtol=0,
                                   atol=1e-8 * scale)


def test_pressure_jacrev_matches_fast_fp64(batch64):
    cfg = lbl.LBLConfig(model="R98", elevations_deg=(30.0,),
                        freqs_ghz=F_SUB, dtype="float64")
    fast = jacobians.kmatrix_batch_fast(batch64, cfg, wrt=("p",))["p"]
    ref = jacobians.kmatrix_batch(batch64, cfg, wrt=("p",))["p"]
    torch.testing.assert_close(fast, ref, rtol=0,
                               atol=1e-8 * float(ref.abs().max()))


def _tb(prof, **kw):
    p = {**prof, **kw}
    return lbl.forward_single(p["z"], p["p"], p["t"], p["rho"], p["lwc"],
                              torch.tensor(F_SUB, dtype=torch.float64),
                              30.0, "R24")["tb"]


@pytest.mark.parametrize("name,levels,step,atol", [
    ("t", (0, 10, 30), 0.5, 5e-3), ("rho", (0, 15), 0.05, 2e-2)])
def test_kmatrix_single_vs_central_differences(batch64, name, levels, step,
                                               atol):
    """The JAX package's finite-difference checks, in float64."""
    prof = {k: v[0] for k, v in batch64.items()}
    k = jacobians.kmatrix_single(prof["z"], prof["p"], prof["t"],
                                 prof["rho"], prof["lwc"],
                                 torch.tensor(F_SUB, dtype=torch.float64),
                                 30.0, "R24", wrt=(name,))[name]
    assert k.shape == (3, 32)
    for lev in levels:
        up, down = prof[name].clone(), prof[name].clone()
        up[lev] += step
        down[lev] -= step
        fd = (_tb(prof, **{name: up}) - _tb(prof, **{name: down})) / (2 * step)
        np.testing.assert_allclose(k[:, lev].numpy(), fd.numpy(), rtol=0,
                                   atol=atol)


def test_physical_signs():
    """Zenith: cloud liquid warms the K and Ka bands, and at 58 GHz the
    temperature weights integrate to about one."""
    freqs = (22.24, 31.4, 58.0)
    cfg = lbl.LBLConfig(elevations_deg=(90.0,), freqs_ghz=freqs,
                        dtype="float64")
    prof = lbl.demo_batch(2, 180, dtype=torch.float64, device="cpu")
    k = jacobians.kmatrix_batch_fast(prof, cfg, wrt=("t", "lwc"))
    cloud = prof["lwc"][0] > 0
    assert int(cloud.sum()) >= 3
    assert bool((k["lwc"][:, 0, :2][..., cloud] > 0).all())
    sums = k["t"][:, 0, 2].sum(-1)
    assert bool(((sums > 0.7) & (sums < 1.3)).all()), sums


def test_ppmv_conversion_matches_jax(k64, batch64):
    p, t = batch64["p"], batch64["t"]
    got = jacobians.kmatrix_ppmv_from_rho(k64["rho"], p[:, None], t[:, None])
    with jax.enable_x64(True):
        want = jjac.kmatrix_ppmv_from_rho(jnp.asarray(k64["rho"].numpy()),
                                          jnp.asarray(p.numpy())[:, None],
                                          jnp.asarray(t.numpy())[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


def test_routing_on_cpu(batch, monkeypatch):
    """wrt within {t, rho, lwc} takes the kernels' pipeline, on the CPU
    through the plain versions, and launches nothing; wrt with "p" takes the
    closed form; the rule raises its one ValueError on a stand-in for a
    CUDA float64 tensor."""
    calls = []
    for route in ("_kmatrix_batch_fused_lanes", "_kmatrix_batch_closed_form"):
        monkeypatch.setattr(jacobians, route, lambda *a, _n=route,
                            _f=getattr(jacobians, route):
                            calls.append(_n) or _f(*a))
    counters = (absorption.absorption_tangents_lb,
                geometry.slant_geometry_lb, adjoint.kmatrix_assembled_lb,
                adjoint.kmatrix_assembled_rho_lwc_lb)
    before = [c.launches for c in counters]
    lanes = jacobians.kmatrix_batch_fast(batch, CFG, wrt=WRT)
    plain = jacobians.kmatrix_batch_fast(
        batch, dataclasses.replace(CFG, use_kernels=False), wrt=WRT)
    closed = jacobians.kmatrix_batch_fast(batch, CFG, wrt=WRT + ("p",))
    assert calls == ["_kmatrix_batch_fused_lanes"] * 2 + [
        "_kmatrix_batch_closed_form"]
    assert [c.launches for c in counters] == before
    for name in WRT:
        assert torch.equal(plain[name], lanes[name]), name
        torch.testing.assert_close(lanes[name], closed[name], rtol=0,
                                   atol=1e-5 * float(closed[name].abs().max()))
    cuda64 = types.SimpleNamespace(device=torch.device("cuda", 0),
                                   dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 only"):
        launches(cuda64)
    assert launches(cuda64, use_kernels=False) is False


def _assembled_plain(lev, cfg, da_lwc):
    """The pipeline's plain stages in turn, dalpha/dLWC given: K4's plain
    version without its fourth output, the geometry, K5a and K5b, each
    with use_kernels=False; {name: (B, E, F, L)}."""
    f, t = cfg.freqs_ghz, lev["t"]
    alpha, da_t, da_rho = absorption.absorption_tangents_lb(
        f, lev["p"], t, lev["rho"], lev["lwc"], cfg.model, use_kernels=False)
    g = geometry.slant_geometry_lb(cfg.elevations_deg, lev["z"], lev["p"], t,
                                   lev["rho"], ("t", "rho"),
                                   use_kernels=False)
    geo = (g["dds_dnl"], g["dds_dk"])
    k = {"t": adjoint.kmatrix_assembled_lb(
        f, "t", alpha, da_t, g["ds"], t, *geo, g["dn"]["t"], g["r0cos"],
        use_kernels=False)}
    k["rho"], k["lwc"] = adjoint.kmatrix_assembled_rho_lwc_lb(
        f, alpha, da_rho, da_lwc, g["ds"], t, *geo, g["dn"]["rho"],
        g["r0cos"], use_kernels=False)
    return {n: v.permute(3, 0, 1, 2) for n, v in k.items()}


@pytest.mark.parametrize("freqs", [F_SUB, lbl.LBLConfig().freqs_ghz],
                         ids=["3ch", "hatpro"])
def test_plain_k4_writes_what_dalpha_dlwc_gave(batch, freqs):
    """On the plain path dalpha/dLWC comes from K4's plain version: the
    K-matrix is the same to the bit as the same stages fed `_dalpha_dlwc`,
    the plain K4's first three outputs do not hang on `with_lwc`, and no
    launch counts."""
    cfg = dataclasses.replace(CFG, freqs_ghz=freqs)
    lev = lbl.level_major_profiles(batch, cfg)
    args = (freqs, lev["p"], lev["t"], lev["rho"], lev["lwc"], cfg.model)
    counters = (absorption.absorption_tangents_lb.launches,
                absorption.absorption_tangents_lb.lwc_launches)
    three = absorption.absorption_tangents_lb(*args)
    four = absorption.absorption_tangents_lb(*args, with_lwc=True)
    assert len(three) == 3 and len(four) == 4
    for a, b in zip(three, four):
        assert torch.equal(a, b)
    assert torch.equal(four[3], jacobians._dalpha_dlwc(cfg, lev["t"]))
    got = jacobians.kmatrix_batch_fast(batch, cfg, wrt=WRT)
    want = _assembled_plain(lev, cfg, jacobians._dalpha_dlwc(cfg, lev["t"]))
    for name in WRT:
        assert torch.equal(got[name], want[name]), name
    assert (absorption.absorption_tangents_lb.launches,
            absorption.absorption_tangents_lb.lwc_launches) == counters


@pytest.mark.parametrize("wrt", [("t",), ("rho",), ("lwc",), ("rho", "lwc"),
                                 ("t", "lwc")])
def test_lanes_subsets_match_closed_form(batch64, closed64, wrt):
    """Each subset of wrt through the pipeline (one K5 call per variable)
    gives the closed form's result."""
    got = jacobians.kmatrix_batch_fast(
        batch64, dataclasses.replace(CFG, dtype="float64"), wrt=wrt)
    assert set(got) == set(wrt)
    for name in wrt:
        torch.testing.assert_close(got[name], closed64[name], rtol=1e-12,
                                   atol=1e-14)


def test_kmatrix_without_liquid_in_the_profiles(batch):
    """No "lwc" entry: the K-matrix is taken at zero liquid, like the
    forward."""
    dry = {k: v for k, v in batch.items() if k != "lwc"}
    got = jacobians.kmatrix_batch_fast(dry, CFG, wrt=WRT)
    want = jacobians.kmatrix_batch_fast({**dry, "lwc": torch.zeros_like(
        batch["t"])}, CFG, wrt=WRT)
    for name in WRT:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
