"""The one rule that picks kernel or plain version (`ops.cuda.launches`),
on the CPU: each wrapper it guards runs its plain version on CPU tensors and
with use_kernels=False, raises the rule's ValueError for a CUDA tensor of
another dtype, and enters its kernel path for a CUDA float32 one.  A CUDA
tensor is stood in for by what the rule reads of it, its device and dtype."""

import types

import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (fast,
                                                                  jacobians,
                                                                  lbl)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import geometry, thermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    absorption, adjoint, fastk, launches, rte, spectral)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    geometry as kgeo)

torch.set_num_threads(1)

FREQS = (22.24, 31.4, 54.94)
ELEVS = (90.0, 30.0, 4.2)


def _cuda(dtype):
    return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype)


@pytest.fixture(scope="module")
def lev():
    out = lbl.level_major_profiles(lbl.demo_batch(2, 12, device="cpu"),
                                   lbl.LBLConfig())
    out["n"] = geometry.refractive_index(
        out["p"], out["t"], thermo.rho_to_e(out["rho"], out["t"]))
    return out


def _points(lev):
    return [lev[k] for k in ("p", "t", "rho", "lwc")]


def _k5(lev):
    alpha, da_t, da_rho = absorption.absorption_tangents_lb_reference(
        FREQS, *_points(lev))
    g = kgeo.slant_geometry_lb_reference(ELEVS, *(lev[k] for k in
                                                  ("z", "p", "t", "rho")))
    return alpha, da_t, da_rho, g


def _absorption_lb(lev):
    return (FREQS, *_points(lev)), absorption.absorption_lb_reference


def _absorption_tangents_lb(lev):
    return (FREQS, *_points(lev)), \
        absorption.absorption_tangents_lb_reference


def _forward_lb(lev):
    alpha = absorption.absorption_lb_reference(FREQS, *_points(lev))
    return (FREQS, ELEVS, alpha, lev["z"], lev["n"], lev["t"]), \
        rte.forward_lb_reference


def _forward_lb_vjp(lev):
    alpha = absorption.absorption_lb_reference(FREQS, *_points(lev))
    mid = 0.5 * (alpha[:, 1:] + alpha[:, :-1])
    g_tb = torch.linspace(-1.0, 1.0, len(ELEVS) * len(FREQS) * 2).reshape(
        len(ELEVS), len(FREQS), 2)
    return (FREQS, ELEVS, mid, lev["z"], lev["n"], lev["t"], g_tb), \
        rte.forward_lb_vjp_reference


def _downwelling_lb(lev):
    alpha, _, _, g = _k5(lev)
    return (FREQS, alpha, g["ds"], lev["t"]), rte.downwelling_lb_reference


def _kmatrix_assembled_lb(lev):
    alpha, da_t, _, g = _k5(lev)
    return (FREQS, "t", alpha, da_t, g["ds"], lev["t"], g["dds_dnl"],
            g["dds_dk"], g["dn"]["t"], g["r0cos"]), \
        adjoint.kmatrix_assembled_lb_reference


def _kmatrix_assembled_rho_lwc_lb(lev):
    alpha, _, da_rho, g = _k5(lev)
    da_lwc = jacobians._dalpha_dlwc(lbl.LBLConfig(freqs_ghz=FREQS), lev["t"])
    return (FREQS, alpha, da_rho, da_lwc, g["ds"], lev["t"], g["dds_dnl"],
            g["dds_dk"], g["dn"]["rho"], g["r0cos"]), \
        adjoint.kmatrix_assembled_rho_lwc_lb_reference


def _absorption_spectral(lev):
    return (torch.linspace(20.0, 60.0, 7), *_points(lev)), \
        spectral.absorption_spectral_reference


def _slant_geometry_lb(lev):
    return (ELEVS, *(lev[k] for k in ("z", "p", "t", "rho"))), \
        kgeo.slant_geometry_lb_reference


def _fastk_adjoint(lev):
    cfg = fast.FastConfig(freqs_ghz=FREQS, elevations_deg=ELEVS)
    profiles = fast.batch_arrays({k: v.T for k, v in lev.items() if k != "n"},
                                 torch.float32)
    w = fast.init_params(cfg, device="cpu")["w"]

    def plain(*args):
        freqs, elevations, weights, *prof = args
        k = jacobians.fast_k_inputs(
            {"w": weights}, dict(zip(("z", "p", "t", "rho", "lwc"), prof)),
            elevations)
        return fastk.fastk_adjoint_reference(freqs, **k)

    return (FREQS, ELEVS, w, *(profiles[n] for n in ("z", "p", "t", "rho",
                                                     "lwc"))), plain


# each wrapper the rule guards: its module and what builds its arguments
# and names its plain version
WRAPPERS = {
    "absorption_lb": (absorption, _absorption_lb),
    "absorption_tangents_lb": (absorption, _absorption_tangents_lb),
    "forward_lb": (rte, _forward_lb),
    "forward_lb_vjp": (rte, _forward_lb_vjp),
    "downwelling_lb": (rte, _downwelling_lb),
    "kmatrix_assembled_lb": (adjoint, _kmatrix_assembled_lb),
    "kmatrix_assembled_rho_lwc_lb": (adjoint,
                                     _kmatrix_assembled_rho_lwc_lb),
    "absorption_spectral": (spectral, _absorption_spectral),
    "slant_geometry_lb": (kgeo, _slant_geometry_lb),
    "fastk_adjoint": (fastk, _fastk_adjoint),
}


def _same(got, want):
    if torch.is_tensor(want):
        return torch.equal(got, want)
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _same(got[k], want[k]) for k in want)
    return len(got) == len(want) and all(map(_same, got, want))


class _Launched(Exception):
    pass


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_each_wrapper_follows_the_rule(lev, name, monkeypatch):
    module, inputs = WRAPPERS[name]
    fn = getattr(module, name)
    args, reference = inputs(lev)
    want = reference(*args)
    before = fn.launches
    # a CPU tensor, with or without use_kernels: the plain version
    assert _same(fn(*args), want)
    assert _same(fn(*args, use_kernels=False), want)
    assert fn.launches == before

    # the same calls as if their tensors were on the card: the kernel path
    # starts with the wrapper's span, which here raises
    real_span = module.span

    def span(label):
        if label.startswith("cuda."):
            raise _Launched(label)
        return real_span(label)

    def rule_on(dtype):
        return lambda x, use_kernels=True: launches(_cuda(dtype), use_kernels)

    monkeypatch.setattr(module, "span", span)
    monkeypatch.setattr(module, "launches", rule_on(torch.float64))
    with pytest.raises(ValueError, match="float32 only"):
        fn(*args)
    assert _same(fn(*args, use_kernels=False), want)
    monkeypatch.setattr(module, "launches", rule_on(torch.float32))
    with pytest.raises(_Launched, match=f"cuda.{name}"):
        fn(*args)
    assert _same(fn(*args, use_kernels=False), want)
    assert fn.launches == before


def test_the_rule_itself():
    cpu64 = torch.zeros(2, dtype=torch.float64)
    for use_kernels in (True, False):
        assert launches(cpu64, use_kernels) is False
        assert launches(cpu64.float(), use_kernels) is False
    assert launches(_cuda(torch.float32)) is True
    assert launches(_cuda(torch.float32), use_kernels=False) is False
    assert launches(_cuda(torch.float64), use_kernels=False) is False
    for dtype in (torch.float64, torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 only"):
            launches(_cuda(dtype))


def test_the_geometry_wrapper_takes_its_plain_version_for_p(lev,
                                                            monkeypatch):
    """The kernel writes the partials in t and rho only: names with "p"
    take the plain version, where the kernel would launch too."""
    args = (ELEVS, *(lev[k] for k in ("z", "p", "t", "rho")))
    monkeypatch.setattr(kgeo, "launches", lambda x, use_kernels=True: True)
    want = kgeo.slant_geometry_lb_reference(*args, names=("t", "p"))
    assert _same(kgeo.slant_geometry_lb(*args, names=("t", "p")), want)
