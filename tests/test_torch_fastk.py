"""The fast operator's closed-form K on the CPU: the plain version of the
fast-K kernel (`ops/cuda/fastk.py`) against the kernel's preamble and walk
in plain torch (`_mirrors.fastk_preamble`, `_mirrors.fastk_warp_walk`), the
wrapper's plain route and its routing in
`jacobians.kmatrix_fast_adjoint_batch`, and the kernel's symbol.  The
kernel itself runs in the `cuda` tests of `test_torch_kernels.py`."""

import functools
import re

import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (fast,
                                                                  jacobians,
                                                                  lbl)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import spans
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    _build, _mirrors, fastk)

torch.set_num_threads(1)

ELEVS = (90.0, 30.0, 4.2)
CFG = fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
WRTS = [("t", "rho"), ("t",), ("rho",)]


@functools.lru_cache(maxsize=None)
def _weights(n_levels):
    """Weights fitted on 24 profiles, plus a random part that drives the
    regression below zero in some layers, so the clamp of
    `fast.extinction_partials` zeroes them and their partials."""
    cfg = fast.FastConfig(outputs=("tb",))
    w = fast.fit_closed_form(lbl.demo_batch(24, n_levels, device="cpu"),
                             cfg)["w"]
    return w + fast.init_params(cfg, scale=1e-3, seed=5, device="cpu")["w"]


def _profiles(batch, n_levels, dtype=torch.float64):
    """(B, L) demo profiles z, p, t, rho, lwc in `dtype`."""
    return fast.batch_arrays(lbl.demo_batch(batch, n_levels, seed=7,
                                            device="cpu"), dtype)


def _inputs(batch, n_levels, dtype=torch.float64):
    return jacobians.fast_k_inputs({"w": _weights(n_levels).double()},
                                   _profiles(batch, n_levels, dtype), ELEVS)


def _row_error(got, want):
    """The largest |got - want| of each (profile, elevation, channel) row
    over the row's largest |want|, the worst row."""
    err = (got.double() - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-300)).max())


@pytest.mark.parametrize("wrt", WRTS, ids="_".join)
@pytest.mark.parametrize("n_levels", [2, 33, 60, 180])
def test_warp_walk_matches_the_plain_version(n_levels, wrt):
    """The kernel's walk in chunks of 32 layers against the plain version,
    both in float64: only the order of the sums differs, so 1e-12 of the
    largest entry; a bound by row would gauge the plain version's own
    S = atm - cumsum, which cancels near the column top (1.8e-10 of the
    row's largest |K_rho| in an opaque channel).  L=2 is one layer, L=33
    one full chunk, L=60 and 180 a part-empty top chunk; the inputs hold
    layers the clamp zeroes and opacities on both sides of the emission
    series' threshold."""
    k = _inputs(5, n_levels)
    dtau = k["alpha_mid"].transpose(1, 2)[:, None] * k["ds"][:, :, None]
    if n_levels >= 60:
        assert bool((dtau < 0.03).any()) and bool((dtau > 0.5).any())
        assert bool((k["alpha_mid"] == 0).any())
    want = fastk.fastk_adjoint_reference(CFG.freqs_ghz, **k, wrt=wrt)
    got = _mirrors.fastk_warp_walk(CFG.freqs_ghz, **k, wrt=wrt)
    assert set(got) == set(want) == set(wrt)
    for name in wrt:
        assert got[name].shape == (5, len(ELEVS), 14, n_levels)
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-12 * float(want[name].abs().max()), name


@pytest.mark.parametrize("n_levels", [60, 180])
def test_warp_walk_in_float32_meets_the_card_tests_bound(n_levels):
    """The walk in float32 on float32 inputs against the plain version in
    float64 on the same inputs, to the card test's bound, 1e-3 of each
    row's largest |K|; the plain version in float32 takes S = atm - cumsum,
    which cancels near the column top, and misses it for K_rho."""
    k = {n: v.float() for n, v in _inputs(9, n_levels).items()}
    want = fastk.fastk_adjoint_reference(
        CFG.freqs_ghz, **{n: v.double() for n, v in k.items()})
    got = _mirrors.fastk_warp_walk(CFG.freqs_ghz, **k)
    plain = fastk.fastk_adjoint_reference(CFG.freqs_ghz, **k)
    for name in fastk.FASTK_WRT:
        assert got[name].dtype == torch.float32
        assert _row_error(got[name], want[name]) <= 1e-4, name
    assert _row_error(plain["rho"], want["rho"]) > 1e-3


def test_cpu_profiles_never_reach_the_wrapper(monkeypatch):
    """On the CPU `kmatrix_fast_adjoint_batch` passes its config's
    use_kernels to the wrapper, whose kernel path CPU profiles never reach:
    the wrapper takes the plain version, use_kernels or not, and the
    outputs are the plain version on the inputs `fast_k_inputs` gives."""
    def no_kernel_path(label):
        raise AssertionError(f"{label} was entered")

    seen = []
    monkeypatch.setattr(fastk, "span", lambda label: no_kernel_path(label)
                        if label.startswith("cuda.") else spans.span(label))
    monkeypatch.setattr(jacobians, "fastk_adjoint", lambda *a, **kw:
                        seen.append(kw["use_kernels"])
                        or fastk.fastk_adjoint(*a, **kw))
    profiles = lbl.demo_batch(3, 40, device="cpu")
    params = {"w": _weights(40)}
    before = fastk.fastk_adjoint.launches
    for cfg in (CFG, fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",),
                                     use_kernels=False)):
        got = jacobians.kmatrix_fast_adjoint_batch(params, profiles, cfg)
        assert seen[-1] == cfg.use_kernels
        want = fastk.fastk_adjoint_reference(
            CFG.freqs_ghz, **jacobians.fast_k_inputs(
                params, fast.batch_arrays(profiles, torch.float32), ELEVS))
        for name in fastk.FASTK_WRT:
            assert torch.equal(got[name], want[name]), name
    assert fastk.fastk_adjoint.launches == before


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    prof = _profiles(2, 20, torch.float32)
    w = _weights(20)
    before = fastk.fastk_adjoint.launches
    got = fastk.fastk_adjoint(CFG.freqs_ghz, ELEVS, w, **prof, wrt=("rho",))
    assert fastk.fastk_adjoint.launches == before
    want = fastk.fastk_adjoint_reference(
        CFG.freqs_ghz, **jacobians.fast_k_inputs({"w": w}, prof, ELEVS),
        wrt=("rho",))
    assert set(got) == {"rho"} and torch.equal(got["rho"], want["rho"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=str)
def test_the_plain_route_is_the_prologue_then_the_plain_version(dtype):
    """The wrapper's plain route, and the entry point through it, give
    `fastk_adjoint_reference(**fast_k_inputs(...))` to the bit, in float32
    and in float64, t a strided slice of a wider state as the retrieval
    passes it."""
    prof = _profiles(3, 33, dtype)
    prof["t"] = torch.cat([prof["t"], prof["t"]], dim=1)[:, :33]
    w = _weights(33).to(dtype)
    want = fastk.fastk_adjoint_reference(
        CFG.freqs_ghz, **jacobians.fast_k_inputs({"w": w}, prof, ELEVS))
    got = fastk.fastk_adjoint(CFG.freqs_ghz, ELEVS, w, **prof)
    entry = jacobians.kmatrix_fast_adjoint_batch(
        {"w": _weights(33)}, prof,
        fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",),
                        dtype=str(dtype).removeprefix("torch.")))
    for name in fastk.FASTK_WRT:
        assert got[name].dtype == dtype
        assert torch.equal(got[name], want[name]), name
        assert torch.equal(entry[name], want[name]), name


def _field_error(got, want):
    """max |got - want| over the field's largest |want|."""
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("n_levels", [2, 33, 60, 180])
def test_preamble_mirror_matches_the_prologue(n_levels):
    """The kernel's preamble and chords in plain torch against the plain
    prologue: in float64 to rtol 1e-12 (and 1e-12 of each field's largest
    value where a field's sum cancels to near zero); in float32, on the
    same values, within 1e-5 of each field's largest value of the prologue
    in float64.  The weights drive the regression below zero in some
    layers, and log p crosses the hats' knots."""
    w = _weights(n_levels)
    prof = _profiles(5, n_levels)
    want = jacobians.fast_k_inputs({"w": w.double()}, prof, ELEVS)
    got = _mirrors.fastk_preamble(w.double(), **prof, elevations=ELEVS)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.float64
        torch.testing.assert_close(
            got[name], want[name], rtol=1e-12,
            atol=1e-12 * float(want[name].abs().max()))
    prof32 = {k: v.float() for k, v in prof.items()}
    want = jacobians.fast_k_inputs(
        {"w": w.double()}, {k: v.double() for k, v in prof32.items()}, ELEVS)
    got = _mirrors.fastk_preamble(w, **prof32, elevations=ELEVS)
    for name in want:
        assert got[name].dtype == torch.float32
        assert got[name].shape == want[name].shape
        assert _field_error(got[name], want[name]) <= 1e-5, name
    if n_levels >= 60:
        assert bool((want["alpha_mid"] == 0).any())


@pytest.mark.parametrize("n_levels", [60, 180])
def test_kernel_mirror_in_float32_meets_the_card_tests_bound(n_levels):
    """The kernel's arithmetic from the float32 profiles to K (preamble,
    chords and walk) against the wrapper's plain route in float64 on the
    same values: each row within 1e-3 of the row's largest |K|, the card
    test's bound (the plain route in float32 misses it for K_rho)."""
    w = _weights(n_levels)
    prof = _profiles(9, n_levels, torch.float32)
    got = _mirrors.fastk_warp_walk(CFG.freqs_ghz, **_mirrors.fastk_preamble(
        w, **prof, elevations=ELEVS))
    want = fastk.fastk_adjoint(CFG.freqs_ghz, ELEVS, w.double(),
                               **{k: v.double() for k, v in prof.items()})
    plain = fastk.fastk_adjoint(CFG.freqs_ghz, ELEVS, w, **prof)
    for name in fastk.FASTK_WRT:
        assert got[name].dtype == torch.float32
        assert _row_error(got[name], want[name]) <= 1e-3, name
    assert _row_error(plain["rho"], want["rho"]) > 1e-3


def test_the_kernel_takes_the_hats_knots_of_the_fast_operator():
    """The wrapper hands the kernel the knots of `fast._hats`, their lower
    and upper neighbours, as the plain version rounds them."""
    like = torch.zeros(1)
    k, lo, hi = (v.reshape(-1) for v in fast._knots(like))
    assert torch.equal(fastk._knots(torch.device("cpu")),
                       torch.cat([k, lo, hi]))


def test_the_kernel_symbol_feeds_no_other_roofline():
    """The benchmark's trace reader matches kernels by substring, so the
    kernel's name holds none of the symbols other metrics read; and the
    entry point has its ctypes row."""
    src = (_build.CSRC / "fastk.cu").read_text()
    kernels = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    assert kernels == ["fastk_adjoint_kernel"]
    for other in ("downwelling", "kmatrix_kernel", "absorption_",
                  "spectral_kernel", "slant_geometry_kernel",
                  "line_state_kernel", "chain"):
        assert other not in kernels[0]
    assert "mwr_fastk_adjoint" in _build.SIGNATURES
