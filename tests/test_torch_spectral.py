"""The port's monochromatic spectral forward (`models/spectral.py`) and the
module of kernel K6 (`ops/cuda/spectral.py`), held against the frozen fp64
absorption goldens, the JAX package's XLA path and its Pallas path
(interpret mode) on the same inputs."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.models import spectral as jspec
from mwr_fast_forward_operators_and_lbls_tpu.ops import geometry as jgeo
from mwr_fast_forward_operators_and_lbls_tpu.ops import thermo as jthermo
from mwr_fast_forward_operators_and_lbls_tpu.ops.absorption import (
    n2_absorption as jax_n2_absorption)
from mwr_fast_forward_operators_and_lbls_tpu.ops.absorption import (
    total_absorption as jax_total_absorption)
from mwr_fast_forward_operators_and_lbls_tpu.ops.pallas import (
    spectral_kernel as jk6)
from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    ZENITH_SWEEP_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl, spectral
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    _mirrors as mirrors)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    spectral as k6)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
ELEVS = (90.0, 14.4)


@pytest.fixture(scope="module")
def points():
    """32 points from the surface to 5 hPa, moist and cloudy, and 256
    frequencies over 20-64 GHz, as float32 numpy arrays."""
    rng = np.random.default_rng(3)
    n = 32
    return {"p": np.linspace(1000.0, 5.0, n).astype(np.float32),
            "t": (250.0 + 30.0 * rng.random(n)).astype(np.float32),
            "rho": (8.0 * rng.random(n)).astype(np.float32),
            "lwc": (0.2 * rng.random(n)).astype(np.float32),
            "f": np.linspace(20.0, 64.0, 256).astype(np.float32)}


def _port_alpha(points, model):
    """The plain K6 on `points`, transposed to the JAX (N, F) layout."""
    args = [torch.from_numpy(points[k]) for k in ("f", "p", "t", "rho", "lwc")]
    return k6.absorption_spectral_reference(*args, model).numpy().T


def _jax_pallas_alpha(points, model):
    return np.asarray(jk6.absorption_spectral(
        *(jnp.asarray(points[k]) for k in ("f", "p", "t", "rho", "lwc")),
        model))


def _per_frequency_error(got, want):
    """max over points |got - want| / max over points |want|, worst
    frequency."""
    return float((np.abs(got - want).max(0) / np.abs(want).max(0)).max())


@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_reference_matches_jax_xla(points, model):
    """fp32, (256 frequencies, 32 points): within 1e-5 of each frequency's
    largest alpha (the same formulas in two libraries)."""
    want = np.asarray(jax_total_absorption(
        jnp.asarray(points["f"])[None, :], *(points[k][:, None] for k in
                                             ("p", "t", "rho", "lwc")),
        model=model))
    got = _port_alpha(points, model)
    assert got.dtype == np.float32 and got.shape == want.shape == (32, 256)
    assert _per_frequency_error(got, want) <= 1e-5


@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_reference_frozen_absorption_fp64(model):
    """fp64, the 20 golden frequencies x 6 clear-sky conditions with
    lwc = 0: rtol 1e-9."""
    g = json.loads((GOLDEN / f"absorption_{model}.json").read_text())
    p, t, rho = (torch.tensor(c, dtype=torch.float64)
                 for c in zip(*g["conditions"]))
    got = k6.absorption_spectral_reference(
        torch.tensor(g["freqs_ghz"], dtype=torch.float64), p, t, rho,
        torch.zeros_like(p), model)
    assert got.dtype == torch.float64 and got.shape == (20, 6)
    want = np.stack([np.asarray(v) for v in g["alpha"].values()], axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("model", ["R24", "R20SD"])
def test_reference_matches_jax_pallas(points, model):
    """The JAX K6 (interpret mode) reassociates fp32 in its merge trees:
    within 5e-5 of each frequency's largest alpha."""
    assert _per_frequency_error(_port_alpha(points, model),
                                _jax_pallas_alpha(points, model)) <= 5e-5


def test_r03_follows_xla_not_the_tpu_kernel(points):
    """R03 gets the 1998 dry continuum in the XLA path, the goldens and the
    port; the JAX K6 gives it the 2017 form.  The port minus the JAX K6 is
    the 1998 - 2017 continuum difference, to 5e-6 of each frequency's
    largest alpha, and that difference is itself over 2e-5 there."""
    got = _port_alpha(points, "R03")
    xla = np.asarray(jax_total_absorption(
        jnp.asarray(points["f"])[None, :], *(points[k][:, None] for k in
                                             ("p", "t", "rho", "lwc")),
        model="R03"))
    tpu = _jax_pallas_alpha(points, "R03")
    assert _per_frequency_error(got, xla) <= 1e-5
    pda = (points["p"] - points["rho"] * points["t"] / 217.0)[:, None]
    f = jnp.asarray(points["f"])[None, :]
    t = points["t"][:, None]
    dry = np.asarray(jax_n2_absorption(f, pda, t, variant="R98")
                     - jax_n2_absorption(f, pda, t, variant="R24"))
    scale = np.abs(tpu).max(0)
    assert float((np.abs(dry).max(0) / scale).max()) > 2e-5
    assert float((np.abs(got - tpu - dry).max(0) / scale).max()) <= 5e-6


def test_reference_sub_chunks_are_seamless(points, monkeypatch):
    whole = _port_alpha(points, "R20SD")
    monkeypatch.setattr(k6, "PLAIN_INTERMEDIATE_BYTES", 32 * 240 * 4 * 7)
    assert k6._plain_chunk(32, "R20SD", 4) == 7
    np.testing.assert_array_equal(_port_alpha(points, "R20SD"), whole)


def test_f_range_that_excludes_the_grid_raises(points):
    args = [torch.from_numpy(points[k]) for k in ("f", "p", "t", "rho", "lwc")]
    inside = k6.absorption_spectral(*args, "R24", f_range=(20.0, 64.0))
    torch.testing.assert_close(inside, k6.absorption_spectral(*args, "R24"),
                               rtol=0, atol=0)
    for f_range in ((21.0, 64.0), (20.0, 63.5), (70.0, 80.0)):
        with pytest.raises(ValueError, match="outside f_range"):
            k6.absorption_spectral(*args, "R24", f_range=f_range)
    with pytest.raises(ValueError, match="unknown absorption model"):
        k6.absorption_spectral(*args, "R99")


def test_wrapper_takes_the_plain_version_on_cpu(points):
    args = [torch.from_numpy(points[k]) for k in ("f", "p", "t", "rho", "lwc")]
    before = k6.absorption_spectral.launches
    got = k6.absorption_spectral(*args, "R24")
    assert k6.absorption_spectral.launches == before == 0
    assert got.shape == (256, 32)
    torch.testing.assert_close(
        got, k6.absorption_spectral_reference(*args, "R24"), rtol=0, atol=0)


@pytest.fixture(scope="module")
def profiles():
    return lbl.demo_batch(3, 48, device="cpu")


@pytest.fixture(scope="module")
def grid():
    return np.linspace(20.0, 62.0, 256).astype(np.float32)


@pytest.fixture(scope="module")
def port_out(profiles, grid):
    return spectral.forward_spectral(profiles, grid, ELEVS, "R24")


def test_forward_matches_jax_pallas_forward(profiles, grid, port_out):
    """JAX `forward_spectral` (K6 in interpret mode, its RTE in XLA): TB
    within 5e-3 K, tau within 1e-4 relative."""
    want = jspec.forward_spectral({k: v.numpy() for k, v in profiles.items()},
                                  grid, ELEVS, "R24")
    assert port_out["tb"].shape == (3, len(ELEVS), 256)
    assert port_out["tb"].dtype == torch.float32
    np.testing.assert_allclose(port_out["tb"].numpy(), np.asarray(want["tb"]),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(port_out["tau_total"].numpy(),
                               np.asarray(want["tau_total"]), rtol=1e-4)


def _jax_xla_forward(profiles, grid):
    """The composed XLA reference: total_absorption, then
    spectral._rte_freq_lanes on the vmapped slant_path_lengths."""
    prof = {k: v.numpy() for k, v in profiles.items()}
    alpha = jnp.asarray(jax_total_absorption(
        jnp.asarray(grid)[None, None, :], *(prof[k][..., None] for k in
                                            ("p", "t", "rho", "lwc")),
        model="R24"))                                          # (B, L, F)
    e_hpa = jthermo.rho_to_e(prof["rho"], prof["t"])
    tbs, taus, paths = [], [], []
    for el in ELEVS:
        ds = jax.vmap(lambda zi, pi, ti, ei, _el=el: jgeo.slant_path_lengths(
            zi, pi, ti, ei, _el))(prof["z"], prof["p"], prof["t"], e_hpa)
        tb, tau = jspec._rte_freq_lanes(alpha, ds, jnp.asarray(prof["t"]),
                                        jnp.asarray(grid))
        tbs.append(np.asarray(tb))
        taus.append(np.asarray(tau))
        paths.append(np.asarray(ds))
    return (np.stack(tbs, 1), np.stack(taus, 1), np.array(alpha),
            np.stack(paths))


def test_forward_matches_jax_xla_composition(profiles, grid, port_out):
    """TB within 2e-3 K and tau within 1e-5 relative of the composed XLA
    reference."""
    tb, tau, _, _ = _jax_xla_forward(profiles, grid)
    np.testing.assert_allclose(port_out["tb"].numpy(), tb, rtol=0, atol=2e-3)
    np.testing.assert_allclose(port_out["tau_total"].numpy(), tau, rtol=1e-5)


def test_rte_freq_lanes_matches_jax(profiles, grid):
    """The port's `_rte_freq_lanes` against the JAX function of that name on
    the same alpha and paths: 1e-3 K in fp32."""
    _, _, alpha, paths = _jax_xla_forward(profiles, grid)
    for e, ds in enumerate(paths):
        want_tb, want_tau = jspec._rte_freq_lanes(
            jnp.asarray(alpha), jnp.asarray(ds), jnp.asarray(
                profiles["t"].numpy()), jnp.asarray(grid))
        tb, tau = spectral._rte_freq_lanes(
            torch.from_numpy(alpha), torch.from_numpy(ds), profiles["t"],
            torch.from_numpy(grid))
        np.testing.assert_allclose(tb.numpy(), np.asarray(want_tb), rtol=0,
                                   atol=1e-3, err_msg=f"elevation {e}")
        np.testing.assert_allclose(tau.numpy(), np.asarray(want_tau),
                                   rtol=1e-5)


def test_chunking_is_seamless(profiles):
    f = np.linspace(22.0, 32.0, 300).astype(np.float32)
    a = spectral.forward_spectral(profiles, f, (90.0,), "R98", freq_chunk=128)
    b = spectral.forward_spectral(profiles, f, (90.0,), "R98",
                                  freq_chunk=4096)
    assert a["tb"].shape == (3, 1, 300)
    np.testing.assert_allclose(a["tb"].numpy(), b["tb"].numpy(), rtol=0,
                               atol=1e-4)


def test_matches_the_channel_forward_at_channel_centres(profiles):
    """At the 14 channel centres the spectral path is the channel forward:
    TB within 2e-2 K, tau within 1e-3 relative (as the JAX package's
    test)."""
    cfg = lbl.LBLConfig(model="R24", elevations_deg=ELEVS,
                        outputs=("tb", "tau_total"))
    want = lbl.forward_batch(profiles, cfg)
    got = spectral.forward_spectral(profiles, cfg.freqs_ghz, ELEVS, "R24")
    np.testing.assert_allclose(got["tb"].numpy(), want["tb"].numpy(), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(got["tau_total"].numpy(),
                               want["tau_total"].numpy(), rtol=1e-3,
                               atol=5e-3)


def test_line_structure(grid, port_out):
    tau = port_out["tau_total"][:, 0].numpy()                  # zenith
    i22, i26, i60 = (int(np.argmin(np.abs(grid - g)))
                     for g in (22.235, 26.0, 60.0))
    assert np.all(tau[:, i22] > 1.2 * tau[:, i26])             # water line
    assert np.all(tau[:, i60] > 10.0 * tau[:, i26])            # opaque O2


def test_srf_convolve_matches_jax(port_out):
    w = np.ones((2, 256), np.float32) * np.array([[1.0], [0.0]], np.float32)
    w[1, 60:68] = 1.0
    got = spectral.srf_convolve(port_out["tb"], torch.from_numpy(w))
    want = np.asarray(jspec.srf_convolve(jnp.asarray(port_out["tb"].numpy()),
                                         jnp.asarray(w)))
    assert got.shape == (3, len(ELEVS), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got[..., 0].numpy(),
                               port_out["tb"].mean(-1).numpy(), rtol=1e-5)


def test_plain_routes_and_float64(profiles, grid, port_out):
    """use_kernels=False is the same plain path on the CPU; float64 profiles
    run it in float64, within 2e-3 K of float32."""
    plain = spectral.forward_spectral(profiles, grid, ELEVS, "R24",
                                      use_kernels=False)
    for k in ("tb", "tau_total"):
        torch.testing.assert_close(plain[k], port_out[k], rtol=0, atol=0)
    out64 = spectral.forward_spectral(
        {k: v.double() for k, v in profiles.items()}, grid, ELEVS, "R24")
    assert out64["tb"].dtype == torch.float64
    np.testing.assert_allclose(out64["tb"].numpy(), port_out["tb"].numpy(),
                               rtol=0, atol=2e-3)


# ---- the arithmetic of K6's redesigned body, held against float64 ---------

def _line_centre_case():
    """Six points from a humid surface to the top of the column (25 hPa),
    and grids at the 50k spectrum's 0.88 MHz spacing around the 22.235 GHz
    water line, the 51-54 GHz window and three O2 line centres."""
    points = {
        "p": [1013.0, 1000.0, 500.0, 100.0, 41.0, 25.0],
        "t": [303.0, 288.0, 250.0, 215.0, 220.0, 222.0],
        "rho": [25.0, 12.0, 1.0, 0.01, 0.001, 0.0005],
        "lwc": [0.0, 0.2, 0.1, 0.0, 0.0, 0.0]}
    grids = [np.arange(c - half, c + half, 0.00088)
             for c, half in ((22.235, 0.2), (52.5, 1.5), (56.26, 0.2),
                             (58.45, 0.2), (60.3, 0.2))]
    f = torch.from_numpy(np.concatenate(grids).astype(np.float32))
    return f, [torch.tensor(points[k]) for k in ("p", "t", "rho", "lwc")]


def _share_of_max(got, ref):
    """max |got - ref| as a share of each frequency's maximum of ref."""
    scale = ref.abs().amax(dim=1, keepdim=True)
    return float(((got.double() - ref).abs() / scale).max())


@pytest.mark.parametrize("model", sorted(k6.H2O_MODELS))
def test_merged_arithmetic_against_float64(model):
    """The order of operations of K6's main pass (per-point line state, one
    rational in q = d1 d2 + w^2 per line, two O2 lines on one divide,
    folded strengths, f^2 after the loops, the liquid term from two
    reciprocals), in float32 with IEEE divides, against the
    function in float64 on the same float32 inputs, tables included: at
    most twice the plain float32 version's error and under 3e-6 of each
    frequency's maximum alpha."""
    f, args = _line_centre_case()
    ref = k6.absorption_spectral_float64(f, *args, model)
    plain = _share_of_max(
        k6.absorption_spectral_reference(f, *args, model), ref)
    merged = _share_of_max(
        mirrors.absorption_spectral_merged(f, *args, model), ref)
    assert merged <= 2.0 * plain and merged < 3e-6, (merged, plain)
    # in float64 the merged form is the function itself
    merged64 = mirrors.absorption_spectral_merged(
        f.double(), *(a.double() for a in args), model)
    exact = k6.absorption_spectral_reference(
        f.double(), *(a.double() for a in args), model)
    assert _share_of_max(merged64, exact) < 1e-12


def _o2_line_sum(f, args, model, expanded):
    """The O2 lines' sum of K6's main pass, one rational per line from the
    state of `line_state`, with q from the difference d1 or expanded in f;
    and the factor o2s f^2 that takes it to alpha."""
    st = k6.line_state(*args, model)
    f0 = torch.as_tensor(k6.O2_MODELS[model].f, dtype=f.dtype)
    dnu, c2, dfsq, k2, k3 = (st["o2"][k][None]
                             for k in ("dnu", "c2", "dfsq", "k2", "k3"))
    f = f[:, None, None]
    if expanded:
        c = 0.5 * c2
        q = (f * f - c * c) + dfsq
    else:
        d1 = (f - f0) - dnu
        q = d1 * (d1 + c2) + dfsq
    total = ((k2 + q * k3) / (q * q + dfsq * (c2 * c2))).sum(-1)
    return total, st["scalars"]["o2s"][None] * (f * f)[..., 0]


@pytest.mark.parametrize("model", ["R98", "R24"])
def test_expanded_pair_cancels_at_the_line_centres(model):
    """q = d1 d2 + w^2 formed as (f^2 - (c / 2)^2) + w^2 instead of from the
    difference d1 = f - c / 2 fails the bound of the test above more than
    ten times over its error: f^2 is about 3600, where float32 resolves
    2.4e-4, and q falls to 1e-3 at the line centres at 25 hPa."""
    f, args = _line_centre_case()
    ref = k6.absorption_spectral_float64(f, *args, model)
    alpha = mirrors.absorption_spectral_merged(f, *args, model)
    merged = _share_of_max(alpha, ref)
    from_d1, scale = _o2_line_sum(f, args, model, expanded=False)
    in_f, _ = _o2_line_sum(f, args, model, expanded=True)
    expanded = _share_of_max(alpha + scale * (in_f - from_d1), ref)
    assert expanded > 3e-6 and expanded > 10.0 * merged, (expanded, merged)


def test_float32_tables_move_alpha_more_than_the_arithmetic():
    """Rounding the line tables to float32 moves alpha by more than any of
    the float32 arithmetic does: the reason K6 is held against float64 on
    its own tables."""
    f, args = _line_centre_case()
    args64 = [a.double() for a in args]
    on_float32_tables = k6.absorption_spectral_float64(f, *args, "R24")
    exact = k6.absorption_spectral_reference(f.double(), *args64, "R24")
    moved = _share_of_max(exact, on_float32_tables)
    plain = _share_of_max(
        k6.absorption_spectral_reference(f, *args, "R24"), on_float32_tables)
    assert 3e-6 < moved < 2e-5 and plain < 1e-6, (moved, plain)


@pytest.mark.parametrize("model", ["R17", "R20SD", "R24"])
def test_line_state_layout(model):
    """`line_state` has one entry per row of the kernel's state, and the
    merged form rebuilt from the plain line shapes agrees with it."""
    f, args = _line_centre_case()
    st = k6.line_state(*args, model)
    n_h2o = k6.H2O_MODELS[model].fl.size
    n_o2 = k6.O2_MODELS[model].f.size
    assert tuple(st["scalars"]) == k6.STATE_SCALARS
    assert all(v.shape == (6,) for v in st["scalars"].values())
    assert all(v.shape == (6, n_h2o) for v in st["h2o"].values())
    assert tuple(st["o2"]) == ("dnu", "c2", "dfsq", "k2", "k3")
    assert all(v.shape == (6, n_o2) for v in st["o2"].values())
    assert k6.n_state(model) == (9 + k6.h2o_slots(model) * n_h2o + 5 * n_o2)
    assert k6.h2o_slots(model) == (6 if model.endswith("SD") else 3)
    if not model.endswith("SD"):
        assert float(st["h2o"]["gamma2"].abs().max()) == 0.0
