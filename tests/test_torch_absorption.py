"""The port's absorption ops and the module of kernels K1 and K4
(`ops/cuda/absorption.py`), held against the frozen fp64 goldens and the JAX
package's XLA `total_absorption` (and its jax.jvp) on the same inputs."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.constants import afgl
from mwr_fast_forward_operators_and_lbls_tpu.constants.h2o_lines import (
    ZENITH_SWEEP_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu.ops.absorption import (
    total_absorption as jax_total_absorption)
from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS, O2_MODELS, o3_lines)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.absorption import (
    total_absorption)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    _mirrors as mirrors)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    absorption as k1)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
FREQS = lbl.LBLConfig().freqs_ghz


@pytest.fixture(scope="module")
def points():
    """demo_batch(4, 96) levels, flattened, as float32 numpy arrays."""
    b = lbl.demo_batch(4, 96, device="cpu")
    z = b["z"].numpy().reshape(-1)
    o3 = np.interp(z / 1000.0, afgl.CLIMATOLOGIES["midlatitude_summer"]
                   ["z_km"], afgl.CLIMATOLOGIES["midlatitude_summer"]
                   ["o3_ppmv"]).astype(np.float32)
    out = {k: b[k].numpy().reshape(-1) for k in ("p", "t", "rho", "lwc")}
    out["o3"] = o3
    return out


@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_frozen_absorption_fp64(model):
    g = json.loads((GOLDEN / f"absorption_{model}.json").read_text())
    f = torch.tensor(g["freqs_ghz"], dtype=torch.float64)
    for (p, t, rho), (key, want) in zip(g["conditions"], g["alpha"].items()):
        a = total_absorption(f, torch.tensor(p, dtype=torch.float64),
                             torch.tensor(t, dtype=torch.float64),
                             torch.tensor(rho, dtype=torch.float64),
                             model=model)
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-9,
                                   err_msg=f"{model} @ {key}")


@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_fp32_matches_jax_xla(points, model, with_o3):
    """fp32 against the XLA reference on the same points: per channel,
    max |dalpha| <= 1e-4 x max |alpha| (100x fp32 rounding done by two
    libms)."""
    o3 = points["o3"] if with_o3 else None
    want = np.asarray(jax_total_absorption(
        jnp.asarray(FREQS, jnp.float32)[:, None], points["p"][None],
        points["t"][None], points["rho"][None], points["lwc"][None],
        model=model, o3_ppmv=None if o3 is None else o3[None]))
    got = total_absorption(
        torch.tensor(FREQS, dtype=torch.float32)[:, None],
        torch.from_numpy(points["p"])[None],
        torch.from_numpy(points["t"])[None],
        torch.from_numpy(points["rho"])[None],
        torch.from_numpy(points["lwc"])[None], model=model,
        o3_ppmv=None if o3 is None else torch.from_numpy(o3)[None]).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want).max(axis=1)
    scale = np.abs(want).max(axis=1)
    assert np.all(err <= 1e-4 * scale), (err / scale).max()


def test_o3_adds_absorption(points):
    args = [torch.from_numpy(points[k])[None] for k in ("p", "t", "rho")]
    f = torch.tensor(FREQS, dtype=torch.float32)[:, None]
    clear = total_absorption(f, *args, model="R24")
    with_o3 = total_absorption(f, *args, model="R24",
                               o3_ppmv=torch.from_numpy(points["o3"])[None])
    assert bool((with_o3 >= clear).all()) and bool((with_o3 > clear).any())


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown absorption model"):
        total_absorption(torch.tensor([22.24]), 1000.0, 280.0, 5.0,
                         model="R99")


@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
def test_reference_layout_equals_total_absorption(with_o3):
    prof = {k: v.T.contiguous()
            for k, v in lbl.demo_batch(3, 40, device="cpu").items()}
    o3 = lbl._afgl_o3(prof["z"]) if with_o3 else None
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    got = k1.absorption_lb_reference(FREQS, *args, "R20SD", o3=o3)
    assert got.shape == (len(FREQS), 40, 3)
    for c, f in enumerate(FREQS):
        want = total_absorption(torch.tensor(f), *args, model="R20SD",
                                o3_ppmv=o3)
        torch.testing.assert_close(got[c], want, rtol=1e-6, atol=0)


def test_wrapper_takes_the_plain_version_on_cpu():
    prof = {k: v.T.contiguous()
            for k, v in lbl.demo_batch(2, 30, device="cpu").items()}
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    before = k1.absorption_lb.launches
    got = k1.absorption_lb(FREQS, *args, "R24")
    assert k1.absorption_lb.launches == before == 0
    torch.testing.assert_close(got, k1.absorption_lb_reference(FREQS, *args,
                                                               "R24"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_packed_table_columns(model, with_o3):
    """Each column of the packed table, read at the offsets LineTables
    gives, is the release's line table in float32."""
    lay = k1.table_layout(model, with_o3)
    tab = k1.line_tables(model, with_o3, torch.device("cpu")).numpy()
    assert tab.dtype == np.float32 and tab.shape == (lay.size,)
    h2o, o2 = H2O_MODELS[model], O2_MODELS[model]

    def cols(base, n, fields, source):
        for i, name in enumerate(fields):
            np.testing.assert_array_equal(
                tab[base + i * n: base + (i + 1) * n],
                np.asarray(getattr(source, name), np.float32), err_msg=name)

    cols(lay.h2o, lay.n_h2o, k1.H2O_FIELDS, h2o)
    cols(lay.o2, lay.n_o2, k1.O2_FIELDS, o2)
    if with_o3:
        cols(lay.o3, lay.n_o3, k1.O3_FIELDS, o3_lines)
    else:
        assert lay.n_o3 == 0 and lay.o3 == lay.gl
    head = dict(zip(k1.HEADER_FIELDS, tab[:len(k1.HEADER_FIELDS)]))
    assert head["cutoff"] == np.float32(h2o.cutoff_ghz)
    assert head["mixing_basis_p"] == float(o2.mixing_basis == "p")
    # the 1998 dry continuum for R98 and R03 (ops/absorption/n2.py)
    dry98 = model in ("R98", "R03")
    assert head["n2_exp"] == np.float32(3.55 if dry98 else 3.6)
    assert head["n2_fdep"] == (0.0 if dry98 else 1.0)
    np.testing.assert_array_equal(tab[lay.gl:lay.gl + 16],
                                  k1._GL_X.astype(np.float32))


def _jax_partial(model, name, lev, freqs):
    """alpha and its partial in `name` (seeded with ones) by jax.jvp of the
    XLA total_absorption, float64, levels (L, B) numpy."""
    f = jnp.asarray(freqs, jnp.float64)[:, None, None]
    state = {k: jnp.asarray(lev[k])[None] for k in ("p", "t", "rho")}

    def alpha_of(v):
        s = {**state, name: v}
        return jax_total_absorption(f, s["p"], s["t"], s["rho"],
                                    jnp.asarray(lev["lwc"])[None],
                                    model=model)

    value, tangent = jax.jvp(alpha_of, (state[name],),
                             (jnp.ones_like(state[name]),))
    return np.asarray(value), np.asarray(tangent)


@pytest.fixture(scope="module")
def levels64():
    """(L, B) float64 levels of demo_batch(2, 40): the cloud layer is in."""
    return {k: v.T.contiguous().double()
            for k, v in lbl.demo_batch(2, 40, device="cpu").items()}


@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_tangents_reference_matches_jax_jvp(levels64, model):
    """K4's plain version (two torch.func.jvp passes) against jax.jvp of the
    XLA absorption in float64, every release: the same formulas, so
    agreement to 1e-9 relative, with a floor of 1e-12 of each channel's
    largest partial where a partial crosses zero."""
    args = [levels64[k] for k in ("p", "t", "rho", "lwc")]
    got = k1.absorption_tangents_lb_reference(FREQS, *args, model)
    lev = {k: v.numpy() for k, v in levels64.items()}
    with jax.enable_x64(True):
        alpha, da_t = _jax_partial(model, "t", lev, FREQS)
        _, da_rho = _jax_partial(model, "rho", lev, FREQS)
    for g, want in zip(got, (alpha, da_t, da_rho)):
        assert g.dtype == torch.float64 and g.shape == want.shape
        floor = 1e-12 * np.abs(want).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(g.numpy() - want)
                      <= 1e-9 * np.abs(want) + floor), model


def test_pressure_partial_matches_jax_jvp(levels64):
    args = [levels64[k] for k in ("p", "t", "rho", "lwc")]
    alpha, d = k1.absorption_partials_lb(FREQS, *args, "R98", wrt=("p",))
    lev = {k: v.numpy() for k, v in levels64.items()}
    with jax.enable_x64(True):
        want_alpha, want_dp = _jax_partial("R98", "p", lev, FREQS)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, rtol=1e-10)
    np.testing.assert_allclose(d["p"].numpy(), want_dp, rtol=1e-9,
                               atol=1e-12 * np.abs(want_dp).max())
    assert set(d) == {"p"}


def test_tangents_are_the_derivatives(levels64):
    """Central differences of the plain absorption in T and rho, float64:
    the O(h^2) truncation of the differences sets the 1e-5 tolerance."""
    p, t, rho, lwc = (levels64[k] for k in ("p", "t", "rho", "lwc"))
    alpha, da_t, da_rho = k1.absorption_tangents_lb_reference(
        FREQS, p, t, rho, lwc, "R24")

    def fd(dt=0.0, dr=0.0):
        return k1.absorption_lb_reference(FREQS, p, t + dt, rho + dr, lwc)

    for got, want in ((da_t, (fd(dt=1e-4) - fd(dt=-1e-4)) / 2e-4),
                      (da_rho, (fd(dr=1e-5) - fd(dr=-1e-5)) / 2e-5)):
        scale = want.abs().amax(dim=(1, 2), keepdim=True)
        assert bool(((got - want).abs() <= 1e-5 * scale).all())
    torch.testing.assert_close(alpha, fd(), rtol=0, atol=0)


def test_tangent_wrapper_takes_the_plain_version_on_cpu():
    prof = {k: v.T.contiguous()
            for k, v in lbl.demo_batch(2, 30, device="cpu").items()}
    args = [prof[k] for k in ("p", "t", "rho", "lwc")]
    got = k1.absorption_tangents_lb(FREQS, *args, "R24")
    assert k1.absorption_tangents_lb.launches == 0
    want = k1.absorption_tangents_lb_reference(FREQS, *args, "R24")
    for g, w in zip(got, want):
        assert g.shape == (len(FREQS), 30, 2) and g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---- K1's arithmetic: the merged rationals on a per-point line state ----

@pytest.fixture(scope="module")
def levels96():
    """(L, B) float32 levels of the 96-level demo_batch(4), with AFGL O3."""
    lev = {k: v.T.contiguous()
           for k, v in lbl.demo_batch(4, 96, device="cpu").items()}
    lev["o3"] = lbl._afgl_o3(lev["z"])
    return lev


def _share_of_max(got, ref):
    """max |got - ref| as a share of each channel's largest |ref|."""
    return float(((got.double() - ref.double()).abs().amax(dim=(1, 2))
                  / ref.abs().amax(dim=(1, 2))).max())


@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_merged_arithmetic_holds_float64(levels96, model, with_o3):
    """K1's order of operations in float32 (per-point state, one rational
    in q per line, two O2 lines per divide, f^2 last) against the function
    in float64 on the float32 tables: 5e-6 of each channel's largest alpha,
    the gate the kernel is held to on the card."""
    args = [levels96[k] for k in ("p", "t", "rho", "lwc")]
    o3 = levels96["o3"] if with_o3 else None
    got = mirrors.absorption_lb_merged(FREQS, *args, model, o3=o3)
    want = k1.absorption_lb_float64(FREQS, *args, model, o3=o3)
    assert got.dtype == torch.float32 and want.dtype == torch.float64
    assert got.shape == want.shape == (len(FREQS), 96, 4)
    assert _share_of_max(got, want) <= 5e-6
    # and in float64 it is the function, to rounding: the algebra is exact
    exact = mirrors.absorption_lb_merged(FREQS, *(a.double() for a in args), model,
                                    o3=None if o3 is None else o3.double())
    plain = k1.absorption_lb_reference(
        FREQS, *(a.double() for a in args), model,
        o3=None if o3 is None else o3.double())
    assert _share_of_max(exact, plain) <= 1e-12


@pytest.mark.parametrize("with_o3", [False, True], ids=["no_o3", "o3"])
@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_merged_arithmetic_matches_jax_xla(levels96, model, with_o3):
    """The same against the JAX package's XLA absorption on the same numpy
    inputs: per channel 1e-4 of the largest alpha, as the plain version."""
    lev = {k: v.numpy() for k, v in levels96.items()}
    o3 = levels96["o3"] if with_o3 else None
    want = np.asarray(jax_total_absorption(
        jnp.asarray(FREQS, jnp.float32)[:, None, None], lev["p"][None],
        lev["t"][None], lev["rho"][None], lev["lwc"][None], model=model,
        o3_ppmv=None if o3 is None else lev["o3"][None]))
    got = mirrors.absorption_lb_merged(
        FREQS, *(levels96[k] for k in ("p", "t", "rho", "lwc")), model, o3=o3)
    assert _share_of_max(got, torch.tensor(want)) <= 1e-4


def test_merged_o3_lines_are_the_plain_o3_term(levels96):
    """What O3 adds in K1's form (one rational per line, the density scale
    in the strength) is the plain O3 term: 1e-5 of its largest value."""
    args = [levels96[k].double() for k in ("p", "t", "rho", "lwc")]
    o3 = levels96["o3"].double()
    added = (mirrors.absorption_lb_merged(FREQS, *args, "R24", o3=o3)
             - mirrors.absorption_lb_merged(FREQS, *args, "R24"))
    want = (k1.absorption_lb_reference(FREQS, *args, "R24", o3=o3)
            - k1.absorption_lb_reference(FREQS, *args, "R24"))
    assert float(want.max()) > 0.0
    assert float((added - want).abs().max()) <= 1e-5 * float(want.max())


@pytest.mark.parametrize("freqs", [(22.24,), (22.24, 900.0), (183.31, 760.0)],
                         ids=["one", "span_leaves_cutoff", "submm"])
def test_merged_arithmetic_under_the_cutoff_tests(levels96, freqs):
    """A line is merged only where all channels lie inside the cutoff on both
    sides; with a channel outside, every channel takes the halves apart.
    Either way the function in float64 is met to 5e-6."""
    args = [levels96[k] for k in ("p", "t", "rho", "lwc")]
    for model in ("R24", "R20SD"):
        got = mirrors.absorption_lb_merged(freqs, *args, model)
        want = k1.absorption_lb_float64(freqs, *args, model)
        assert got.shape == (len(freqs), 96, 4)
        assert _share_of_max(got, want) <= 5e-6, model


# ---- K4's arithmetic: channel groups, the tangents by the body's formulas --

LEVEL_ARGS = ("p", "t", "rho", "lwc")


@pytest.mark.parametrize("model", ["R98", "R24", "R20SD"])
def test_grouped_tangents_match_jax_jvp(levels96, model):
    """K4's order of operations in float32 (two groups of 7 channels, the
    tangents from the body's own formulas) against jax.jvp of the JAX
    package's XLA absorption in float64 on the same float32 inputs: alpha to
    1e-4 and each tangent to 1e-3 of its channel's largest value, the gates
    of the kernel on the card."""
    lev = {k: v.numpy().astype(np.float64) for k, v in levels96.items()}
    with jax.enable_x64(True):
        alpha, da_t = _jax_partial(model, "t", lev, FREQS)
        _, da_rho = _jax_partial(model, "rho", lev, FREQS)
    got = mirrors.absorption_tangents_grouped(
        FREQS, *(levels96[k] for k in LEVEL_ARGS), model)
    for g, want, bound in zip(got, (alpha, da_t, da_rho), (1e-4, 1e-3, 1e-3)):
        assert g.dtype == torch.float32 and g.shape == want.shape
        assert _share_of_max(g, torch.from_numpy(want)) <= bound


@pytest.mark.parametrize("model", ZENITH_SWEEP_MODELS)
def test_grouped_tangents_hold_float64(levels96, model):
    """The same in float32 against the plain function's jvp in float64 on
    the kernel's float32 tables: alpha to 5e-6 and each tangent to 1e-5 of
    its channel's largest value.  In float64 it is the function, to
    rounding: the algebra of the merged rationals and of their tangents is
    exact."""
    args = [levels96[k] for k in LEVEL_ARGS]
    got = mirrors.absorption_tangents_grouped(FREQS, *args, model)
    want = k1.absorption_tangents_lb_float64(FREQS, *args, model)
    for g, w, bound in zip(got, want, (5e-6, 1e-5, 1e-5)):
        assert g.dtype == torch.float32 and w.dtype == torch.float64
        assert g.shape == w.shape == (len(FREQS), 96, 4)
        assert _share_of_max(g, w) <= bound
    args64 = [a.double() for a in args]
    exact = mirrors.absorption_tangents_grouped(FREQS, *args64, model)
    plain = k1.absorption_tangents_lb_reference(FREQS, *args64, model)
    for g, w in zip(exact, plain):
        assert _share_of_max(g, w) <= 1e-12


@pytest.mark.parametrize("freqs", [(22.24,), (22.24, 900.0), (183.31, 760.0)],
                         ids=["one", "span_leaves_cutoff", "submm"])
def test_grouped_tangents_under_the_cutoff_tests(levels96, freqs):
    """A line is merged only where every channel of the group lies inside
    the cutoff on both sides; a group that straddles a line's cutoff takes
    the halves apart.  Either way float64 on the float32 tables is met to
    5e-6 (alpha) and 1e-5 (tangents), and for the qSD release too."""
    args = [levels96[k] for k in LEVEL_ARGS]
    for model in ("R24", "R20SD"):
        got = mirrors.absorption_tangents_grouped(freqs, *args, model)
        want = k1.absorption_tangents_lb_float64(freqs, *args, model)
        for g, w, bound in zip(got, want, (5e-6, 1e-5, 1e-5)):
            assert g.shape == (len(freqs), 96, 4)
            assert _share_of_max(g, w) <= bound, model


@pytest.mark.parametrize("group", [2, 3])
def test_one_group_and_a_split_give_the_same_sums(levels96, group):
    """Four channels as one group or in groups of 2 or 3 (the last filled
    up with its last channel): the group decides only which lines take the
    merged form, so the sums agree to rounding in float64 and to 5e-6 of
    each channel's largest value in float32."""
    freqs = (22.24, 23.04, 183.31, 900.0)
    for dtype, bound in ((torch.float64, 1e-12), (torch.float32, 5e-6)):
        args = [levels96[k].to(dtype) for k in LEVEL_ARGS]
        one = mirrors.absorption_tangents_grouped(freqs, *args, "R24", group=4)
        split = mirrors.absorption_tangents_grouped(freqs, *args, "R24",
                                                    group=group)
        for a, b in zip(one, split):
            assert a.shape == b.shape == (4, 96, 4)
            assert _share_of_max(b, a) <= bound, dtype


@pytest.mark.parametrize("n_channels,want", [(1, (1, 1)), (8, (1, 8)),
                                             (9, (2, 5)), (14, (2, 7)),
                                             (16, (2, 8))])
def test_tangent_groups_are_at_most_eight_and_even(n_channels, want):
    assert k1.tangent_groups(n_channels) == want
    # the K-matrix shape, 256 profiles x 180 levels at 14 channels: 720
    # blocks of 128 points
    assert k1.tangent_blocks(256 * 180, n_channels) == 360 * want[0]
