"""The port's profiling module on the CPU: the chain kernel's plain version,
the timer, the per-kernel rooflines and the bound."""

import dataclasses

import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS, O2_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import chain
from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import profiling

torch.set_num_threads(1)

def _c(value):
    """The kernel's float32 literal, as a float64."""
    return np.float64(np.float32(value))


NUMPY_OPS = {
    "fma": lambda v: v * _c(1.0000001) + _c(1e-9),
    "div": lambda v: 1.0 / (v + _c(1.3)),
    "exp": lambda v: np.exp(v * _c(1e-6)),
}
U = 2.0 ** -24      # the relative rounding error of one float32 operation


def _recurrence64(x, op, k):
    a = [x.astype(np.float64) * _c(1.0 + j * 1e-3) for j in range(8)]
    for _ in range(k):
        a = [NUMPY_OPS[op](v) for v in a]
    return sum(a)


def _chain_inputs(seed, n):
    """Half uniform in [0, 1), half log-uniform in [1e-9, 1e-7): on the
    small half the fma chain's b = 1e-9 a step changes the value many
    times over."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.random(n // 2, dtype=np.float32),
        (10.0 ** rng.uniform(-9.0, -7.0, n - n // 2)).astype(np.float32)])


# float32 against a float64 recurrence on the same float32 constants.  The
# fma chain has slope ~1 and keeps every rounding: two per step, one for the
# scaling and seven in the sum, each at most 2^-24 relative, all terms
# positive.  The other two contract to a fixed point.
@pytest.mark.parametrize("op,k,rtol", [("fma", 96, (2 * 96 + 8) * U),
                                       ("div", 24, 1e-6), ("exp", 24, 1e-6)])
def test_chain_reference_matches_a_float64_recurrence(op, k, rtol):
    x = _chain_inputs(7, 1000)
    assert chain.default_k(op) == k
    want = _recurrence64(x, op, k)
    got32 = chain.chain_reference(torch.from_numpy(x), op).numpy()
    np.testing.assert_allclose(got32, want, rtol=rtol, atol=0)
    got64 = chain.chain_reference(torch.from_numpy(x).double(), op).numpy()
    np.testing.assert_allclose(got64, want, rtol=1e-12, atol=0)
    twice = chain.chain_reference(torch.from_numpy(x).double(), op, 2 * k)
    np.testing.assert_allclose(twice.numpy(), _recurrence64(x, op, 2 * k),
                               rtol=1e-12, atol=0)


def test_only_the_fma_chain_shows_its_length():
    """One application more or less moves the fma chain by 1e-9 per copy,
    over 1e-3 of the value on the small inputs and far over the tolerance
    it is held to; the div and exp chains have converged long before k."""
    x = torch.from_numpy(_chain_inputs(9, 1000)).double()
    small = x < 1e-7
    k = chain.default_k("fma")
    at_k, short = (chain.chain_reference(x, "fma", n) for n in (k, k - 1))
    moved = ((at_k - short) / at_k)[small]
    assert float(moved.min()) > 1e-3 > 50 * (2 * k + 8) * U
    twice = chain.chain_reference(x, "fma", 2 * k)
    np.testing.assert_allclose((twice - at_k)[small].numpy(),
                               8 * k * np.float64(np.float32(1e-9)),
                               rtol=1e-4)
    for op in ("div", "exp"):
        k = chain.default_k(op)
        at_k, short = (chain.chain_reference(x, op, n) for n in (k, k // 2))
        assert float(((at_k - short) / at_k).abs().max()) < 1e-6


@pytest.mark.parametrize("op", sorted(chain.OPS))
def test_chain_on_cpu_takes_the_plain_version_and_counts_no_launch(op):
    x = torch.from_numpy(np.random.default_rng(8).random((4, 33),
                                                         dtype=np.float32))
    before = chain.chain.launches
    got = chain.chain(x, op)
    assert chain.chain.launches == before
    assert got.shape == x.shape
    torch.testing.assert_close(got, chain.chain_reference(x, op), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="unknown primitive"):
        chain.chain(x, "tanh")


def test_device_time_on_a_cpu_function_is_positive():
    x = torch.ones(256, 256)
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    seconds = profiling.device_time(fn, (x,), iters=3, trials=2)
    assert 0.0 < seconds < 1.0
    assert len(calls) == 1 + 3 * 2          # one warm-up, then iters x trials
    assert profiling.device_time(lambda: x + 1, (), iters=2, trials=1,
                                 device="cpu") > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_measure_peaks_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profiling.measure_peaks()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profiling.measure_peaks("cpu")


def test_default_peaks_are_the_published_h100_figures():
    p = profiling.DEFAULT_PEAKS
    assert p["fma"] == 33.5e12 and p["hbm"] == 3.35e12
    # 132 SMs x 16 special-function lanes x 1.98 GHz
    assert p["div"] == p["exp"] == pytest.approx(132 * 16 * 1.983e9, rel=2e-3)
    assert set(p) == {"fma", "div", "exp", "hbm"}


@pytest.mark.parametrize("counts,category", [
    ((33.5e12, 1.0, 1.0, 1.0), "fma"),
    ((1.0, 4.19e12, 1.0, 1.0), "div"),
    ((1.0, 1.0, 4.19e12, 1.0), "exp"),
    ((1.0, 1.0, 1.0, 3.35e12), "bytes"),
])
def test_time_bound_picks_the_binding_category(counts, category):
    roof = profiling.Roofline(*counts)
    assert roof.bound_by() == category
    assert roof.time_bound_s() == pytest.approx(1.0)
    assert roof.times_s()[category] == pytest.approx(1.0)
    # other peaks move the bound: ten times the rates, a tenth of the time
    fast = {k: 10.0 * v for k, v in profiling.DEFAULT_PEAKS.items()}
    assert roof.time_bound_s(fast) == pytest.approx(0.1)
    # the additive model is never under the bound
    assert profiling.pipeline_model_time(roof) >= roof.time_bound_s()


def test_pipeline_model_adds_the_dispatch_times():
    roof = profiling.Roofline(33.5e12, 4.19e12, 4.19e12, 3.35e12)
    assert profiling.pipeline_model_time(roof) == pytest.approx(3.0)
    assert roof.time_bound_s() == pytest.approx(1.0)


GRID = np.linspace(20.0, 64.0, 50_000)[:8192]
P = profiling
KERNEL_ROOFLINES = {
    "k1": lambda b, **kw: P.k1_roofline(b * 180, **kw),
    "k1_o3": lambda b, **kw: P.k1_roofline(b * 180, with_o3=True, **kw),
    "k2": lambda b, **kw: P.k2_roofline(b, **kw),
    "k2_mid": lambda b, **kw: P.k2_roofline(b, alpha_is_mid=True, **kw),
    "k2_trans": lambda b, **kw: P.k2_roofline(b, want_trans_level=True, **kw),
    "k2_series": lambda b, **kw: P.k2_roofline(
        b, small_dtau_fraction=0.65, planck_series_fraction=1.0, **kw),
    "k2_mid_series": lambda b, **kw: P.k2_roofline(
        b, alpha_is_mid=True, planck_series_fraction=1.0, **kw),
    "k1_sd": lambda b, **kw: P.k1_roofline(b * 180, model="R20SD", **kw),
    "k1_r98": lambda b, **kw: P.k1_roofline(b * 180, model="R98", **kw),
    "k1_submm": lambda b, **kw: P.k1_roofline(b * 180, (183.31, 900.0), **kw),
    "k3": lambda b, **kw: P.k2_roofline(b, 180, 8192, 1, given_paths=True,
                                        **kw),
    "k3_series": lambda b, **kw: P.k2_roofline(
        b, 180, 8192, 1, given_paths=True, planck_series_fraction=1.0, **kw),
    "k4": lambda b, **kw: P.k4_roofline(b * 180, **kw),
    "k5_t": lambda b, **kw: P.k5_roofline(b, which="t", **kw),
    "k5_rho": lambda b, **kw: P.k5_roofline(b, which="rho", **kw),
    "k5_lwc": lambda b, **kw: P.k5_roofline(b, which="lwc", **kw),
    "k5_rho_lwc": lambda b, **kw: P.k5_roofline(b, which="rho_lwc", **kw),
    "k6": lambda b, **kw: P.k6_roofline(b * 180, GRID, **kw),
    "k6_sd": lambda b, **kw: P.k6_roofline(b * 180, GRID[:64], "R20SD", **kw),
    "k7": lambda b: P.k7_roofline(b * 4096),
}


@pytest.mark.parametrize("name", sorted(KERNEL_ROOFLINES))
def test_kernel_roofline_is_positive_and_linear_in_the_batch(name):
    make = KERNEL_ROOFLINES[name]
    r1, r2, r3 = (dataclasses.astuple(make(b)) for b in (32, 64, 96))
    for field, a, b, c in zip(("fma", "div", "exp", "bytes"), r1, r2, r3):
        # affine in the batch: the tables, the channel vector and what
        # depends on the frequency grid alone are read or formed once
        assert c - b == pytest.approx(b - a, rel=1e-9), field
        assert b >= a >= 0.0 and (a > 0.0 or b == 0.0), field
        assert 2 * a >= b, field
    assert make(32).fma_ops > 0 and make(32).hbm_bytes > 0
    assert make(32).time_bound_s() > 0.0


@pytest.mark.parametrize("name", sorted(set(KERNEL_ROOFLINES) - {"k7"}))
def test_function_bound_is_not_above_what_the_body_executes(name):
    make = KERNEL_ROOFLINES[name]
    needed, coded = make(64), make(64, as_coded=True)
    assert needed.hbm_bytes == coded.hbm_bytes
    assert needed.time_bound_s() <= coded.time_bound_s()
    assert needed.div_ops <= coded.div_ops
    assert needed.exp_ops <= coded.exp_ops
    # as coded, the operations are proportional to the batch, but for what
    # K6's state pass forms once per frequency of the grid
    per_call = [2 * a - b for a, b in zip(
        dataclasses.astuple(coded)[:3],
        dataclasses.astuple(make(128, as_coded=True))[:3])]
    n_grid = {"k6": GRID.size, "k6_sd": 64}.get(name, 0)
    grid_only = P._charge(P._K6_CODED, P._FLOAT, {"freq": n_grid})
    tol = 1e-12 * coded.fma_ops
    assert per_call[1:] == pytest.approx([grid_only.div, grid_only.exp],
                                         abs=tol)
    # multiplies or adds, whichever the body has more of
    assert any(per_call[0] == pytest.approx(most + grid_only.other, abs=tol)
               for most in (grid_only.mul, grid_only.add))


def test_each_quantity_is_charged_on_the_indices_it_depends_on():
    B, L, F, E = 64, 180, 14, 10
    # K2: one expf per (elevation, channel, layer, profile), Planck per
    # (channel, level, profile) and per channel, log1pf twice per output
    k2 = profiling.k2_roofline(B, L, F, E)
    assert k2.exp_ops == E * F * (L - 1) * B + F * L * B + F + 2 * E * F * B
    coded = profiling.k2_roofline(B, L, F, E, as_coded=True)
    assert coded.exp_ops == E * F * B * (2 * (L - 1) + 4)
    # chords per (elevation, layer, profile): four divides or square roots
    thin = profiling.k2_roofline(B, L, F, E, given_paths=True)
    assert k2.div_ops - thin.div_ops == 4 * E * (L - 1) * B
    # K5: one exponential per layer and Planck per level
    k5 = profiling.k5_roofline(B, L, F, E, "lwc")
    assert k5.exp_ops == E * F * (L - 1) * B + F * L * B + F + E * F * B
    # K6: a point's and a line's setup once, whatever the number of tiles
    f32 = np.linspace(22.0, 31.0, 32)
    k6 = profiling.k6_roofline(1000, f32)
    assert k6.exp_ops == profiling.k6_roofline(1000, f32[:16]).exp_ops
    # and so does the body: its state pass runs once per call.  It calls
    # powf, a logarithm and an exponential each time, 34 a point, where the
    # function is charged one logarithm per point (K1's body does so)
    coded = profiling.k6_roofline(1000, f32, as_coded=True)
    assert coded.exp_ops \
        == profiling.k6_roofline(1000, f32[:16], as_coded=True).exp_ops
    assert coded.exp_ops - k6.exp_ops == 1000 * (35 - 1)
    k1_body = profiling.k1_roofline(1000, f32[:16], as_coded=True)
    assert k1_body.exp_ops == profiling.k1_roofline(1000, f32[:16]).exp_ops


def test_float_lines_are_one_rational_and_two_o2_lines_share_a_divide():
    """Per (point, frequency) the function on floats needs one divide per
    two O2 lines, one per H2O line that has a half inside the cutoff and
    four in the tail; with both tangents (K4) the same per line."""
    f, n = np.linspace(51.0, 54.0, 16), 1000
    fl, cut = H2O_MODELS["R24"].fl, H2O_MODELS["R24"].cutoff_ghz
    near = np.abs(f[:8, None] - fl) < cut
    far = np.abs(f[:8, None] + fl) < cut
    n_o2 = O2_MODELS["R24"].f.size

    def per_frequency(make, field):
        """Of one point more, on the first eight frequencies."""
        def per_point(grid):
            return (getattr(make(2 * n, grid), field)
                    - getattr(make(n, grid), field)) / n
        return per_point(f) - per_point(f[8:])

    want = 8 * (-(-n_o2 // 2) + 4) + (near | far).sum()
    assert per_frequency(P.k6_roofline, "div_ops") == pytest.approx(want)
    assert per_frequency(P.k1_roofline, "div_ops") == pytest.approx(want)
    # K4 carries both tangents through the same rationals: the same divides
    # per line, and five in the tail (aimag's quotient rule is the fifth)
    want_k4 = 8 * (-(-n_o2 // 2) + 5) + (near | far).sum()
    assert per_frequency(P.k4_roofline, "div_ops") == pytest.approx(want_k4)
    # the body pays an add more per O2 line and a multiply more per pair
    coded = per_frequency(lambda *a: P.k6_roofline(*a, as_coded=True),
                          "fma_ops")
    needed = per_frequency(P.k6_roofline, "fma_ops")
    assert 8 * n_o2 <= coded - needed <= 8 * 3 * n_o2


def test_new_bodies_are_counted_as_they_are_coded():
    """K1's body pays one reciprocal per two O2 lines and per merged H2O
    line; K4's pays one per O2 line and per merged H2O line in each of its
    two groups of 7 channels; K2's staged body forms the chord once per
    block of up to 16 channels, takes no exponential for Planck where the
    series serves, and pays a reciprocal per layer for computing both forms
    of the emission factors, on any batch."""
    n, f = 1000, np.asarray(P._HATPRO)
    k1 = P.k1_roofline(n, as_coded=True)
    n_o2, n_h2o = O2_MODELS["R24"].f.size, H2O_MODELS["R24"].fl.size
    fl, cut = H2O_MODELS["R24"].fl, H2O_MODELS["R24"].cutoff_ghz
    near = np.abs(f[:, None] - fl) < cut
    far = np.abs(f[:, None] + fl) < cut
    merged = (near & far).all(axis=0)
    lines = f.size * merged.sum() + near[:, ~merged].sum() \
        + far[:, ~merged].sum()
    # per point: per channel 25 for the O2 pairs and 4 in the tail, and the
    # H2O lines; 15 bases, 300 / T, / 217, k_nr and 1 / fp; the block's
    # share of the table's reciprocals
    per_point = f.size * (-(-n_o2 // 2) + 4) + lines + n_h2o + 4
    assert k1.div_ops / n == pytest.approx(
        per_point + (n_h2o + n_o2 + 2 * f.size) / 128)
    # K4, per group and point: per channel a reciprocal per O2 line and per
    # merged H2O line, five IEEE divides in the tail; a reciprocal per half
    # of the lines apart; 300 / T, / 217, 1 / ti, 1 / fp and a base per H2O
    # line; the block's share of the records' and the channels' divides
    k4 = P.k4_roofline(n, as_coded=True)
    want = 0
    for group in (f[:7], f[7:]):
        g_near = np.abs(group[:, None] - fl) < cut
        g_far = np.abs(group[:, None] + fl) < cut
        both = (g_near & g_far).all(axis=0)
        want += (group.size * (n_o2 + both.sum() + 5) + g_near[:, ~both].sum()
                 + g_far[:, ~both].sum() + 4 + n_h2o
                 + (n_h2o + n_o2 + 3 * group.size) / 128)
    assert k4.div_ops / n == pytest.approx(want)
    B, L, F, E = 64, 180, 14, 10
    staged = P.k2_roofline(B, L, F, E, planck_series_fraction=1.0,
                           as_coded=True)
    chords = 4 * E * (L - 1)            # divides and square roots a profile
    per_thread = staged.div_ops / B - chords
    # per (elevation, channel, profile): a reciprocal per level for Planck's
    # series, one per layer for the quotient (whatever the opacity), two for
    # the cosmic background, five in the tail
    assert per_thread == pytest.approx(F * E * (L + (L - 1) + 7), rel=1e-12)
    # any batch takes this body: the counts are proportional to it
    odd = P.k2_roofline(B + 1, L, F, E, planck_series_fraction=1.0,
                        as_coded=True)
    assert odd.div_ops / (B + 1) == pytest.approx(staged.div_ops / B)
    # K3's other body (an odd batch) takes Planck by expm1f and a divide more
    k3 = [P.k2_roofline(b, L, F, 1, given_paths=True, as_coded=True,
                        planck_series_fraction=1.0) for b in (B, B + 1)]
    assert k3[1].exp_ops / (B + 1) > k3[0].exp_ops / B
    assert staged.exp_ops == E * F * B * ((L - 1) + 3)
    # 28 channels are two blocks of 14 (16 at the most): the chord twice
    two = P.k2_roofline(B, L, 28, E, planck_series_fraction=1.0,
                        as_coded=True)
    assert two.div_ops / B - 2 * per_thread == pytest.approx(2 * chords)


def test_planck_series_share_moves_the_rte_count():
    t = torch.tensor([[250.0], [2.7]])
    assert P.planck_series_share((22.0, 60.0), t) == 0.5
    assert P.planck_series_share((22.0, 60.0), t[:1]) == 1.0
    closed = P.k2_roofline(32, 180, 8192, 1, given_paths=True)
    series = P.k2_roofline(32, 180, 8192, 1, given_paths=True,
                           planck_series_fraction=1.0)
    levels = 8192 * 180 * 32
    # an exponential and a divide less per (channel, level, profile); the
    # series' fp32 instructions are not charged, since the closed form needs
    # none (the function takes the lesser of both forms in each resource);
    # the body that runs the series pays them; the same bytes
    assert closed.exp_ops - series.exp_ops == levels
    assert closed.div_ops - series.div_ops == levels
    assert series.fma_ops == closed.fma_ops
    assert (P.k2_roofline(32, 180, 8192, 1, given_paths=True,
                          planck_series_fraction=1.0, as_coded=True).fma_ops
            > P.k2_roofline(32, 180, 8192, 1, given_paths=True,
                            as_coded=True).fma_ops)
    assert series.hbm_bytes == closed.hbm_bytes
    half = P.k2_roofline(32, 180, 8192, 1, given_paths=True,
                         planck_series_fraction=0.5)
    assert half.exp_ops == pytest.approx(0.5 * (closed.exp_ops
                                                + series.exp_ops))
    # K3's staged body takes the same share by the series
    for share in (0.0, 1.0):
        body = P.k2_roofline(32, 180, 8192, 1, given_paths=True,
                             planck_series_fraction=share, as_coded=True)
        want = P.k2_roofline(32, 180, 8192, 1, given_paths=True,
                             planck_series_fraction=share)
        assert 0 <= body.exp_ops - want.exp_ops < 0.01 * want.exp_ops


def test_dual_numbers_cost_more_than_floats():
    k1, k4 = profiling.k1_roofline(1000), profiling.k4_roofline(1000)
    assert k4.fma_ops > 2 * k1.fma_ops
    assert k4.div_ops > k1.div_ops and k4.exp_ops == k1.exp_ops
    assert k4.hbm_bytes > k1.hbm_bytes


@pytest.mark.parametrize("n_channels,groups", [(8, 1), (14, 2), (16, 2)])
def test_k4_body_forms_the_line_state_once_per_group(n_channels, groups):
    """K4's body takes the channels in groups of at most 8 and forms every
    line's state in each: as many exponentials a point as the function
    (which forms it once) times the groups; the function's fp32 count stays
    under the body's, whose group of 7 spends the O2 state on 7 channels."""
    f = np.linspace(22.0, 58.0, n_channels)
    need = profiling.k4_roofline(1000, f)
    body = profiling.k4_roofline(1000, f, as_coded=True)
    assert body.exp_ops == groups * need.exp_ops
    assert need.fma_ops < body.fma_ops and need.div_ops < body.div_ops
    assert body.hbm_bytes == need.hbm_bytes


def test_clough_cutoff_is_counted_for_the_frequencies_given():
    # at 900 GHz other line halves lie inside the 750 GHz cutoff than at 22
    low = profiling.k1_roofline(1000, (22.24,))
    high = profiling.k1_roofline(1000, (900.0,))
    assert low.fma_ops != high.fma_ops
    # K1's body merges a line's two halves where both lie inside (one divide
    # where the halves apart took two), so at these two frequencies its
    # divides happen to agree and its fp32 instructions show the branches;
    # so do K4's, whose group of one channel merges where K1 does
    for make in (profiling.k1_roofline, profiling.k4_roofline):
        low, high = (make(1000, (f,), as_coded=True) for f in (22.24, 900.0))
        assert low.div_ops == high.div_ops and low.fma_ops != high.fma_ops
    # a group that straddles the cutoff of 13 lines takes them apart: 27
    # halves at 22.24 GHz and 14 at 900 where two close channels pay 26
    # merged rationals and 2 halves, 13 reciprocals less a point
    close, pair = (profiling.k4_roofline(1000, f, as_coded=True)
                   for f in ((22.24, 23.04), (22.24, 900.0)))
    assert pair.div_ops - close.div_ops == pytest.approx(1000 * 13)
    # the qSD releases evaluate 16 quadrature nodes per near half
    assert (profiling.k1_roofline(1000, model="R20SD").div_ops
            > profiling.k1_roofline(1000, model="R20").div_ops)


def test_data_dependent_branches_move_the_counts():
    thin = profiling.k2_roofline(64, small_dtau_fraction=1.0)
    thick = profiling.k2_roofline(64, small_dtau_fraction=0.0)
    assert thick.div_ops > thin.div_ops and thick.fma_ops < thin.fma_ops
    series = profiling.k5_roofline(64, series_fraction=1.0)
    closed = profiling.k5_roofline(64, series_fraction=0.0)
    assert closed.div_ops > series.div_ops and closed.fma_ops < series.fma_ops
    # the body pays an expf more on the closed branch; the function does not
    assert closed.exp_ops == series.exp_ops
    assert (profiling.k5_roofline(64, series_fraction=0.0,
                                  as_coded=True).exp_ops
            > profiling.k5_roofline(64, as_coded=True).exp_ops)
    dtau = torch.tensor([0.01, 0.02, 0.04, 0.6])
    assert profiling.small_dtau_share(dtau) == 0.5
    assert profiling.small_dtau_share(dtau, 0.5) == 0.75


def test_path_rooflines_are_the_sums_of_their_kernels():
    lbl_sum = (profiling.k1_roofline(1024 * 180)
               + profiling.k2_roofline(1024))
    assert profiling.lbl_roofline(1024) == lbl_sum
    spec_sum = (profiling.k6_roofline(5760, np.linspace(20.0, 64.0, 8192))
                + profiling.k2_roofline(32, 180, 8192, 1, given_paths=True))
    assert profiling.spectral_roofline(5760, 8192) == spec_sum
    # fewer channels and lines, less work
    assert (profiling.lbl_roofline(1024, n_channels=7).fma_ops
            < lbl_sum.fma_ops)
    assert (profiling.lbl_roofline(1024, n_o2_lines=20).div_ops
            < lbl_sum.div_ops)
    assert (profiling.spectral_roofline(5760, 8192, f_range=(20.0, 400.0))
            != spec_sum)


def test_path_times_needs_a_card(monkeypatch, capsys):
    """The host-against-device timer of one entry point exits with 1 on a
    machine without a card, having measured nothing."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
        path_times)
    monkeypatch.setattr("sys.argv", ["path_times.py", "--path", "forward"])
    assert path_times.main() == 1
    assert "CUDA" in capsys.readouterr().out
