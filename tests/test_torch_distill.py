"""The distillation's training step (`models/fast.py::train_step`) and K2's
backward (`ops/cuda/rte.py`: the autograd Function `_K2Mid` around K2, and
K2v, `forward_lb_vjp`).

On the CPU: the Function, on the plain versions, gives autograd's gradient
of `forward_lb_reference` to the bit and refuses every gradient it does not
compute; K2v's arithmetic in plain torch (`_mirrors.rte_vjp_walk`) is the
plain gradient in float64 and meets the card tests' bound in float32;
`train_step` on the CPU is the step as it was before K2 had a backward, to
the bit, in float32 and float64.  On the card (marked `cuda`):
K2v against the plain gradient in float64, and the step on the kernel path:
one K2 and one K2v a step (the first through their wrappers, the rest as
the captured graph's replays), no plain RTE operation, the step's loss and
gradient against the plain step in float64 away from the float32 noise
floor of the fit, and the graphed step equal to the eager one.
"""

import dataclasses

import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast, lbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import geometry, thermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    _mirrors, rte)

torch.set_num_threads(1)

FREQS = (22.24, 31.4, 54.94, 58.0)
ELEVS = (90.0, 30.0, 4.2)


def _levels(batch, n_levels, dtype, device="cpu", seed=0):
    """z, n, t (L, B) of `batch` demo profiles, and the profiles."""
    prof = lbl.demo_batch(batch, n_levels, seed=seed, device=device)
    lev = {k: v.to(dtype).T.contiguous() for k, v in prof.items()}
    n = geometry.refractive_index(lev["p"], lev["t"],
                                  thermo.rho_to_e(lev["rho"], lev["t"]))
    return lev["z"], n, lev["t"], prof


def _alpha_mid(n_ch, n_levels, batch, dtype, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    # layer extinction of 0-0.6 Np/km: opacities on both sides of the
    # emission series' switch at low elevations
    return (0.6 * torch.rand(n_ch, n_levels - 1, batch, generator=g,
                             dtype=torch.float64)).to(device, dtype)


def _cotangent(batch, dtype, device="cpu", seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(len(ELEVS), len(FREQS), batch, generator=g,
                       dtype=torch.float64).to(device, dtype)


def test_the_function_is_autograd_of_the_plain_version_in_float64():
    z, n, t, _ = _levels(3, 24, torch.float64)
    alpha = _alpha_mid(len(FREQS), 24, 3, torch.float64).requires_grad_(True)
    cot = _cotangent(3, torch.float64)
    tb = rte.forward_lb_reference(FREQS, ELEVS, alpha, z, n, t,
                                  alpha_is_mid=True)["tb"]
    (want,) = torch.autograd.grad(tb, alpha, cot)
    out = rte._K2Mid.apply(alpha, z, n, t, FREQS, ELEVS, True, False, False)
    assert torch.equal(out[0].detach(), tb.detach())
    (got,) = torch.autograd.grad(out[0], alpha, cot)
    assert torch.equal(got, want)
    assert torch.equal(
        rte.forward_lb_vjp(FREQS, ELEVS, alpha.detach(), z, n, t, cot), want)


@pytest.mark.parametrize("which", ("tau_total", "t_mr", "trans_level", "t",
                                   "level alpha"))
def test_the_function_refuses_a_gradient_it_does_not_compute(which):
    """A graph that needs any gradient but alpha's through tb raises in the
    backward; it never returns a wrong one."""
    z, n, t, _ = _levels(2, 12, torch.float64)
    mid = which != "level alpha"
    alpha = _alpha_mid(len(FREQS), 12 if mid else 13, 2,
                       torch.float64).requires_grad_(True)
    if which == "t":
        t = t.clone().requires_grad_(True)
    out = dict(zip(("tb", "tau_total", "t_mr", "trans_level"),
                   rte._K2Mid.apply(alpha, z, n, t, FREQS, ELEVS, mid, True,
                                    False)))
    loss = out[which if which in out else "tb"].sum()
    with pytest.raises(NotImplementedError, match="K2v"):
        loss.backward()


def _fitted_case(batch, n_levels, dtype=torch.float32, device="cpu"):
    """alpha_mid from a closed-form fit, z, n, t and a seeded cotangent."""
    z, n, t, prof = _levels(batch, n_levels, dtype, device,
                            seed=batch + n_levels)
    cfg = fast.FastConfig(freqs_ghz=FREQS, elevations_deg=ELEVS)
    w = fast.fit_closed_form(prof, cfg)["w"]
    lev = {k: v.T.contiguous() for k, v in prof.items()}
    alpha = fast.serving_extinction({"w": w}, lev["p"], lev["t"], lev["rho"],
                                    lev["lwc"])
    return alpha, z, n, t, _cotangent(batch, dtype, device)


def _column_gap(got, want):
    """Each (channel, profile) column's largest gap over the layers, over
    the column's largest |dL/dalpha|: the worst column."""
    return float(((got.double() - want).abs().amax(1)
                  / want.abs().amax(1)).max())


@pytest.mark.parametrize("n_levels", (180, 60))
def test_the_kernels_walk_in_float64_is_the_plain_gradient(n_levels):
    args = [x.double() for x in _fitted_case(5, n_levels)]
    want = rte.forward_lb_vjp_reference(FREQS, ELEVS, *args)
    got = _mirrors.rte_vjp_walk(FREQS, ELEVS, *args)
    assert _column_gap(got, want) <= 1e-10


@pytest.mark.parametrize("n_levels", (180, 60))
def test_the_kernels_walk_in_float32_meets_the_card_tests_bound(n_levels):
    args = _fitted_case(5, n_levels)
    want = rte.forward_lb_vjp_reference(FREQS, ELEVS,
                                        *(x.double() for x in args))
    got = _mirrors.rte_vjp_walk(FREQS, ELEVS, *args)
    assert got.dtype == torch.float32
    assert _column_gap(got, want) <= K2V_BOUND / 4


def _parent_train_step(params, optimizer, profiles, targets, config):
    """The training step as it was before K2 had a backward: the loss on
    the plain version, autograd, one optimizer step."""
    optimizer.zero_grad(set_to_none=True)
    plain = dataclasses.replace(config, use_kernels=False, outputs=("tb",))
    pred = fast.fast_forward_batch(params, profiles, plain)["tb"]
    loss = torch.mean((pred - targets) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_train_step_on_the_cpu_is_the_parents_to_the_bit(dtype):
    cfg = fast.FastConfig(freqs_ghz=FREQS, elevations_deg=ELEVS, dtype=dtype)
    prof = lbl.demo_batch(4, 40, device="cpu")
    targets = fast.fast_forward_batch(
        fast.init_params(cfg, seed=3, device="cpu"), prof, cfg)["tb"] + 0.5
    runs = []
    for step in (fast.train_step, _parent_train_step):
        params = fast.init_params(cfg, seed=4, device="cpu")
        optimizer = fast.make_optimizer(params)
        losses = [step(params, optimizer, prof, targets, cfg)
                  for _ in range(3)]
        runs.append((torch.stack(losses), params["w"].detach()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][1].dtype == getattr(torch, dtype)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# K2v against the plain gradient in float64 on the same float32 inputs:
# each (channel, profile) column's largest gap over the layers, over the
# column's largest |dL/dalpha|.  K2v sums in float32 what the plain version
# sums in float64 (the opacity up 179 layers, S_k down from the top, the
# radiance) and takes its chords in FK's form, float32 sqrt of a float64
# product; the float32 plain version, whose S_k = atm - cumsum cancels near
# the column top, is not the yardstick (`forward_lb_vjp`'s docstring).
K2V_BOUND = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (1, 37, 256))
@pytest.mark.parametrize("n_levels", (180, 60))
def test_k2v_against_the_plain_gradient_in_float64(batch, n_levels):
    alpha, z, n, t, cot = _fitted_case(batch, n_levels, device=_card())
    before = rte.forward_lb_vjp.launches
    got = rte.forward_lb_vjp(FREQS, ELEVS, alpha, z, n, t, cot)
    assert rte.forward_lb_vjp.launches == before + 1
    want = rte.forward_lb_vjp_reference(
        FREQS, ELEVS, *(x.double() for x in (alpha, z, n, t, cot)))
    assert got.shape == alpha.shape and got.dtype == torch.float32
    assert _column_gap(got, want) <= K2V_BOUND


@pytest.mark.cuda
def test_the_step_on_the_card_runs_k2_and_k2v_and_no_plain_rte():
    """The first step for a shape warms the pipeline up and captures it
    (`fast._graphed_loss`): K2 and K2v launch through their wrappers,
    under their spans.  Each later step replays the graphs: one K2 and one
    K2v a step on the device, and no plain RTE operation on the host."""
    dev = _card()
    cfg = fast.FastConfig()
    prof = lbl.demo_batch(64, 180, device=dev)
    targets = lbl.forward_batch(prof, lbl.LBLConfig(outputs=("tb",)))["tb"]
    params = fast.fit_closed_form(prof, cfg)
    optimizer = fast.make_optimizer(params)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = (rte.forward_lb.launches, rte.forward_lb_vjp.launches)
    with torch.profiler.profile(activities=acts) as first:
        fast.train_step(params, optimizer, prof, targets, cfg)
        torch.cuda.synchronize()
    # three warm-up passes, forward and backward, and the step's replay of
    # the graphs; the capture, which runs nothing, counts nothing
    assert (rte.forward_lb.launches - counts[0],
            rte.forward_lb_vjp.launches - counts[1]) == (4, 4)
    assert {"cuda.forward_lb", "cuda.forward_lb_vjp", "distill.backward"} \
        <= {e.name for e in first.events()}
    steps = 3
    counts = (rte.forward_lb.launches, rte.forward_lb_vjp.launches)
    grads = []
    with torch.profiler.profile(activities=acts) as p:
        for _ in range(steps):
            fast.train_step(params, optimizer, prof, targets, cfg)
            grads.append((params["w"].grad, params["w"].grad.clone()))
        torch.cuda.synchronize()
    assert (rte.forward_lb.launches - counts[0],
            rte.forward_lb_vjp.launches - counts[1]) == (steps, steps)
    # each step's gradient is the caller's: the next step's backward, which
    # writes the graph's buffer, leaves it as it was
    for g, kept in grads:
        assert torch.equal(g, kept)
    assert len({g.data_ptr() for g, _ in grads}) == steps
    kernels = [e.name for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("rte_vjp_kernel" in k for k in kernels) == steps
    assert sum("downwelling" in k for k in kernels) == steps
    host = {e.name for e in p.events()}
    # the plain RTE's operations (its cumulative opacity, Planck and its
    # inverse) and their backward ops, which nothing else in the step runs
    plain_rte = {"aten::cumsum", "aten::expm1", "aten::log1p",
                 "CumsumBackward0", "Expm1Backward0", "Log1PBackward0"}
    assert not host & plain_rte, host & plain_rte

    # the step's loss and gradient against the plain step in float64, four
    # steps on from the closed-form fit: at the fit the loss is some 5e-6
    # K^2, residuals of a few mK, the size of float32's rounding of the TBs,
    # and Adam's first steps take it to several K^2
    w0 = params["w"].detach().clone()
    p32 = {"w": w0.clone().requires_grad_(True)}
    loss = fast.distill_loss(p32, prof, targets, cfg)
    loss.backward()
    p64 = {"w": w0.double().requires_grad_(True)}
    loss64 = fast.distill_loss(
        p64, {k: v.double() for k, v in prof.items()}, targets.double(),
        dataclasses.replace(cfg, dtype="float64", use_kernels=False))
    loss64.backward()
    assert float(loss64) > 0.1
    assert abs(float(loss) - float(loss64)) <= 1e-4 * float(loss64)
    # of the largest |dL/dw|: one channel's column can cancel to a few % of
    # its own terms (the opaque 56-58 GHz channels, where a layer's emission
    # and the attenuation of the layers above it nearly balance)
    gap = (p32["w"].grad.double() - p64["w"].grad).abs().max()
    assert float(gap / p64["w"].grad.abs().max()) <= 1e-3


@pytest.mark.cuda
def test_the_graphed_step_is_the_eager_step():
    """`train_step` through the graph gives, step after step, the loss and
    the gradient that the same step taken eagerly (`distill_loss`, its
    backward) gives at the weights the step starts from: the same kernels,
    the product's sums perhaps in another order (of the largest |dL/dw|)."""
    dev = _card()
    cfg = fast.FastConfig(freqs_ghz=FREQS, elevations_deg=ELEVS)
    prof = lbl.demo_batch(8, 60, device=dev)
    targets = lbl.forward_batch(prof, lbl.LBLConfig(
        freqs_ghz=FREQS, elevations_deg=ELEVS, outputs=("tb",)))["tb"]
    params = fast.fit_closed_form(prof, cfg)
    optimizer = fast.make_optimizer(params)
    for _ in range(4):
        eager = {"w": params["w"].detach().clone().requires_grad_(True)}
        want = fast.distill_loss(eager, prof, targets, cfg)
        with fast._true_fp32_matmul():
            want.backward()
        loss = fast.train_step(params, optimizer, prof, targets, cfg)
        torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=0.0)
        g, g_want = params["w"].grad, eager["w"].grad
        assert float((g - g_want).abs().max() / g_want.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_an_optimizer_holds_one_graphed_loss_and_drops_it_with_itself():
    """The graphed loss is the optimizer's, for the shapes of its last
    step: a step at other shapes captures anew in its place, and the graph
    goes with the optimizer."""
    import gc

    dev = _card()
    cfg = fast.FastConfig(freqs_ghz=FREQS, elevations_deg=ELEVS)
    prof = lbl.demo_batch(8, 60, device=dev)
    targets = lbl.forward_batch(prof, lbl.LBLConfig(
        freqs_ghz=FREQS, elevations_deg=ELEVS, outputs=("tb",)))["tb"]
    params = fast.fit_closed_form(prof, cfg)
    optimizer = fast.make_optimizer(params)
    held = len(fast._GRAPHED_LOSSES)
    fast.train_step(params, optimizer, prof, targets, cfg)
    first = fast._GRAPHED_LOSSES[optimizer]
    fast.train_step(params, optimizer, prof, targets, cfg)
    assert fast._GRAPHED_LOSSES[optimizer] is first
    fast.train_step(params, optimizer, {k: v[:5] for k, v in prof.items()},
                    targets[:5], cfg)
    assert len(fast._GRAPHED_LOSSES) == held + 1
    assert fast._GRAPHED_LOSSES[optimizer][0] != first[0]
    del optimizer, first
    gc.collect()
    assert len(fast._GRAPHED_LOSSES) == held
