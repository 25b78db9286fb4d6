"""The port's fast operator (`models/fast.py`) against the JAX package's, on
the CPU: the same numpy inputs through both, each tolerance stated."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.models import fast as jfast
from mwr_fast_forward_operators_and_lbls_tpu.models import lbl as jlbl
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast, lbl

torch.set_num_threads(1)

ELEVS = (90.0, 14.4, 4.2)
N_LEVELS = 96


def _numpy(profiles):
    return {k: v.numpy() for k, v in profiles.items()}


def _jax(profiles):
    return {k: jnp.asarray(v) for k, v in _numpy(profiles).items()}


@pytest.fixture(scope="module")
def profiles():
    """16 seeded profiles of 96 levels; the port's `demo_batch` makes the
    JAX package's numbers in numpy."""
    return lbl.demo_batch(16, N_LEVELS, device="cpu")


@pytest.fixture(scope="module")
def fitted(profiles):
    """Each package's own closed-form fit on the same profiles."""
    cfg = fast.FastConfig(elevations_deg=ELEVS)
    jcfg = jfast.FastConfig(elevations_deg=ELEVS)
    return (fast.fit_closed_form(profiles, cfg),
            jfast.fit_closed_form(_jax(profiles), jcfg))


def test_demo_batch_is_the_jax_packages(profiles):
    want = jlbl.demo_batch(16, n_levels=N_LEVELS)
    for k, v in profiles.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_layer_features_match_jax(profiles):
    args = [profiles[k] for k in ("p", "t", "rho", "lwc")]
    got = fast.layer_features(*args).numpy()
    want = np.asarray(jfast.layer_features(*(jnp.asarray(a.numpy())
                                             for a in args)))
    assert got.shape == want.shape == (16, N_LEVELS - 1, fast.N_FEATURES)
    # float32 products in another order: 1e-5 relative
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    p_mid = 0.5 * (profiles["p"][:, :-1] + profiles["p"][:, 1:])
    hats = fast._logp_hat_basis(p_mid).numpy()
    assert hats.shape == (16, N_LEVELS - 1, fast.N_P_BINS)
    np.testing.assert_allclose(hats.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        hats, np.asarray(jfast._logp_hat_basis(jnp.asarray(p_mid.numpy()))),
        atol=1e-6)


def test_level_major_features_are_the_same_features(profiles):
    args = [profiles[k] for k in ("p", "t", "rho", "lwc")]
    w = torch.from_numpy(np.random.default_rng(0).normal(
        0.0, 1e-3, (fast.N_FEATURES, 14)).astype(np.float32))
    want = fast.predict_extinction({"w": w}, *args)            # (B, L-1, C)
    got = fast.serving_extinction({"w": w}, *(a.T.contiguous()
                                              for a in args))   # (C, L-1, B)
    assert got.shape == (14, N_LEVELS - 1, 16)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.permute(2, 1, 0).numpy(), want.numpy(),
                               rtol=0, atol=1e-5 * scale)


def test_predict_extinction_matches_jax(profiles):
    w = np.random.default_rng(1).normal(
        0.0, 1e-3, (fast.N_FEATURES, 14)).astype(np.float32)
    args = [profiles[k] for k in ("p", "t", "rho", "lwc")]
    got = fast.predict_extinction({"w": torch.from_numpy(w)}, *args).numpy()
    want = np.asarray(jfast.predict_extinction(
        {"w": jnp.asarray(w)}, *(jnp.asarray(a.numpy()) for a in args)))
    assert (got >= 0).all() and (got == 0).any() and (got > 0).any()
    # a 72-term float32 sum of mixed signs: 1e-5 of the largest extinction
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_extinction_partials_are_the_ones_seeded_tangents(profiles, fitted):
    params = fitted[0]
    p, t, rho, lwc = (profiles[k][:4].double()
                      for k in ("p", "t", "rho", "lwc"))
    p64 = {"w": params["w"].double()}
    alpha, d_t, d_rho = fast.extinction_partials(p64, p, t, rho, lwc)
    ones = torch.ones_like(t)
    a_ref, dt_ref = torch.func.jvp(
        lambda v: fast.predict_extinction(p64, p, v, rho, lwc), (t,), (ones,))
    _, dr_ref = torch.func.jvp(
        lambda v: fast.predict_extinction(p64, p, t, v, lwc), (rho,), (ones,))
    torch.testing.assert_close(alpha, a_ref, rtol=1e-12, atol=0)
    torch.testing.assert_close(d_t, dt_ref, rtol=1e-9,
                               atol=1e-12 * float(dt_ref.abs().max()))
    torch.testing.assert_close(d_rho, dr_ref, rtol=1e-9,
                               atol=1e-12 * float(dr_ref.abs().max()))


@pytest.mark.parametrize("use_lanes", [False, True], ids=["vmap", "lanes"])
def test_fast_forward_batch_matches_jax_on_shared_parameters(
        profiles, fitted, use_lanes):
    """Shared weights (the port's fit) through both packages, each of JAX's
    two paths (the lanes path runs the Pallas RTE kernel in interpret mode):
    tb within 2e-3 K.  Found: 3.7e-4 K (vmap) and 4.7e-4 K (lanes)."""
    params = fitted[0]
    sub = {k: v[:6] for k, v in profiles.items()}
    cfg = fast.FastConfig(elevations_deg=ELEVS)
    got = fast.fast_forward_batch(params, sub, cfg)
    jcfg = jfast.FastConfig(elevations_deg=ELEVS, use_lanes=use_lanes)
    want = jfast.fast_forward_batch({"w": jnp.asarray(params["w"].numpy())},
                                    _jax(sub), jcfg)
    assert set(got) == set(want) == {"tb", "tau_total", "t_mr",
                                     "trans_level"}
    assert got["tb"].shape == (6, len(ELEVS), 14)
    assert got["trans_level"].shape == (6, len(ELEVS), 14, N_LEVELS)
    np.testing.assert_allclose(got["tb"].numpy(), np.asarray(want["tb"]),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["tau_total"].numpy(),
                               np.asarray(want["tau_total"]), rtol=1e-4)
    np.testing.assert_allclose(got["trans_level"].numpy(),
                               np.asarray(want["trans_level"]), rtol=0,
                               atol=1e-5)


def test_outputs_follow_the_config_and_single_matches_batch(profiles, fitted):
    params = fitted[0]
    sub = {k: v[:2] for k, v in profiles.items()}
    cfg = fast.FastConfig(elevations_deg=ELEVS, outputs=("tb", "tau_total"))
    out = fast.fast_forward_batch(params, sub, cfg)
    assert set(out) == {"tb", "tau_total"}
    one = fast.fast_forward_single(
        params, *(sub[k][1] for k in ("z", "p", "t", "rho", "lwc")),
        ELEVS[1], cfg)
    # the same arithmetic, batched or not
    np.testing.assert_allclose(one["tb"].numpy(), out["tb"][1, 1].numpy(),
                               rtol=0, atol=1e-4)
    no_lwc = {k: v for k, v in sub.items() if k != "lwc"}
    dry = fast.fast_forward_batch(params, no_lwc, cfg)["tb"]
    zero = fast.fast_forward_batch(
        params, {**sub, "lwc": torch.zeros_like(sub["rho"])}, cfg)["tb"]
    torch.testing.assert_close(dry, zero, rtol=0, atol=0)
    out64 = fast.fast_forward_batch(
        params, sub, dataclasses.replace(cfg, dtype="float64"))
    assert out64["tb"].dtype == torch.float64
    np.testing.assert_allclose(out64["tb"].numpy(), out["tb"].numpy(),
                               rtol=0, atol=5e-3)


def test_teacher_extinction_matches_jax(profiles):
    sub = {k: v[:3] for k, v in profiles.items()}
    got = fast.teacher_layer_extinction(sub, fast.FastConfig()).numpy()
    want = np.asarray(jfast.teacher_layer_extinction(_jax(sub),
                                                     jfast.FastConfig()))
    assert got.shape == want.shape == (3, N_LEVELS - 1, 14)
    # the LBL absorption in float32, as tests/test_torch_absorption.py
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=1e-6 * np.abs(want).max())


def test_each_packages_own_fit_gives_the_same_tbs(profiles, fitted):
    """The 72 x 72 normal equations are ill-conditioned, so the weights
    themselves need not agree; the TBs they give do, within 5e-3 K, and both
    meet the gates the JAX package holds its fit to."""
    params, jparams = fitted
    cfg = fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
    jcfg = jfast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
    tb = fast.fast_forward_batch(params, profiles, cfg)["tb"].numpy()
    jtb = np.asarray(jfast.fast_forward_batch(jparams, _jax(profiles),
                                              jcfg)["tb"])
    assert params["w"].dtype == torch.float32
    assert params["w"].shape == (fast.N_FEATURES, 14)
    np.testing.assert_allclose(tb, jtb, rtol=0, atol=5e-3)
    teacher = lbl.forward_batch(profiles, lbl.LBLConfig(
        model="R24", elevations_deg=ELEVS, outputs=("tb",)))["tb"].numpy()
    err = tb - teacher
    assert np.sqrt((err ** 2).mean()) < 0.02
    assert np.abs(err).max() < 0.15


def test_fit_generalizes_to_unseen_profiles(fitted):
    unseen = lbl.demo_batch(8, N_LEVELS, seed=777, device="cpu")
    teacher = lbl.forward_batch(unseen, lbl.LBLConfig(
        model="R24", elevations_deg=ELEVS, outputs=("tb",)))["tb"]
    pred = fast.fast_forward_batch(fitted[0], unseen, fast.FastConfig(
        elevations_deg=ELEVS, outputs=("tb",)))["tb"]
    assert float(((pred - teacher) ** 2).mean().sqrt()) < 0.05


def test_train_step_lowers_the_loss(profiles, fitted):
    """From weights 5 % off the fit, Adam(1e-4) steps lower the TB loss.
    (From the closed-form optimum itself the same steps raise it, in the
    JAX package as here: its loss there is ~1e-5 K^2.)"""
    cfg = fast.FastConfig(elevations_deg=ELEVS)
    sub = {k: v[:8] for k, v in profiles.items()}
    targets = lbl.forward_batch(sub, lbl.LBLConfig(
        model="R24", elevations_deg=ELEVS, outputs=("tb",)))["tb"]
    params = {"w": fitted[0]["w"].clone() * 1.05}
    optimizer = fast.make_optimizer(params)
    assert params["w"].requires_grad
    with torch.no_grad():
        start = float(fast.distill_loss(params, sub, targets, cfg))
    losses = [float(fast.train_step(params, optimizer, sub, targets, cfg))
              for _ in range(12)]
    assert losses[0] == pytest.approx(start, rel=1e-6)
    assert np.isfinite(losses).all()
    assert min(losses[1:]) < 0.9 * losses[0]


def test_distill_without_steps_is_the_closed_form_fit(profiles, fitted):
    sub = {k: v[:8] for k, v in profiles.items()}
    cfg = fast.FastConfig(elevations_deg=ELEVS)
    params, history = fast.distill(sub, cfg, steps=0)
    assert history == [] and not params["w"].requires_grad
    torch.testing.assert_close(params["w"],
                               fast.fit_closed_form(sub, cfg)["w"],
                               rtol=0, atol=0)
    tuned, history = fast.distill(sub, cfg, steps=2, log_every=1)
    assert len(history) == 2 and not tuned["w"].requires_grad


def test_npz_written_by_one_package_loads_in_the_other(tmp_path, fitted):
    params, jparams = fitted
    fast.save_params(params, str(tmp_path / "torch.npz"))
    loaded = jfast.load_params(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(loaded["w"]),
                                  params["w"].numpy())
    jfast.save_params(jparams, str(tmp_path / "jax.npz"))
    back = fast.load_params(str(tmp_path / "jax.npz"), device="cpu")
    assert set(back) == {"w"} and back["w"].dtype == torch.float32
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(jparams["w"]))


def test_entry_points_want_the_card_unless_told_otherwise(tmp_path, fitted):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    fast.save_params(fitted[0], str(tmp_path / "w.npz"))
    for call in (lambda: fast.init_params(),
                 lambda: fast.load_params(str(tmp_path / "w.npz")),
                 lambda: fast.FastOperator()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_init_params_and_the_module(profiles):
    cfg = fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
    a = fast.init_params(cfg, seed=3, device="cpu")
    b = fast.init_params(cfg, seed=3, device="cpu")
    c = fast.init_params(cfg, seed=4, device="cpu")
    assert a["w"].shape == (fast.N_FEATURES, 14)
    torch.testing.assert_close(a["w"], b["w"], rtol=0, atol=0)
    assert not torch.equal(a["w"], c["w"])
    assert 5e-4 < float(a["w"].std()) < 2e-3
    gen = torch.Generator().manual_seed(3)
    torch.testing.assert_close(
        fast.init_params(cfg, device="cpu", generator=gen)["w"], a["w"],
        rtol=0, atol=0)
    module = fast.FastOperator(a, cfg, device="cpu")
    assert [n for n, _ in module.named_parameters()] == ["w"]
    sub = {k: v[:2] for k, v in profiles.items()}
    torch.testing.assert_close(
        module(sub)["tb"].detach(),
        fast.fast_forward_batch(a, sub, cfg)["tb"], rtol=0, atol=0)
