"""The port's fast-operator K-matrix and OEM retrieval against the JAX
package's, on the CPU: the same numpy inputs through both, each tolerance
stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.models import fast as jfast
from mwr_fast_forward_operators_and_lbls_tpu.models import (
    jacobians as jjacobians)
from mwr_fast_forward_operators_and_lbls_tpu.models import (
    retrieval as jretrieval)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
    fast, jacobians, lbl, retrieval)

torch.set_num_threads(1)

ELEVS = (90.0, 30.0, 14.4, 4.2)
N_LEVELS = 96


def _jax(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    profiles = lbl.demo_batch(16, N_LEVELS, device="cpu")
    cfg = fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
    params = fast.fit_closed_form(profiles, cfg)
    ocfg = retrieval.OEMConfig(elevations_deg=ELEVS, n_iter=4)
    return profiles, params, cfg, ocfg


@pytest.fixture(scope="module")
def setup40():
    """The 40-level grid of the JAX package's retrieval tests: the prior's
    correlation length is 8 levels, so its gates belong to that grid."""
    profiles = lbl.demo_batch(16, 40, device="cpu")
    cfg = fast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
    params = fast.fit_closed_form(profiles, cfg)
    ocfg = retrieval.OEMConfig(elevations_deg=ELEVS, n_iter=4)
    return profiles, params, cfg, ocfg


def _one(profiles, i):
    return [profiles[k][i] for k in ("z", "p", "t", "rho", "lwc")]


def test_prior_covariance_matches_jax():
    got = retrieval._prior_covariance(40, 3.0, 8.0).numpy()
    want = np.asarray(jretrieval._prior_covariance(40, 3.0, 8.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0] == pytest.approx(9.0) and np.allclose(got, got.T)
    assert retrieval.OEMConfig().freqs_ghz == jretrieval.OEMConfig().freqs_ghz
    assert (retrieval.OEMConfig().elevations_deg
            == jretrieval.OEMConfig().elevations_deg)


def test_closed_form_fast_k_matches_autograd(setup):
    """The closed form against `torch.func.jacrev` through the fast forward,
    at the JAX package's gate: 2e-3 of max |K| (tests/test_retrieval.py)."""
    profiles, params, cfg, _ = setup
    z, p, t, rho, lwc = _one(profiles, 1)
    ks = jacobians.kmatrix_fast_adjoint_single(params, z, p, t, rho, lwc, cfg)
    assert set(ks) == {"t", "rho"}
    for e, el in enumerate(ELEVS):
        ref = jacobians.kmatrix_fast_single(params, z, p, t, rho, lwc,
                                            torch.tensor(el), cfg,
                                            wrt=("t", "rho"))
        for name in ("t", "rho"):
            assert ks[name].shape == (len(ELEVS), 14, N_LEVELS)
            scale = float(ref[name].abs().max())
            assert scale > 0
            np.testing.assert_allclose(ks[name][e].numpy(),
                                       ref[name].numpy(), rtol=0,
                                       atol=2e-3 * scale)


def test_closed_form_fast_k_matches_jax(setup):
    """Against the JAX package's `kmatrix_fast_adjoint_single` on the same
    inputs and weights: 2e-3 of max |K|."""
    profiles, params, cfg, _ = setup
    one = _one(profiles, 2)
    got = jacobians.kmatrix_fast_adjoint_single(params, *one, cfg)
    jcfg = jfast.FastConfig(elevations_deg=ELEVS, outputs=("tb",))
    want = jjacobians.kmatrix_fast_adjoint_single(
        {"w": jnp.asarray(params["w"].numpy())},
        *(jnp.asarray(a.numpy()) for a in one), jcfg, wrt=("t", "rho"))
    for name in ("t", "rho"):
        ref = np.asarray(want[name])
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max())


def test_batched_closed_form_equals_the_single_one(setup):
    profiles, params, cfg, _ = setup
    sub = {k: v[:3] for k, v in profiles.items()}
    batch = jacobians.kmatrix_fast_adjoint_batch(params, sub, cfg)
    for i in range(3):
        one = jacobians.kmatrix_fast_adjoint_single(params, *_one(sub, i),
                                                    cfg)
        for name in ("t", "rho"):
            assert batch[name].shape == (3, len(ELEVS), 14, N_LEVELS)
            np.testing.assert_allclose(
                batch[name][i].numpy(), one[name].numpy(), rtol=0,
                atol=1e-5 * float(one[name].abs().max()))
    only_t = jacobians.kmatrix_fast_adjoint_batch(params, sub, cfg,
                                                  wrt=("t",))
    assert set(only_t) == {"t"}
    torch.testing.assert_close(only_t["t"], batch["t"], rtol=0, atol=0)


def test_kmatrix_fast_batch_by_autograd_matches_finite_differences(setup):
    profiles, params, cfg, _ = setup
    sub = {k: v[:2].double() for k, v in profiles.items()}
    cfg64 = fast.FastConfig(elevations_deg=(90.0, 14.4), outputs=("tb",),
                            dtype="float64")
    kb = jacobians.kmatrix_fast_batch(params, sub, cfg64)
    assert set(kb) == {"t", "rho", "lwc"}
    assert kb["t"].shape == (2, 2, 14, N_LEVELS)
    level, eps = 5, 1e-3

    def tb_at(name, delta):
        bumped = dict(sub)
        bumped[name] = sub[name].clone()
        bumped[name][:, level] += delta
        return fast.fast_forward_batch(params, bumped, cfg64)["tb"]

    for name in ("t", "rho", "lwc"):
        fd = (tb_at(name, eps) - tb_at(name, -eps)) / (2 * eps)
        # float64 central differences of a smooth function
        np.testing.assert_allclose(kb[name][..., level].numpy(), fd.numpy(),
                                   rtol=1e-5,
                                   atol=1e-7 * float(kb[name].abs().max()))


def test_retrieve_matches_jax(setup):
    """The same observation, grid, priors and weights through both
    retrievals: t within 0.05 K, rho within 1 %, tb_fit within 0.02 K, dofs
    within 1 %."""
    profiles, params, cfg, ocfg = setup
    i = 0
    z, p, t_true, rho_true, lwc = _one(profiles, i)
    tb_obs = fast.fast_forward_batch(
        params, {k: v[i:i + 1] for k, v in profiles.items()}, cfg)["tb"][0]
    t_prior, rho_prior = t_true + 2.5, rho_true * 0.7
    got = retrieval.retrieve(params, tb_obs, z, p, t_prior, rho_prior, ocfg,
                             lwc)
    jocfg = jretrieval.OEMConfig(elevations_deg=ELEVS, n_iter=4)
    want = jretrieval.retrieve(
        {"w": jnp.asarray(params["w"].numpy())},
        *(jnp.asarray(a.numpy()) for a in (tb_obs, z, p, t_prior, rho_prior)),
        jocfg, jnp.asarray(lwc.numpy()))
    assert got["t"].shape == (N_LEVELS,) and got["cost"].shape == (4,)
    assert got["tb_fit"].shape == (len(ELEVS), 14)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(got["rho"].numpy(), np.asarray(want["rho"]),
                               rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(got["tb_fit"].numpy(),
                               np.asarray(want["tb_fit"]), rtol=0, atol=0.02)
    assert float(got["dofs"]) == pytest.approx(float(want["dofs"]), rel=0.01)
    np.testing.assert_allclose(got["cost"].numpy(), np.asarray(want["cost"]),
                               rtol=0.02, atol=1e-4)


def test_retrieval_recovers_perturbed_truth(setup40):
    """The gates of the JAX package's test of the same name."""
    profiles, params, cfg, ocfg = setup40
    z, p, t_true, rho_true, lwc = _one(profiles, 0)
    tb_obs = fast.fast_forward_batch(
        params, {k: v[:1] for k, v in profiles.items()}, cfg)["tb"][0]
    t_prior, rho_prior = t_true + 2.5, rho_true * 0.7
    out = retrieval.retrieve(params, tb_obs, z, p, t_prior, rho_prior, ocfg,
                             lwc)
    err_prior = float((t_prior - t_true).abs().mean())
    err_post = float((out["t"] - t_true).abs().mean())
    assert err_post < 0.7 * err_prior, (err_prior, err_post)
    assert float((out["tb_fit"] - tb_obs).abs().mean()) < 0.5
    assert float(out["cost"][-1]) < float(out["cost"][0])
    assert 0.0 < float(out["dofs"]) < 2 * z.shape[0]
    assert bool((out["rho"] >= 0).all())


def test_retrieval_truth_recovery_statistics(setup40):
    """The gates of the JAX package's test of the same name, on the same
    seeded ensemble of perturbed priors."""
    profiles, params, cfg, ocfg = setup40
    n = 6
    sub = {k: v[:n] for k, v in profiles.items()}
    tb = fast.fast_forward_batch(params, sub, cfg)["tb"]
    rng = np.random.default_rng(7)
    lev = sub["t"].shape[1]
    bump = np.exp(-0.5 * ((np.arange(lev)[None, :]
                           - rng.uniform(3, 25, (n, 1))) / 6.0) ** 2)
    t_prior = sub["t"] + torch.from_numpy(
        (4.0 * rng.standard_normal((n, 1)) * bump).astype(np.float32))
    rho_prior = sub["rho"] * torch.from_numpy(
        (1.0 + 0.35 * rng.standard_normal((n, 1)) * bump).astype(np.float32))
    out = retrieval.retrieve_batch(params, tb, sub["z"], sub["p"], t_prior,
                                   rho_prior, ocfg, sub["lwc"])

    def rms(a):
        return np.sqrt(np.mean(a.numpy() ** 2, axis=0))

    rms_t_prior, rms_t_post = rms(t_prior - sub["t"]), rms(out["t"] - sub["t"])
    rms_r_prior = rms(rho_prior - sub["rho"])
    rms_r_post = rms(out["rho"] - sub["rho"])
    assert rms_r_post.mean() < 0.3 * rms_r_prior.mean()
    assert rms_t_post[:20].mean() < 0.6 * rms_t_prior[:20].mean()
    assert rms_t_post.mean() < 0.8 * rms_t_prior.mean()
    assert (rms_t_post <= rms_t_prior + 0.1).all()
    assert (rms_r_post <= rms_r_prior + 0.05).all()
    dofs = out["dofs"].numpy()
    assert (dofs > 2.0).all() and (dofs < 2 * lev).all()
    assert out["t"].shape == (n, lev) and out["rho"].shape == (n, lev)
    assert out["tb_fit"].shape == (n, len(ELEVS), 14)
    assert out["cost"].shape == (n, ocfg.n_iter)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    # the batch is the per-profile retrieval, profile by profile
    one = retrieval.retrieve(params, tb[2], sub["z"][2], sub["p"][2],
                             t_prior[2], rho_prior[2], ocfg, sub["lwc"][2])
    np.testing.assert_allclose(one["t"].numpy(), out["t"][2].numpy(), rtol=0,
                               atol=5e-3)


def test_retrieval_without_liquid_takes_zero_liquid(setup):
    profiles, params, cfg, ocfg = setup
    z, p, t, rho, _ = _one(profiles, 3)
    clear = {"z": z[None], "p": p[None], "t": t[None], "rho": rho[None]}
    tb_obs = fast.fast_forward_batch(params, clear, cfg)["tb"][0]
    a = retrieval.retrieve(params, tb_obs, z, p, t + 1.0, rho * 0.9, ocfg)
    b = retrieval.retrieve(params, tb_obs, z, p, t + 1.0, rho * 0.9, ocfg,
                           torch.zeros_like(z))
    torch.testing.assert_close(a["t"], b["t"], rtol=0, atol=0)
    assert float((a["tb_fit"] - tb_obs).abs().mean()) < 0.5


@pytest.mark.parametrize("entry", ["retrieve_batch", "retrieve"])
def test_numpy_inputs_ask_for_the_card(setup, entry):
    """numpy inputs are not a request for the CPU: without a card the
    retrieval raises and names `device="cpu"`, as every other entry point
    does, where it used to run on the CPU unasked."""
    profiles, params, cfg, ocfg = setup
    assert not torch.cuda.is_available()
    if entry == "retrieve":
        arrays = [a.numpy() for a in _one(profiles, 0)]
        tb_obs = np.zeros((len(ELEVS), 14), np.float32)
    else:
        arrays = [profiles[k].numpy() for k in ("z", "p", "t", "rho", "lwc")]
        tb_obs = np.zeros((16, len(ELEVS), 14), np.float32)
    z, p, t, rho, lwc = arrays
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(retrieval, entry)(params, tb_obs, z, p, t, rho, ocfg, lwc)


def test_cpu_tensors_keep_the_retrieval_on_the_cpu(setup):
    """The grid `z_m` names the device: with it a CPU tensor, numpy arrays
    and lists beside it join it there, and the result is that of tensors
    throughout."""
    profiles, params, cfg, ocfg = setup
    z, p, t_true, rho_true, lwc = _one(profiles, 4)
    tb_obs = fast.fast_forward_batch(
        params, {k: v[4:5] for k, v in profiles.items()}, cfg)["tb"][0]
    t_prior, rho_prior = t_true + 1.0, rho_true * 0.9
    want = retrieval.retrieve(params, tb_obs, z, p, t_prior, rho_prior, ocfg,
                              lwc)
    got = retrieval.retrieve(params, tb_obs.numpy(), z, p.numpy(),
                             t_prior.tolist(), rho_prior.numpy(), ocfg,
                             lwc.numpy())
    for k, v in want.items():
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    batch = retrieval.retrieve_batch(
        params, tb_obs[None].numpy(), z[None], p[None].numpy(),
        t_prior[None].numpy(), rho_prior[None].numpy(), ocfg)
    assert batch["t"].device.type == "cpu" and batch["t"].shape == (1, N_LEVELS)
