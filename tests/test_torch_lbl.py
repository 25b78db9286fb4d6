"""The port's LBL forward as a whole, held against the frozen TB golden, the
JAX package's XLA forward and its Pallas forward (interpret mode), on the
same profiles."""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.models import lbl as jlbl
from mwr_fast_forward_operators_and_lbls_tpu_torch import anchors
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
    fast, jacobians, lbl, spectral)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (
    absorption_lb)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
    forward_lb)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.tensors import (
    resolve_device)

torch.set_num_threads(1)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" /
                     "tb_standard.json").read_text())
ELEVS = (90.0, 30.0, 4.2)
ALL_OUTPUTS = ("tb", "tau_total", "t_mr", "trans_level")


@pytest.fixture(scope="module")
def batch():
    return lbl.demo_batch(4, 96, device="cpu")


@pytest.fixture(scope="module")
def cfg():
    return lbl.LBLConfig(elevations_deg=ELEVS)


@pytest.fixture(scope="module")
def out32(batch, cfg):
    return lbl.forward_batch(batch, cfg)


@pytest.fixture(scope="module")
def out64(batch, cfg):
    b64 = {k: v.double() for k, v in batch.items()}
    return lbl.forward_batch(b64, dataclasses.replace(cfg, dtype="float64"))


@pytest.fixture(scope="module")
def jax_out32(batch):
    return jlbl.forward_batch({k: v.numpy() for k, v in batch.items()},
                              jlbl.LBLConfig(elevations_deg=ELEVS))


def _standard(dtype):
    return {k: torch.as_tensor(v, dtype=dtype)
            for k, v in anchors.standard_profiles().items()}


def test_standard_profiles_match_the_golden_generator():
    from tools.make_golden import standard_profiles
    want = standard_profiles()
    got = anchors.standard_profiles()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("model", ["R98", "R17", "R20", "R24"])
def test_frozen_tb_standard_profiles_fp64(model):
    cfg = lbl.LBLConfig(model=model, dtype="float64", outputs=("tb",),
                        elevations_deg=tuple(GOLDEN["elevations_deg"]))
    tb = lbl.forward_batch(_standard(torch.float64), cfg)["tb"]
    assert tb.dtype == torch.float64
    np.testing.assert_allclose(tb.numpy(), np.asarray(GOLDEN["tb"][model]),
                               atol=1e-6, rtol=0)


def test_fp32_tb_within_budget_of_golden():
    cfg = lbl.LBLConfig(model="R24", outputs=("tb",),
                        elevations_deg=tuple(GOLDEN["elevations_deg"]))
    tb = lbl.forward_batch(_standard(torch.float32), cfg)["tb"]
    err = np.abs(tb.numpy() - np.asarray(GOLDEN["tb"]["R24"])).max()
    assert err < 0.05, err


def test_shapes_and_outputs(out32, batch):
    nb, nl = batch["z"].shape
    assert set(out32) == set(ALL_OUTPUTS)
    for k in ("tb", "tau_total", "t_mr"):
        assert out32[k].shape == (nb, len(ELEVS), 14)
        assert out32[k].is_contiguous()
    assert out32["trans_level"].shape == (nb, len(ELEVS), 14, nl)
    assert bool(torch.isfinite(out32["tb"]).all())
    assert 2.7 < float(out32["tb"].min()) and float(out32["tb"].max()) < 330


def test_fp32_matches_jax_xla(out32, jax_out32):
    assert set(out32) == set(jax_out32)
    np.testing.assert_allclose(out32["tb"].numpy(),
                               np.asarray(jax_out32["tb"]), rtol=0, atol=2e-2)
    np.testing.assert_allclose(out32["t_mr"].numpy(),
                               np.asarray(jax_out32["t_mr"]), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(out32["tau_total"].numpy(),
                               np.asarray(jax_out32["tau_total"]), rtol=1e-3)
    np.testing.assert_allclose(out32["trans_level"].numpy(),
                               np.asarray(jax_out32["trans_level"]), rtol=0,
                               atol=5e-3)


def test_fp64_matches_jax_xla(batch, out64):
    with jax.enable_x64(True):
        want = jlbl.forward_batch(
            {k: v.double().numpy() for k, v in batch.items()},
            jlbl.LBLConfig(elevations_deg=ELEVS, dtype="float64"))
        want = {k: np.asarray(v) for k, v in want.items()}
    for k in ("tb", "t_mr"):
        np.testing.assert_allclose(out64[k].numpy(), want[k], rtol=0,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(out64["tau_total"].numpy(), want["tau_total"],
                               rtol=1e-12)
    np.testing.assert_allclose(out64["trans_level"].numpy(),
                               want["trans_level"], rtol=0, atol=1e-12)


def test_fp32_within_budget_of_fp64(out32, out64):
    err = (out32["tb"].double() - out64["tb"]).abs().max()
    assert float(err) < 0.025, err


def test_matches_jax_pallas_path():
    """Against the JAX Pallas path (interpret mode on the CPU), which rounds
    to bf16 on purpose: the JAX package's own 2e-2 K gate."""
    b = lbl.demo_batch(2, 64, device="cpu")
    kw = dict(model="R24", elevations_deg=(90.0, 4.2), outputs=("tb",))
    want = jlbl.forward_batch({k: v.numpy() for k, v in b.items()},
                              jlbl.LBLConfig(use_pallas=True, **kw))["tb"]
    got = lbl.forward_batch(b, lbl.LBLConfig(**kw))["tb"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-2)


def test_include_o3_matches_jax_xla(batch):
    kw = dict(model="R24", elevations_deg=(90.0, 4.2), outputs=("tb",),
              include_o3=True)
    b = {k: v[:2, :64] for k, v in batch.items()}
    want = jlbl.forward_batch({k: v.numpy() for k, v in b.items()},
                              jlbl.LBLConfig(**kw))["tb"]
    got = lbl.forward_batch(b, lbl.LBLConfig(**kw))["tb"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-3)
    no_o3 = lbl.forward_batch(b, lbl.LBLConfig(**{**kw, "include_o3":
                                                  False}))["tb"]
    assert float((got - no_o3).abs().max()) > 1e-5


def test_odd_batch(batch, out32, cfg):
    b3 = {k: v[:3] for k, v in batch.items()}
    got = lbl.forward_batch(b3, cfg)
    assert got["tb"].shape == (3, len(ELEVS), 14)
    for k in ALL_OUTPUTS:
        torch.testing.assert_close(got[k], out32[k][:3], rtol=1e-6, atol=1e-4)


def test_forward_single_matches_batch(batch, out32):
    sub = (22.24, 31.4, 58.0)
    freqs = lbl.LBLConfig().freqs_ghz
    idx = [freqs.index(f) for f in sub]
    p0 = {k: v[0] for k, v in batch.items()}
    single = lbl.forward_single(p0["z"], p0["p"], p0["t"], p0["rho"],
                                p0["lwc"], torch.tensor(sub), 90.0)
    np.testing.assert_allclose(single["tb"].numpy(),
                               out32["tb"][0, 0, idx].numpy(), rtol=0,
                               atol=2e-3)


def test_demo_profile_equals_jax():
    for seed in (0, 7):
        want = jlbl.demo_profile(50, seed)
        got = lbl.demo_profile(50, seed, device="cpu")
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got64 = lbl.demo_batch(2, 50, seed=3, dtype=torch.float64, device="cpu")
    want = jlbl.demo_batch(2, 50, seed=3)
    for k in want:
        assert got64[k].dtype == torch.float64
        np.testing.assert_array_equal(got64[k].numpy(),
                                      np.asarray(want[k], np.float64))


def test_forward_all_models(batch, cfg, out32):
    tbs = lbl.forward_all_models(batch, cfg)
    assert set(tbs) == {"R98", "R17", "R20", "R24"}
    torch.testing.assert_close(tbs["R24"], out32["tb"], rtol=0, atol=0)
    assert float((tbs["R98"] - tbs["R24"]).abs().max()) > 0.01


def test_lbl_operator_module(batch, cfg, out32):
    op = lbl.LBLOperator(cfg, device="cpu")
    assert "tables" in dict(op.named_buffers())
    got = op(batch)
    for k in ALL_OUTPUTS:
        torch.testing.assert_close(got[k], out32[k], rtol=0, atol=0)


def test_cpu_runs_the_plain_path(batch, cfg, out32):
    """On CPU tensors the kernel switch changes nothing and launches
    nothing."""
    before = (absorption_lb.launches, forward_lb.launches)
    plain = lbl.forward_batch(batch, dataclasses.replace(cfg,
                                                         use_kernels=False))
    assert (absorption_lb.launches, forward_lb.launches) == before == (0, 0)
    for k in ALL_OUTPUTS:
        torch.testing.assert_close(plain[k], out32[k], rtol=0, atol=0)


def test_outputs_subset_and_numpy_input(batch, cfg, out32):
    """A subset of the outputs; numpy profiles ask for the card, so without
    one they raise, and as CPU tensors they run the plain path."""
    sub = dataclasses.replace(cfg, outputs=("tb",))
    arrays = {k: v.numpy() for k, v in batch.items()}
    got = lbl.forward_batch({k: torch.as_tensor(v) for k, v in arrays.items()},
                            sub)
    assert set(got) == {"tb"}
    torch.testing.assert_close(got["tb"], out32["tb"], rtol=0, atol=0)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lbl.forward_batch(arrays, sub)


ENTRY_POINTS = {
    "forward_batch": lambda a: lbl.forward_batch(a),
    "forward_spectral": lambda a: spectral.forward_spectral(a, [22.0, 31.0]),
    "kmatrix_batch": lambda a: jacobians.kmatrix_batch(a),
    "kmatrix_batch_fast": lambda a: jacobians.kmatrix_batch_fast(a),
    "demo_batch": lambda a: lbl.demo_batch(2, 8),
    "demo_profile": lambda a: lbl.demo_profile(8),
    "LBLOperator": lambda a: lbl.LBLOperator(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without a card, an entry point that is not asked for the CPU raises
    and names `device="cpu"`; numpy profiles count as not asking."""
    assert not torch.cuda.is_available()
    arrays = {k: v.numpy()
              for k, v in lbl.demo_batch(2, 8, device="cpu").items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](arrays)


def test_device_cpu_asks_for_the_cpu():
    b = lbl.demo_batch(2, 8, device="cpu")
    assert all(v.device.type == "cpu" and v.shape == (2, 8)
               for v in b.values())
    assert lbl.demo_profile(8, device="cpu")["t"].shape == (8,)
    op = lbl.LBLOperator(lbl.LBLConfig(outputs=("tb",)), device="cpu")
    assert op.tables.device.type == "cpu"
    assert op(b)["tb"].shape == (2, 10, 14)
    assert resolve_device("cpu") == torch.device("cpu")
    assert fast.resolve_device is resolve_device


def test_flip_profile_roundtrip(batch):
    back = lbl.flip_profile(lbl.flip_profile(batch))
    for k in batch:
        assert torch.equal(back[k], batch[k])
