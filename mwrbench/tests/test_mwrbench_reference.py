"""The plain reference agrees with the port's plain path, both in float64,
on small CPU inputs; and the reference's float32 is as close as the port's
float32, so a comparison can tell float32 from a lower precision."""

import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
    jacobians, lbl, spectral)
from mwrbench import inputs
from mwrbench.reference import forward as ref
from mwrbench.reference import hatpro

FREQS = tuple(hatpro.HATPRO_FREQS_GHZ.tolist())
ELEVS = tuple(hatpro.ELEVATIONS_DEG.tolist())


@pytest.fixture(scope="module")
def host():
    return inputs.profiles(20260101, 3, 60)


def _torch(host, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in host.items()}


@pytest.mark.parametrize("model", ["R98", "R17", "R20", "R24"])
def test_lbl_tb_equals_the_ports_plain_path(host, model):
    cfg = lbl.LBLConfig(model=model, dtype="float64", use_kernels=False,
                        outputs=("tb",))
    port = lbl.forward_batch(_torch(host, torch.float64), cfg)["tb"]
    ours = ref.lbl_tb(host, FREQS, ELEVS, model, block=2)
    assert port.shape == ours.shape
    assert float((port - ours).abs().max()) < 1e-9


def test_kmatrix_equals_the_ports_closed_form(host):
    cfg = lbl.LBLConfig(dtype="float64", use_kernels=False)
    port = jacobians.kmatrix_batch_fast(_torch(host, torch.float64), cfg)
    ours = ref.kmatrix(host, FREQS, ELEVS, "R24", block=2)
    for name in ("t", "rho", "lwc"):
        scale = float(ours[name].abs().max())
        assert scale > 0
        assert float((port[name] - ours[name]).abs().max()) < 1e-9 * scale


def test_spectral_srf_equals_the_ports_plain_path(host):
    f = np.linspace(20.0, 64.0, 700).astype(np.float32)
    w = inputs.srf_weights(f)
    tb = spectral.forward_spectral(_torch(host, torch.float64), f, (90.0,),
                                   "R24", freq_chunk=256,
                                   use_kernels=False)["tb"]
    port = spectral.srf_convolve(tb, w)
    ours = ref.spectral_srf(host, f, w, (90.0,), "R24", freq_block=128)
    assert float((port - ours).abs().max()) < 1e-9


def test_lower_precisions_read_as_their_precision(host):
    exact = ref.lbl_tb(host, FREQS, ELEVS, "R24")
    f32 = ref.lbl_tb(host, FREQS, ELEVS, "R24", dtype=torch.float32)
    bf16 = ref.lbl_tb(host, FREQS, ELEVS, "R24", dtype=torch.bfloat16)
    gap32 = float((f32.double() - exact).abs().max())
    gap16 = float((bf16.double() - exact).abs().max())
    assert gap32 < 0.01
    assert gap16 > 100 * gap32
