"""The port's forward stage (`pipeline/forward.py`) and merge held to the JAX
package's, on the CPU.

One harmonized dataset, built by each package from the same synthetic
files, goes through each package's `forward_stage` with the JAX package's
fitted weights: the JAX stage on its XLA path off-TPU, the port's on
`device="cpu"`, where the kernels' wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.data import (
    preprocess as jprep, synthetic as jsyn)
from mwr_fast_forward_operators_and_lbls_tpu.models import fast as jfast
from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
    forward_stage as jforward_stage)
from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
    netcdf, preprocess)
from mwr_fast_forward_operators_and_lbls_tpu_torch.eval import deviations
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast
from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
    forward_stage, merge)

torch.set_num_threads(1)

MODELS = ("R24", "R17")
OUTPUTS = ("TBs_LBL_R24", "TBs_LBL_R17", "TBs_Fast", "ttrans_Fast",
           "levtrans_Fast", "Jacobian_T_LBL", "Jacobian_rho_LBL",
           "Jacobian_liq_LBL")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The campaign of tests/test_pipeline.py: two sondes, one instrument."""
    root = tmp_path_factory.mktemp("pipe")
    sondes = [jsyn.write_sonde_nc_arms(str(root / f"{stamp}.nc"), seed=i)
              for i, stamp in enumerate(("20240805_102936",
                                         "20240806_102936"))]
    mwr_files = {"joyhat": []}
    for i, day in enumerate(("05", "06")):
        launch = np.datetime64(f"2024-08-{day}T10:29:36")
        mwr_files["joyhat"].append(jsyn.write_mwr_l1(
            str(root / f"l1_{i}.nc"), launch, seed=i))
        mwr_files["joyhat"].append(jsyn.write_mwr_l2(
            str(root / f"mwr0_l2_clwvi_{i}.nc"), launch, "clwvi", seed=i))
    return sondes, mwr_files


@pytest.fixture(scope="module")
def harmonized(files):
    return preprocess.preprocess_files(*files[:1], "Vital", "Juelich",
                                       files[1])


@pytest.fixture(scope="module")
def jax_weights(files):
    """The JAX package's `distill_on_dataset` weights, as numpy."""
    jds = jprep.preprocess_files(files[0], "Vital", "Juelich", files[1])
    return jds, {k: np.asarray(v)
                 for k, v in jfast.distill_on_dataset(jds).items()}


@pytest.fixture(scope="module")
def staged(harmonized, jax_weights):
    """Both stages with the R24 and R17 releases, the fast operator on the
    JAX weights, and the K-matrix."""
    jds, weights = jax_weights
    want = jforward_stage(jds.copy(), models=MODELS, fast_params=weights,
                          with_jacobians=True)
    got = forward_stage(harmonized.copy(), models=MODELS,
                        fast_params=weights, with_jacobians=True,
                        device="cpu")
    return got, want


# (rtol, atol) per variable, atol of the Jacobians times max |K| per name
TOLERANCES = {
    "TBs_LBL_R24": (0, 2e-2), "TBs_LBL_R17": (0, 2e-2),
    "TBs_Fast": (0, 2e-3),
    "ttrans_Fast": (0, 1e-4), "levtrans_Fast": (0, 1e-5),
    "Jacobian_T_LBL": (0, 2e-4), "Jacobian_rho_LBL": (0, 2e-4),
    "Jacobian_liq_LBL": (0, 2e-4),
}


@pytest.mark.parametrize("name", OUTPUTS)
def test_stage_output_matches_jax(staged, name):
    """Each variable against the JAX stage's: TBs_LBL_* within 2e-2 K
    (found 1.5e-4 K), TBs_Fast within 2e-3 K (found 2.0e-4 K), ttrans_Fast
    within 1e-4 (found 5.7e-7), levtrans_Fast within 1e-5 (found 2.0e-6),
    Jacobian_* within 2e-4 max |K| per name (found 1.8e-5, 8.6e-6 and
    1.0e-5 max |K| for T, rho and liq).  Dims, attrs and NaN positions are
    identical."""
    got, want = staged[0][name], staged[1][name]
    assert got.dims == want.dims
    assert got.attrs == want.attrs
    assert got.data.dtype == want.data.dtype == np.float32
    assert got.data.shape == want.data.shape
    np.testing.assert_array_equal(np.isnan(got.data), np.isnan(want.data))
    rtol, atol = TOLERANCES[name]
    if name.startswith("Jacobian_"):
        atol *= float(np.nanmax(np.abs(want.data)))
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=atol)


def test_stage_variables_match_jax(staged):
    got, want = staged
    assert set(got.variables) == set(want.variables)
    assert got.dims == want.dims
    nt = got.dims["time"]
    assert got["TBs_LBL_R24"].data.shape == (nt, 14, 10, 2)
    assert got["levtrans_Fast"].data.shape == (nt, 14, 180, 10, 2)
    assert got["Jacobian_T_LBL"].data.shape == (nt, 14, 10, 180, 2)
    assert np.isfinite(got["TBs_LBL_R24"].data).all()


def test_stage_physics(staged):
    """The physics checks of tests/test_pipeline.py on the port's stage.

    The K-matrix check there reads the top level (the last, levels run
    ground -> top), where K_T of the opaque 58 GHz channel is zero to
    within +-7e-9 of either sign in both packages.  Here the lowest level's
    K_T is positive, which is what that check's comment states, and the top
    level's is zero within 1e-6 max |K|."""
    ds = staged[0]
    tb = ds["TBs_LBL_R24"].data
    assert np.all(tb[:, 0, -1, 0] > tb[:, 0, 0, 0])
    tt = ds["ttrans_Fast"].data
    assert np.all(tt[:, 0, -1, 0] <= tt[:, 0, 0, 0] + 1e-6)
    assert np.nanmax(np.abs(ds["TBs_Fast"].data - tb)) < 0.3
    k_t = ds["Jacobian_T_LBL"].data
    assert np.all(k_t[:, 13, 0, 0, :] > 0)
    assert np.abs(k_t[:, 13, 0, -1, :]).max() <= 1e-6 * np.abs(k_t).max()


def test_batch_size_does_not_change_the_outputs(harmonized, jax_weights,
                                                staged):
    """batch_size=1 against the fixture's 256.  The stage adds no
    arithmetic that depends on the chunking, and every entry point computes
    a profile the same way whatever the batch; but on the CPU, torch's
    vectorized elementwise loops run the last elements of a tensor through
    the scalar functions and its reductions take their order from the
    layout, so float32 results move in the last place.  TBs and
    transmittances are held within 1e-6 relative, about 8 ulp (found
    9.2e-5 K, 3 ulp at 290 K, on the LBL TBs and 0 on the fast operator's).
    The K-matrix takes each level's source term as atm - cumsum, as the JAX
    package does, which cancels near the top and turns those ulps of atm
    into up to 1.8e-5 max |K|: it is held within 1e-4 max |K|."""
    got = forward_stage(harmonized.copy(), models=MODELS,
                        fast_params=jax_weights[1], with_jacobians=True,
                        batch_size=1, device="cpu")
    for name in OUTPUTS:
        want = staged[0][name].data
        if name.startswith("Jacobian_"):
            tol = dict(rtol=0, atol=1e-4 * float(np.abs(want).max()))
        else:
            tol = dict(rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[name].data, want, err_msg=name, **tol)


def test_ragged_last_chunk(harmonized, staged):
    """Three profiles in chunks of two: the last chunk holds one."""
    ds = harmonized.isel(time=[0, 1, 0])
    got = forward_stage(ds, models=("R24",), batch_size=2, device="cpu")
    tb = got["TBs_LBL_R24"].data
    want = staged[0]["TBs_LBL_R24"].data
    np.testing.assert_allclose(tb[:2], want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb[2], tb[0], rtol=1e-6, atol=0)


def test_nan_profile_screening(harmonized):
    ds = harmonized.copy()
    ds["Level_Temperature"].data[:, 0, :] = np.nan   # kill profile 0
    out = forward_stage(ds, models=("R24",), device="cpu")
    tb = out["TBs_LBL_R24"].data
    assert np.isnan(tb[0]).all()
    assert np.isfinite(tb[1]).all()


def test_all_profiles_invalid_gives_nan(harmonized):
    ds = harmonized.copy()
    ds["Level_Temperature"].data[:] = np.nan
    out = forward_stage(ds, models=("R24",), device="cpu")
    assert np.isnan(out["TBs_LBL_R24"].data).all()


def test_compressed_upload_tb_budget(harmonized):
    """The opt-in fp16-anomaly upload (`forward._upload`) stays inside the
    pipeline's 0.05 K TB budget (found 3.1e-4 K)."""
    a = forward_stage(harmonized.copy(), models=("R24",),
                      device="cpu")["TBs_LBL_R24"].data
    b = forward_stage(harmonized.copy(), models=("R24",),
                      compress_upload=True,
                      device="cpu")["TBs_LBL_R24"].data
    assert np.isfinite(b).all()
    worst = float(np.abs(a - b).max())
    assert worst < 0.05, f"fp16-anomaly payload costs {worst:.4f} K"


def test_plain_path_matches_the_kernels_wrappers(harmonized, staged,
                                                 jax_weights):
    """use_kernels=False runs the plain versions; on the CPU the wrappers take
    them too, so the two agree to the last bit."""
    got = forward_stage(harmonized.copy(), models=MODELS,
                        fast_params=jax_weights[1], with_jacobians=True,
                        use_kernels=False, device="cpu")
    for name in OUTPUTS:
        np.testing.assert_array_equal(got[name].data, staged[0][name].data,
                                      err_msg=name)


def test_stage_wants_the_card_unless_told_otherwise(harmonized, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_stage(harmonized.copy(), models=("R24",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast.distill_on_dataset(harmonized)


def test_ports_own_distillation_gives_the_jax_weights_tbs(harmonized,
                                                          jax_weights,
                                                          staged):
    """The port's `distill_on_dataset` on its own dataset: TBs within
    test_torch_fast.py's 5e-3 K of those of the JAX weights (found
    5.8e-4 K)."""
    params = fast.distill_on_dataset(harmonized, device="cpu")
    assert params["w"].dtype == torch.float32
    assert params["w"].device.type == "cpu"
    got = forward_stage(harmonized.copy(), models=("R24",),
                        fast_params=params, device="cpu")
    np.testing.assert_allclose(got["TBs_Fast"].data,
                               staged[0]["TBs_Fast"].data, rtol=0, atol=5e-3)


def test_distill_on_dataset_screens_nan_rows(harmonized):
    ds = harmonized.copy()
    ds["Level_Temperature"].data[:, 0, :] = np.nan
    params = fast.distill_on_dataset(ds, device="cpu")
    assert torch.isfinite(params["w"]).all()


def test_distill_on_dataset_fine_tunes_with_steps(harmonized):
    """steps > 0 adds the TB-space fine-tune to the closed-form fit."""
    fit = fast.distill_on_dataset(harmonized, device="cpu")
    tuned = fast.distill_on_dataset(harmonized, steps=2, device="cpu")
    assert tuned["w"].shape == fit["w"].shape
    assert not tuned["w"].requires_grad
    assert torch.isfinite(tuned["w"]).all()
    assert not torch.equal(tuned["w"], fit["w"])


def test_params_from_numpy_carries_either_packages_weights(jax_weights,
                                                          tmp_path):
    weights = jax_weights[1]
    got = fast.params_from_numpy(weights, device="cpu")
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), weights["w"])
    live = {"w": torch.tensor(weights["w"], requires_grad=True)}
    carried = fast.params_from_numpy(live, device="cpu")
    assert not carried["w"].requires_grad
    torch.testing.assert_close(carried["w"], live["w"].detach(), rtol=0,
                               atol=0)
    path = str(tmp_path / "w.npz")
    jfast.save_params(weights, path)
    loaded = fast.load_params(path, device="cpu")
    np.testing.assert_array_equal(loaded["w"].numpy(), weights["w"])


def test_merge_model_results(staged, harmonized):
    with_models = staged[0]
    merged = merge.merge_model_results(harmonized.copy(), with_models)
    for name in OUTPUTS:
        assert name in merged
    np.testing.assert_array_equal(merged["TBs_LBL_R24"].data,
                                  with_models["TBs_LBL_R24"].data)


def test_analysis_dataset(staged, tmp_path):
    """The parts of tests/test_pipeline.py::test_analysis_dataset_and_stats
    that need no eval/stats."""
    ds = merge.analysis_dataset(staged[0].copy(), compat=True)
    assert "cloud_flag" in ds
    names = deviations.deviation_variables(ds)
    assert "Deviations_Fast_R24" in names
    assert "Deviations_joyhat_R24" in names
    assert "TBs_PyRTlib_R24" in ds
    assert "TBs_RTTOV_gb" in ds
    np.testing.assert_array_equal(ds["TBs_PyRTlib_R24"].data,
                                  ds["TBs_LBL_R24"].data)
    path = str(tmp_path / "analysis.nc")
    netcdf.write(path, ds)
    r = netcdf.read(path)
    assert "Deviations_Fast_R24" in r
    assert r["Deviations_Fast_R24"].attrs["ref_label"] == "TBs_LBL_R24"


def test_analysis_dataset_matches_jax(staged):
    """The port's merge on the port's stage against the JAX merge on the
    JAX stage: the same variables; deviations within the TB tolerance."""
    from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
        merge as jmerge)
    got = merge.analysis_dataset(staged[0].copy(), compat=True)
    want = jmerge.analysis_dataset(staged[1].copy(), compat=True)
    assert set(got.variables) == set(want.variables)
    np.testing.assert_array_equal(got["cloud_flag"].data,
                                  want["cloud_flag"].data)
    for name in deviations.deviation_variables(want):
        np.testing.assert_allclose(got[name].data, want[name].data, rtol=0,
                                   atol=2e-2, err_msg=name)
