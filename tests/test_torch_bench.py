"""The port's benchmark (the port package's `bench.py`) held to the root
`bench.py` on the CPU, at small sizes: its JSON line has
bench.py's keys (read from bench.py's text) and numbers, and each
measurement's timed output equals bench.py's workload through the JAX
entry points on their XLA paths (the spectrum's absorption through its
Pallas kernel in interpret mode, which is the JAX entry point's only path)
on the same seeded inputs."""

import ast
import json
import math
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.data.dataset import (
    Dataset as JDataset, Variable as JVariable)
from mwr_fast_forward_operators_and_lbls_tpu.models import fast as jfast
from mwr_fast_forward_operators_and_lbls_tpu.models import jacobians as jjac
from mwr_fast_forward_operators_and_lbls_tpu.models import lbl as jlbl
from mwr_fast_forward_operators_and_lbls_tpu.models import (
    retrieval as jretrieval)
from mwr_fast_forward_operators_and_lbls_tpu.models import (
    spectral as jspectral)
from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
    forward_stage as jforward_stage)
from mwr_fast_forward_operators_and_lbls_tpu_torch import bench
from mwr_fast_forward_operators_and_lbls_tpu_torch.data import preprocess
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
    fast, lbl, spectral)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
    downwelling_lb)
from chip_smoke import bench_py_keys

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

SMALL = dict(N_LEVELS=16, HEADLINE_BATCH=4, SPECTRAL_BATCH=2, N_FREQS=300,
             FREQ_CHUNK=128, KMATRIX_BATCH=3, DISTILL_BATCH=6,
             SERVING_BATCH=8, SERVING_FIT=8, RETRIEVAL_BATCH=4,
             RETRIEVAL_FIT=4, N_STAGE_TIME=4, STAGE_BATCH=3)
# the bench's own sizes, read before any test cuts them down
FULL = {name: getattr(bench, name) for name in SMALL}
# the keys that only the card defines: null on the CPU
CARD_ONLY = {"lbl_roofline_frac", "lbl_refined_model_frac",
             "spectral_roofline_frac", "spectral_refined_model_frac",
             "forward_stage_upload_frac_of_wall", "power_limit_w"}


def test_sizes_are_bench_py_values():
    """The port's size constants hold the numbers bench.py's functions
    assign (read from its text)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    sizes = {}
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        for node in fn.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, (ast.Constant, ast.Tuple)):
                names = node.targets[0]
                names = names.elts if isinstance(names, ast.Tuple) else [names]
                values = (node.value.elts if isinstance(node.value, ast.Tuple)
                          else [node.value])
                for n, v in zip(names, values):
                    if isinstance(v, ast.Constant):
                        sizes[(fn.name, n.id)] = v.value
    assert {
        ("bench_headline", "batch"): FULL["HEADLINE_BATCH"],
        ("bench_spectral", "batch"): FULL["SPECTRAL_BATCH"],
        ("bench_spectral", "nf"): FULL["N_FREQS"],
        ("bench_kmatrix", "batch"): FULL["KMATRIX_BATCH"],
        ("bench_distill_step", "batch"): FULL["DISTILL_BATCH"],
        ("bench_fast_serving", "batch"): FULL["SERVING_BATCH"],
        ("bench_retrieval", "batch"): FULL["RETRIEVAL_BATCH"],
        ("bench_retrieval", "n_lev"): FULL["N_LEVELS"],
    }.items() <= sizes.items()


@pytest.fixture(scope="module")
def small():
    """The bench's sizes cut down and every timing to one call after the
    warm-up."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(bench, name, value)
        mp.setattr(bench, "TIMING", {k: (1, 1) for k in bench.TIMING})
        yield


@pytest.fixture(scope="module")
def runs(small):
    return bench.measure("cpu")[1]


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _numbers(tree):
    """Every number in a JSON object, nested ones included."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _numbers(value)
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            yield key, value


# -- the JSON line --------------------------------------------------------

def test_full_line_has_bench_py_keys_and_positive_numbers(small, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    top, extra, decomp = bench_py_keys()
    assert set(line) == top == {"metric", "value", "unit", "vs_baseline",
                                "extra"}
    assert set(line["extra"]) == extra | {"device", "power_limit_w"}
    for name, keys in decomp.items():
        assert set(line["extra"][name]) == keys
    assert line["metric"] == "tb_spectra_per_s_per_chip"
    assert line["vs_baseline"] == round(
        line["value"] / bench.BASELINE_SPECTRA_PER_S, 2)
    assert line["extra"]["device"] == "cpu"
    for key in CARD_ONLY:
        assert line["extra"][key] is None, key
    numbers = dict(_numbers(line))
    assert set(numbers) >= extra - CARD_ONLY - set(decomp)
    for key, value in numbers.items():
        assert math.isfinite(value), (key, value)
        # one less the ratio of two CPU times 10-20 % apart: on a loaded
        # host either sign (phase 24 holds it > 0 on the card)
        assert value > 0 or key == "rte_glue_frac_of_chunk", (key, value)
    assert line["extra"]["spectral_decomp_ms"]["rte_glue_frac_of_chunk"] < 1


def test_quick_prints_the_headline_alone(small, capsys):
    assert bench.main(["--device", "cpu", "--quick"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == bench_py_keys()[0] - {"extra"}
    assert math.isfinite(line["value"]) and line["value"] > 0


def test_without_a_card_raises_and_prints_no_result(capsys):
    """Without --device the bench computes on the card; where there is none
    `main` raises the port's error before any work, and `python -m` exits
    with an error and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""
    proc = subprocess.run(
        [sys.executable, "-m", bench.__name__, "--quick"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


# -- each measurement against the JAX workload -----------------------------

def test_headline_matches_jax_xla(runs):
    """bench.py's headline through the JAX XLA forward: tb within 2e-2 K
    (test_torch_lbl.py)."""
    run = runs["headline"]
    want = jlbl.forward_batch(_np(run.inputs["profiles"]), jlbl.LBLConfig(
        model="R24", outputs=("tb",)))["tb"]
    assert run.out["tb"].shape == (4, 10, 14)
    np.testing.assert_allclose(run.out["tb"].numpy(), np.asarray(want),
                               rtol=0, atol=2e-2)


def test_spectrum_matches_jax(runs):
    """bench.py's spectrum, the JAX `forward_spectral` (its only path, K6 in
    interpret mode) and `srf_convolve` on the same grid and SRFs: the
    channel TBs within 5e-3 K (test_torch_spectral.py).  The decomposition
    is what the spectrum runs: K3 of the timed K6 output is the timed
    chunk, and the chunk is the spectrum's first frequencies, to the bit."""
    run, inp = runs["spectral"], runs["spectral"].inputs
    f = inp["f_ghz"]
    want = jspectral.srf_convolve(
        jspectral.forward_spectral(_np(inp["profiles"]), f, (90.0,), "R24",
                                   freq_chunk=bench.FREQ_CHUNK)["tb"],
        jnp.asarray(bench.srf_weights(f)))
    assert run.out["tb_srf"].shape == (2, 1, 14)
    np.testing.assert_allclose(run.out["tb_srf"].numpy(), np.asarray(want),
                               rtol=0, atol=5e-3)
    chunk = downwelling_lb(inp["f_chunk"], run.out["alpha"], inp["ds"],
                           inp["levels"]["t"])
    for k in ("tb", "tau_total"):
        torch.testing.assert_close(chunk[k], run.out["chunk"][k], rtol=0,
                                   atol=0)
    whole = spectral.forward_spectral(inp["profiles"], f, (90.0,), "R24",
                                      freq_chunk=bench.FREQ_CHUNK)
    torch.testing.assert_close(
        whole["tb"][..., :bench.FREQ_CHUNK],
        run.out["chunk"]["tb"].permute(2, 0, 1), rtol=0, atol=0)


def test_kmatrix_matches_jax_xla(runs):
    """bench.py's K-matrix through the JAX XLA closed form: within 2e-4
    max(max|K|, 1) per name (test_torch_jacobians.py); its forward within
    2e-2 K; K5a alone on the timed K4 output is the K-matrix's k_t to the
    bit."""
    run = runs["kmatrix"]
    prof = _np(run.inputs["profiles"])
    want = jjac.kmatrix_batch_fast(prof, jlbl.LBLConfig(model="R24"),
                                   wrt=("t", "rho", "lwc"))
    for name in ("t", "rho", "lwc"):
        a, b = np.asarray(want[name]), run.out["k"][name].numpy()
        assert b.shape == a.shape == (3, 10, 14, 16)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=2e-4 * max(np.abs(a).max(), 1.0))
    tb = jlbl.forward_batch(prof, jlbl.LBLConfig(model="R24",
                                                 outputs=("tb",)))["tb"]
    np.testing.assert_allclose(run.out["tb"].numpy(), np.asarray(tb),
                               rtol=0, atol=2e-2)
    torch.testing.assert_close(run.out["k_t_lb"].permute(3, 0, 1, 2),
                               run.out["k"]["t"], rtol=0, atol=0)
    torch.testing.assert_close(run.out["tangents"][0],
                               run.inputs["adjoint_args"][0], rtol=0, atol=0)


def test_distill_step_matches_jax(runs):
    """bench.py's distillation step.  The port steps in place, so the last
    timed call is the last of `steps` steps from the fit: replayed here from
    the same weights it is the same to the bit.  That last step from the
    same weights and Adam state through the JAX `train_step` (optax Adam,
    1e-4): the loss within 1e-4 relative, the weights within 1e-5 (a few
    float32 steps at |w| ~ 35).  The teacher TBs within 2e-2 K of the JAX
    forward."""
    run, inp = runs["distill"], runs["distill"].inputs
    cfg = inp["config"]
    params = {"w": inp["w0"].clone()}
    optimizer = fast.make_optimizer(params)
    for _ in range(run.out["steps"] - 1):
        fast.train_step(params, optimizer, inp["profiles"], inp["targets"],
                        cfg)
    w_prev = params["w"].detach().clone()
    state = {k: v.clone() for k, v in optimizer.state[params["w"]].items()}
    loss = fast.train_step(params, optimizer, inp["profiles"],
                           inp["targets"], cfg)
    torch.testing.assert_close(loss, run.out["loss"], rtol=0, atol=0)
    torch.testing.assert_close(params["w"].detach(), run.out["w"], rtol=0,
                               atol=0)

    jparams = {"w": jnp.asarray(w_prev.numpy())}
    opt = jfast._default_optimizer()
    adam, *rest = opt.init(jparams)
    adam = adam._replace(count=jnp.asarray(int(state["step"]), jnp.int32),
                         mu={"w": jnp.asarray(state["exp_avg"].numpy())},
                         nu={"w": jnp.asarray(state["exp_avg_sq"].numpy())})
    prof = _np(inp["profiles"])
    w_jax, _, loss_jax = jfast.train_step(
        jparams, (adam, *rest), prof, jnp.asarray(inp["targets"].numpy()),
        jfast.FastConfig(), opt)
    assert float(run.out["loss"]) == pytest.approx(float(loss_jax), rel=1e-4)
    np.testing.assert_allclose(run.out["w"].numpy(), np.asarray(w_jax["w"]),
                               rtol=0, atol=1e-5)
    teacher = jlbl.forward_batch(prof, jlbl.LBLConfig(
        model="R24", outputs=("tb",)))["tb"]
    np.testing.assert_allclose(inp["targets"].numpy(), np.asarray(teacher),
                               rtol=0, atol=2e-2)


def test_fast_serving_matches_jax_xla(runs):
    """bench.py's serving on the port's weights through the JAX XLA fast
    forward: tb within 2e-3 K, tau_total within 1e-4 relative
    (test_torch_fast.py)."""
    run, inp = runs["serving"], runs["serving"].inputs
    want = jfast.fast_forward_batch(
        {"w": jnp.asarray(inp["params"]["w"].numpy())},
        _np(inp["profiles"]), jfast.FastConfig(outputs=("tb", "tau_total")))
    assert set(run.out) == {"tb", "tau_total"}
    np.testing.assert_allclose(run.out["tb"].numpy(), np.asarray(want["tb"]),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(run.out["tau_total"].numpy(),
                               np.asarray(want["tau_total"]), rtol=1e-4)


def test_retrieval_matches_jax(runs):
    """bench.py's retrieval (3 steps, priors T + 1.5 K and rho x 0.8) on the
    same observations, weights and cloud through the JAX `retrieve_batch`:
    t within 0.05 K, rho within 1 % (test_torch_retrieval.py)."""
    run, inp = runs["retrieval"], runs["retrieval"].inputs
    want = jretrieval.retrieve_batch(
        {"w": jnp.asarray(inp["params"]["w"].numpy())},
        *(jnp.asarray(inp[k].numpy()) for k in ("tb_obs", "z", "p",
                                                 "t_prior", "rho_prior")),
        jretrieval.OEMConfig(n_iter=3), jnp.asarray(inp["lwc"].numpy()))
    assert bool(torch.isfinite(run.out["t"]).all())
    np.testing.assert_allclose(run.out["t"].numpy(), np.asarray(want["t"]),
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(run.out["rho"].numpy(),
                               np.asarray(want["rho"]), rtol=0.01, atol=1e-4)


def _jax_stage_dataset(n_time, n_lev):
    """bench.py:318-342 as written, on the JAX `demo_batch`."""
    profs = jlbl.demo_batch(n_time, n_levels=n_lev)
    ds = JDataset()
    flip = slice(None, None, -1)

    def lev_var(x):
        a = np.asarray(x).T[flip]
        return np.repeat(a[:, :, None], 2, axis=2).astype("f4")

    p = np.asarray(profs["p"])
    t = np.asarray(profs["t"])
    rho = np.asarray(profs["rho"])
    e = rho * t / 216.679
    mr = 1000.0 * 0.622 * e / np.maximum(p - e, 1e-3)
    air = p * 100.0 / (287.04 * t)
    liq = np.asarray(profs["lwc"]) / 1000.0 / air
    dims = ("N_Levels", "time", "Crop")
    ds["Level_Pressure"] = JVariable(dims, lev_var(p))
    ds["Level_Temperature"] = JVariable(dims, lev_var(t))
    ds["Level_H2O"] = JVariable(dims, lev_var(mr))
    ds["Level_z"] = JVariable(dims, lev_var(profs["z"]))
    ds["Level_Liquid"] = JVariable(dims, lev_var(liq))
    return ds


def test_stage_dataset_is_bench_py_construction(small):
    got = bench.stage_dataset(6)
    want = _jax_stage_dataset(6, 16)
    assert set(got.variables) == set(want.variables)
    for name, var in want.variables.items():
        assert got[name].dims == var.dims
        assert got[name].data.dtype == var.data.dtype == np.float32
        np.testing.assert_array_equal(got[name].data, var.data, err_msg=name)


def test_forward_stage_matches_jax(runs):
    """bench.py's stage, float32 and fp16 payloads, through the JAX
    `forward_stage` on its XLA path on bench.py's dataset: TBs within 2e-2
    K (test_torch_pipeline.py); crop 0's timed chunk loop is the stage's
    crop 0 to the bit."""
    run = runs["stage"]
    jds = _jax_stage_dataset(4, 16)
    for key, compress in (("stage", False), ("stage_f16", True)):
        want = jforward_stage(jds.copy(), models=("R24",), batch_size=3,
                              compress_upload=compress)
        got = run.out[key]["TBs_LBL_R24"]
        assert got.shape == (4, 14, 10, 2)
        np.testing.assert_allclose(got, want["TBs_LBL_R24"].data, rtol=0,
                                   atol=2e-2, err_msg=key)
    device = run.out["device"]["R24"].numpy()
    np.testing.assert_array_equal(device,
                                  run.out["stage"]["TBs_LBL_R24"][..., 0])


def test_stage_chunks_are_forward_batch_calls(runs):
    """Each chunk of the timed stage is `forward_batch` on those profiles,
    to the bit."""
    run = runs["stage"]
    for crop in (0, 1):
        prof = {k: torch.from_numpy(v) for k, v in
                preprocess.profiles_for_forward(run.inputs["dataset"],
                                                crop=crop).items()}
        for s in range(0, 4, 3):
            tb = lbl.forward_batch({k: v[s:s + 3] for k, v in prof.items()},
                                   lbl.LBLConfig(outputs=("tb",)))["tb"]
            np.testing.assert_array_equal(
                run.out["stage"]["TBs_LBL_R24"][s:s + 3, ..., crop],
                tb.permute(0, 2, 1).numpy())
