"""The port's tools (`mwr_fast_forward_operators_and_lbls_tpu_torch/tools/`)
held to the JAX package's `tools/` on the CPU: the copied constants, the
synthetic campaign archive and the campaign chain, the perf probe's JSON,
the goldens regenerated against the frozen `tests/golden/`, the table fit's
trajectory and both refit recoveries of tests/test_golden.py."""

import json
import os
import pathlib
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu.data import (
    preprocess as jprep)
from mwr_fast_forward_operators_and_lbls_tpu.models import fast as jfast
from mwr_fast_forward_operators_and_lbls_tpu.ops import absorption as jabs
from mwr_fast_forward_operators_and_lbls_tpu.pipeline import (
    forward_stage as jforward_stage)
from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS, O2_MODELS)
from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
    netcdf, preprocess)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.absorption import (
    h2o_absorption, n2_absorption, o2_absorption)
from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
    forward_stage)
from mwr_fast_forward_operators_and_lbls_tpu_torch.tools import (
    campaign_demo, fit_tables, make_golden, perf_probe)
from tools import campaign_demo as jdemo
from tools import fit_tables as jfit
from tools import make_golden as jgolden

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"


# -- the copies -------------------------------------------------------------

@pytest.mark.parametrize("module, original, name", [
    (campaign_demo, jdemo, "CAMPAIGNS"),
    (make_golden, jgolden, "FREQS_GHZ"),
    (make_golden, jgolden, "CONDITIONS"),
    (fit_tables, jfit, "SCALE_NAMES"),
    (fit_tables, jfit, "PER_LINE_NAMES"),
    (fit_tables, jfit, "_PER_LINE_FLOOR"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_copied_constants_equal_the_jax_tools(module, original, name):
    assert getattr(module, name) == getattr(original, name)


@pytest.mark.parametrize("model", ["R24", "R19", "R98"])
def test_per_line_scales_equal_the_jax_tool(model):
    assert fit_tables._per_line_scales(model) == jfit._per_line_scales(model)


# -- without a card ---------------------------------------------------------

@pytest.mark.parametrize("tool, argv", [
    (perf_probe, ["--batch", "2"]),
    (make_golden, ["--out", "{tmp}/golden"]),
    (fit_tables, ["--golden", str(GOLDEN / "absorption_R24.json")]),
    (campaign_demo, ["--workdir", "{tmp}/work", "--n-sondes", "3"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__")
    else None)
def test_tool_without_device_wants_a_card(tool, argv, tmp_path):
    """Without --device each tool computes on the card; where there is
    none it raises before any work and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([a.format(tmp=tmp_path) for a in argv])
    assert os.listdir(tmp_path) == []


_NO_MATPLOTLIB = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] == 'matplotlib':
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
from mwr_fast_forward_operators_and_lbls_tpu_torch.tools import campaign_demo
sys.exit(campaign_demo.main(sys.argv[1:]))
"""


def test_campaign_demo_without_matplotlib_stops_before_any_work(tmp_path):
    """The full report draws figures: with matplotlib unimportable the demo
    says so and exits with 2 before it writes a file."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_MATPLOTLIB, "--device", "cpu",
         "--workdir", str(tmp_path / "work"), "--n-sondes", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "matplotlib" in proc.stderr
    assert os.listdir(tmp_path) == []


# -- campaign_demo ----------------------------------------------------------

def test_generate_raws_writes_the_jax_archive(tmp_path):
    """The same specs, and every file the same bytes, as the JAX tool's."""
    mine = campaign_demo.generate_raws(str(tmp_path / "port"), 6)
    theirs = jdemo.generate_raws(str(tmp_path / "jax"), 6)
    assert json.loads(json.dumps(mine).replace(str(tmp_path / "port"), "R")) \
        == json.loads(json.dumps(theirs).replace(str(tmp_path / "jax"), "R"))
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*.nc"))
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*.nc"))
    assert len(files) == 4 * 6
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


def test_campaign_demo_raw_generation(tmp_path):
    """tests/test_cli.py::test_campaign_demo_raw_generation on the port's
    archive and preprocessing: 3 campaigns concat on time with
    Campaign/Location stamped per launch, launches over May-July."""
    specs = campaign_demo.generate_raws(str(tmp_path / "raw"), 6)
    assert len(specs) == 3
    ds = preprocess.preprocess_campaigns(specs)
    assert ds.dims["time"] >= 5
    camps = {str(c) for c in np.asarray(ds["Campaign"].data).astype(str)}
    assert {"FESSTVaL", "Socles", "Vital-I"} <= camps
    t = np.asarray(ds["time"].data, "f8")
    import datetime as dt
    months = {dt.datetime.fromtimestamp(x, dt.timezone.utc).month
              for x in t}
    assert months & {5, 6} and months & {6, 7}


DEMO_MODELS = ("R24",)
# (rtol, atol) of tests/test_torch_pipeline.py
TB_TOLERANCES = {"TBs_LBL_R24": (0, 2e-2), "TBs_Fast": (0, 2e-3),
                 "ttrans_Fast": (0, 1e-4), "levtrans_Fast": (0, 1e-5)}


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The demo's stages but the report at 6 sondes, R24 and the fast
    operator: the port's `run_chain` on the CPU, and the JAX tool's chain
    (its `main` without the compile cache and the report) on the same
    archive."""
    work = tmp_path_factory.mktemp("demo")
    timings = {}
    ds, dims, params = campaign_demo.run_chain(
        str(work / "port"), 6, DEMO_MODELS, "cpu", timings)
    specs = jdemo.generate_raws(str(work / "jax" / "raw"), 6)
    jds = jprep.preprocess_campaigns(specs)
    jparams = jfast.distill_on_dataset(jds, jfast.FastConfig())
    jds = jforward_stage(jds, models=DEMO_MODELS, fast_params=jparams)
    return {"work": work / "port", "ds": ds, "dims": dims, "params": params,
            "timings": timings, "jax": jds}


def test_demo_chain_writes_its_files(demo):
    assert set(demo["timings"]) == {"generate_raws_s", "preprocess_s",
                                    "distill_s", "forward_s", "analysis_s"}
    assert {"harmonized.nc", "results.nc", "analysis.nc"} <= set(
        os.listdir(demo["work"]))
    assert demo["dims"]["time"] == demo["jax"].dims["time"] >= 5
    assert campaign_demo.n_spectra(demo["dims"], DEMO_MODELS) == \
        demo["dims"]["time"] * 2 * 10 * 2
    assert "Deviations_Fast_R24" in demo["ds"] and "cloud_flag" in demo["ds"]


@pytest.mark.parametrize("name", sorted(TB_TOLERANCES))
def test_demo_outputs_match_the_jax_chain(demo, name):
    """Each TB variable of results.nc against the JAX chain's, each package
    with its own closed-form weights: within the stage's tolerances."""
    got = netcdf.read(str(demo["work"] / "results.nc"))[name]
    want = demo["jax"][name]
    assert got.dims == want.dims
    assert got.data.shape == want.data.shape
    np.testing.assert_array_equal(np.isnan(got.data), np.isnan(want.data))
    rtol, atol = TB_TOLERANCES[name]
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=atol)


def test_demo_results_equal_forward_stage_called_directly(demo):
    """results.nc holds, to the bit, what `forward_stage` gives on
    harmonized.nc with the chain's weights."""
    harm = netcdf.read(str(demo["work"] / "harmonized.nc"))
    direct = forward_stage(harm, DEMO_MODELS, demo["params"], device="cpu")
    got = netcdf.read(str(demo["work"] / "results.nc"))
    for name in TB_TOLERANCES:
        np.testing.assert_array_equal(got[name].data, direct[name].data)


# -- perf_probe ---------------------------------------------------------------

def _jax_probe_keys():
    """The keys of the JSON object the JAX tool prints (its `out` dict)."""
    import ast

    tree = ast.parse((REPO / "tools" / "perf_probe.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "out"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no `out` dict in tools/perf_probe.py")


def test_perf_probe_split(tmp_path):
    """At B=8 x 24 levels on the CPU: the JAX tool's keys, with the jaxpr
    model's `refined_*`/`counts_*` in their as-coded form, and K2 of the
    timed K1 output equal to `forward_batch`'s tb."""
    out = perf_probe.probe(8, 24, device="cpu")
    want = [("as_coded_" + k.removeprefix("refined_")
             if k.startswith(("refined_", "counts_")) else k)
            for k in _jax_probe_keys()]
    assert list(out)[:len(want)] == want
    assert list(out)[len(want):] == ["k2_of_k1_equals_forward_batch"]
    assert out["k2_of_k1_equals_forward_batch"] is True
    assert out["batch"] == 8 and out["platform"] == out["device"] == "cpu"
    assert out["glue_ms"] == max(out["glue_ms_raw"], 0.0)
    assert set(out["category_bounds_ms"]) == {"fma", "div", "exp", "hbm"}
    for key in ("as_coded_counts_abs_per_pt", "as_coded_counts_rte_per_pt"):
        assert set(out[key]) == {"fma", "div", "exp", "hbm_bytes"}
        assert all(v > 0 for v in out[key].values())


# -- make_golden --------------------------------------------------------------

def test_make_golden_reproduces_the_frozen_files(tmp_path, capsys):
    """The port's goldens on the CPU against tests/golden/: absorption
    within 1e-9 relative, tb_standard within 1e-6 K, literature.json equal
    (on this host every file is the same bytes), and tests/golden/ left as
    it was."""
    before = {p.name: p.read_bytes() for p in GOLDEN.glob("*.json")}
    assert make_golden.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = make_golden.compare(tmp_path, GOLDEN)
    assert printed == report
    assert set(report["absorption_max_rel"]) == set(H2O_MODELS)
    assert max(report["absorption_max_rel"].values()) <= 1e-9
    assert report["tb_standard_max_abs_k"] <= 1e-6
    assert report["literature_equal"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(before)
    for name, data in before.items():
        assert (tmp_path / name).read_bytes() == data, name
    assert {p.name: p.read_bytes() for p in GOLDEN.glob("*.json")} == before


def test_make_golden_refuses_a_model_outside_the_envelope(monkeypatch):
    """A release that fails a checkpoint stops the tool before it writes."""
    rows = [dict(name="dry_60GHz_sea_level", kind="absorption", value=30.0,
                 lo=13.5, hi=16.5, ok=False)]
    monkeypatch.setattr(make_golden.anchors, "run_checkpoints",
                        lambda model, device=None: rows)
    with pytest.raises(SystemExit, match="refusing to freeze"):
        make_golden.check_literature("R24", "cpu")


# -- fit_tables ---------------------------------------------------------------

def _retune_golden():
    """The synthetic +4 % h2o_s1 retune of tests/test_golden.py, from the
    JAX physics in float64."""
    with jax.enable_x64(True):
        f = jnp.asarray(jgolden.FREQS_GHZ, jnp.float64)
        hm, om = jfit.apply_scales("R24", {"h2o_s1": 1.04})
        alpha = {}
        conds = jgolden.CONDITIONS[:4]
        for (p, t, rho) in conds:
            e = rho * t / 217.0
            a = (jabs.h2o_absorption(f, p, t, rho, hm)
                 + jabs.o2_absorption(f, p, t, rho, om)
                 + jabs.n2_absorption(f, p - e, t, variant="R24"))
            alpha[f"{p:g}_{t:g}_{rho:g}"] = [float(v) for v in np.asarray(a)]
    return {"freqs_ghz": jgolden.FREQS_GHZ,
            "conditions": [list(c) for c in conds], "alpha": alpha}


def test_fit_follows_the_jax_trajectory():
    """20 steps of the hand-written Adam from the same golden: every scale
    within 1e-8 relative of the JAX fit's (found 3e-15), the residuals
    too."""
    golden = _retune_golden()
    with jax.enable_x64(True):
        want = jfit.fit(golden, "R24", steps=20)
    got = fit_tables.fit(golden, "R24", steps=20, device="cpu")
    assert list(got) == list(want) and got["model"] == "R24"
    assert list(got["scales"]) == list(want["scales"])
    for name, v in want["scales"].items():
        assert abs(got["scales"][name] / v - 1.0) <= 1e-8, name
    for key in ("rms_log_residual_before", "rms_log_residual_after"):
        assert abs(got[key] / want[key] - 1.0) <= 1e-8, key


def test_scaled_tables_keep_the_autograd_graph():
    """A factor that requires grad reaches alpha through every table it
    scales: d alpha / d s by autograd equals the central difference."""
    f = torch.tensor(make_golden.FREQS_GHZ, dtype=torch.float64)
    p, t, rho = (torch.tensor(v, dtype=torch.float64)
                 for v in (850.0, 280.0, 4.0))
    for name in fit_tables.SCALE_NAMES:
        s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)

        def alpha(scale):
            hm, om = fit_tables.apply_scales("R24", {name: scale})
            e = rho * t / 217.0
            return (h2o_absorption(f, p, t, rho, hm)
                    + o2_absorption(f, p, t, rho, om)
                    + n2_absorption(f, p - e, t, variant="R24")).sum()

        (g,) = torch.autograd.grad(alpha(s), s)
        with torch.no_grad():
            fd = (alpha(1.0 + 1e-6) - alpha(1.0 - 1e-6)) / 2e-6
        assert abs(float(g) - float(fd)) <= 1e-5 * abs(float(fd)) + 1e-12, \
            name


def test_fit_tables_recovers_synthetic_retune():
    """tests/test_golden.py::test_fit_tables_recovers_synthetic_retune on
    the port: a golden from R24 with the H2O intensities scaled by +4 %
    (the port's float64 physics), recovered by the port's fit."""
    f = torch.tensor(make_golden.FREQS_GHZ, dtype=torch.float64)
    hm, om = fit_tables.apply_scales("R24", {"h2o_s1": 1.04})
    alpha = {}
    conds = make_golden.CONDITIONS[:4]
    for (p, t, rho) in conds:
        e = rho * t / 217.0
        a = (h2o_absorption(f, p, t, rho, hm)
             + o2_absorption(f, p, t, rho, om)
             + n2_absorption(f, p - e, t, variant="R24"))
        alpha[f"{p:g}_{t:g}_{rho:g}"] = [float(v) for v in a.numpy()]
    golden = {"freqs_ghz": make_golden.FREQS_GHZ,
              "conditions": [list(c) for c in conds], "alpha": alpha}
    result = fit_tables.fit(golden, "R24", steps=250, device="cpu")
    assert result["rms_log_residual_after"] < 0.3 * \
        result["rms_log_residual_before"]
    assert 1.02 < result["scales"]["h2o_s1"] < 1.06, result["scales"]
    # untouched knobs stay near 1
    assert 0.97 < result["scales"]["o2_s"] < 1.03


def test_per_line_refit_recovers_ecs_perturbation():
    """tests/test_golden.py::test_per_line_refit_recovers_ecs_perturbation
    on the port: perturb the R19 O2 mixing tables per line, smooth in the
    table's N-ordering, synthesize a multi-temperature golden from the
    perturbed physics and recover the perturbation from the unperturbed
    table with `fit_per_line`."""
    base = O2_MODELS["R19"]
    n = base.f.size
    idx = np.arange(n, dtype=np.float64)
    manifold = (np.asarray(base.f) > 50.0) & (np.asarray(base.f) < 120.0)
    dy0 = 0.06 * np.max(np.abs(base.y0)) * np.sin(idx / 5.0) * manifold
    dy1 = 0.08 * np.max(np.abs(base.y1)) * np.cos(idx / 7.0) * manifold
    dg0 = 0.10 * max(np.max(np.abs(base.g0)), 0.01) \
        * np.sin(idx / 6.0 + 1.0) * manifold
    truth = replace(base, y0=base.y0 + dy0, y1=base.y1 + dy1,
                    g0=base.g0 + dg0)

    f = torch.tensor(np.linspace(50.0, 68.0, 120), dtype=torch.float64)
    conds = [(1013.0, 300.0, 5.0), (1013.0, 250.0, 1.0),
             (700.0, 270.0, 2.0), (400.0, 230.0, 0.2),
             (850.0, 285.0, 8.0)]
    hm = H2O_MODELS["R19"]
    alpha = {}
    for (p, t, rho) in conds:
        e = rho * t / 217.0
        a = (h2o_absorption(f, p, t, rho, hm)
             + o2_absorption(f, p, t, rho, truth)
             + n2_absorption(f, p - e, t, variant="R19"))
        alpha[f"{p:g}_{t:g}_{rho:g}"] = [float(v) for v in a.numpy()]
    golden = {"freqs_ghz": [float(v) for v in f.numpy()],
              "conditions": [list(c) for c in conds], "alpha": alpha}

    result = fit_tables.fit_per_line(golden, "R19", steps=900, lr=0.02,
                                     l2=1e-4, smooth=1e-4, device="cpu")

    assert result["rms_log_residual_after"] < 1e-3, result[
        "rms_log_residual_after"]
    assert result["rms_log_residual_after"] < 0.05 * \
        result["rms_log_residual_before"]
    got = np.asarray(result["deltas"]["y0"])
    w = manifold & (np.abs(dy0) > 0.2 * np.max(np.abs(dy0)))
    corr = np.corrcoef(got[w], dy0[w])[0, 1]
    assert corr > 0.9, corr
    rel_l2 = np.linalg.norm(got[w] - dy0[w]) / np.linalg.norm(dy0[w])
    assert rel_l2 < 0.5, rel_l2


def test_fit_tables_main_writes_the_json(tmp_path, capsys):
    """`main` on a golden file with --device cpu prints the fit's JSON and
    writes it to --out."""
    path = tmp_path / "golden.json"
    path.write_text(json.dumps(_retune_golden()))
    out = tmp_path / "fitted.json"
    fit_tables.main(["--golden", str(path), "--steps", "3", "--out",
                     str(out), "--device", "cpu"])
    result = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == result
    assert list(result["scales"]) == list(fit_tables.SCALE_NAMES)
