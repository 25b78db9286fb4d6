"""The port's command line (`cli/`), run with `--device cpu`: the
counterparts of tests/test_cli.py, and the port's results.nc against the
JAX CLI's on the same raw files."""

import argparse
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mwr_fast_forward_operators_and_lbls_tpu_torch as tpkg
from mwr_fast_forward_operators_and_lbls_tpu.cli.main import (
    build_parser as jbuild_parser, main as jmain)
from mwr_fast_forward_operators_and_lbls_tpu_torch.cli.main import (
    build_parser, main)
from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
    netcdf, synthetic)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(tpkg.__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """tests/test_cli.py's raw files: two sondes and their L1 files."""
    root = tmp_path_factory.mktemp("cli")
    for i, stamp in enumerate(("20240805_102936", "20240806_102936")):
        synthetic.write_sonde_nc_arms(str(root / f"{stamp}.nc"), seed=i)
        launch = np.datetime64(f"2024-08-0{5+i}T10:29:36")
        synthetic.write_mwr_l1(str(root / f"l1_{i}.nc"), launch, seed=i)
    return root


def _preprocess(raw, out, *extra):
    return main(CPU + ["preprocess", "--sondes", f"{raw}/2024*_*.nc",
                       "--campaign", "Vital", "--location", "Juelich",
                       "--mwr", f"joyhat={raw}/l1_*.nc", "-o", out, *extra])


@pytest.fixture(scope="module")
def chain(raw, tmp_path_factory):
    """One preprocess -> distill -> forward chain for the evaluate /
    retrieve / spectral tests, as tests/test_cli.py's."""
    root = tmp_path_factory.mktemp("chain")
    harm, params, results = (str(root / n) for n in ("h.nc", "p.npz",
                                                     "r.nc"))
    assert _preprocess(raw, harm) == 0
    assert main(CPU + ["distill", "-i", harm, "-o", params]) == 0
    assert main(CPU + ["forward", "-i", harm, "-o", results,
                       "--models", "R24,R98", "--fast-params", params]) == 0
    return {"harm": harm, "params": params, "results": results}


def test_cli_pipeline(chain, tmp_path):
    harm, params = chain["harm"], chain["params"]
    assert os.path.exists(harm)
    with np.load(params) as z:
        assert z["w"].shape == (72, 14) and np.isfinite(z["w"]).all()
    results = str(tmp_path / "results.nc")
    assert main(CPU + ["forward", "-i", harm, "-o", results,
                       "--models", "R24", "--fast-params", params,
                       "--compat"]) == 0
    ds = netcdf.read(results)
    assert "TBs_LBL_R24" in ds and "TBs_Fast" in ds
    assert "TBs_PyRTlib_R24" in ds     # compat alias
    assert np.isfinite(ds["TBs_LBL_R24"].data).all()

    outdir = str(tmp_path / "plots")
    analysis = str(tmp_path / "analysis.nc")
    assert main(CPU + ["evaluate", "-i", results, "-o", analysis,
                       "--outdir", outdir]) == 0
    pngs = [f for f in os.listdir(outdir) if f.endswith(".png")]
    assert len(pngs) >= 5
    a = netcdf.read(analysis)
    assert "cloud_flag" in a
    assert any(n.startswith("Deviations_") for n in a.variables)


def test_cli_config(capsys):
    assert main(["config"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_levels"] == 180
    assert out["models"] == ["R98", "R17", "R20", "R24"]


def test_cli_runs_as_a_module():
    """`python -m <port>.cli`, as a user runs it; the parser has the JAX
    CLI's subcommands, `bench` included, and refuses any other."""
    mod = f"{tpkg.__name__}.cli"
    proc = subprocess.run([sys.executable, "-m", mod, "--device", "cpu",
                           "config"], cwd=REPO, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["batch_size"] == 256
    sub = next(a for a in build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == set(next(
        a for a in jbuild_parser()._actions
        if isinstance(a, argparse._SubParsersAction)).choices)
    assert "bench" in sub.choices
    with pytest.raises(SystemExit):
        main(["no-such-subcommand"])


def test_cli_missing_sondes(tmp_path):
    assert main(CPU + ["preprocess", "--sondes", f"{tmp_path}/nope*.nc",
                       "-o", str(tmp_path / "x.nc")]) == 1
    assert main(CPU + ["run-all", "--sondes", f"{tmp_path}/nope*.nc",
                       "--workdir", str(tmp_path / "w")]) == 1


def test_cli_nc4(raw, tmp_path):
    """--nc4 writes NetCDF-4/HDF5 (through h5py), read back equal to the
    classic file."""
    pytest.importorskip("h5py")
    a, b = str(tmp_path / "h4.nc"), str(tmp_path / "h3.nc")
    assert _preprocess(raw, a, "--nc4") == 0
    assert _preprocess(raw, b) == 0
    with open(a, "rb") as fh:
        assert fh.read(4) == b"\x89HDF"
    d4, d3 = netcdf.read(a), netcdf.read(b)
    assert set(d4.variables) == set(d3.variables)
    np.testing.assert_array_equal(d4["Level_Temperature"].data,
                                  d3["Level_Temperature"].data)


def test_cli_retrieve_and_spectral(chain, tmp_path):
    harm, params, results = (chain["harm"], chain["params"],
                             chain["results"])
    ret = str(tmp_path / "ret.nc")
    assert main(CPU + ["retrieve", "-i", results, "-o", ret,
                       "--fast-params", params]) == 0
    ds = netcdf.read(ret)
    t = ds["Retrieved_T"].data
    valid = np.isfinite(t).all(axis=1)
    assert valid.any()
    assert (t[valid] > 150).all() and (t[valid] < 330).all()
    assert np.isfinite(ds["Retrieved_rho"].data[valid]).all()
    assert main(CPU + ["retrieve", "-i", results, "-o", ret,
                       "--fast-params", params, "--tb-var", "nope"]) == 1

    spec = str(tmp_path / "spec.nc")
    assert main(CPU + ["spectral", "-i", harm, "-o", spec, "--n-freqs",
                       "256", "--f-min", "22.0", "--f-max", "32.0"]) == 0
    sd = netcdf.read(spec)
    assert sd["TB_spectrum"].data.shape[1] == 256
    assert np.isfinite(sd["TB_spectrum"].data).all()
    f = sd["frequency"].data
    assert f[0] == np.float32(22.0) and f[-1] == np.float32(32.0)
    # the water line at 22.235 GHz stands above the window at 31.4 GHz
    tb = sd["TB_spectrum"].data
    assert (tb[:, np.argmin(np.abs(f - 22.235))]
            > tb[:, np.argmin(np.abs(f - 31.4))]).all()


def test_cli_run_all(raw, tmp_path):
    work = str(tmp_path / "work")
    assert main(CPU + ["run-all", "--sondes", f"{raw}/2024*_*.nc",
                       "--campaign", "Vital", "--location", "Juelich",
                       "--mwr", f"joyhat={raw}/l1_*.nc",
                       "--workdir", work, "--models", "R24",
                       "--distill", "--compat"]) == 0
    for name in ("harmonized.nc", "results.nc", "analysis.nc",
                 "fast_params.npz", "stats.csv", "run_all.log"):
        assert os.path.exists(os.path.join(work, name)), name
    ds = netcdf.read(os.path.join(work, "results.nc"))
    assert "TBs_LBL_R24" in ds and "TBs_Fast" in ds
    assert "TBs_PyRTlib_R24" in ds       # compat alias
    pngs = [f for f in os.listdir(os.path.join(work, "plots"))
            if f.endswith(".png")]
    assert len(pngs) >= 5
    with open(os.path.join(work, "stats.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert rows and all(np.isfinite(float(r["rmse"])) for r in rows
                        if int(r["n"]))

    # stage-level resume: reuses harmonized.nc without the sonde files
    assert main(CPU + ["run-all", "--sondes", f"{raw}/nonexistent*.nc",
                       "--workdir", work, "--models", "R24",
                       "--resume"]) == 0
    with open(os.path.join(work, "run_all.log")) as fh:
        log = fh.read()
    assert "resume: reading existing" in log
    assert log.count("run-all complete in") == 2


def test_cli_evaluate_stratified(chain, tmp_path):
    results = chain["results"]
    outdir = str(tmp_path / "figs")
    csv_path = str(tmp_path / "stats.csv")
    assert main(CPU + ["evaluate", "-i", results, "--outdir", outdir,
                       "--sky", "all", "--start", "2024-08-01",
                       "--end", "2024-09-01", "--per-sonde", "1",
                       "--stats-csv", csv_path]) == 0
    assert os.path.exists(csv_path)
    assert os.path.isdir(os.path.join(outdir, "per_sonde"))


def test_cli_evaluate_full_matrix(chain, tmp_path, monkeypatch):
    """`evaluate --full`: campaign x location x seasonal-window x sky cells,
    each with the standard figure set and a per-elevation stats CSV, and
    a manifest.  Its input is R24's forward with the one instrument the raw
    files hold (the other five instruments' all-NaN TBs are dropped: each
    would add five figures to every cell).  The cells are rendered
    in-process: the spawned workers' path is held to it in
    test_torch_eval.py."""
    monkeypatch.setenv("MWR_REPORT_WORKERS", "1")
    r24 = str(tmp_path / "r24.nc")
    assert main(CPU + ["forward", "-i", chain["harm"], "-o", r24,
                       "--models", "R24"]) == 0
    ds = netcdf.read(r24)
    absent = [n for n, v in ds.variables.items() if n.startswith("TBs_")
              and np.isnan(v.data).all()]
    assert len(absent) == 5
    for name in absent:
        del ds.variables[name]
    netcdf.write(r24, ds)
    outdir = str(tmp_path / "matrix")
    assert main(CPU + ["evaluate", "-i", r24, "--outdir", outdir,
                       "--full"]) == 0
    with open(os.path.join(outdir, "manifest.json")) as fh:
        manifest = json.load(fh)
    cells = manifest["cells"]
    assert "all/full/all" in cells
    assert "Vital_Juelich/full/all" in cells
    for label, cell in cells.items():
        assert cell["n_figures"] >= 1, label
        assert os.path.exists(os.path.join(outdir, cell["stats_csv"]))
        for fig in cell["figures"]:
            assert os.path.exists(os.path.join(outdir, fig))
    with open(os.path.join(outdir,
                           cells["all/full/all"]["stats_csv"])) as fh:
        rows = list(csv.DictReader(fh))
    assert len({r["elevation_deg"] for r in rows}) == 10
    assert manifest["n_figures_total"] >= 4 * len(cells) - 4


@pytest.mark.parametrize("command", (
    "forward", "distill", "retrieve", "spectral", "bench", "simulate-rttov",
    "simulate-arms", "run-all"))
def test_cli_without_device_wants_a_card(chain, tmp_path, command):
    """Without --device on a host without a card every computing
    subcommand raises `resolve_device`'s error before it reads or writes
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    out = str(tmp_path / "out")
    argv = {
        "forward": ["forward", "-i", chain["harm"], "-o", out],
        "distill": ["distill", "-i", chain["harm"], "-o", out],
        "retrieve": ["retrieve", "-i", chain["results"], "-o", out,
                     "--fast-params", chain["params"]],
        "spectral": ["spectral", "-i", chain["harm"], "-o", out],
        "bench": ["bench"],
        "simulate-rttov": ["simulate-rttov", "-i", out, "-o", out],
        "simulate-arms": ["simulate-arms", "-i", out, "-o", out],
        "run-all": ["run-all", "--sondes", chain["harm"], "--workdir", out],
    }[command]
    with pytest.raises(RuntimeError, match="no CUDA device; pass "
                                           "device='cpu'"):
        main(argv)
    assert os.listdir(tmp_path) == []


def test_cli_bench_prints_the_jax_rows(capsys):
    """`bench --device cpu` prints one JSON row per mesh size, with the
    keys of the JAX package's `scaling.measure` rows."""
    assert main(CPU + ["bench", "--batch", "2"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["n_devices"] for r in rows] == [1]
    assert set(rows[0]) == {"n_devices", "seconds", "spectra_per_s",
                            "efficiency", "sharding_overhead_eff",
                            "platform", "note"}
    assert rows[0]["platform"] == "cpu" and rows[0]["spectra_per_s"] > 0


_NO_MATPLOTLIB = f"""
import json, os, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] == 'matplotlib':
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
from {tpkg.__name__}.cli.main import main
out = {{}}
for argv in (sys.argv[1:8], sys.argv[8:]):
    try:
        main(argv)
        out[argv[2]] = 'ran'
    except ImportError as exc:
        out[argv[2]] = repr(exc)
print(json.dumps(out))
"""


def test_cli_figures_without_matplotlib_fail_before_any_work(chain,
                                                             tmp_path):
    """With matplotlib unimportable, `evaluate` and `run-all` raise at
    once, as the JAX CLI's import of its plots module does; they write
    nothing."""
    work, analysis = str(tmp_path / "w"), str(tmp_path / "a.nc")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_MATPLOTLIB,
         "--device", "cpu", "evaluate", "-i", chain["results"], "-o",
         analysis, "--device", "cpu", "run-all", "--sondes", chain["harm"],
         "--workdir", work], cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"evaluate", "run-all"}
    assert all("matplotlib" in v for v in out.values()), out
    assert os.listdir(tmp_path) == []


# -- parity with the JAX CLI --------------------------------------------------

# (rtol, atol) of tests/test_torch_pipeline.py, atol of the Jacobians times
# max |K|; the JAX stage's float32 TBs on the CPU against the port's
TOLERANCES = {"TBs_LBL_": (0, 2e-2), "TBs_Fast": (0, 2e-3),
              "ttrans_Fast": (0, 1e-4), "levtrans_Fast": (0, 1e-5),
              "Jacobian_": (0, 2e-4)}


def _tolerance(name, var):
    source = var.attrs.get("alias_of", name)
    for prefix, tol in TOLERANCES.items():
        if source.startswith(prefix):
            return tol
    return None


@pytest.fixture(scope="module")
def both_clis(raw, tmp_path_factory):
    """The same raw files through both CLIs: preprocess, the JAX CLI's
    distill (the weights both forwards use), then forward with R24 and
    R17, the fast operator, the K-matrix and the compat aliases."""
    root = tmp_path_factory.mktemp("both")
    files = {k: str(root / f"{k}.nc") for k in ("jh", "th", "jr", "tr")}
    params = str(root / "jax_params.npz")
    common = ["--sondes", f"{raw}/2024*_*.nc", "--campaign", "Vital",
              "--location", "Juelich", "--mwr", f"joyhat={raw}/l1_*.nc"]
    forward = ["--models", "R24,R17", "--fast-params", params,
               "--with-jacobians", "--compat"]
    assert jmain(["--cache-dir", "", "preprocess", *common,
                  "-o", files["jh"]]) == 0
    assert main(CPU + ["preprocess", *common, "-o", files["th"]]) == 0
    assert jmain(["--cache-dir", "", "distill", "-i", files["jh"],
                  "-o", params]) == 0
    assert jmain(["--cache-dir", "", "forward", "-i", files["jh"],
                  "-o", files["jr"], *forward]) == 0
    assert main(CPU + ["forward", "-i", files["th"], "-o", files["tr"],
                       *forward]) == 0
    return files


def test_harmonized_files_are_the_same_bytes(both_clis):
    with open(both_clis["jh"], "rb") as a, open(both_clis["th"], "rb") as b:
        assert a.read() == b.read()


def test_results_match_the_jax_cli(both_clis):
    """Every variable both results.nc hold: the model outputs at the
    tolerances of tests/test_torch_pipeline.py (TBs_LBL_* 2e-2 K, TBs_Fast
    2e-3 K, ttrans_Fast 1e-4, levtrans_Fast 1e-5, Jacobian_* 2e-4 of max
    |K|; aliases as their source), everything else (the harmonized inputs
    carried through) equal; dims, attributes and NaN positions equal."""
    got, want = netcdf.read(both_clis["tr"]), netcdf.read(both_clis["jr"])
    assert set(got.variables) == set(want.variables)
    assert got.dims == want.dims
    checked = 0
    for name, w in want.variables.items():
        g = got[name]
        assert g.dims == w.dims, name
        assert g.attrs == w.attrs, name
        assert g.data.dtype == w.data.dtype, name
        tol = _tolerance(name, w)
        if tol is None:
            np.testing.assert_array_equal(g.data, w.data, err_msg=name)
            continue
        np.testing.assert_array_equal(np.isnan(g.data), np.isnan(w.data))
        rtol, atol = tol
        if name.startswith("Jacobian_") or w.attrs.get(
                "alias_of", "").startswith("Jacobian_"):
            atol *= float(np.nanmax(np.abs(w.data)))
        np.testing.assert_allclose(g.data, w.data, rtol=rtol, atol=atol,
                                   err_msg=name)
        checked += 1
    assert checked >= 8
