"""The torch port stands alone: it imports no jax and nothing of the JAX
package, and its own copy of the spectroscopy tables equals the JAX package's
number for number."""

import ast
import ctypes
import dataclasses
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mwr_fast_forward_operators_and_lbls_tpu_torch as port
from mwr_fast_forward_operators_and_lbls_tpu import constants as jconst
from mwr_fast_forward_operators_and_lbls_tpu.ops.absorption import h2o as jh2o
from mwr_fast_forward_operators_and_lbls_tpu_torch import constants as tconst
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.absorption import (
    h2o as th2o)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import _build

torch.set_num_threads(1)

PORT_DIR = pathlib.Path(port.__file__).parent
REPO = PORT_DIR.parent
JAX_PKG = "mwr_fast_forward_operators_and_lbls_tpu"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# jax, the JAX package, and the repo's root `tools/`, which imports both
FORBIDDEN = ("jax", "jaxlib", JAX_PKG, "tools")


@pytest.mark.parametrize("path", sorted(PORT_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT_DIR)))
def test_port_sources_import_no_jax(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_chip_smoke_imports_no_jax():
    path = REPO / "chip_smoke.py"
    names = list(_imported_modules(path))
    assert port.__name__ in {n.split(".")[0] for n in names}
    for name in names:
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (f"import sys, {port.__name__} as m; "
            f"from {port.__name__}.models import fast, jacobians, lbl, "
            f"retrieval, spectral; "
            f"from {port.__name__}.ops import geometry, rte, thermo; "
            f"from {port.__name__}.ops.cuda import _build, absorption, "
            f"adjoint, chain, rte, spectral; "
            f"from {port.__name__}.parallel import profiling; "
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"('jax', 'jaxlib', '{JAX_PKG}')); "
            f"print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the data layer, the forward stage, the evaluation layer,
# interop, checkpointing, the command line, the anchors, the multi-device
# layer, the tools and the bench, each imported with jax, the JAX package,
# the root `tools/` and matplotlib blocked (the figures import matplotlib
# when they draw, not when their module is imported)
STAGE_MODULES = ("utils", "utils.times", "utils.geo", "utils.native", "data",
                 "data.dataset", "data.netcdf", "data.synthetic",
                 "data.radiosonde", "data.mwr", "data.cloud",
                 "data.preprocess", "data.les", "eval", "eval.deviations",
                 "eval.sky", "pipeline", "pipeline.forward",
                 "pipeline.merge", "models.fast", "eval.stats", "eval.plots",
                 "eval.report", "parallel.checkpoint", "interop",
                 "interop.rttov_gb", "interop.arms_gb", "cli", "cli.main",
                 "cli.__main__", "anchors", "parallel", "parallel.mesh",
                 "parallel.sharding", "parallel.scaling", "parallel.dryrun",
                 "tools", "tools.campaign_demo", "tools.perf_probe",
                 "tools.make_golden", "tools.fit_tables", "bench")

_BLOCKED_IMPORTS = f"""
import importlib, json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', '{JAX_PKG}', 'tools',
                                  'matplotlib'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
result = {{}}
for name in sys.argv[1:]:
    if name == 'cli.__main__':
        continue
    try:
        importlib.import_module('{port.__name__}.' + name)
        result[name] = 'ok'
    except Exception as exc:
        result[name] = repr(exc)
bad = sorted(k for k in sys.modules if k.split('.')[0] in
             ('jax', 'jaxlib', '{JAX_PKG}', 'tools', 'matplotlib'))
sys.argv[1:] = ['--device', 'cpu', 'config']
try:
    importlib.import_module('{port.__name__}.cli.__main__')
except SystemExit as exc:
    result['cli.__main__'] = 'ok' if exc.code == 0 else repr(exc.code)
print(json.dumps({{'modules': result, 'loaded': bad}}))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    """One interpreter, with jax, the JAX package and matplotlib made
    unimportable, imports each module in turn, then runs the command line
    as `python -m` does (`config`)."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS, *STAGE_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", STAGE_MODULES)
def test_stage_module_imports_with_jax_blocked(blocked_imports, name):
    assert blocked_imports["modules"][name] == "ok", blocked_imports
    assert blocked_imports["loaded"] == []


@pytest.mark.parametrize("name", ["BASELINE_SPECTRA_PER_S", "N_STAGE_TIME"])
def test_bench_constants_equal_the_root_bench(name):
    """The port's bench keeps its own copy of the root bench.py's
    constants (bench.py imports jax)."""
    import importlib.util

    from mwr_fast_forward_operators_and_lbls_tpu_torch import bench

    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    assert getattr(bench, name) == getattr(root_bench, name)


TABLE_MODULES = ("physics", "hatpro", "h2o_lines", "o2_lines", "o3_lines",
                 "afgl")


@pytest.mark.parametrize("name", TABLE_MODULES)
def test_table_modules_are_the_ports_own_files(name):
    module = getattr(tconst, name)
    path = pathlib.Path(module.__file__).resolve()
    assert path == (PORT_DIR / "constants" / f"{name}.py").resolve()
    assert module.__name__ == f"{port.__name__}.constants.{name}"


def test_port_imports_from_a_directory_that_holds_nothing_else(tmp_path):
    """A copy of the port's package alone, in an empty directory, imports
    and computes: it opens no file of the JAX package."""
    shutil.copytree(PORT_DIR, tmp_path / port.__name__,
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (f"import sys, pathlib, torch, {port.__name__} as m; "
            f"from {port.__name__}.constants import H2O_MODELS, hatpro; "
            f"from {port.__name__}.models import fast, lbl, retrieval, "
            f"jacobians, spectral; "
            f"from {port.__name__}.parallel import profiling; "
            f"from {port.__name__}.pipeline import forward, merge; "
            f"from {port.__name__}.data import preprocess, synthetic; "
            f"from {port.__name__}.eval import plots, report, stats; "
            f"from {port.__name__}.interop import arms_gb, rttov_gb; "
            f"from {port.__name__}.parallel import checkpoint; "
            f"from {port.__name__}.cli import main; "
            f"from {port.__name__}.tools import campaign_demo, fit_tables, "
            f"make_golden, perf_probe; "
            f"from {port.__name__} import bench; "
            f"here = pathlib.Path.cwd().resolve(); "
            f"assert pathlib.Path(m.__file__).resolve().is_relative_to(here);"
            f" assert pathlib.Path(hatpro.__file__).resolve()"
            f".is_relative_to(here); "
            f"tb = lbl.forward_batch(lbl.demo_batch(1, 24, device='cpu'), "
            f"lbl.LBLConfig(outputs=('tb',)))['tb']; "
            f"assert tb.shape == (1, 10, 14) and bool(torch.isfinite(tb)"
            f".all()); "
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"('jax', 'jaxlib', '{JAX_PKG}')); "
            f"print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=180,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _assert_same_dataclass(a, b):
    assert dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b)
    for field in dataclasses.fields(a):
        va, vb = getattr(a, field.name), getattr(b, field.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=field.name)
        else:
            assert va == vb, field.name


@pytest.mark.parametrize("model", sorted(jconst.H2O_MODELS))
def test_path_loader_tables_equal_the_jax_package(model):
    _assert_same_dataclass(tconst.H2O_MODELS[model],
                           jconst.H2O_MODELS[model])
    _assert_same_dataclass(tconst.O2_MODELS[model], jconst.O2_MODELS[model])
    assert tconst.O2_MODELS[model].has_second_order == \
        jconst.O2_MODELS[model].has_second_order


def test_path_loader_scalars_and_arrays_equal_the_jax_package():
    from mwr_fast_forward_operators_and_lbls_tpu.constants import (afgl,
                                                                   o3_lines,
                                                                   physics)
    np.testing.assert_array_equal(tconst.HATPRO_FREQS_GHZ,
                                  jconst.HATPRO_FREQS_GHZ)
    np.testing.assert_array_equal(tconst.ELEVATIONS_DEG,
                                  jconst.ELEVATIONS_DEG)
    assert tconst.N_LEVELS == jconst.N_LEVELS
    for name in ("O3_FL", "O3_S1", "O3_B2", "O3_W3", "O3_X"):
        np.testing.assert_array_equal(getattr(tconst, name),
                                      getattr(o3_lines, name))
    for clim, table in afgl.CLIMATOLOGIES.items():
        for key, values in table.items():
            np.testing.assert_array_equal(tconst.CLIMATOLOGIES[clim][key],
                                          values)
    for name in ("HK_GHZ", "T_COSMIC", "RV", "EARTH_RADIUS", "C_LIGHT",
                 "H_PLANCK", "K_BOLTZ"):
        assert getattr(tconst, name) == getattr(physics, name), name


def test_gauss_laguerre_rule_matches_the_jax_tables():
    np.testing.assert_allclose(th2o._GL_X, jh2o._GL_X, rtol=1e-12, atol=0)
    np.testing.assert_allclose(th2o._GL_W, jh2o._GL_W, rtol=1e-12, atol=0)


def _c_entry_points():
    """{name: [C parameter types]} of every extern "C" function in csrc/."""
    out = {}
    for src in sorted((PORT_DIR / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            out[name] = [" ".join(p.split()[:-1]) if "*" not in p
                         else "pointer" for p in params.split(",")]
    return out


def test_every_c_entry_point_has_its_ctypes_signature():
    """A missing or short SIGNATURES row makes ctypes pass a device pointer
    as a 32-bit int: every pointer is c_void_p, every int c_int, every
    float c_float, in order."""
    ctype = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float, "double": ctypes.c_double}
    entries = _c_entry_points()
    assert set(entries) == set(_build.SIGNATURES)
    assert {"mwr_absorption_lb", "mwr_absorption_tangents_lb",
            "mwr_forward_lb", "mwr_kmatrix_lb", "mwr_downwelling_lb",
            "mwr_absorption_spectral", "mwr_chain"} <= set(entries)
    for name, params in entries.items():
        assert _build.SIGNATURES[name] == [ctype[p] for p in params], name
