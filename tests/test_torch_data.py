"""The port's data layer held to the JAX package's, on the CPU.

The port keeps its own copies of the numpy-only modules (importing any
module of the JAX package imports jax).  Each copy equals its original line
for line apart from its import lines, the form of its citations of the
reference implementation's files and, in `data/les.py`, the one call that
takes theta from the port's torch thermodynamics.  What the copies
write and read equals what the originals write and read.
"""

import dataclasses
import difflib
import pathlib
import re

import numpy as np
import pytest
import torch

import mwr_fast_forward_operators_and_lbls_tpu as jpkg
import mwr_fast_forward_operators_and_lbls_tpu_torch as tpkg
from mwr_fast_forward_operators_and_lbls_tpu.data import (
    cloud as jcloud, les as jles, mwr as jmwr, netcdf as jnetcdf,
    preprocess as jprep, radiosonde as jradio, synthetic as jsyn)
from mwr_fast_forward_operators_and_lbls_tpu.data.dataset import (
    Dataset as JDataset)
from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
    cloud as tcloud, les as tles, mwr as tmwr, netcdf as tnetcdf,
    preprocess as tprep, radiosonde as tradio, synthetic as tsyn)
from mwr_fast_forward_operators_and_lbls_tpu_torch.data.dataset import (
    Dataset as TDataset)
from mwr_fast_forward_operators_and_lbls_tpu_torch.utils import native

torch.set_num_threads(1)

JAX_DIR = pathlib.Path(jpkg.__file__).parent
PORT_DIR = pathlib.Path(tpkg.__file__).parent

COPIES = ("utils/__init__.py", "utils/times.py", "utils/geo.py",
          "utils/native.py", "data/__init__.py", "data/dataset.py",
          "data/netcdf.py", "data/synthetic.py", "data/radiosonde.py",
          "data/mwr.py", "data/cloud.py", "data/preprocess.py",
          "data/les.py", "eval/deviations.py", "eval/sky.py",
          "pipeline/merge.py")

# the one edit that is not an import: theta from the port's torch thermo
LES_EDIT = (
    ["    theta = np.asarray(thermo.potential_temperature(",
     "        np.asarray(t_k, np.float64), np.asarray(p_hpa, np.float64)))"],
    ["    theta = thermo.potential_temperature(",
     "        torch.as_tensor(t_k, dtype=torch.float64),",
     "        torch.as_tensor(p_hpa, dtype=torch.float64)).numpy()"])


def _cited(line: str) -> str:
    """The originals cite the reference implementation's files by absolute
    path; the copies by their path in the reference's own tree."""
    return re.sub(r"/\w+/reference/", "reference/", line)


def _is_import(line: str) -> bool:
    s = line.strip()
    return s.startswith("import ") or (s.startswith("from ")
                                       and " import " in s)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_jax_module_line_for_line(rel):
    ours = (PORT_DIR / rel).read_text().splitlines()
    theirs = [_cited(x) for x in (JAX_DIR / rel).read_text().splitlines()]
    edits = []
    matcher = difflib.SequenceMatcher(a=theirs, b=ours, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        a, b = theirs[i1:i2], ours[j1:j2]
        if all(_is_import(x) for x in a + b):
            continue
        edits.append((a, b))
    allowed = [LES_EDIT] if rel == "data/les.py" else []
    assert [tuple(e) for e in edits] == [tuple(e) for e in allowed], edits


# -- synthetic files ---------------------------------------------------------

def _writers(syn):
    launch = np.datetime64("2024-08-05T10:29:36")
    return {
        "sonde_nc_arms": lambda p, s: syn.write_sonde_nc_arms(p, seed=s),
        "sonde_nc_dwd": lambda p, s: syn.write_sonde_nc_dwd(p, seed=s),
        "sonde_txt_graw": lambda p, s: syn.write_sonde_txt_graw(p, seed=s),
        "mwr_l1": lambda p, s: syn.write_mwr_l1(p, launch, seed=s),
        **{f"mwr_l2_{prod}": (lambda p, s, prod=prod: syn.write_mwr_l2(
            p, launch, prod, seed=s))
           for prod in ("ta", "hua", "prw", "clwvi")},
    }


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("kind", sorted(_writers(jsyn)))
def test_synthetic_writers_write_the_same_bytes(kind, seed, tmp_path):
    a, b = tmp_path / "jax.bin", tmp_path / "port.bin"
    _writers(jsyn)[kind](str(a), seed)
    _writers(tsyn)[kind](str(b), seed)
    assert a.read_bytes() == b.read_bytes()


# -- NetCDF ------------------------------------------------------------------

def _sample(dataset_cls):
    rng = np.random.default_rng(7)
    ds = dataset_cls(attrs={"title": "cross-read", "n": np.int32(3),
                            "scale": 0.5})
    ds["time"] = (("time",), np.arange(5, dtype="f8") * 60.0,
                  {"units": "seconds since 1970-01-01 00:00:00"})
    ds["tb"] = (("time", "chan"), rng.normal(200.0, 30.0, (5, 14))
                .astype("f4"), {"units": "K", "long_name": "TB"})
    ds["flag"] = (("time",), rng.integers(0, 4, 5).astype("i4"), {})
    ds["nan"] = (("time", "chan"), np.full((5, 14), np.nan, "f4"), {})
    ds["i2"] = (("chan",), np.arange(14, dtype="i2"), {})
    return ds


def _assert_same_dataset(a, b):
    assert a.dims == b.dims
    assert set(a.variables) == set(b.variables)
    assert set(a.attrs) == set(b.attrs)
    for k in a.attrs:
        np.testing.assert_array_equal(np.asarray(a.attrs[k]),
                                      np.asarray(b.attrs[k]), err_msg=k)
    for name, va in a.variables.items():
        vb = b[name]
        assert va.dims == vb.dims, name
        assert set(va.attrs) == set(vb.attrs), name
        for k in va.attrs:
            np.testing.assert_array_equal(np.asarray(va.attrs[k]),
                                          np.asarray(vb.attrs[k]),
                                          err_msg=f"{name}.{k}")
        assert va.data.dtype == vb.data.dtype, name
        np.testing.assert_array_equal(va.data, vb.data, err_msg=name)


@pytest.mark.parametrize("version", (2, 5))
@pytest.mark.parametrize("writer", ("jax", "port"))
def test_netcdf_written_by_one_reads_equal_in_the_other(writer, version,
                                                         tmp_path):
    path = str(tmp_path / "x.nc")
    w_mod, w_cls = ((jnetcdf, JDataset) if writer == "jax"
                    else (tnetcdf, TDataset))
    ds = _sample(w_cls)
    w_mod.write(path, ds, version=version)
    back = tnetcdf.read(path)
    _assert_same_dataset(jnetcdf.read(path), back)
    for name, var in ds.variables.items():
        np.testing.assert_array_equal(back[name].data, var.data,
                                      err_msg=name)


# -- the synthetic campaign of tests/test_preprocess.py ----------------------

@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """3 sondes + one instrument's L1/L2 files, written by the port."""
    root = tmp_path_factory.mktemp("campaign")
    sondes, launches = [], []
    for i, stamp in enumerate(("20240805_102936", "20240806_102936",
                               "20240807_102936")):
        path = str(root / f"{stamp}.nc")
        tsyn.write_sonde_nc_arms(path, seed=i)
        sondes.append(path)
        launches.append(np.datetime64(f"2024-08-0{5 + i}T10:29:36"))
    mwr_files = {"joyhat": []}
    for i, launch in enumerate(launches):
        mwr_files["joyhat"].append(tsyn.write_mwr_l1(
            str(root / f"mwr_l1_{i}.nc"), launch, seed=10 + i))
        for j, prod in enumerate(("ta", "hua", "prw", "clwvi")):
            mwr_files["joyhat"].append(tsyn.write_mwr_l2(
                str(root / f"mwr0_l2_{prod}_{i}.nc"), launch, prod,
                seed=20 + 10 * j + i))
    graw = tsyn.write_sonde_txt_graw(str(root / "graw_Profile.txt"), seed=5)
    return sondes, launches, mwr_files, graw


@pytest.fixture(scope="module")
def harmonized(campaign):
    sondes, _, mwr_files, _ = campaign
    return (jprep.preprocess_files(sondes, "Vital", "Juelich", mwr_files),
            tprep.preprocess_files(sondes, "Vital", "Juelich", mwr_files))


def test_preprocess_files_equal(harmonized):
    """Same variables, dims, attrs and data, NaN in the same places
    (assert_array_equal treats NaN as equal only where both are NaN)."""
    _assert_same_dataset(*harmonized)


@pytest.mark.parametrize("crop", (0, 1))
def test_profiles_for_forward_equal(harmonized, crop):
    a = jprep.profiles_for_forward(harmonized[0], crop=crop)
    b = tprep.profiles_for_forward(harmonized[1], crop=crop)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_value(a, b, where=""):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same_value(getattr(a, f.name), getattr(b, f.name),
                               f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same_value(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_value(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_derive_cloud_features_equal(seed):
    s = tsyn.synthetic_sounding(seed, n_samples=600)
    args = (s["z"], s["p"], s["t"], s["rh"])
    _assert_same_value(jcloud.derive_cloud_features(*args),
                       tcloud.derive_cloud_features(*args))


def test_read_radiosonde_txt_equal(campaign):
    """The GRAW path, through `native.parse_table` where the library loads
    and through its Python fallback otherwise."""
    graw = campaign[3]
    a = jradio.read_radiosonde_txt(graw)
    b = tradio.read_radiosonde_txt(graw)
    assert b.valid
    _assert_same_value(a, b)


@pytest.mark.parametrize("day", (0, 1, 2))
def test_read_l1_tbs_equal(campaign, day):
    _, launches, mwr_files, _ = campaign
    l1 = [f for f in mwr_files["joyhat"] if "l1" in f]
    a = jmwr.read_l1_tbs(l1, launches[day])
    b = tmwr.read_l1_tbs(l1, launches[day])
    assert np.isfinite(b[0]).any()
    _assert_same_value(a, b)


@pytest.mark.parametrize("day", (0, 1, 2))
def test_read_l2_profiles_equal(campaign, day):
    _, launches, mwr_files, _ = campaign
    l2 = [f for f in mwr_files["joyhat"] if "_l2_" in f]
    a = jmwr.read_l2_profiles(l2, launches[day])
    b = tmwr.read_l2_profiles(l2, launches[day])
    assert np.isfinite(b[0][1]).all()
    _assert_same_value(a, b)


def test_native_library_state_is_shared():
    """Both copies find the same optional library (native/ncio), or both
    fall back to numpy."""
    from mwr_fast_forward_operators_and_lbls_tpu.utils import native as jn
    assert native.available() == jn.available()


def test_write_les_sounding_agrees(tmp_path):
    """The port's theta comes from torch (float64); the files' numbers agree
    within 1e-6 relative (found: equal to the printed digits)."""
    s = tsyn.synthetic_sounding(4, n_samples=300)
    mr = 5.0 * np.exp(-s["z"] / 2500.0)
    a = jles.write_les_sounding(str(tmp_path / "jax.txt"), s["z"], s["t"],
                                s["p"], mr)
    b = tles.write_les_sounding(str(tmp_path / "port.txt"), s["z"], s["t"],
                                s["p"], mr)
    na = [np.array(ln.split(), float) for ln in open(a)]
    nb = [np.array(ln.split(), float) for ln in open(b)]
    assert len(na) == len(nb) == s["z"].size
    for x, y in zip(na, nb):
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=0)
