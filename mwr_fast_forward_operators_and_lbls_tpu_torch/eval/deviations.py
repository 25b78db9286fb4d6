"""Deviations dataset builder (the reference's L3 merge product).

Adds `Deviations_<var>_<reference>` variables with `var_label`/`ref_label`
attributes exactly as reference/python_src/plot_scripts/
x_analysis_script_MARCH26.py:169-235: fast models and MWRs against the R24
LBL, and fast models against the MWRs.  Variable naming maps the reference's
external models to this framework's native operators:

    TBs_LBL_R24   <- TBs_PyRTlib_R24   (native line-by-line, models/lbl.py)
    TBs_Fast      <- TBs_RTTOV_gb      (fast operator, models/fast.py)

`compat_aliases` can add the reference's variable names on top so downstream
tooling written against the reference schema keeps working.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import Dataset, Variable

MWR_INSTRUMENTS = ("dwdhat", "foghat", "sunhat", "tophat", "hamhat", "joyhat")

# instruments whose deviations use the Crop=1 (roof-mounted) profile variant
ROOF_INSTRUMENTS = ("joyhat",)

COMPAT_ALIASES = {
    "TBs_LBL_R24": "TBs_PyRTlib_R24",
    "TBs_LBL_R20": "TBs_PyRTlib_R20",
    "TBs_LBL_R17": "TBs_PyRTlib_R17",
    "TBs_LBL_R98": "TBs_PyRTlib_R98",
    "TBs_Fast": "TBs_RTTOV_gb",
    "ttrans_Fast": "ttrans_RTTOV_gb",
    "levtrans_Fast": "levtrans_RTTOV_gb",
}


def _model_tb(ds: Dataset, name: str, crop: int) -> np.ndarray:
    """Model TBs (time, chan, elev) from a (time, chan, elev, Crop) var."""
    return ds[name].data[..., crop]


def _mwr_tb(ds: Dataset, inst: str) -> np.ndarray:
    """MWR TBs (time, chan, elev) from (time, elev, azi, chan): nanmean over
    azimuth then reorder — the reference's .squeeze().transpose on mostly
    single-azimuth data generalized to a scan average."""
    tb = ds[f"TBs_{inst}"].data
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        mean_azi = np.nanmean(tb, axis=2)         # (time, elev, chan)
    return np.transpose(mean_azi, (0, 2, 1))      # (time, chan, elev)


def add_deviations(ds: Dataset, lbl_ref: str = "TBs_LBL_R24",
                   fast_models: tuple = ("TBs_Fast",)) -> Dataset:
    """Attach the reference's 13-variable deviation family."""
    dims = ("time", "N_Channels", "elevation")

    def put(name, data, var_label, ref_label):
        ds[name] = Variable(dims, data,
                            {"var_label": var_label, "ref_label": ref_label,
                             "units": "K"})

    if lbl_ref in ds:
        ref0 = _model_tb(ds, lbl_ref, crop=0)
        ref1 = _model_tb(ds, lbl_ref, crop=1)
        for fm in fast_models:
            if fm in ds:
                short = fm.replace("TBs_", "")
                put(f"Deviations_{short}_R24",
                    _model_tb(ds, fm, 0) - ref0, fm, lbl_ref)
        for inst in MWR_INSTRUMENTS:
            if f"TBs_{inst}" in ds:
                ref = ref1 if inst in ROOF_INSTRUMENTS else ref0
                put(f"Deviations_{inst}_R24",
                    _mwr_tb(ds, inst) - ref, f"TBs_{inst}", lbl_ref)

    for fm in fast_models:
        if fm not in ds:
            continue
        short = fm.replace("TBs_", "")
        for inst in ("dwdhat", "joyhat"):
            if f"TBs_{inst}" in ds:
                crop = 1 if inst in ROOF_INSTRUMENTS else 0
                put(f"Deviations_{short}_{inst}",
                    _model_tb(ds, fm, crop) - _mwr_tb(ds, inst),
                    fm, f"TBs_{inst}")
    return ds


def deviation_variables(ds: Dataset) -> list:
    return [name for name in ds if name.startswith("Deviations_")]


def split_by_reference(ds: Dataset, lbl_ref: str = "TBs_LBL_R24"):
    """Deviations referenced to the LBL vs referenced to MWRs
    (get_deviation_variables_split, x_line_plots_by_elev_MARCH26.py:68-97)."""
    lbl_refd, mwr_refd = [], []
    for name in deviation_variables(ds):
        ref = ds[name].attrs.get("ref_label", "")
        (lbl_refd if ref == lbl_ref else mwr_refd).append(name)
    return lbl_refd, mwr_refd


def compat_aliases(ds: Dataset, mapping: dict = COMPAT_ALIASES) -> Dataset:
    """Duplicate native variable names under the reference's names
    (zero-copy views) so reference-schema consumers keep working."""
    for ours, theirs in mapping.items():
        if ours in ds and theirs not in ds:
            var = ds[ours]
            ds[theirs] = Variable(var.dims, var.data,
                                  {**var.attrs, "alias_of": ours})
    return ds
