"""Merge stage: combine per-model result datasets into one analysis file.

Equivalent of reference/python_src/proc/summarize_proc_results.py:73-90
(which copies `TBs_ARMS_gb` + four `TBs_PyRTlib_*` variables into the
RTTOV-gb output dataset).  Our forward stage usually writes all models into
one dataset already; this stage exists for pipelines that ran model families
in separate processes/files, and for attaching the deviations + cloud-flag
family (the reference's x_analysis_script_MARCH26.py step).
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import Dataset, Variable
from ..eval import deviations as dev_mod
from ..eval import sky as sky_mod


def merge_model_results(base: Dataset, *others: Dataset,
                        prefixes: tuple = ("TBs_", "ttrans_", "levtrans_",
                                           "Jacobian_")) -> Dataset:
    """Copy model-output variables from `others` into `base` (aligned on the
    time axis by exact timestamp match)."""
    base_times = base["time"].data
    for other in others:
        times = other["time"].data
        if times.shape == base_times.shape and np.array_equal(times, base_times):
            idx = slice(None)
        else:
            lookup = {t: i for i, t in enumerate(times)}
            idx = np.array([lookup.get(t, -1) for t in base_times])
            if (idx < 0).any():
                missing = int((idx < 0).sum())
                raise ValueError(
                    f"{missing} base timestamps missing from merged dataset")
        for name, var in other.variables.items():
            if any(name.startswith(p) for p in prefixes) and name not in base:
                data = var.data if isinstance(idx, slice) else var.data[idx]
                base[name] = Variable(var.dims, data, dict(var.attrs))
    return base


def analysis_dataset(ds: Dataset, external_cloud_flag=None,
                     compat: bool = False) -> Dataset:
    """L3 product: cloud flag + deviations (+ optional reference-schema
    aliases) — the `..._and_stats.nc` the plot layer consumes."""
    ds = sky_mod.add_cloud_flag(ds, external_cloud_flag)
    ds = dev_mod.add_deviations(ds)
    if compat:
        ds = dev_mod.compat_aliases(ds)
    return ds
