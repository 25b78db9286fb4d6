"""Sky classification: clear/cloudy flags and dataset splits.

Reproduces the reference's three-source cloud flag
(reference/python_src/plot_scripts/x_analysis_script_MARCH26.py:82-163)
and the clear-sky split of the main analysis
(multi_campaign_plots_and_ana.py:103-151):

  * primary: an external cloud-flag product (time, elevation), e.g. the MLNN
    retrieval the reference reindexes within a 30-min tolerance
  * fallback where the primary is NaN: mean MWR LWP > 0.005 kg m^-2
  * override: radiosonde-derived LWP (Crop=0) > 0.2 kg m^-2 -> cloudy
"""

from __future__ import annotations

import numpy as np

from ..constants import hatpro
from ..data.dataset import Dataset, Variable

LWP_CLEAR_THRESHOLD = 0.005   # kg/m^2 (multi_campaign_plots_and_ana.py:32)
LWP_RS_OVERRIDE = 0.2         # kg/m^2 (x_analysis_script_MARCH26.py:101-112)


def mean_mwr_lwp(ds: Dataset) -> np.ndarray:
    """Mean over instruments of nansum-per-instrument LWP (the reference's
    water_sum, x_analysis_script_MARCH26.py:128-138)."""
    vals = []
    for inst in ("Dwdhat", "Foghat", "Sunhat", "Tophat", "Joyhat", "Hamhat"):
        name = f"{inst}_LWP"
        if name in ds:
            vals.append(np.nansum(np.nan_to_num(
                ds[name].data[:, None]), axis=1))
    if not vals:
        return np.zeros(ds.dims.get("time", 0))
    return np.nanmean(np.stack(vals), axis=0)


def read_external_cloud_flags(pattern: str, ds_times,
                              tolerance_s: float = 1800.0,
                              n_elev: int = hatpro.N_ELEVATIONS):
    """Read external retrieval cloud-flag NetCDFs (the MLNN product) and
    reindex them onto the dataset time axis.

    Reproduces add_MLNN_cloud_info (reference/python_src/plot_scripts/
    x_analysis_script_MARCH26.py:82-97): glob the product files, take their
    `cloud_flag(time, n_angle)`, and nearest-match each dataset timestep
    within a 30-min tolerance; timesteps without coverage stay NaN so the
    LWP fallback in `add_cloud_flag` fills them.

    Args:
      pattern: glob of product NetCDF files.  Each must carry `cloud_flag`
        with a time dimension and an angle dimension (either order) plus a
        `time` variable (CF-encoded or epoch seconds).
      ds_times: (T,) dataset times [epoch s] (or anything
        utils.times.to_epoch_seconds accepts elementwise).

    Returns:
      (T, n_elev) float array with NaN where the product has no coverage,
      ready to pass as `external_flag` to `add_cloud_flag`; None when no
      files match (the reference's behavior degrades the same way).
    """
    import glob as globmod

    from ..data import netcdf
    from ..utils import times as times_mod

    files = sorted(globmod.glob(pattern))
    if not files:
        return None
    t_parts, f_parts = [], []
    for path in files:
        prod = netcdf.read(path)
        if "cloud_flag" not in prod or "time" not in prod:
            continue
        var = prod["cloud_flag"]
        t = times_mod.decode_cf_time(prod["time"].data,
                                     prod["time"].attrs.get("units"))
        arr = np.asarray(var.data, float)
        if arr.ndim == 1:
            arr = np.tile(arr[:, None], (1, n_elev))
        elif var.dims and var.dims[0] != "time":
            arr = arr.T                       # (n_angle, time) -> (time, ..)
        if arr.shape[1] < n_elev:             # zenith-only products
            arr = np.concatenate(
                [arr, np.full((arr.shape[0], n_elev - arr.shape[1]),
                              np.nan)], axis=1)
        t_parts.append(t)
        f_parts.append(arr[:, :n_elev])
    if not t_parts:
        return None
    t_all = np.concatenate(t_parts)
    f_all = np.concatenate(f_parts, axis=0)
    order = np.argsort(t_all, kind="stable")
    t_all, f_all = t_all[order], f_all[order]

    want = np.asarray([times_mod.to_epoch_seconds(t) for t in
                       np.asarray(ds_times).ravel()], np.float64)
    # nearest neighbour within tolerance (xarray reindex method="nearest")
    idx = np.searchsorted(t_all, want)
    idx_lo = np.clip(idx - 1, 0, len(t_all) - 1)
    idx_hi = np.clip(idx, 0, len(t_all) - 1)
    take_hi = np.abs(t_all[idx_hi] - want) < np.abs(t_all[idx_lo] - want)
    nearest = np.where(take_hi, idx_hi, idx_lo)
    out = f_all[nearest].astype(float)
    out[np.abs(t_all[nearest] - want) > tolerance_s] = np.nan
    return out


def add_cloud_flag(ds: Dataset, external_flag: np.ndarray | None = None,
                   thres_lwp: float = LWP_CLEAR_THRESHOLD,
                   rs_override: float = LWP_RS_OVERRIDE) -> Dataset:
    """Attach `cloud_flag (time, elevation)` in {0 clear, 1 cloudy}.

    external_flag: optional (time, elevation) float array with NaN where the
    external product has no coverage (the MLNN role).
    """
    n_time = ds.dims["time"]
    n_elev = ds.dims.get("elevation", hatpro.N_ELEVATIONS)

    lwp_flag = (mean_mwr_lwp(ds) > thres_lwp).astype(float)     # (time,)
    lwp_flag2d = np.tile(lwp_flag[:, None], (1, n_elev))

    if external_flag is None:
        combined = lwp_flag2d
    else:
        combined = np.array(external_flag, float)
        nan = np.isnan(combined)
        combined[nan] = lwp_flag2d[nan]

    if "LWP_radiosonde" in ds:
        rs = ds["LWP_radiosonde"].data[:, 0]                     # Crop=0
        liquid = (np.nan_to_num(rs) > rs_override)[:, None]
        combined = np.where(liquid, 1.0, combined)

    ds["cloud_flag"] = Variable(
        ("time", "elevation"), combined.astype(np.int32),
        {"long_name": "Cloud flag (external primary, LWP + radiosonde-liquid "
                      "fallback)",
         "flag_values": "0, 1", "flag_meanings": "clear cloudy"})
    return ds


def split_clear_cloudy(ds: Dataset, thres_lwp: float = LWP_CLEAR_THRESHOLD):
    """(ds_clear, ds_cloudy) by mean MWR LWP (clear_sky_dataset,
    multi_campaign_plots_and_ana.py:103-151)."""
    lwp = mean_mwr_lwp(ds)
    clear = lwp <= thres_lwp
    return ds.sel_mask("time", clear), ds.sel_mask("time", ~clear)


def sky_mask(ds: Dataset, sky: str, elevation_index: int) -> np.ndarray:
    """(time,) bool mask for "clear" | "cloudy" | "all" at one elevation from
    the per-elevation cloud_flag (apply_sky_mask,
    x_colorplot_by_elevs_and_chans_MARCH26.py:145-171)."""
    if sky == "all" or "cloud_flag" not in ds:
        return np.ones(ds.dims["time"], bool)
    flag = ds["cloud_flag"].data[:, elevation_index]
    return flag == 0 if sky == "clear" else flag == 1
