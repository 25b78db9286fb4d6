"""MWR (RPG-HATPRO) observation ingest: L1 brightness temperatures and L2
retrieved profiles, matched to radiosonde launch times.

Behavioral re-implementation of reference/python_src/preproc/
MWR_read_in_module.py on our own NetCDF codec, vectorized:

  * scan matching within |dt| <= 15 min and |d(elev)|,|d(azi)| <= 0.05 deg
    (MWR_read_in_module.py:41-43), averaging *all* matching scans
  * three L1 dialects: BL-scan files (time x ele x channel), `MWR_1C01`
    files (elevation_angle/azimuth_angle/quality_flag), generic `mwr` files
    (ele/azi/flag) (:167-234)
  * L2 products ta / hua / prw(IWV) / clwvi(LWP) (+ "single" combined files),
    re-gridded to the 180-level output grid by inserting interpolated points
    while preserving the original retrieval levels (:238-269)
  * negative LWP/IWV clamped to zero (:273-282)
  * per-instrument station-height offsets (+112/+74/+110 m, :381-417)
"""

from __future__ import annotations

import numpy as np

from ..constants import hatpro
from . import netcdf
from .dataset import Dataset

MIN_TIME_DIFF_MIN = hatpro.MAX_TIME_DIFF_MIN
MAX_ELEV_AZI_DIFF = hatpro.MAX_ELEV_AZI_DIFF_DEG


def decode_time(var) -> np.ndarray:
    """CF-style time decode to np.datetime64[s] (supports seconds/minutes/
    hours/days since <epoch>)."""
    units = str(var.attrs.get("units", "seconds since 1970-01-01 00:00:00"))
    parts = units.split("since")
    unit = parts[0].strip().lower()
    epoch = np.datetime64(parts[1].strip().split()[0] + "T" +
                          (parts[1].strip().split()[1]
                           if len(parts[1].strip().split()) > 1 else "00:00:00"))
    scale = {"seconds": 1, "second": 1, "minutes": 60, "minute": 60,
             "hours": 3600, "hour": 3600, "days": 86400, "day": 86400}[unit]
    vals = np.asarray(var.data, dtype="f8") * scale
    return epoch.astype("datetime64[s]") + vals.astype("timedelta64[s]")


def match_scans(elev, azi, times, target_elev, target_azi, launch,
                time_tol_min: float = MIN_TIME_DIFF_MIN,
                angle_tol: float = MAX_ELEV_AZI_DIFF) -> np.ndarray:
    """Indices of scans matching elevation/azimuth/time tolerances
    (`nearest_ele4elevation_mean`, MWR_read_in_module.py:110-139).
    target_azi may be None (= "ANY")."""
    mask = np.abs(np.asarray(elev) - target_elev) < angle_tol
    if target_azi is not None:
        mask &= np.abs(np.asarray(azi) - target_azi) < angle_tol
    dt_s = np.abs((np.asarray(times) - launch) / np.timedelta64(1, "s"))
    mask &= dt_s <= time_tol_min * 60.0
    return np.nonzero(mask)[0]


def _within_time(times, launch, tol_min=MIN_TIME_DIFF_MIN):
    dt_s = np.abs((np.asarray(times) - launch) / np.timedelta64(1, "s"))
    return np.nonzero(dt_s <= tol_min * 60.0)[0]


# path -> (mtime, tmin, tmax): each MWR file's time coverage, read once per
# campaign instead of once per (file, launch) pair.  The reference avoids
# the same O(files x launches) blow-up by narrowing with per-datetime
# filename globs (MWR_read_in_module.py:45-50); coverage caching is the
# dialect-agnostic equivalent (no filename convention required).
_TIME_RANGE_CACHE: dict = {}


def _files_covering(files: list, launch: np.datetime64,
                    tol_min=MIN_TIME_DIFF_MIN) -> list:
    """Subset of `files` whose time axis comes within `tol_min` of launch."""
    import os

    out = []
    for path in files:
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        cached = _TIME_RANGE_CACHE.get(path)
        if cached is None or cached[0] != mtime:
            ds = netcdf.read_many([path])[0]
            if ds is None or "time" not in ds:
                _TIME_RANGE_CACHE[path] = (mtime, None, None)
            else:
                t = decode_time(ds["time"])
                _TIME_RANGE_CACHE[path] = (mtime, t.min(), t.max())
        _, tmin, tmax = _TIME_RANGE_CACHE[path]
        if tmin is None:
            out.append(path)  # undecodable: let the reader decide
            continue
        pad = np.timedelta64(int(tol_min * 60), "s")
        if tmin - pad <= launch <= tmax + pad:
            out.append(path)
    return out


def read_l1_tbs(files: list, launch: np.datetime64,
                elevations=hatpro.ELEVATIONS_DEG,
                azimuths=hatpro.AZIMUTHS_DEG):
    """(n_elev, n_azi, 14) TB array averaged over matching scans, plus
    lat/lon and a mean quality flag (get_tbs_from_l1, :167-234)."""
    tbs = np.full((len(elevations), len(azimuths), hatpro.N_CHANNELS), np.nan)
    lat = lon = np.nan
    qual = 0.0
    files = _files_covering(files, launch)
    for path, ds in zip(files, netcdf.read_many(files)):
        if ds is None:
            continue
        times = decode_time(ds["time"])
        if "BL" in path and "ele" in ds and ds["tb"].data.ndim == 3:
            # BL-scan file: tb(time, ele, chan), azimuth fixed (column 0)
            idx = _within_time(times, launch)
            if idx.size == 0:
                continue
            for ei, el in enumerate(ds["ele"].data):
                tgt = np.nonzero(np.abs(elevations - el) < 0.05)[0]
                if tgt.size:
                    tbs[tgt[0], 0, :] = np.nanmean(
                        ds["tb"].data[idx, ei, :], axis=0)
            if "flag" in ds:
                qual = float(np.nanmean(ds["flag"].data[idx]))
            continue

        if "elevation_angle" in ds:     # 1C01 dialect
            elev, azi = ds["elevation_angle"].data, ds["azimuth_angle"].data
            flag_name = "quality_flag"
        else:                            # generic mwr dialect
            elev, azi = ds["ele"].data, ds["azi"].data
            flag_name = "flag"
        tb = ds["tb"].data
        for i, el in enumerate(elevations):
            for j, az in enumerate(azimuths):
                idx = match_scans(elev, azi, times, el, az, launch)
                if idx.size:
                    tbs[i, j, :] = np.nanmean(tb[idx, :], axis=0)
                    if flag_name in ds:
                        qual = float(np.nanmean(ds[flag_name].data[idx]))
        for la, lo in (("latitude", "longitude"), ("lat", "lon")):
            if la in ds:
                lat = float(np.ravel(ds[la].data)[0])
                lon = float(np.ravel(ds[lo].data)[0])
                break
    return tbs, lat, lon, qual


# -- L2 regridding ----------------------------------------------------------

def insert_points_preserving(x_old: np.ndarray, n_new: int) -> np.ndarray:
    """Refine a grid to `n_new` points by inserting equally spaced points in
    each interval while keeping every original point
    (interpolate_preserve_old_points_fix, MWR_read_in_module.py:238-258)."""
    x_old = np.asarray(x_old, float)
    n_old = x_old.size
    if n_new <= n_old:
        return x_old[:n_new]
    extra = n_new - n_old
    n_int = n_old - 1
    per, rem = divmod(extra, n_int)
    out = []
    for i in range(n_int):
        count = per + (rem if i == 0 else 0)
        seg = np.linspace(x_old[i], x_old[i + 1], count + 2)
        out.extend(seg[:-1] if i < n_int - 1 else seg)
    return np.sort(np.asarray(out))


def regrid_to_levels(x_old, y_old, n_levels: int = hatpro.N_LEVELS):
    """Linear re-grid preserving original points (interp2_180, :262-269)."""
    x_new = insert_points_preserving(x_old, n_levels)
    y_new = np.interp(x_new, np.asarray(x_old, float),
                      np.asarray(y_old, float))
    return x_new, y_new


def clamp_lwp_iwv(lwp: float, iwv: float):
    """Negative LWP/IWV -> 0 (check_lwp_iwv, :273-282)."""
    lwp = np.nan if np.ndim(lwp) else (0.0 if lwp < 0 else float(lwp))
    iwv = np.nan if np.ndim(iwv) else (0.0 if iwv < 0 else float(iwv))
    return lwp, iwv


def read_l2_profiles(files: list, launch: np.datetime64,
                     n_levels: int = hatpro.N_LEVELS):
    """Retrieved profiles regridded to n_levels, ground -> top.

    Returns (data, lwp, iwv) where data rows are the reference's convention
    (get_profs_from_l2, :286-363): 0 = height grid [m], 1 = zenith ta [K],
    2 = BL-scan ta [K], 3 = absolute humidity [kg/m^3].
    """
    data = np.full((4, n_levels), np.nan)
    lwp = iwv = np.nan
    files = _files_covering(files, launch)
    for path, ds in zip(files, netcdf.read_many(files)):
        if ds is None:
            continue
        times = decode_time(ds["time"])
        name = path.split("/")[-1]

        if "single" in name:
            idx = match_scans(ds["elevation_angle"].data,
                              ds["azimuth_angle"].data, times, 90.0, None,
                              launch)
            if idx.size:
                h = ds["height"].data
                x, y = regrid_to_levels(
                    h, np.nanmean(ds["temperature"].data[idx, :], axis=0),
                    n_levels)
                data[0], data[1] = x, y
                _, data[3] = regrid_to_levels(
                    h, np.nanmean(ds["absolute_humidity"].data[idx, :], axis=0),
                    n_levels)
                lwp = float(np.nanmean(ds["lwp"].data[idx]))
                iwv = float(np.nanmean(ds["iwv"].data[idx]))
            continue

        idx = _within_time(times, launch)
        if idx.size == 0:
            continue
        if "ta" in ds and "mwrBL" in name:
            _, data[2] = regrid_to_levels(
                ds["height"].data, np.nanmean(ds["ta"].data[idx, :], axis=0),
                n_levels)
        elif "ta" in ds:
            x, y = regrid_to_levels(
                ds["height"].data, np.nanmean(ds["ta"].data[idx, :], axis=0),
                n_levels)
            data[0], data[1] = x, y
        elif "hua" in ds:
            _, data[3] = regrid_to_levels(
                ds["height"].data, np.nanmean(ds["hua"].data[idx, :], axis=0),
                n_levels)
        elif "prw" in ds:
            iwv = float(np.nanmean(ds["prw"].data[idx]))
        elif "clwvi" in ds:
            lwp = float(np.nanmean(ds["clwvi"].data[idx]))
    lwp, iwv = clamp_lwp_iwv(lwp, iwv)
    return data, lwp, iwv


def get_mwr_data(launch: np.datetime64, instrument_files: dict,
                 height_offsets: dict = hatpro.INSTRUMENT_HEIGHT_OFFSET_M):
    """Per-instrument L1 TBs + L2 retrievals for one launch.

    instrument_files: {instrument: [paths]}; L1/L2 split by "_l2_"/"single"/
    product markers in the filename (get_mwr_data, :367-461).  Returns
    {instrument: {"tbs", "profiles", "lwp", "iwv", "lat", "lon", "qual"}}
    with the station-height offset applied to the retrieved height grid.
    """
    out = {}
    for inst, files in instrument_files.items():
        l2_markers = ("_l2_", "single", "_hua_", "_prw_", "_clwvi_")
        l2 = [f for f in files if any(m in f for m in l2_markers)]
        l1 = [f for f in files if f not in l2]
        tbs, lat, lon, qual = read_l1_tbs(l1, launch)
        profiles, lwp, iwv = read_l2_profiles(l2, launch)
        off = height_offsets.get(inst, 0.0)
        if np.isfinite(profiles[0]).any():
            profiles[0] = profiles[0] + off
        out[inst] = {"tbs": tbs, "profiles": profiles, "lwp": lwp,
                     "iwv": iwv, "lat": lat, "lon": lon, "qual": qual}
    return out


def interpolate_azimuths(tbs: np.ndarray) -> np.ndarray:
    """Fill azimuth gaps by linear interpolation along the (periodic) azimuth
    axis — for instruments scanning at 30 deg steps on the 5 deg output grid
    (interpolate_azimuths, preprocessing4all.py:871-879).

    tbs: (..., n_azi, n_chan); interpolates along axis -2 where a column is
    all-NaN but neighbors exist.
    """
    out = np.array(tbs, copy=True)
    n_azi = out.shape[-2]
    flat = out.reshape(-1, n_azi, out.shape[-1])
    az = np.arange(n_azi, dtype=float)
    for b in range(flat.shape[0]):
        for ch in range(flat.shape[2]):
            col = flat[b, :, ch]
            good = np.isfinite(col)
            if good.sum() >= 2 and not good.all():
                # periodic linear interpolation over azimuth index
                xg = az[good]
                col[~good] = np.interp(az[~good], xg, col[good],
                                       period=n_azi)
    return flat.reshape(out.shape)
