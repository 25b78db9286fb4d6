"""Radiosonde ingest: NetCDF (3 dialects) + GRAW text profiles.

Behavioral re-implementation of the reference's readers
(reference/python_src/preproc/preprocessing4all.py:198-446) on our own
NetCDF codec, producing ground->top profiles on the canonical 180-level grid:

  * dialect detection: `Height/Temperature/Pressure/Humidity` (ARMS-style),
    `zg|zsl/ta/pa/hur` (DWD sups_rao / fval style, Pa pressures), GRAW
    `*_Profile.txt` tables (skip 20 header / 10 footer rows)
  * burst trimming at max altitude, cut at min pressure 137 hPa
  * ground-clutter "crop" detection: count leading samples whose height
    changes < 2 m (preprocessing4all.py:253-268); optional fixed crop at the
    132 m level for roof-mounted instrument comparisons
  * rejection: fewer than 300 raw samples, top below 10 km, z jumps > 500 m
    or p jumps > 50 hPa between thinned levels
  * thinning to 80 boundary-layer (< 3 km) + 120 free-troposphere points
    with running-mean smoothing between thinned indices
  * RH normalization (fractions -> %), mixing-ratio & ppmv derivation with
    the reference's Clausius-Clapeyron forms
  * climatology extension above the sonde top (AFGL midlatitude summer) with
    the reference's p-threshold rule, then a top-below-10-hPa resample
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..constants import afgl, hatpro
from ..utils import native
from . import netcdf

MIN_P_HPA = 137.0       # preprocessing4all.py:43 "Do not change"
DATAPOINTS_BL = 80
DATAPOINTS_FT = 120
MIN_RAW_SAMPLES = 300
MIN_TOP_M = 10_000.0
MAX_Z_JUMP_M = 500.0
MAX_P_JUMP_HPA = 50.0


@dataclass
class SondeProfile:
    """Ground -> top profile arrays (variable length until harmonized)."""

    p_hpa: np.ndarray
    t_k: np.ndarray
    rh_pct: np.ndarray
    mr_gkg: np.ndarray
    ppmv: np.ndarray
    z_m: np.ndarray
    lat: float = np.nan
    lon: float = np.nan
    surface_altitude_km: float = np.nan
    valid: bool = True
    reject_reason: str = ""
    lwc_kg_kg: np.ndarray | None = None
    ice_kg_kg: np.ndarray | None = None
    lwp_kg_m2: float = np.nan

    @classmethod
    def invalid(cls, reason: str, n: int = hatpro.N_LEVELS) -> "SondeProfile":
        nanv = np.full(n, np.nan)
        return cls(nanv, nanv.copy(), nanv.copy(), nanv.copy(), nanv.copy(),
                   nanv.copy(), valid=False, reject_reason=reason)


# -- humidity conversions (the reference's exact CC forms, :104-152) --------

def _es_liq_pa(t_k):
    return 610.78 * np.exp(2.5e6 / 462.0 * (1.0 / 273.15 - 1.0 / t_k))


def rh_to_mr_kgkg(rh_pct, t_k, p_pa):
    e = _es_liq_pa(t_k) * rh_pct / 100.0
    q = 0.622 * e / (p_pa - 0.3777 * e)
    return q / (1.0 - q)


def rh_to_ppmv(rh_pct, t_k, p_pa):
    e = _es_liq_pa(t_k) * rh_pct / 100.0
    return 1e6 * e / p_pa


# -- thinning ---------------------------------------------------------------

def running_mean(inds: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Mean of `values` between midpoints of consecutive thinned indices
    (preprocessing4all.py:156-169); endpoints taken verbatim."""
    inds = np.asarray(inds)
    out = np.empty(inds.size, dtype=float)
    for i, ind in enumerate(inds):
        if i == 0 or i == inds.size - 1:
            out[i] = values[ind]
        else:
            lo = (ind + inds[i - 1]) // 2
            hi = (ind + inds[i + 1]) // 2
            seg = values[lo:hi]
            out[i] = np.nanmean(seg) if seg.size else values[ind]
    return out


def thinning_indices(z: np.ndarray, crop: int, max_index: int,
                     bl: int = DATAPOINTS_BL, ft: int = DATAPOINTS_FT):
    index3000 = int(np.nanargmin(np.abs(z[:max_index] - 3000.0)))
    inc_bl = max(int(np.ceil((index3000 - crop) / bl)), 1)
    inc_ft = max(int(np.ceil((max_index - index3000) / ft)), 1)
    return np.unique(np.r_[crop:index3000:inc_bl, index3000:max_index:inc_ft])


def detect_ground_clutter(z: np.ndarray, limit: int = 1000) -> int:
    """Leading samples with height changes < 2 m (pre-launch data)."""
    crop = 0
    old = z[0]
    for i in range(1, min(limit, z.size)):
        if abs(z[i] - old) < 2.0:
            crop += 1
        else:
            break
        old = z[i]
    return crop


# -- core assembly shared by all dialects -----------------------------------

def _assemble(z, t_k, p_hpa, rh, lat, lon, crop: int) -> SondeProfile:
    """Trim, thin, smooth, convert; reject unusable soundings."""
    max_index = int(np.nanargmax(z))
    if p_hpa[max_index] < MIN_P_HPA:
        max_index = int(np.nanargmin(np.abs(p_hpa[:max_index] - MIN_P_HPA)))
    if crop == 0:
        crop = detect_ground_clutter(z)
    if max_index < MIN_RAW_SAMPLES:
        return SondeProfile.invalid(f"only {max_index} raw samples")
    if np.nanmax(z) < MIN_TOP_M:
        return SondeProfile.invalid(f"top {np.nanmax(z):.0f} m below 10 km")

    inds = thinning_indices(z, crop, max_index)
    z_thin = z[inds].astype(float)
    t_thin = running_mean(inds, t_k)
    p_thin = running_mean(inds, p_hpa)
    rh_thin = running_mean(inds, rh)
    if np.all(rh_thin <= 1.5):
        rh_thin = rh_thin * 100.0

    jump_z = np.abs(np.diff(z_thin)) > MAX_Z_JUMP_M
    jump_p = np.abs(np.diff(p_thin)) > MAX_P_JUMP_HPA
    if (jump_z | jump_p)[: max(z_thin.size // 2, 1)].any():
        return SondeProfile.invalid("z/p jump between thinned levels")

    mr = rh_to_mr_kgkg(rh_thin, t_thin, p_thin * 100.0)
    ppmv = rh_to_ppmv(rh_thin, t_thin, p_thin * 100.0)
    return SondeProfile(
        p_hpa=p_thin, t_k=t_thin, rh_pct=rh_thin, mr_gkg=mr * 1000.0,
        ppmv=ppmv, z_m=z_thin, lat=float(lat), lon=float(lon),
        surface_altitude_km=float(z_thin[0]) / 1000.0,
    )


def read_radiosonde_nc(path: str, crop_at_132m: bool = False) -> SondeProfile:
    """Read any of the three NetCDF dialects (preprocessing4all.py:198-344)."""
    ds = netcdf.read(path)
    if "Height" in ds:
        z = np.ravel(ds["Height"].data).astype(float)
        t = np.ravel(ds["Temperature"].data).astype(float)
        p = np.ravel(ds["Pressure"].data).astype(float)  # hPa
        rh = np.ravel(ds["Humidity"].data).astype(float)
        lat = np.ravel(ds["Latitude"].data)[0]
        lon = np.ravel(ds["Longitude"].data)[0]
    elif "zg" in ds or "zsl" in ds:
        zname = "zg" if "zg" in ds else "zsl"
        z = np.ravel(ds[zname].data).astype(float)
        t = np.ravel(ds["ta"].data).astype(float)
        p = np.ravel(ds["pa"].data).astype(float) / 100.0  # Pa -> hPa
        rh = np.ravel(ds["hur"].data).astype(float)
        lat = np.ravel(ds["lat"].data)[0]
        lon = np.ravel(ds["lon"].data)[0]
    else:
        return SondeProfile.invalid(f"unknown NetCDF dialect in {path}")
    if np.all(rh[np.isfinite(rh)] <= 1.5):
        rh = rh * 100.0
    crop = int(np.nanargmin(np.abs(z - 132.0))) if crop_at_132m else 0
    return _assemble(z, t, p, rh, lat, lon, crop)


_GRAW_COLUMNS = ["Time", "P", "T", "Hu", "Ws", "Wd", "Long", "Lat", "Alt",
                 "Geopot", "Rs", "Elevation", "Azimuth", "Range"]


def read_radiosonde_txt(path: str, crop_at_132m: bool = False,
                        skip_header: int = 20, skip_footer: int = 10) -> SondeProfile:
    """GRAW `*_Profile.txt` table (preprocessing4all.py:348-446): whitespace
    table, 20 header + 10 footer rows, T in Celsius, p in hPa.

    Uses the native ncio table tokenizer when built (native/ncio); falls back
    to pure-Python parsing otherwise.
    """
    arr = native.parse_table(path, len(_GRAW_COLUMNS), skip_header,
                             skip_footer)
    if arr is None:
        with open(path, "r", errors="ignore") as fh:
            lines = fh.readlines()
        body = lines[skip_header:len(lines) - skip_footer]
        rows = []
        for ln in body:
            parts = re.split(r"\s+", ln.strip())
            if len(parts) < len(_GRAW_COLUMNS):
                continue
            try:
                rows.append([float(x) for x in parts[:len(_GRAW_COLUMNS)]])
            except ValueError:
                continue
        arr = np.asarray(rows) if rows else np.empty((0, len(_GRAW_COLUMNS)))
    if arr.shape[0] == 0:
        return SondeProfile.invalid(f"no parseable rows in {path}")
    col = {c: arr[:, i] for i, c in enumerate(_GRAW_COLUMNS)}
    z = col["Alt"]
    crop = int(np.nanargmin(np.abs(z - 132.0))) if crop_at_132m else 0
    return _assemble(z, col["T"] + 273.15, col["P"], col["Hu"],
                     col["Lat"][0], col["Long"][0], crop)


# -- climatology extension --------------------------------------------------

def _afgl_mls():
    z = afgl.Z_KM * 1000.0
    p = afgl.MLS_P_HPA
    t = afgl.MLS_T_K
    ppmv = afgl.MLS_H2O_PPMV
    e = ppmv * p / 1e6
    mr = 0.622 * e / (p - e)  # kg/kg
    rh = 100.0 * (e * 100.0) / _es_liq_pa(t)
    return z, p, t, ppmv, mr, rh


def extend_with_climatology(prof: SondeProfile,
                            min_p: float = MIN_P_HPA) -> SondeProfile:
    """Stitch AFGL midlatitude-summer levels above the sonde top.

    Threshold rule (preprocessing4all.py:478-531): take the *lowest* of
    (index of min p, last index with ppmv <= 2*min ppmv, index of max z) as
    the cut pressure, clamped to [137, 200] hPa; everything at lower pressure
    comes from climatology; ppmv is recomputed from the stitched RH; finally
    the top levels are resampled so the profile tops out below 10 hPa.
    """
    if not prof.valid:
        return prof
    p, t, ppmv, mr = prof.p_hpa, prof.t_k, prof.ppmv, prof.mr_gkg / 1000.0
    z, rh = prof.z_m, prof.rh_pct

    p_index = int(np.nanargmin(p))
    wv_min = np.nanmin(ppmv)
    candidates = np.where(ppmv <= 2.0 * wv_min)[0]
    wv_index = int(candidates[-1]) if candidates.size else p_index
    z_index = int(np.nanargmax(z))
    thres_idx = min(p_index, wv_index, z_index)
    p_threshold = float(np.clip(p[thres_idx], min_p, 200.0))

    zc, pc, tc, ppmvc, mrc, rhc = _afgl_mls()
    mask_rs = p > p_threshold
    mask_clim = pc < p_threshold

    p2 = np.concatenate([p[mask_rs], pc[mask_clim]])
    t2 = np.concatenate([t[mask_rs], tc[mask_clim]])
    mr2 = np.concatenate([mr[mask_rs], mrc[mask_clim]])
    z2 = np.concatenate([z[mask_rs], zc[mask_clim]])
    rh2 = np.concatenate([rh[mask_rs], rhc[mask_clim]])
    ppmv2 = rh_to_ppmv(rh2, t2, p2 * 100.0)

    return SondeProfile(
        p_hpa=p2, t_k=t2, rh_pct=rh2, mr_gkg=mr2 * 1000.0, ppmv=ppmv2,
        z_m=z2, lat=prof.lat, lon=prof.lon,
        surface_altitude_km=prof.surface_altitude_km,
    )


def harmonize_levels(prof: SondeProfile,
                     n_levels: int = hatpro.N_LEVELS) -> SondeProfile:
    """Trim/pad to exactly `n_levels`, keeping the ground-most levels but
    forcing the retained top below 10 hPa.

    This reproduces the combined effect of the reference's `lowest2tenhPa`
    rewrite of levels 173..179 followed by the `[-n_levels:]` crop of the
    TOA->ground arrays (preprocessing4all.py:450-474, 683-690): the lowest
    `n_levels - 7` levels are kept verbatim and the top 7 are respaced from
    there up to the first stitched level with p < 10 hPa, so no stratospheric
    mass is silently dropped."""
    if not prof.valid:
        return SondeProfile.invalid(prof.reject_reason, n_levels)

    p_full = prof.p_hpa
    pick = None
    if p_full.size >= n_levels and p_full[n_levels - 1] > 10.0:
        idx10 = np.where(p_full < 10.0)[0]
        if idx10.size:
            start = n_levels - 7
            top = np.clip(
                np.linspace(start, idx10[0], 7).round().astype(int),
                0, p_full.size - 1)
            pick = np.concatenate([np.arange(start), top])

    def fix(a):
        if pick is not None:
            return a[pick]
        if a.size >= n_levels:
            return a[:n_levels]
        return np.concatenate([a, np.full(n_levels - a.size, np.nan)])

    return SondeProfile(
        p_hpa=fix(prof.p_hpa), t_k=fix(prof.t_k), rh_pct=fix(prof.rh_pct),
        mr_gkg=fix(prof.mr_gkg), ppmv=fix(prof.ppmv), z_m=fix(prof.z_m),
        lat=prof.lat, lon=prof.lon,
        surface_altitude_km=prof.surface_altitude_km,
        lwc_kg_kg=None if prof.lwc_kg_kg is None else fix(prof.lwc_kg_kg),
        ice_kg_kg=None if prof.ice_kg_kg is None else fix(prof.ice_kg_kg),
        lwp_kg_m2=prof.lwp_kg_m2,
    )


# -- physical-realism checks (warnings promoted to a structured report) -----

def physical_realism_report(prof: SondeProfile) -> list:
    """The reference's runtime warnings (preprocessing4all.py:553-572) as a
    list of violation strings (empty = clean); tests assert on it."""
    issues = []
    p, t, rh = prof.p_hpa, prof.t_k, prof.rh_pct
    ppmv, mr, z = prof.ppmv, prof.mr_gkg, prof.z_m
    fin = np.isfinite
    if np.any((p > 1100) & fin(p)) or np.any((p < 0) & fin(p)):
        issues.append("pressure outside (0, 1100) hPa")
    if np.any((t > 400) & fin(t)) or np.any((t < 0) & fin(t)):
        issues.append("temperature outside (0, 400) K")
    if np.any((rh > 110) & fin(rh)) or np.any((rh < 0) & fin(rh)):
        issues.append("RH outside (0, 110) %")
    if np.any((ppmv > 40000) & fin(ppmv)) or np.any((ppmv < 0) & fin(ppmv)):
        issues.append("water vapor outside (0, 40000) ppmv")
    if np.any((z > 130000) & fin(z)) or np.any((z < 0) & fin(z)):
        issues.append("height outside (0, 130) km")
    if np.any((mr > 20) & fin(mr)) or np.any((mr < 0) & fin(mr)):
        issues.append("mixing ratio outside (0, 20) g/kg")
    if z.size >= 2 and fin(z[-2:]).all() and abs(z[-1] - z[-2]) < 2.0:
        issues.append("top levels closer than 2 m (ground data in profile?)")
    return issues


def moisture_consistency_report(prof: SondeProfile,
                                tol_mr: float = 0.2, tol_rh: float = 3.0,
                                tol_ppmv: float = 100.0) -> list:
    """Round-trip mr/RH/ppmv consistency (preprocessing4all.py:70-100)."""
    issues = []
    mr_rt = rh_to_mr_kgkg(prof.rh_pct, prof.t_k, prof.p_hpa * 100.0) * 1000.0
    ppmv_rt = rh_to_ppmv(prof.rh_pct, prof.t_k, prof.p_hpa * 100.0)
    d_mr = np.nanmax(np.abs(mr_rt - prof.mr_gkg))
    d_ppmv = np.nanmax(np.abs(ppmv_rt - prof.ppmv))
    if d_mr > tol_mr:
        issues.append(f"mr vs RH differ by {d_mr:.3f} g/kg (tol {tol_mr})")
    if d_ppmv > tol_ppmv:
        issues.append(f"ppmv vs RH differ by {d_ppmv:.1f} ppmv (tol {tol_ppmv})")
    return issues


def parse_launch_datetime(filename: str) -> np.datetime64:
    """Launch time from the three filename conventions
    (preprocessing4all.py:535-549)."""
    stem = filename.split("/")[-1].split(".")[0]
    if "sups_rao_sonde00" in filename or "fval" in filename:
        s = stem.split("_")[-1]
        return np.datetime64(f"{s[:4]}-{s[4:6]}-{s[6:8]}T{s[8:10]}:{s[10:12]}:{s[12:14]}")
    if filename.endswith("_Profile.txt") or "Profile" in stem:
        s = stem
        return np.datetime64(f"{s[:4]}-{s[4:6]}-{s[6:8]}T{s[8:10]}:{s[10:12]}:{s[12:14]}")
    s = stem  # "YYYYMMDD_HHMMSS.nc"
    return np.datetime64(f"{s[:4]}-{s[4:6]}-{s[6:8]}T{s[9:11]}:{s[11:13]}:{s[13:15]}")
