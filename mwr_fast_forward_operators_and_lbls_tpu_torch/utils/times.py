"""Timestamp conversions used across the ingest/analysis layers.

The conversions of reference/python_src/merge_data_into_netCDF/
Sc_module.py:17-52 (datetime <-> unix seconds <-> 'seconds since 1970'
NetCDF convention <-> file-name date strings), UTC throughout.
"""

from __future__ import annotations

import datetime as dt

import numpy as np

_EPOCH = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)


def to_epoch_seconds(t) -> float:
    """datetime / datetime64 / ISO string / number -> unix seconds (UTC)."""
    if isinstance(t, (int, float, np.floating, np.integer)):
        return float(t)
    if isinstance(t, dt.datetime):
        if t.tzinfo is None:
            t = t.replace(tzinfo=dt.timezone.utc)
        return t.timestamp()
    return float(np.datetime64(t, "s").astype("f8"))


def from_epoch_seconds(seconds: float) -> dt.datetime:
    """Unix seconds -> aware UTC datetime."""
    return _EPOCH + dt.timedelta(seconds=float(seconds))


def to_datetime64(t) -> np.datetime64:
    return np.datetime64(int(round(to_epoch_seconds(t))), "s")


def parse_compact(stamp: str) -> dt.datetime:
    """'YYYYMMDDHHMM[SS]' or 'YYYYMMDD' file-name stamps -> UTC datetime
    (the formats of the reference's sonde/MWR file names,
    preprocessing4all.py:535-550)."""
    fmts = {8: "%Y%m%d", 12: "%Y%m%d%H%M", 14: "%Y%m%d%H%M%S"}
    fmt = fmts.get(len(stamp))
    if fmt is None:
        raise ValueError(f"unrecognized stamp {stamp!r}")
    return dt.datetime.strptime(stamp, fmt).replace(tzinfo=dt.timezone.utc)


_CF_UNITS = {"seconds": 1.0, "second": 1.0, "sec": 1.0, "s": 1.0,
             "minutes": 60.0, "minute": 60.0, "min": 60.0,
             "hours": 3600.0, "hour": 3600.0, "hr": 3600.0, "h": 3600.0,
             "days": 86400.0, "day": 86400.0, "d": 86400.0}


def decode_cf_time(values, units: str | None) -> np.ndarray:
    """CF '<unit> since <reference>' time values -> unix epoch seconds.

    Covers the encodings the external retrieval / MWR products use (xarray
    would decode these transparently in the reference,
    x_analysis_script_MARCH26.py:84-97); values without a 'since' clause are
    assumed to be epoch seconds already.
    """
    vals = np.asarray(values, np.float64)
    if not units or " since " not in str(units):
        return vals
    unit, ref = str(units).split(" since ", 1)
    scale = _CF_UNITS.get(unit.strip().lower())
    if scale is None:
        raise ValueError(f"unsupported CF time unit {unit!r}")
    ref = ref.strip().replace("T", " ").split("+")[0].rstrip("Z").strip()
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
                "%Y-%m-%d %H:%M", "%Y-%m-%d"):
        try:
            base = dt.datetime.strptime(ref, fmt).replace(
                tzinfo=dt.timezone.utc)
            break
        except ValueError:
            continue
    else:
        raise ValueError(f"unparseable CF reference date {ref!r}")
    return base.timestamp() + vals * scale


def format_compact(t, seconds: bool = False) -> str:
    d = from_epoch_seconds(to_epoch_seconds(t))
    return d.strftime("%Y%m%d%H%M%S" if seconds else "%Y%m%d%H%M")
