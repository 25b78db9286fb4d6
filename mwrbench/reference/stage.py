"""The forward stage's outputs, worked out again from the harmonized
dataset's own variables: every (time, crop) profile through each release's
LBL, the fast operator and the K-matrix of the last release, in the
reference layout, NaN where a profile is not finite."""

import numpy as np
import torch

from . import fast
from .forward import kmatrix, lbl_tb

LEVEL_VARS = ("Level_Pressure", "Level_Temperature", "Level_H2O", "Level_z",
              "Level_Liquid")


def profiles_of(levels: dict, crop: int) -> dict:
    """(time, L) float64 profiles ground -> top of one crop, from the
    dataset's (N_Levels, time, Crop) level variables (top -> ground):
    vapor density from the mixing ratio, liquid water content from the
    liquid mixing ratio [kg/kg] and the air density."""
    p, t, mr, z, liq = (np.asarray(levels[k][::-1, :, crop], np.float64).T
                        for k in LEVEL_VARS)
    e = (mr / 1000.0) * p / (0.622 + mr / 1000.0)
    air = p * 100.0 / (287.04 * t)
    return {"z": z, "p": p, "t": t, "rho": 216.679 * e / t,
            "lwc": np.nan_to_num(liq, nan=0.0) * air * 1000.0}


def outputs(levels: dict, w, models, freqs, elevations, device,
            dtype=torch.float64, product_dtype=None) -> dict:
    """{variable: float64 tensor on `device`} of the stage's outputs,
    computed in `dtype`."""
    n_time = levels["Level_z"].shape[1]
    nc, ne, nl = len(freqs), len(elevations), levels["Level_z"].shape[0]

    def nan(*shape):
        return torch.full(shape + (2,), float("nan"), dtype=torch.float64,
                          device=device)

    out = {f"TBs_LBL_{m}": nan(n_time, nc, ne) for m in models}
    out.update({k: nan(n_time, nc, ne) for k in ("TBs_Fast", "ttrans_Fast")})
    out["levtrans_Fast"] = nan(n_time, nc, nl, ne)
    out.update({f"Jacobian_{k}_LBL": nan(n_time, nc, ne, nl)
                for k in ("T", "rho", "liq")})
    for crop in (0, 1):
        prof = profiles_of(levels, crop)
        valid = np.all([np.isfinite(v).all(axis=1) for v in prof.values()],
                       axis=0)
        if not valid.any():
            continue
        good = {k: v[valid] for k, v in prof.items()}
        rows = torch.as_tensor(np.flatnonzero(valid), device=device)

        def put(name, value, order):
            out[name][rows, ..., crop] = value.permute(order).double()
        for m in models:
            put(f"TBs_LBL_{m}", lbl_tb(good, freqs, elevations, m, dtype,
                                       device), (0, 2, 1))
        x = {k: torch.as_tensor(v, device=device).to(dtype)
             for k, v in good.items()}
        tb, tau, trans = fast.forward(w, x, freqs, elevations, product_dtype)
        put("TBs_Fast", tb, (0, 2, 1))
        put("ttrans_Fast", torch.exp(-tau), (0, 2, 1))
        put("levtrans_Fast", trans, (0, 2, 3, 1))
        k = kmatrix(good, freqs, elevations, models[-1], dtype, device)
        for name, key in (("T", "t"), ("rho", "rho"), ("liq", "lwc")):
            put(f"Jacobian_{name}_LBL", k[key], (0, 2, 1, 3))
    return out
