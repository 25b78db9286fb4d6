"""LES sounding writer.

The reference exports radiosonde profiles as large-eddy-simulation input
soundings (reference/python_src/merge_data_into_netCDF/
Sc_module.py:263-288: surface line 'p0 theta0 qv0 u0 v0' followed by per-
level 'z theta qv u v' rows).  Same text contract here, built on this
framework's thermo ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import thermo


def write_les_sounding(path: str, z_m, t_k, p_hpa, mr_gkg,
                       u_ms=None, v_ms=None) -> str:
    """Write an LES initial sounding; profiles ground -> top.

    Columns: height [m], potential temperature [K], water-vapor mixing ratio
    [g/kg], u and v wind [m/s] (zeros when not observed — radiosonde drift
    winds are not part of the harmonized dataset).
    """
    z = np.asarray(z_m, np.float64)
    theta = thermo.potential_temperature(
        torch.as_tensor(t_k, dtype=torch.float64),
        torch.as_tensor(p_hpa, dtype=torch.float64)).numpy()
    q = np.asarray(mr_gkg, np.float64)
    u = np.zeros_like(z) if u_ms is None else np.asarray(u_ms, np.float64)
    v = np.zeros_like(z) if v_ms is None else np.asarray(v_ms, np.float64)
    lines = [f"{float(np.asarray(p_hpa)[0]):10.2f} {theta[0]:10.3f} "
             f"{q[0]:10.4f} {u[0]:8.2f} {v[0]:8.2f}"]
    for i in range(1, z.size):
        lines.append(f"{z[i]:10.1f} {theta[i]:10.3f} {q[i]:10.4f} "
                     f"{u[i]:8.2f} {v[i]:8.2f}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
