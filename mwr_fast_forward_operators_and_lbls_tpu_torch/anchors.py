"""Deterministic analytic profiles behind the frozen TB golden
(`tests/golden/tb_standard.json`)."""

import numpy as np


def standard_profiles(n_levels: int = 180) -> dict:
    """Three deterministic analytic profiles (no RNG): midlatitude-moist,
    winter-dry, and tropical-humid, as float64 numpy arrays (3, L)."""
    z = np.linspace(0.0, 25_000.0, n_levels)
    profs = {"z": [], "p": [], "t": [], "rho": [], "lwc": []}
    for (t0, gamma, rh0, p0) in [(288.15, 6.5e-3, 0.70, 1013.25),
                                 (263.15, 5.5e-3, 0.50, 1030.0),
                                 (300.15, 6.0e-3, 0.80, 1008.0)]:
        t = np.maximum(t0 - gamma * z, 216.65)
        # hydrostatic pressure with the same piecewise-linear T
        dz = np.diff(z)
        tm = 0.5 * (t[1:] + t[:-1])
        p = p0 * np.exp(-np.concatenate([[0.0],
                                         np.cumsum(0.0341632 * dz / tm)]))
        rh = rh0 * np.exp(-z / 8000.0)
        es = 6.1078 * np.exp(17.08085 * (t - 273.15)
                             / (234.175 + (t - 273.15)))
        rho = 216.679 * rh * es / t
        profs["z"].append(z)
        profs["p"].append(p)
        profs["t"].append(t)
        profs["rho"].append(rho)
        profs["lwc"].append(np.zeros_like(z))
    return {k: np.stack(v) for k, v in profs.items()}
