"""The needed work of one call of each driver's entry point, per launch of
each kernel, from the cell's own sizes (`counts`, the frozen copy)."""

import numpy as np

from . import counts


def lbl_call(workload: dict, config: dict) -> dict:
    """`forward_batch`, tb only: K1 on batch x levels points at the
    channels, K2 on the batch at every elevation."""
    b, n_lev = workload["batch"], config["n_levels"]
    ch, el = config["channels_ghz"], config["elevations_deg"]
    return {"k1": [counts.k1_roofline(b * n_lev, ch, workload["model"])],
            "k2": [counts.k2_roofline(b, n_lev, len(ch), len(el))]}


def spectral_call(workload: dict, config: dict) -> dict:
    """`forward_spectral` on the grid in chunks: per chunk K6 on batch x
    levels points at the chunk's frequencies, K3 on the given paths."""
    b, n_lev = workload["batch"], config["n_levels"]
    f = np.linspace(config["f_min_ghz"], config["f_max_ghz"],
                    config["n_freqs"]).astype(np.float32)
    step = workload["freq_chunk"]
    chunks = [f[s:s + step] for s in range(0, f.size, step)]
    n_el = len(config["elevations_deg"])
    return {"k6": [counts.k6_roofline(b * n_lev, c, config["model"])
                   for c in chunks],
            "k3": [counts.k2_roofline(b, n_lev, c.size, n_el,
                                      given_paths=True) for c in chunks]}


def kmatrix_call(workload: dict, config: dict) -> dict:
    """`kmatrix_batch_fast` wrt (t, rho, lwc): K4 on batch x levels
    points, K5a for t, K5b for rho and lwc."""
    b, n_lev = workload["batch"], config["n_levels"]
    ch, el = config["channels_ghz"], config["elevations_deg"]
    return {"k4": [counts.k4_roofline(b * n_lev, ch, workload["model"])],
            "k5": [counts.k5_roofline(b, n_lev, len(ch), len(el), which=w)
                   for w in ("t", "rho_lwc")]}


def all_of(per_kernel: dict) -> list:
    return [r for rs in per_kernel.values() for r in rs]
