"""The plain reference of each timed entry point, in blocks that fit.

Every function takes the inputs the benchmark made (numpy arrays, (B, L),
levels ground -> top) and computes in `dtype`: float64 for the reference,
a lower precision for the control.  Nothing here reads what the program
derived from them.

  lbl_tb         TB (B, E, F) of the slant-path LBL forward
  spectral_srf   the channel TBs (B, E, C) of the monochromatic spectrum
                 folded with the channels' spectral response functions
  kmatrix        dTB/d(t, rho, lwc) (B, E, F, L), by reverse-mode autograd
                 through lbl_tb's own arithmetic
"""

import numpy as np
import torch

from .physics import (chord_lengths, downwelling_tb, refractive_index,
                      rho_to_e, total_absorption)

VARIABLES = ("z", "p", "t", "rho", "lwc")


def _columns(profiles: dict, rows: slice, dtype, device) -> dict:
    return {k: torch.as_tensor(np.asarray(profiles[k][rows], np.float64),
                               device=device).to(dtype) for k in VARIABLES}


def _cos(elevations_deg, dtype, device):
    el = torch.as_tensor(np.asarray(elevations_deg, np.float64),
                         device=device).to(dtype)
    return torch.cos(torch.deg2rad(el))


def _paths(x: dict, cos_el):
    """Slant paths (E, b, L-1) of level columns x (b, L)."""
    n = refractive_index(x["p"], x["t"], rho_to_e(x["rho"], x["t"]))
    return chord_lengths(x["z"][None], n[None], cos_el[:, None])


def lbl_tb(profiles: dict, freqs_ghz, elevations_deg, model: str,
           dtype=torch.float64, device="cpu", block: int = 64):
    """TB (B, E, F) of every profile at every elevation and channel."""
    n_prof = len(profiles["t"])
    f = torch.as_tensor(np.asarray(freqs_ghz, np.float64),
                        device=device).to(dtype)
    cos_el = _cos(elevations_deg, dtype, device)
    out = []
    for s in range(0, n_prof, block):
        x = _columns(profiles, slice(s, s + block), dtype, device)
        alpha = total_absorption(f[:, None, None], x["p"], x["t"], x["rho"],
                                 x["lwc"], model)              # (F, b, L)
        ds = _paths(x, cos_el)                                 # (E, b, L-1)
        tb = downwelling_tb(alpha[None], ds[:, None], x["t"],
                            f[None, :, None])                  # (E, F, b)
        out.append(tb.permute(2, 0, 1))
    return torch.cat(out)


def spectral_srf(profiles: dict, f_ghz, weights, elevations_deg, model: str,
                 dtype=torch.float64, srf_dtype=torch.float64, device="cpu",
                 freq_block: int = 512):
    """The monochromatic TB spectrum on the grid `f_ghz` (F,), folded with
    `weights` (C, F), each channel's normalised to sum 1: (B, E, C)."""
    x = _columns(profiles, slice(None), dtype, device)
    f_all = torch.as_tensor(np.asarray(f_ghz, np.float64),
                            device=device).to(dtype)
    w = torch.as_tensor(np.asarray(weights, np.float64), device=device)
    w = (w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-30)).to(srf_dtype)
    ds = _paths(x, _cos(elevations_deg, dtype, device))        # (E, B, L-1)
    acc = 0.0
    for s in range(0, f_all.numel(), freq_block):
        f = f_all[s:s + freq_block]
        alpha = total_absorption(f[:, None, None], x["p"], x["t"], x["rho"],
                                 x["lwc"], model)              # (Fc, B, L)
        tb = downwelling_tb(alpha[None], ds[:, None], x["t"],
                            f[None, :, None])                  # (E, Fc, B)
        acc = acc + torch.einsum("efb,cf->bec", tb.to(srf_dtype),
                                 w[:, s:s + freq_block])
    return acc


def kmatrix(profiles: dict, freqs_ghz, elevations_deg, model: str,
            dtype=torch.float64, device="cpu", block: int = 16):
    """dTB/d(t, rho, lwc), each (B, E, F, L).

    Every (elevation, channel) takes its own copy of the profile columns as
    the leaves, so TB[e, f, b] depends on its own copy alone and one
    backward pass of the summed TBs gives every row of K."""
    n_prof = len(profiles["t"])
    f = torch.as_tensor(np.asarray(freqs_ghz, np.float64),
                        device=device).to(dtype)
    cos_el = _cos(elevations_deg, dtype, device)
    n_el, n_f = cos_el.numel(), f.numel()
    out = {k: [] for k in ("t", "rho", "lwc")}
    for s in range(0, n_prof, block):
        x = _columns(profiles, slice(s, s + block), dtype, device)
        leaves = {k: x[k].expand(n_el, n_f, *x[k].shape).clone()
                  .requires_grad_(True) for k in out}          # (E, F, b, L)
        t, rho, lwc = leaves["t"], leaves["rho"], leaves["lwc"]
        with torch.enable_grad():
            alpha = total_absorption(f[None, :, None, None], x["p"], t, rho,
                                     lwc, model)               # (E, F, b, L)
            n = refractive_index(x["p"], t, rho_to_e(rho, t))
            ds = chord_lengths(x["z"], n, cos_el[:, None, None])
            tb = downwelling_tb(alpha, ds, t, f[None, :, None])
            grads = torch.autograd.grad(tb.sum(), (t, rho, lwc))
        for k, g in zip(out, grads):
            out[k].append(g.permute(2, 0, 1, 3))
    return {k: torch.cat(v) for k, v in out.items()}
