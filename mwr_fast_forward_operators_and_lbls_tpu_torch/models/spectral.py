"""High-resolution monochromatic forward: TB spectra on a dense frequency grid
and their convolution with channel spectral response functions (SRFs).

    profiles (B, L) x elevations (E) x frequencies (F)  ->  TB (B, E, F)

`forward_spectral` transposes the profiles once to the (L, B) layout,
computes the slant paths (E, L-1, B) once, and streams the frequency grid
through two stages in chunks of `freq_chunk`: absorption on the runtime grid
(kernel K6, alpha (Fc, L, B)) and the downwelling RTE on the given paths
(kernel K3, tb and tau_total (E, Fc, B)), each chunk permuted into the
(B, E, F) outputs.  Each stage launches its kernel or runs its plain
version by the rule of `ops.cuda.launches`, given `use_kernels`.
Peak device memory is one (Fc, L, B) alpha block whatever F is.
"""

import numpy as np
import torch

from ..constants import physics as phys
from ..ops import geometry, rte, thermo
from ..ops.cuda.rte import downwelling_lb
from ..ops.cuda.spectral import absorption_spectral
from ..ops.spans import span
from .lbl import LBLConfig, level_major_profiles


def _rte_freq_lanes(alpha, ds_km, t_k, f_ghz, t_cosmic=phys.T_COSMIC):
    """Downwelling TB with frequency last, in plain torch (the JAX package's
    function of this name).

    alpha (B, L, F); ds_km (B, L-1); t_k (B, L); f_ghz (F,).  Returns tb
    (B, F) and tau_total (B, F).
    """
    alpha_mid = 0.5 * (alpha[:, :-1] + alpha[:, 1:])
    dtau = alpha_mid * ds_km[:, :, None]                    # (B, L-1, F)
    ctau = torch.cumsum(dtau, dim=1)
    e_ctau = torch.exp(-ctau)
    trans_below = torch.cat([torch.ones_like(e_ctau[:, :1]), e_ctau[:, :-1]],
                            dim=1)
    b = rte.planck_tb(t_k[:, :, None], f_ghz[None, None, :])  # (B, L, F)
    g_bot, g_top = rte._emission_factors(dtau)
    atm = torch.sum((g_bot * b[:, :-1] + g_top * b[:, 1:]) * trans_below,
                    dim=1)                                   # (B, F)
    cosmic = rte.planck_tb(t_cosmic, f_ghz)[None] * e_ctau[:, -1]
    return rte.inverse_planck_tb(atm + cosmic, f_ghz[None]), ctau[:, -1]


def _forward_chunk(levels: dict, f_chunk, ds_km, model: str,
                   use_kernels: bool):
    """tb and tau_total (E, Fc, B) of one frequency chunk: absorption on the
    chunk's grid, then the RTE on the given slant paths ds_km (E, L-1, B)."""
    p, t, rho, lwc = (levels[k] for k in ("p", "t", "rho", "lwc"))
    alpha = absorption_spectral(f_chunk, p, t, rho, lwc, model,
                                use_kernels=use_kernels)
    return downwelling_lb(f_chunk, alpha, ds_km, t, use_kernels=use_kernels)


def forward_spectral(profiles: dict, f_ghz, elevations_deg=(90.0,),
                     model: str = "R24", freq_chunk: int = 2048,
                     use_kernels: bool = True) -> dict:
    """Monochromatic TB spectra: (B, L) profiles x (F,) grid -> (B, E, F).

    profiles: "z" [m], "p" [hPa], "t" [K], "rho" [g/m^3] and optionally
      "lwc" [g/m^3], each (B, L), levels ground -> top, on one device
      (tensors stay where they are, numpy arrays go to the CUDA card); the
      working dtype is theirs (float32 at least).
    f_ghz: the frequency grid [GHz], a sequence, numpy array or tensor; its
      values are rounded to float32, as in the JAX package.
    use_kernels: as `LBLConfig.use_kernels`; where the kernels launch
      (`ops.cuda.launches`), K6 and K3 once per chunk.

    Returns tb and tau_total, each (B, E, F).
    """
    dtype = torch.promote_types(torch.as_tensor(profiles["p"]).dtype,
                                torch.float32)
    with span("spectral.forward_spectral"):
        with span("spectral.layout"):
            levels = level_major_profiles(
                profiles, LBLConfig(dtype=str(dtype).removeprefix("torch.")))
            z, p, t, rho = (levels[k] for k in ("z", "p", "t", "rho"))
            f = (f_ghz if torch.is_tensor(f_ghz)
                 else torch.from_numpy(np.asarray(f_ghz, np.float32)))
            f = f.to(device=p.device, dtype=torch.float32).to(dtype)
            f = f.reshape(-1)
        with span("spectral.slant_geometry"):
            e_hpa = thermo.rho_to_e(rho, t)
            ds = torch.stack([
                geometry.slant_path_lengths_lb(z, p, t, e_hpa, el)
                for el in elevations_deg])                   # (E, L-1, B)

        n_lev, batch = p.shape
        nf, chunk = f.numel(), max(1, int(freq_chunk))
        out = {k: torch.empty((batch, len(elevations_deg), nf), dtype=dtype,
                              device=p.device) for k in ("tb", "tau_total")}
        for s in range(0, nf, chunk):
            with span("spectral.chunk"):
                stacked = _forward_chunk(levels, f[s:s + chunk], ds, model,
                                         use_kernels)
                for k, v in out.items():
                    v[:, :, s:s + chunk] = stacked[k].permute(2, 0, 1)
        return out


def srf_convolve(tb_mono, weights):
    """Channel-SRF convolution: tb_mono (..., F) x weights (C, F) -> (..., C),
    each channel's weights normalised to sum 1.

    The product runs in float64 and is rounded to tb_mono's dtype: at least
    as exact as the JAX package's Precision.HIGHEST, and never TF32 whatever
    the global matmul setting.  It is a few MFLOP for a 50k spectrum.
    """
    with span("spectral.srf_convolve"):
        w = torch.as_tensor(weights).to(device=tb_mono.device,
                                        dtype=torch.float64)
        w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-30)
        return torch.matmul(tb_mono.double(), w.T).to(tb_mono.dtype)
