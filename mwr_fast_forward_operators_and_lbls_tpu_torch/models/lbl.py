"""Batched line-by-line forward operator: profiles -> brightness temperatures.

    profiles (B, L) x elevations (E) x frequencies (F)  ->  TB (B, E, F)

with the total slant opacity, the mean radiating temperature and, on request,
the ground-to-level transmittance as secondary outputs.  Profiles enter
ground -> top (ascending z); `flip_profile` reverses the level axis.

`forward_batch` transposes the profiles once to the (L, B) layout and runs
three stages: absorption (kernel K1), the refractive index (plain torch) and
geometry + RTE (kernel K2).  On CUDA tensors the stages launch the kernels;
on CPU tensors, or with `use_kernels=False`, they run the plain versions.
"""

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..constants import CLIMATOLOGIES, hatpro
from ..ops import geometry, rte, thermo
from ..ops.absorption import total_absorption
from ..ops.cuda.absorption import (absorption_lb, absorption_lb_reference,
                                   line_tables)
from ..ops.cuda.rte import forward_lb, forward_lb_reference
from ..ops.tensors import input_device, resolve_device


@dataclasses.dataclass(frozen=True)
class LBLConfig:
    """Static configuration of the LBL forward operator."""

    model: str = "R24"
    freqs_ghz: tuple = tuple(hatpro.HATPRO_FREQS_GHZ.tolist())
    elevations_deg: tuple = tuple(hatpro.ELEVATIONS_DEG.tolist())
    include_liquid: bool = True
    dtype: str = "float32"
    # Launch the CUDA kernels on CUDA tensors (they are float32 only).  False
    # runs the plain torch versions on any device, for comparisons.
    use_kernels: bool = True
    # trans_level is (B, E, F, L), by far the largest output; ask only for
    # what is needed.
    outputs: tuple = ("tb", "tau_total", "t_mr", "trans_level")
    # Add ozone absorption from the profiles' "o3_ppmv" entry, falling back
    # to the AFGL mid-latitude summer profile interpolated in z.
    include_o3: bool = False


def flip_profile(profile: dict) -> dict:
    """Reverse the level axis (last axis) of every per-level variable."""
    return {k: torch.flip(v, dims=(-1,)) for k, v in profile.items()}


def forward_single(z_m, p_hpa, t_k, rho_gm3, lwc_gm3, f_ghz, elevation_deg,
                   model: str = "R24", o3_ppmv=None):
    """TB and opacity diagnostics for ONE profile at ONE elevation, in plain
    torch.

    z_m, p_hpa, t_k, rho_gm3, lwc_gm3 (or None), o3_ppmv (or None): (L,)
    level tensors, ground -> top; f_ghz (F,).  Returns tb, tau_total, t_mr
    (F,) and trans_level (F, L).
    """
    e_hpa = thermo.rho_to_e(rho_gm3, t_k)
    alpha = total_absorption(
        f_ghz[:, None], p_hpa[None, :], t_k[None, :], rho_gm3[None, :],
        lwc_gm3[None, :] if lwc_gm3 is not None else None, model=model,
        o3_ppmv=o3_ppmv[None, :] if o3_ppmv is not None else None)
    ds_km = geometry.slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg)
    return rte.downwelling_tb(alpha, ds_km, t_k, f_ghz)


def _interp(x, xp, fp):
    """Piecewise-linear interpolation with constant ends (numpy.interp)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    y0, y1 = fp[i - 1], fp[i]
    y = y0 + (x - x0) / (x1 - x0) * (y1 - y0)
    y = torch.where(x < xp[0], fp[0], y)
    return torch.where(x > xp[-1], fp[-1], y)


def _afgl_o3(z_m):
    clim = CLIMATOLOGIES["midlatitude_summer"]
    xp, fp = (torch.as_tensor(clim[k], dtype=z_m.dtype, device=z_m.device)
              for k in ("z_km", "o3_ppmv"))
    return _interp(z_m / 1000.0, xp, fp)


def level_major_profiles(profiles: dict, config: LBLConfig) -> dict:
    """z, p, t, rho and lwc of (B, L) profiles as contiguous (L, B) tensors
    of `config.dtype` on the profiles' device (`input_device`: tensors stay
    where they are, numpy arrays go to the card); lwc is zero when absent
    or when `config.include_liquid` is off."""
    dtype = getattr(torch, config.dtype)
    device = input_device(profiles["p"])

    def level_major(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).T.contiguous()

    out = {k: level_major(profiles[k]) for k in ("z", "p", "t", "rho")}
    lwc = profiles.get("lwc")
    out["lwc"] = (torch.zeros_like(out["rho"])
                  if lwc is None or not config.include_liquid
                  else level_major(lwc))
    return out


def forward_batch(profiles: dict, config: LBLConfig = LBLConfig(),
                  tables=None):
    """Vectorized forward: dict of (B, L) tensors -> dict of batched outputs.

    profiles: "z" [m], "p" [hPa], "t" [K], "rho" [g/m^3], optionally "lwc"
      [g/m^3] and "o3_ppmv"; each (B, L), levels ground -> top, all on one
      device.  Tensors are used where they lie (CPU tensors run the plain
      path on the CPU); numpy arrays are copied to the CUDA card, and raise
      RuntimeError where there is none.
    tables: the packed line table of the absorption kernel for this model
      (`LBLOperator` holds it as a buffer); built and cached when None.

    Returns the outputs named in `config.outputs`: tb, tau_total, t_mr
    (B, E, F) and trans_level (B, E, F, L).
    """
    dtype = getattr(torch, config.dtype)
    device = input_device(profiles["p"])
    if config.use_kernels and device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"the CUDA kernels are float32 only; got dtype "
                         f"{config.dtype!r} (use_kernels=False runs the plain "
                         f"torch path in any dtype)")
    z, p, t, rho, lwc = level_major_profiles(profiles, config).values()
    o3 = None
    if config.include_o3:
        o3 = profiles.get("o3_ppmv")
        o3 = (_afgl_o3(z) if o3 is None
              else torch.as_tensor(o3).to(z).T.contiguous())

    want_trans = "trans_level" in config.outputs
    if config.use_kernels:
        alpha = absorption_lb(config.freqs_ghz, p, t, rho, lwc, config.model,
                              o3=o3, tables=tables)
    else:
        alpha = absorption_lb_reference(config.freqs_ghz, p, t, rho, lwc,
                                        config.model, o3=o3)
    n = geometry.refractive_index(p, t, thermo.rho_to_e(rho, t))
    rte_fn = forward_lb if config.use_kernels else forward_lb_reference
    stacked = rte_fn(config.freqs_ghz, config.elevations_deg, alpha, z, n, t,
                     want_trans_level=want_trans)
    # back to the public (B, E, F[, L]) layout
    return {k: (v.permute(3, 0, 1, 2) if k == "trans_level"
                else v.permute(2, 0, 1)).contiguous()
            for k, v in stacked.items() if k in config.outputs}


def forward_all_models(profiles: dict, config: LBLConfig = LBLConfig(),
                       models: Sequence[str] = ("R98", "R17", "R20", "R24")):
    """TBs for several absorption models; returns {model: tb (B, E, F)}."""
    out = {}
    for m in models:
        cfg = dataclasses.replace(config, model=m, outputs=("tb",),
                                  include_o3=False)
        out[m] = forward_batch(profiles, cfg)["tb"]
    return out


class LBLOperator(nn.Module):
    """The LBL forward operator as a module.  Its parameters are the
    spectroscopy tables, held as the buffer `tables` in the packed layout
    the absorption kernel reads, on `device` (the CUDA card when None;
    RuntimeError where there is none: `device="cpu"` asks for the CPU)."""

    def __init__(self, config: LBLConfig = LBLConfig(), device=None):
        super().__init__()
        self.config = config
        self.register_buffer("tables", line_tables(
            config.model, config.include_o3, resolve_device(device)).clone())

    def forward(self, profiles: dict) -> dict:
        tables = self.tables if self.tables.is_cuda else None
        return forward_batch(profiles, self.config, tables=tables)


def demo_profile(n_levels: int = hatpro.N_LEVELS, seed: int = 0,
                 device=None, dtype=torch.float32) -> dict:
    """A physically plausible synthetic midlatitude profile (ground -> top)
    on `device`: the CUDA card when None (RuntimeError where there is none),
    the CPU on `device="cpu"`.

    The numbers are those of the JAX package's `demo_profile` with the same
    seed: made in numpy, rounded to float32, then cast to `dtype`.
    """
    rng = np.random.default_rng(seed)
    z = np.linspace(0.0, 25_000.0, n_levels)
    t = (288.0 - 6.5e-3 * np.minimum(z, 11_000.0)
         - 0.0005e-3 * np.maximum(z - 11_000.0, 0))
    t = t + rng.normal(0, 0.5, n_levels).cumsum() * 0.05
    p = 1013.0 * np.exp(-z / 7800.0)
    rh = np.clip(75.0 - z / 1000.0 * 2.0 + rng.normal(0, 3.0, n_levels),
                 2.0, 98.0)
    e = rh / 100.0 * 6.1078 * np.exp(17.08085 * (t - 273.15)
                                     / (234.175 + (t - 273.15)))
    rho = 216.679 * e / t
    lwc = np.zeros(n_levels)
    lwc[(z > 1000.0) & (z < 1600.0)] = 0.2
    device = resolve_device(device)
    return {k: torch.as_tensor(v.astype(np.float32)).to(device=device,
                                                        dtype=dtype)
            for k, v in dict(z=z, p=p, t=t, rho=rho, lwc=lwc).items()}


def demo_batch(batch: int, n_levels: int = hatpro.N_LEVELS, seed: int = 0,
               device=None, dtype=torch.float32) -> dict:
    """`batch` demo profiles with seeds seed, seed+1, ...; each (B, L), on
    `device` as in `demo_profile`."""
    device = resolve_device(device)
    profs = [demo_profile(n_levels, seed + i, "cpu", dtype)
             for i in range(batch)]
    return {k: torch.stack([q[k] for q in profs]).to(device)
            for k in profs[0]}
