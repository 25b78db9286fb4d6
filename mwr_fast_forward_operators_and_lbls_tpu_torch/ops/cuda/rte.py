"""Slant-path RTE kernel K2 (`csrc/rte.cu`), its wrapper and plain version.

`forward_lb` maps level absorption (F, L, B), heights, refractive indices and
temperatures (L, B) to tb, tau_total, t_mr (E, F, B) and optionally
trans_level (E, F, L, B).  On CPU tensors it runs `forward_lb_reference`; on
CUDA tensors it launches the kernel or raises.
"""

import functools

import torch

from ...constants import physics as phys
from .. import geometry, rte
from ..tensors import constant_vector
from . import _build


def _cos_elevations(elevations, dtype, device) -> torch.Tensor:
    el = torch.as_tensor(elevations, dtype=dtype, device=device)
    return torch.cos(torch.deg2rad(el))


@functools.lru_cache(maxsize=64)
def _device_cos(elevations: tuple, device) -> torch.Tensor:
    return _cos_elevations(elevations, torch.float32, device)


def forward_lb_reference(freqs, elevations, alpha, z, n, t,
                         alpha_is_mid: bool = False,
                         want_trans_level: bool = False):
    """Plain version of K2: `geometry.chord_lengths` stacked over the
    elevations (the body of `slant_path_lengths_lb`), then
    `rte.downwelling_tb_lb_multi` or `..._from_alpha_mid`."""
    cos_el = _cos_elevations(elevations, z.dtype, z.device)
    ds = torch.stack([geometry.chord_lengths(z, n, c) for c in cos_el])
    f = torch.as_tensor(freqs, dtype=alpha.dtype, device=alpha.device)
    rte_fn = (rte.downwelling_tb_lb_from_alpha_mid if alpha_is_mid
              else rte.downwelling_tb_lb_multi)
    return rte_fn(alpha, ds, t, f, want_trans_level=want_trans_level)


def _check_inputs(freqs, alpha, levels: dict, alpha_is_mid: bool):
    ref = levels["z"]
    for name, a in dict(alpha=alpha, **levels).items():
        if not a.is_cuda or a.dtype != torch.float32:
            raise TypeError(f"{name}: the RTE kernel takes float32 CUDA "
                            f"tensors, got {a.dtype} on {a.device}")
        if a.device != ref.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ref.device}")
    if ref.ndim != 2 or ref.shape[0] < 2:
        raise ValueError(f"z: expected (L, B) with L >= 2, got "
                         f"{tuple(ref.shape)}")
    for name, a in levels.items():
        if a.shape != ref.shape:
            raise ValueError(f"{name}: expected {tuple(ref.shape)}, got "
                             f"{tuple(a.shape)}")
    lev, batch = ref.shape
    want = (len(freqs), lev - 1 if alpha_is_mid else lev, batch)
    if tuple(alpha.shape) != want:
        raise ValueError(f"alpha: expected {want}, got {tuple(alpha.shape)}")


def forward_lb(freqs, elevations, alpha, z, n, t, alpha_is_mid: bool = False,
               want_trans_level: bool = False):
    """Geometry and multi-elevation downwelling RTE.

    freqs (F channels [GHz]) and elevations (E angles [deg]) are sequences.
    alpha is (F, L, B) level absorption [Np/km], or (F, L-1, B) layer-mean
    extinction when `alpha_is_mid`; z [m], n (refractive index) and t [K]
    are (L, B).  Returns tb, tau_total, t_mr (E, F, B) and, when
    `want_trans_level`, trans_level (E, F, L, B).
    """
    if alpha.device.type == "cpu":
        return forward_lb_reference(freqs, elevations, alpha, z, n, t,
                                    alpha_is_mid, want_trans_level)
    _check_inputs(freqs, alpha, dict(z=z, n=n, t=t), alpha_is_mid)
    lev, batch = z.shape
    n_el, n_ch = len(elevations), len(freqs)
    dev = z.device
    cos_el = _device_cos(tuple(float(v) for v in elevations), dev)
    f = constant_vector(freqs, torch.float32, dev)
    out = {k: torch.empty((n_el, n_ch, batch), dtype=torch.float32,
                          device=dev)
           for k in ("tb", "tau_total", "t_mr")}
    if want_trans_level:
        out["trans_level"] = torch.empty((n_el, n_ch, lev, batch),
                                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().mwr_forward_lb(
            cos_el.data_ptr(), f.data_ptr(), alpha.data_ptr(), z.data_ptr(),
            n.data_ptr(), t.data_ptr(), n_el, n_ch, lev, batch,
            int(alpha_is_mid), phys.HK_GHZ, phys.T_COSMIC, phys.EARTH_RADIUS,
            out["tb"].data_ptr(), out["tau_total"].data_ptr(),
            out["t_mr"].data_ptr(),
            out["trans_level"].data_ptr() if want_trans_level else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"RTE kernel launch failed: CUDA error {err}")
    forward_lb.launches += 1
    return out


forward_lb.launches = 0
