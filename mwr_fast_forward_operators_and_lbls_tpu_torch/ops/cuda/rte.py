"""RTE kernels K2 and K3 (`csrc/rte.cu`), their wrappers and plain
versions.

`forward_lb` (K2) maps level absorption (F, L, B), heights, refractive
indices and temperatures (L, B) to tb, tau_total, t_mr (E, F, B) and
optionally trans_level (E, F, L, B).  `downwelling_lb` (K3) maps the same
absorption, given slant paths (E, L-1, B) and temperatures to the same
outputs.  On CPU tensors each runs its plain version; on CUDA tensors it
launches its kernel or raises.

K2 has one body in `csrc/rte.cu`, the staged one: it streams alpha through
shared memory and computes each chord, in float64, once per block of 16
profiles and up to 16 channels.  Only the size of its asynchronous copies
follows alpha's alignment (`forward_lb_body`), the numbers do not.  K3 is
the same body on given paths, with a body of one thread per (elevation,
frequency, profile) for the calls the staged one does not take (the
docstring of `downwelling_lb`).  A launch that is refused raises.
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
def _device_cos(elevations: tuple, device):
    """cos(elevation) on `device` in float64, as K2's chords take it."""
    return _cos_elevations(elevations, torch.float64, device)


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


def _frequency_vector(freqs, device) -> torch.Tensor:
    """The channel vector the RTE kernels read: a float32 tensor on `device`
    as it is, or a sequence made into one (and cached, for the few channels
    of a radiometer)."""
    if not torch.is_tensor(freqs):
        return constant_vector(freqs, torch.float32, device)
    if (freqs.device != device or freqs.dtype != torch.float32
            or freqs.ndim != 1 or not freqs.is_contiguous()):
        raise ValueError(f"freqs: expected a contiguous 1-D float32 tensor "
                         f"on {device}, got {tuple(freqs.shape)} "
                         f"{freqs.dtype} on {freqs.device}")
    return freqs


def _check_inputs(n_ch, alpha, levels: dict, alpha_is_mid: bool,
                  ds_km=None):
    """Check the inputs of K2 (levels z, n, t) or K3 (levels t and the
    paths ds_km)."""
    ref = levels["t"]
    arrays = dict(alpha=alpha, **levels)
    if ds_km is not None:
        arrays["ds_km"] = ds_km
    for name, a in arrays.items():
        if not a.is_cuda or a.dtype != torch.float32:
            raise TypeError(f"{name}: the RTE kernel takes float32 CUDA "
                            f"tensors, got {a.dtype} on {a.device}")
        if a.device != ref.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ref.device}")
    if ref.ndim != 2 or ref.shape[0] < 2:
        raise ValueError(f"t: expected (L, B) with L >= 2, got "
                         f"{tuple(ref.shape)}")
    for name, a in levels.items():
        if a.shape != ref.shape:
            raise ValueError(f"{name}: expected {tuple(ref.shape)}, got "
                             f"{tuple(a.shape)}")
    lev, batch = ref.shape
    want = (n_ch, lev - 1 if alpha_is_mid else lev, batch)
    if tuple(alpha.shape) != want:
        raise ValueError(f"alpha: expected {want}, got {tuple(alpha.shape)}")
    if ds_km is not None and (ds_km.ndim != 3
                              or ds_km.shape[1:] != (lev - 1, batch)):
        raise ValueError(f"ds_km: expected (E, {lev - 1}, {batch}), got "
                         f"{tuple(ds_km.shape)}")


def _outputs(n_el, n_ch, lev, batch, want_trans_level, device) -> dict:
    out = {k: torch.empty((n_el, n_ch, batch), dtype=torch.float32,
                          device=device)
           for k in ("tb", "tau_total", "t_mr")}
    if want_trans_level:
        out["trans_level"] = torch.empty((n_el, n_ch, lev, batch),
                                         dtype=torch.float32, device=device)
    return out


def forward_lb_body(alpha, n_elevations: int,
                    alpha_is_mid: bool = False) -> str:
    """How a call of `forward_lb` on this alpha (F, L or L-1, B) runs:
    "plain" for a CPU tensor; on the card "staged" when B is a multiple of 4
    and alpha's first element lies on a 16-byte boundary (any tensor that
    owns its storage), "staged, 4-byte copies" otherwise: the same body with
    the same arithmetic, filled by smaller asynchronous copies.  Raises
    ValueError for a shape the body refuses (more than about 1,700 levels).
    A pure function of the shape and the pointer."""
    if alpha.device.type == "cpu":
        return "plain"
    n_ch, rows, batch = alpha.shape
    lev = rows + 1 if alpha_is_mid else rows
    piece = _build.library().mwr_forward_lb_copy_bytes(
        alpha.data_ptr(), n_elevations, n_ch, lev, batch)
    if not piece:
        raise ValueError(
            f"the RTE kernel keeps a block's columns in shared memory and "
            f"takes no shape E={n_elevations} F={n_ch} L={lev}: split the "
            f"levels or the elevations, or run the plain version "
            f"(forward_lb_reference)")
    return "staged" if piece == 16 else "staged, 4-byte copies"


def forward_lb(freqs, elevations, alpha, z, n, t, alpha_is_mid: bool = False,
               want_trans_level: bool = False):
    """Geometry and multi-elevation downwelling RTE.

    freqs (F channels [GHz]) is a sequence or a float32 tensor on alpha's
    device; elevations (E angles [deg]) a sequence.
    alpha is (F, L, B) level absorption [Np/km], or (F, L-1, B) layer-mean
    extinction when `alpha_is_mid`; z [m], n (refractive index) and t [K]
    are (L, B).  Returns tb, tau_total, t_mr (E, F, B) and, when
    `want_trans_level`, trans_level (E, F, L, B).

    On the card the chords are taken in float64, which at low elevations
    is closer to float64 than the plain float32 version (at 4.2 degrees TB
    within 5e-4 K, against 2e-3 K); what the call returns does not depend on
    alpha's alignment (`forward_lb_body`).  A shape the kernel refuses
    raises ValueError.
    """
    if alpha.device.type == "cpu":
        return forward_lb_reference(freqs, elevations, alpha, z, n, t,
                                    alpha_is_mid, want_trans_level)
    dev = t.device
    f = _frequency_vector(freqs, dev)
    _check_inputs(f.numel(), alpha, dict(t=t, z=z, n=n), alpha_is_mid)
    lev, batch = t.shape
    n_el, n_ch = len(elevations), f.numel()
    cos_el64 = _device_cos(tuple(float(v) for v in elevations), dev)
    out = _outputs(n_el, n_ch, lev, batch, want_trans_level, dev)
    with torch.cuda.device(dev):
        err = _build.library().mwr_forward_lb(
            cos_el64.data_ptr(), f.data_ptr(), alpha.data_ptr(),
            z.data_ptr(), n.data_ptr(), t.data_ptr(), n_el, n_ch, lev, batch,
            int(alpha_is_mid), phys.HK_GHZ, phys.T_COSMIC, phys.EARTH_RADIUS,
            out["tb"].data_ptr(), out["tau_total"].data_ptr(),
            out["t_mr"].data_ptr(),
            out["trans_level"].data_ptr() if want_trans_level else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        forward_lb_body(alpha, n_el, alpha_is_mid)    # names a refused shape
        raise RuntimeError(f"RTE kernel launch failed: CUDA error {err}")
    forward_lb.launches += 1
    return out


forward_lb.launches = 0


def downwelling_lb_reference(freqs, alpha, ds_km, t,
                             alpha_is_mid: bool = False,
                             want_trans_level: bool = False):
    """Plain version of K3: `rte.downwelling_tb_lb_multi` or
    `..._from_alpha_mid`."""
    f = torch.as_tensor(freqs, dtype=alpha.dtype, device=alpha.device)
    rte_fn = (rte.downwelling_tb_lb_from_alpha_mid if alpha_is_mid
              else rte.downwelling_tb_lb_multi)
    return rte_fn(alpha, ds_km, t, f, want_trans_level=want_trans_level)


def downwelling_lb(freqs, alpha, ds_km, t, alpha_is_mid: bool = False,
                   want_trans_level: bool = False):
    """Multi-elevation downwelling RTE on given slant paths.

    freqs: F frequencies [GHz], a sequence or a float32 tensor on alpha's
    device.  alpha is (F, L, B) level absorption [Np/km], or (F, L-1, B)
    layer-mean extinction when `alpha_is_mid`; ds_km (E, L-1, B) slant path
    lengths [km]; t (L, B) [K].  Returns tb, tau_total, t_mr (E, F, B) and,
    when `want_trans_level`, trans_level (E, F, L, B).

    K3 has two bodies (`csrc/rte.cu::staged_takes` decides between them):
    without trans_level, with B a multiple of 4, L up to 780 and
    alpha's first element on a 16-byte boundary (any tensor that owns its
    storage; a contiguous view that starts elsewhere may not be), alpha is
    streamed through shared memory by 16-byte copies.  Every other call
    takes the body of one thread per (elevation, frequency, profile), at
    about twice the time.  Both raise when their launch is refused.
    """
    if alpha.device.type == "cpu":
        return downwelling_lb_reference(freqs, alpha, ds_km, t, alpha_is_mid,
                                        want_trans_level)
    dev = t.device
    f = _frequency_vector(freqs, dev)
    _check_inputs(f.numel(), alpha, dict(t=t), alpha_is_mid, ds_km)
    lev, batch = t.shape
    n_el, n_ch = ds_km.shape[0], f.numel()
    out = _outputs(n_el, n_ch, lev, batch, want_trans_level, dev)
    with torch.cuda.device(dev):
        err = _build.library().mwr_downwelling_lb(
            f.data_ptr(), alpha.data_ptr(), ds_km.data_ptr(), t.data_ptr(),
            n_el, n_ch, lev, batch, int(alpha_is_mid), phys.HK_GHZ,
            phys.T_COSMIC, out["tb"].data_ptr(), out["tau_total"].data_ptr(),
            out["t_mr"].data_ptr(),
            out["trans_level"].data_ptr() if want_trans_level else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"RTE kernel launch failed: CUDA error {err}")
    downwelling_lb.launches += 1
    return out


downwelling_lb.launches = 0


def staged_resident_warps(n_levels: int, alpha_is_mid: bool = False,
                          kernel: str = "K3", n_channels: int = 14,
                          want_trans_level: bool = False,
                          wide_copies: bool = True) -> int:
    """Warps of the staged body that the current CUDA device keeps resident
    per SM at `n_levels` levels, from the occupancy calculator: K3's, or
    with kernel="K2" that of `forward_lb` at `n_channels` channels, with
    16-byte copies or (K2 only) 4-byte ones."""
    warps = _build.library().mwr_staged_resident_warps(
        {"K3": 0, "K2": 1}[kernel], n_channels, n_levels, int(alpha_is_mid),
        int(want_trans_level), int(wide_copies))
    if warps < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-warps}")
    return warps
