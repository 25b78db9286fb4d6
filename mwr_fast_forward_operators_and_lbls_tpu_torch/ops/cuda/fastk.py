"""The fast operator's closed-form K (`csrc/fastk.cu`): from the profiles
and the regression's weights, the layer-mean extinction and its partials,
the slant geometry, the RTE adjoint and its assembly into K_t and K_rho; its
wrapper and its plain version.

`fastk_adjoint` takes the (B, L) profiles z, p, t, rho, lwc, the weights w
(72, C), the channels and the elevations, and returns {name: K (B, E, C, L)}
for each name of `wrt` in {"t", "rho"}.  By the package's rule
(`ops.cuda.launches`) it launches the kernel, one launch in place of the
plain version's prologue of some 180 operations
(`models/jacobians.py::fast_k_inputs`) and adjoint of 179, 94 of which
write a full (B, E, C, L-1) tensor or larger, or runs that plain version.
"""

import functools

import numpy as np
import torch

from ...constants import physics as phys
from .. import geometry, rte
from ..spans import span
from ..tensors import constant_vector
from . import _build, count_launch, launches
from .rte import _device_cos

FASTK_WRT = ("t", "rho")
# the kernel runs one warp an elevation in a block of at most 1024 threads
MAX_ELEVATIONS = 32
# the regression's features: 18 monomials times 4 hats of log p
N_FEATURES = 72


def _spread(a):
    """Layer field (..., K) -> level field (..., K + 1): each level takes
    half of the layers around it, as x_mid = (x_l + x_{l+1}) / 2."""
    zeros = torch.zeros_like(a[..., :1])
    return 0.5 * (torch.cat([a, zeros], -1) + torch.cat([zeros, a], -1))


def fastk_adjoint_reference(freqs, alpha_mid, d_tm, d_rm, ds, dds_dnl,
                            dds_dk, t, dn_t, dn_rho, r0cos, wrt=FASTK_WRT):
    """Plain version of `fastk_adjoint`, in the inputs' dtype: dTB/d(alpha
    mid, t, ds) from `rte.downwelling_tb_adjoint_mid`, then each layer's
    partial d_tm or d_rm applied and spread to the levels, the Planck term
    for t, and the refraction terms: the tridiagonal dds_dnl spread times
    dn plus the rank-one sum of dds_dk at level 0 times r0cos dn[0]."""
    f = constant_vector(freqs, t.dtype, t.device)
    with span("fastk.rte_adjoint"):
        g_mid, g_t, g_ds = rte.downwelling_tb_adjoint_mid(
            alpha_mid.transpose(1, 2), ds, t, f)              # (B,E,C,.)
    with span("fastk.assembly"):
        dn = {"t": dn_t, "rho": dn_rho}
        out = {}
        if "t" in wrt:
            out["t"] = _spread(g_mid * d_tm.transpose(1, 2)[:, None]) + g_t
        if "rho" in wrt:
            out["rho"] = _spread(g_mid * d_rm.transpose(1, 2)[:, None])
        c = _spread(g_ds * dds_dnl[:, :, None])               # (B,E,C,L)
        s_k = torch.sum(g_ds * dds_dk[:, :, None], dim=-1)    # (B, E, C)
        for name in out:
            g = c * dn[name][:, None, None, :]
            g[..., 0] += s_k * (r0cos * dn[name][:, :1])[:, :, None]
            out[name] = out[name] + g
        return out


@functools.lru_cache(maxsize=8)
def _knots(device) -> torch.Tensor:
    """The hats' knots of log p, their lower and their upper neighbours
    (`models/fast.py::_knots`), 12 float32 values on `device`."""
    from ...models import fast
    k = np.asarray(fast._LOGP_KNOTS)
    lo = np.concatenate([[k[0] - 100.0], k[:-1]])
    hi = np.concatenate([k[1:], [k[-1] + 100.0]])
    return constant_vector(np.concatenate([k, lo, hi]), torch.float32,
                           device)


def _check_inputs(freqs, elevations, w, profiles: dict, wrt):
    t = profiles["t"]
    if not set(wrt) <= set(FASTK_WRT) or not wrt:
        raise ValueError(f"wrt must name some of {FASTK_WRT}, got {wrt}")
    if t.ndim != 2 or t.shape[1] < 2:
        raise ValueError(f"t: expected (B, L) with L >= 2, got "
                         f"{tuple(t.shape)}")
    for name, a in profiles.items():
        if a.device != t.device or a.dtype != t.dtype:
            raise ValueError(f"{name} must be {t.dtype} on {t.device}")
        if a.shape != t.shape:
            raise ValueError(f"{name}: expected {tuple(t.shape)}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous() and not (name == "t" and a.stride(1) == 1):
            raise ValueError(f"{name} must be contiguous (t along L only)")
    n_ch = len(freqs)
    if (tuple(w.shape) != (N_FEATURES, n_ch) or w.dtype != torch.float32
            or w.device != t.device):
        raise ValueError(f"w: expected float32 ({N_FEATURES}, {n_ch}) on "
                         f"{t.device}, got {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}")
    if not 1 <= len(elevations) <= MAX_ELEVATIONS:
        raise ValueError(f"the fast-K kernel takes 1 to {MAX_ELEVATIONS} "
                         f"elevations, got {len(elevations)}")
    if t.shape[0] * n_ch >= 2 ** 31:
        raise ValueError(f"B * C = {t.shape[0] * n_ch} out of range")


def fastk_adjoint(freqs, elevations, w, z, p, t, rho, lwc, wrt=FASTK_WRT,
                  use_kernels: bool = True):
    """K_t and K_rho of the fast operator, {name: (B, E, C, L)} for each
    name of `wrt` (in {"t", "rho"}).

    freqs: C channel frequencies [GHz]; elevations: E scan elevations
    [deg]; w (72, C) the regression's weights; z [m], p [hPa], t [K], rho
    [g/m^3], lwc [g/m^3] the (B, L) profiles.

    The kernel or the plain version by `launches(t, use_kernels)`.  The
    plain version is `jacobians.fast_k_inputs` then
    `fastk_adjoint_reference`, in the profiles' dtype.  The kernel takes
    float32 profiles on the card, contiguous (t along L only, so t may be a
    slice of a wider state), and float32 weights there, in any strides
    (`fast.fit_closed_form` returns them column-major).
    """
    profiles = dict(z=z, p=p, t=t, rho=rho, lwc=lwc)
    if not launches(t, use_kernels):
        from ...models.jacobians import fast_k_inputs
        k = fast_k_inputs({"w": w}, profiles, elevations)
        return fastk_adjoint_reference(freqs, **k, wrt=wrt)
    with span("cuda.fastk_adjoint"):
        _check_inputs(freqs, elevations, w, profiles, wrt)
        dev = t.device
        batch, lev = t.shape
        n_el, n_ch = len(elevations), len(freqs)
        out = {name: torch.empty((batch, n_el, n_ch, lev),
                                 dtype=torch.float32, device=dev)
               for name in FASTK_WRT if name in wrt}
        f = constant_vector(freqs, torch.float32, dev)
        cos_el = _device_cos(tuple(float(v) for v in elevations), dev)

        def ptr(name):
            return out[name].data_ptr() if name in out else None

        with torch.cuda.device(dev):
            err = _build.library().mwr_fastk_adjoint(
                f.data_ptr(), _knots(dev).data_ptr(), w.data_ptr(),
                w.stride(0), w.stride(1), cos_el.data_ptr(), z.data_ptr(),
                p.data_ptr(), t.data_ptr(),
                t.stride(0) if batch > 1 else lev, rho.data_ptr(),
                lwc.data_ptr(), batch, n_el, n_ch, lev, phys.HK_GHZ,
                phys.T_COSMIC, phys.RV, phys.EARTH_RADIUS, geometry._K1,
                geometry._K2, geometry._K3, ptr("t"), ptr("rho"),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"fast-K kernel launch failed: CUDA error "
                               f"{err}")
        count_launch(fastk_adjoint)
        return out


fastk_adjoint.launches = 0
