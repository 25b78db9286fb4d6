"""The fast operator's closed-form K (`csrc/fastk.cu`): the RTE adjoint and
its assembly into K_t and K_rho, its wrapper and its plain version.

`fastk_adjoint` takes what the torch prologue of
`jacobians.kmatrix_fast_adjoint_batch` makes (the layer-mean extinction and
its partials, the chords and their sensitivities, the profiles'
temperatures and refractive-index partials) and returns {name: K (B, E, C,
L)} for each name of `wrt` in {"t", "rho"}.  It launches the kernel, one
launch in place of the plain version's 179 operations, 94 of which write a
full (B, E, C, L-1) tensor or larger, or runs the plain version by the
package's rule (`ops.cuda.launches`).
"""

import torch

from ...constants import physics as phys
from .. import rte
from ..spans import span
from ..tensors import constant_vector
from . import _build, launches

FASTK_WRT = ("t", "rho")
# the kernel runs one warp an elevation in a block of at most 1024 threads
MAX_ELEVATIONS = 32


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


def _check_inputs(freqs, arrays: dict, wrt):
    t = arrays["t"]
    if not set(wrt) <= set(FASTK_WRT) or not wrt:
        raise ValueError(f"wrt must name some of {FASTK_WRT}, got {wrt}")
    for name, a in arrays.items():
        if a.device != t.device or a.dtype != t.dtype:
            raise ValueError(f"{name} must be {t.dtype} on {t.device}")
        if not a.is_contiguous() and not (name == "t" and a.stride(1) == 1):
            raise ValueError(f"{name} must be contiguous (t along L only)")
    if t.ndim != 2 or t.shape[1] < 2:
        raise ValueError(f"t: expected (B, L) with L >= 2, got "
                         f"{tuple(t.shape)}")
    batch, lev = t.shape
    n_el, n_ch = arrays["r0cos"].shape[-1], len(freqs)
    if not 1 <= n_el <= MAX_ELEVATIONS:
        raise ValueError(f"the fast-K kernel takes 1 to {MAX_ELEVATIONS} "
                         f"elevations, got {n_el}")
    layers, chords, levels = ((batch, lev - 1, n_ch), (batch, n_el, lev - 1),
                              (batch, lev))
    want = {"alpha_mid": layers, "d_tm": layers, "d_rm": layers,
            "ds": chords, "dds_dnl": chords, "dds_dk": chords, "t": levels,
            "dn_t": levels, "dn_rho": levels, "r0cos": (batch, n_el)}
    for name, a in arrays.items():
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name}: expected {want[name]}, got "
                             f"{tuple(a.shape)}")
    if batch * n_ch >= 2 ** 31:
        raise ValueError(f"B * C = {batch * n_ch} out of range")


def fastk_adjoint(freqs, alpha_mid, d_tm, d_rm, ds, dds_dnl, dds_dk, t,
                  dn_t, dn_rho, r0cos, wrt=FASTK_WRT,
                  use_kernels: bool = True):
    """K_t and K_rho of the fast operator, {name: (B, E, C, L)} for each
    name of `wrt` (in {"t", "rho"}).

    freqs: C channel frequencies [GHz].  alpha_mid (B, L-1, C) layer-mean
    extinction [Np/km], d_tm and d_rm (B, L-1, C) its partials in the
    layer-mean temperature and vapor density; ds, dds_dnl, dds_dk (B, E,
    L-1) the chords [km] and their sensitivities to the layer's refractive
    index and to the Snell invariant; t (B, L) [K]; dn_t, dn_rho (B, L)
    d(refractive index)/d(t, rho); r0cos (B, E) = (R_E + z_0) cos(el).  A
    partial that `wrt` does not need (d_tm, dn_t for t; d_rm, dn_rho for
    rho) may be None.

    The kernel or the plain version by `launches(t, use_kernels)`.  The
    kernel takes contiguous arrays (t along L only); the chords are made so
    here.
    """
    if not launches(t, use_kernels):
        return fastk_adjoint_reference(freqs, alpha_mid, d_tm, d_rm, ds,
                                       dds_dnl, dds_dk, t, dn_t, dn_rho,
                                       r0cos, wrt)
    if not ds.shape == dds_dnl.shape == dds_dk.shape:
        raise ValueError(f"ds, dds_dnl, dds_dk: expected one shape, got "
                         f"{[tuple(a.shape) for a in (ds, dds_dnl, dds_dk)]}")
    # contiguous (B, E, K), as the kernel reads the chords along K
    ds, dds_dnl, dds_dk = torch.stack((ds, dds_dnl, dds_dk)).unbind(0)
    with span("cuda.fastk_adjoint"):
        arrays = dict(alpha_mid=alpha_mid, ds=ds, dds_dnl=dds_dnl,
                      dds_dk=dds_dk, t=t, r0cos=r0cos)
        if "t" in wrt:
            arrays.update(d_tm=d_tm, dn_t=dn_t)
        if "rho" in wrt:
            arrays.update(d_rm=d_rm, dn_rho=dn_rho)
        _check_inputs(freqs, arrays, wrt)
        dev = t.device
        batch, lev = t.shape
        n_el, n_ch = r0cos.shape[1], len(freqs)
        out = {name: torch.empty((batch, n_el, n_ch, lev),
                                 dtype=torch.float32, device=dev)
               for name in FASTK_WRT if name in wrt}
        f = constant_vector(freqs, torch.float32, dev)

        def ptr(a):
            return None if a is None else a.data_ptr()

        with torch.cuda.device(dev):
            err = _build.library().mwr_fastk_adjoint(
                f.data_ptr(), alpha_mid.data_ptr(), ptr(arrays.get("d_tm")),
                ptr(arrays.get("d_rm")), ds.data_ptr(), dds_dnl.data_ptr(),
                dds_dk.data_ptr(), t.data_ptr(),
                t.stride(0) if batch > 1 else lev,
                ptr(arrays.get("dn_t")), ptr(arrays.get("dn_rho")),
                r0cos.data_ptr(), batch, n_el, n_ch, lev, phys.HK_GHZ,
                phys.T_COSMIC, ptr(out.get("t")), ptr(out.get("rho")),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"fast-K kernel launch failed: CUDA error "
                               f"{err}")
        fastk_adjoint.launches += 1
        return out


fastk_adjoint.launches = 0
