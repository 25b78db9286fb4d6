"""K-matrix adjoint-and-assembly kernel K5 (`csrc/adjoint.cu`), its two
wrappers and their plain versions.

`kmatrix_assembled_lb` returns one assembled K-matrix variable (t, rho or
lwc) and `kmatrix_assembled_rho_lwc_lb` returns k_rho and k_lwc from one
shared adjoint core, each (E, F, L, B).  On CPU tensors they run the plain
versions; on CUDA tensors they launch the kernel or raise.
"""

import torch
import torch.nn.functional as nnf

from ...constants import physics as phys
from .. import rte
from ..tensors import constant_vector
from . import _build

# the kernel's `mode` argument (csrc/adjoint.cu::mwr_kmatrix_lb)
_MODES = {"lwc": 0, "rho": 1, "t": 2, "rho_lwc": 3}
# warps of a block, each walking one chunk of the layers
# (csrc/adjoint.cu::kChunkWarps); a launch takes min(CHUNK_WARPS, L - 1)
CHUNK_WARPS = 8


def kmatrix_assembled_reference(freqs, alpha, da: dict, ds, t_k,
                                dds_dnl=None, dds_dk=None, dn=None,
                                r0cos=None):
    """Plain K for every variable of `da`, from one closed-form adjoint.

    alpha and each da[name] are (F, L, B); ds, dds_dnl and dds_dk (E, L-1,
    B); t_k (L, B); dn maps a name to its d(refractive index) (L, B) and
    selects the names that get the refraction-geometry term; r0cos (E, B).
    Returns {name: K (E, F, L, B)}: `rte.downwelling_tb_adjoint` times
    da[name], plus the Planck term for "t" and, for the names of dn,
    0.5 (A_{l-1} + A_l) dn[l] with A = dTB/dds * dds_dnl, plus the rank-one
    level-0 column sum(dTB/dds * dds_dk) * r0cos * dn[0].
    """
    f = constant_vector(freqs, alpha.dtype, alpha.device)
    g_alpha, g_t, g_ds = rte.downwelling_tb_adjoint(
        alpha.permute(2, 0, 1), ds.permute(2, 0, 1), t_k.T, f)  # (B, E, F, .)
    if dn:
        a = g_ds * dds_dnl.permute(2, 0, 1)[:, :, None]
        c = 0.5 * (nnf.pad(a, (0, 1)) + nnf.pad(a, (1, 0)))   # (B, E, F, L)
        s_k = torch.sum(g_ds * dds_dk.permute(2, 0, 1)[:, :, None], dim=-1)
        col0 = s_k * r0cos.T[:, :, None]                        # (B, E, F)
    out = {}
    for name, tangent in da.items():
        k = g_alpha * tangent.permute(2, 0, 1)[:, None]
        if name == "t":
            k = k + g_t
        if dn and name in dn:
            dnb = dn[name].T[:, None, None, :]                  # (B, 1, 1, L)
            k = k + c * dnb
            k = torch.cat([k[..., :1] + (col0 * dnb[..., 0])[..., None],
                           k[..., 1:]], dim=-1)
        out[name] = k.permute(1, 2, 3, 0)                       # (E, F, L, B)
    return out


def _needs_geometry(which: str, geometry: tuple):
    if which in ("t", "rho") and any(g is None for g in geometry):
        raise ValueError(f"which={which!r} needs dds_dnl, dds_dk, dn and "
                         f"r0cos")


def kmatrix_assembled_lb_reference(freqs, which: str, alpha, da, ds, t_k,
                                   dds_dnl=None, dds_dk=None, dn=None,
                                   r0cos=None):
    """Plain version of `kmatrix_assembled_lb`."""
    _needs_geometry(which, (dds_dnl, dds_dk, dn, r0cos))
    geo = {which: dn} if which in ("t", "rho") else None
    return kmatrix_assembled_reference(freqs, alpha, {which: da}, ds, t_k,
                                       dds_dnl, dds_dk, geo, r0cos)[which]


def kmatrix_assembled_rho_lwc_lb_reference(freqs, alpha, da_rho, da_lwc, ds,
                                           t_k, dds_dnl, dds_dk, dn_rho,
                                           r0cos):
    """Plain version of `kmatrix_assembled_rho_lwc_lb`."""
    k = kmatrix_assembled_reference(freqs, alpha,
                                    {"rho": da_rho, "lwc": da_lwc}, ds, t_k,
                                    dds_dnl, dds_dk, {"rho": dn_rho}, r0cos)
    return k["rho"], k["lwc"]


def _check_inputs(freqs, arrays: dict, n_el: int):
    alpha = arrays["alpha"]
    for name, a in arrays.items():
        if not a.is_cuda or a.dtype != torch.float32:
            raise TypeError(f"{name}: the K-matrix kernel takes float32 CUDA "
                            f"tensors, got {a.dtype} on {a.device}")
        if a.device != alpha.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {alpha.device}")
    if alpha.ndim != 3 or alpha.shape[1] < 2 or alpha.shape[0] != len(freqs):
        raise ValueError(f"alpha: expected ({len(freqs)}, L, B) with L >= 2, "
                         f"got {tuple(alpha.shape)}")
    n_ch, lev, batch = alpha.shape
    want = {"alpha": (n_ch, lev, batch), "da": (n_ch, lev, batch),
            "da2": (n_ch, lev, batch), "ds": (n_el, lev - 1, batch),
            "t": (lev, batch), "dds_dnl": (n_el, lev - 1, batch),
            "dds_dk": (n_el, lev - 1, batch), "dn": (lev, batch),
            "r0cos": (n_el, batch)}
    for name, a in arrays.items():
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name}: expected {want[name]}, got "
                             f"{tuple(a.shape)}")
    if n_el * n_ch * batch >= 2 ** 31:
        raise ValueError(f"E*F*B = {n_el * n_ch * batch} out of range")


def _launch(freqs, mode: str, alpha, da, ds, t_k, dds_dnl=None, dds_dk=None,
            dn=None, r0cos=None, da2=None):
    """Check the inputs, allocate K (and k_lwc in mode rho_lwc) and launch
    the kernel."""
    arrays = dict(alpha=alpha, da=da, ds=ds, t=t_k)
    if mode != "lwc":
        arrays.update(dds_dnl=dds_dnl, dds_dk=dds_dk, dn=dn, r0cos=r0cos)
    if mode == "rho_lwc":
        arrays["da2"] = da2
    n_el = ds.shape[0] if ds.ndim == 3 else 0
    _check_inputs(freqs, arrays, n_el)
    n_ch, lev, batch = alpha.shape
    dev = alpha.device
    outs = [torch.empty((n_el, n_ch, lev, batch), dtype=torch.float32,
                        device=dev) for _ in range(2 if mode == "rho_lwc"
                                                   else 1)]
    f = constant_vector(freqs, torch.float32, dev)

    def ptr(name):
        return arrays[name].data_ptr() if name in arrays else None

    with torch.cuda.device(dev):
        err = _build.library().mwr_kmatrix_lb(
            _MODES[mode], f.data_ptr(), alpha.data_ptr(), da.data_ptr(),
            ptr("da2"), ds.data_ptr(), t_k.data_ptr(), ptr("dds_dnl"),
            ptr("dds_dk"), ptr("dn"), ptr("r0cos"), n_el, n_ch, lev, batch,
            phys.HK_GHZ, phys.T_COSMIC, outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) == 2 else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"K-matrix kernel launch failed: CUDA error {err}")
    return outs


def kmatrix_assembled_lb(freqs, which: str, alpha, da, ds, t_k, dds_dnl=None,
                         dds_dk=None, dn=None, r0cos=None):
    """One assembled K-matrix variable.

    freqs: F channel frequencies [GHz].  which: "t", "rho" or "lwc" (selects
    the direct terms).  alpha (F, L, B) level absorption [Np/km]; da
    (F, L, B) its elementwise partial in `which`; ds (E, L-1, B) slant paths
    [km]; t_k (L, B) temperatures [K].  For which in ("t", "rho"):
    dds_dnl, dds_dk (E, L-1, B) slant-path sensitivities, dn (L, B)
    d(refractive index)/d(which) and r0cos (E, B) = (R_E + z_0) cos(el).
    Returns K (E, F, L, B).

    CPU tensors take the plain version; CUDA tensors (float32, contiguous)
    launch K5.
    """
    if which not in ("t", "rho", "lwc"):
        raise ValueError(f"which must be 't', 'rho' or 'lwc', got {which!r}")
    _needs_geometry(which, (dds_dnl, dds_dk, dn, r0cos))
    if alpha.device.type == "cpu":
        return kmatrix_assembled_lb_reference(freqs, which, alpha, da, ds,
                                              t_k, dds_dnl, dds_dk, dn, r0cos)
    (out,) = _launch(freqs, which, alpha, da, ds, t_k, dds_dnl, dds_dk, dn,
                     r0cos)
    kmatrix_assembled_lb.launches += 1
    return out


kmatrix_assembled_lb.launches = 0


def kmatrix_assembled_rho_lwc_lb(freqs, alpha, da_rho, da_lwc, ds, t_k,
                                 dds_dnl, dds_dk, dn_rho, r0cos):
    """k_rho and k_lwc, each (E, F, L, B), from one shared adjoint core.
    Shapes as in `kmatrix_assembled_lb`; da_lwc (F, L, B) is
    dalpha/d(LWC)."""
    if alpha.device.type == "cpu":
        return kmatrix_assembled_rho_lwc_lb_reference(
            freqs, alpha, da_rho, da_lwc, ds, t_k, dds_dnl, dds_dk, dn_rho,
            r0cos)
    k_rho, k_lwc = _launch(freqs, "rho_lwc", alpha, da_rho, ds, t_k, dds_dnl,
                           dds_dk, dn_rho, r0cos, da2=da_lwc)
    kmatrix_assembled_rho_lwc_lb.launches += 1
    return k_rho, k_lwc


kmatrix_assembled_rho_lwc_lb.launches = 0


def resident_warps(which: str = "t", n_levels: int = 180) -> int:
    """Warps of K5 that the current CUDA device keeps resident per SM for
    `which` ("t", "rho", "lwc" or "rho_lwc") at n_levels levels."""
    warps = _build.library().mwr_kmatrix_resident_warps(_MODES[which],
                                                        n_levels)
    if warps < 0:
        raise RuntimeError(f"K5 occupancy query failed: CUDA error {-warps}")
    return warps
