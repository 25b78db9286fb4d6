"""The K-matrix's float64 slant geometry (`csrc/geometry.cu`), its wrapper
and its plain version.

`slant_geometry_lb` maps level-major profiles z, p, T, rho (L, B) and the
scan's elevations to the chords ds and their sensitivities dds_dnl, dds_dk
(E, L-1, B), r0cos = (R_E + z_0) cos(el) (E, B) and the refractive index's
partials dn {"t", "rho"} (L, B): what K5 takes beside alpha and its
tangents.  It launches the kernel, one launch in place of the plain
version's some 130, or runs the plain version by the package's rule
(`ops.cuda.launches`), and runs the plain version for a partial in p,
which the kernel does not write.
"""

import torch

from ...constants import physics as phys
from .. import geometry, thermo
from ..spans import span
from ..tensors import constant_vector
from . import _build, count_launch, launches
from .rte import _device_cos


def slant_geometry_lb_reference(elevations, z, p, t, rho,
                                names=("t", "rho")) -> dict:
    """Plain version of `slant_geometry_lb`, in float64 and returned in the
    profiles' dtype; dn holds each of `names` in {"t", "rho", "p"}, through
    e = rho T Rv / 1e5.

    Float64 because at low elevations the chords hang on r - rk, and
    float32 quantizes r = R_E + z to half a metre, which put 1.2e-3 of
    max |K| into k_t at 4.2 degrees.
    """
    dtype = t.dtype
    z, p, t, rho = (a.double() for a in (z, p, t, rho))
    e = thermo.rho_to_e(rho, t)
    n = geometry.refractive_index(p, t, e)
    dn_dp, dn_dt, dn_de = geometry.refractive_index_partials(p, t, e)
    # e = rho T Rv / 1e5: de/dT = e(rho, 1), de/drho = e(1, T)
    dn = {"p": dn_dp, "t": dn_dt + dn_de * thermo.rho_to_e(rho, 1.0),
          "rho": dn_de * thermo.rho_to_e(1.0, t)}
    dn = {name: dn[name].to(dtype) for name in names}
    cos_el = torch.cos(torch.deg2rad(constant_vector(
        elevations, torch.float64, t.device)))
    # all elevations at once: levels on axis 0, then (E, B)
    zb, nb, cb = z[:, None], n[:, None], cos_el[:, None]

    def elevation_major(a):                     # (L-1, E, B) -> (E, L-1, B)
        return a.transpose(0, 1).to(dtype).contiguous()

    dds_dnl, dds_dk = geometry.chord_sensitivities(zb, nb, cb)
    r0cos = (phys.EARTH_RADIUS + z[0])[None, :] * cos_el[:, None]
    return dict(ds=elevation_major(geometry.chord_lengths(zb, nb, cb)),
                dds_dnl=elevation_major(dds_dnl),
                dds_dk=elevation_major(dds_dk), r0cos=r0cos.to(dtype), dn=dn)


# the refractive-index partials the kernel writes
GEOMETRY_WRT = frozenset({"t", "rho"})


def _check_inputs(z, p, t, rho):
    """The four profiles: (L, B) with L >= 2, contiguous, on one device, in
    one dtype."""
    arrays = dict(z=z, p=p, t=t, rho=rho)
    if t.ndim != 2 or t.shape[0] < 2:
        raise ValueError(f"t: expected (L, B) with L >= 2, got "
                         f"{tuple(t.shape)}")
    for name, a in arrays.items():
        if a.shape != t.shape:
            raise ValueError(f"{name}: expected {tuple(t.shape)}, got "
                             f"{tuple(a.shape)}")
        if a.device != t.device or a.dtype != t.dtype:
            raise ValueError(f"{name}: expected {t.dtype} on {t.device}, got "
                             f"{a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def slant_geometry_lb(elevations, z, p, t, rho, names=("t", "rho"),
                      use_kernels: bool = True) -> dict:
    """Slant geometry of the K-matrix for the E `elevations` [deg] (a
    sequence) and level-major profiles z [m], p [hPa], t [K], rho [g/m^3]
    (L, B), each contiguous: {"ds", "dds_dnl", "dds_dk"} (E, L-1, B) [km,
    km, km/m], "r0cos" (E, B) [m] and "dn" {name: (L, B)} for each of
    `names` in {"t", "rho", "p"}.

    The kernel or the plain version by `launches(t, use_kernels)`, the
    plain version also where `names` has "p".  The kernel works in float64
    as the plain version does and rounds each output once to float32.
    """
    _check_inputs(z, p, t, rho)
    if not (launches(t, use_kernels) and set(names) <= GEOMETRY_WRT):
        return slant_geometry_lb_reference(elevations, z, p, t, rho, names)
    with span("cuda.slant_geometry_lb"):
        dev = t.device
        lev, batch = t.shape
        cos_el = _device_cos(tuple(float(v) for v in elevations), dev)
        n_el = cos_el.numel()
        out = {k: torch.empty((n_el, lev - 1, batch), dtype=torch.float32,
                              device=dev) for k in ("ds", "dds_dnl", "dds_dk")}
        dn = {k: torch.empty((lev, batch), dtype=torch.float32, device=dev)
              for k in ("t", "rho")}
        r0cos = torch.empty((n_el, batch), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _build.library().mwr_slant_geometry_lb(
                cos_el.data_ptr(), z.data_ptr(), p.data_ptr(), t.data_ptr(),
                rho.data_ptr(), n_el, lev, batch, phys.RV, phys.EARTH_RADIUS,
                geometry._K1, geometry._K2, geometry._K3,
                out["ds"].data_ptr(), out["dds_dnl"].data_ptr(),
                out["dds_dk"].data_ptr(), dn["t"].data_ptr(),
                dn["rho"].data_ptr(), r0cos.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"geometry kernel launch failed: CUDA error "
                               f"{err}")
        count_launch(slant_geometry_lb)
        return dict(out, r0cos=r0cos, dn={name: dn[name] for name in names})


slant_geometry_lb.launches = 0
