"""Slant-path geometry through a spherically stratified refracting atmosphere.

Torch counterpart of the JAX package's `ops/geometry.py`.  Snell's law for a
radially stratified medium, n * r * cos(elevation) = const, gives each layer's
straight chord in closed form.
"""

import torch

from ..constants import physics as phys


def refractivity(p_hpa, t_k, e_hpa):
    """Radio refractivity N [ppm] (Rueeger 2002 'best average' coefficients).

    N = 77.6890 pd/T + 71.2952 e/T + 375463 e/T^2, pd = p - e.
    """
    pd = p_hpa - e_hpa
    return (77.6890 * pd / t_k + 71.2952 * e_hpa / t_k
            + 375463.0 * e_hpa / (t_k * t_k))


def refractive_index(p_hpa, t_k, e_hpa):
    """n = 1 + N*1e-6."""
    return 1.0 + 1e-6 * refractivity(p_hpa, t_k, e_hpa)


def chord_lengths(z_m, n, cos_el):
    """Per-layer slant path [km] from level heights and refractive indices.

    z_m and n have levels on axis 0 (ground -> top) and any trailing batch
    axes; cos_el is the cosine of the elevation, a scalar or a tensor that
    broadcasts against one level row.  The chord consistent with the Snell
    invariant k = n0*r0*cos(el) is evaluated in the cancellation-safe form

        ds = dz * (r_top + r_bot) / (seg_top + seg_bot),
        seg = sqrt((r - rk)(r + rk)),   rk = k / n_layer,

    which is dz exactly at zenith.  dz is taken from z, not from R_E + z:
    in float32 the Earth radius would quantize it to about 0.5 m.
    """
    r = phys.EARTH_RADIUS + z_m
    k = n[:1] * r[:1] * cos_el
    n_layer = 0.5 * (n[:-1] + n[1:])
    rk = k / n_layer
    r_bot, r_top = r[:-1], r[1:]
    seg_top = torch.sqrt(torch.clamp_min((r_top - rk) * (r_top + rk), 0.0))
    seg_bot = torch.sqrt(torch.clamp_min((r_bot - rk) * (r_bot + rk), 0.0))
    dz = z_m[1:] - z_m[:-1]
    ds_m = dz * (r_top + r_bot) / torch.clamp_min(seg_top + seg_bot, 1.0)
    return ds_m * 1e-3


def _cos_deg(elevation_deg, like):
    el = torch.as_tensor(elevation_deg, dtype=like.dtype, device=like.device)
    return torch.cos(torch.deg2rad(el))


def slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """Per-layer slant path lengths [km], ground to top.

    z_m, p_hpa, t_k, e_hpa: (L,) level arrays; elevation_deg: scalar
    (90 = zenith).  Returns ds_km (L-1,).
    """
    n = refractive_index(p_hpa, t_k, e_hpa)
    return chord_lengths(z_m, n, _cos_deg(elevation_deg, z_m))


def slant_path_lengths_lb(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """`slant_path_lengths` in the (L, B) layout: levels on axis 0, profiles
    on axis 1.  Returns ds_km (L-1, B)."""
    n = refractive_index(p_hpa, t_k, e_hpa)
    return chord_lengths(z_m, n, _cos_deg(elevation_deg, z_m))

