"""Slant-path geometry through a spherically stratified refracting atmosphere.

Torch counterpart of the JAX package's `ops/geometry.py`.  Snell's law for a
radially stratified medium, n * r * cos(elevation) = const, gives each layer's
straight chord in closed form, and its partials for the K-matrix.
"""

import torch

from ..constants import physics as phys

# Rueeger (2002) 'best average' refractivity coefficients: K1 [K/hPa],
# K2 [K/hPa], K3 [K^2/hPa]
_K1, _K2, _K3 = 77.6890, 71.2952, 375463.0


def refractivity(p_hpa, t_k, e_hpa):
    """Radio refractivity N [ppm] (Rueeger 2002 'best average' coefficients).

    N = K1 pd/T + K2 e/T + K3 e/T^2, pd = p - e.
    """
    pd = p_hpa - e_hpa
    return _K1 * pd / t_k + _K2 * e_hpa / t_k + _K3 * e_hpa / (t_k * t_k)


def refractive_index(p_hpa, t_k, e_hpa):
    """n = 1 + N*1e-6."""
    return 1.0 + 1e-6 * refractivity(p_hpa, t_k, e_hpa)


def refractive_index_partials(p_hpa, t_k, e_hpa):
    """Closed-form partials of `refractive_index`: (dn/dp, dn/dT at fixed
    e, dn/de), each of the broadcast shape of the inputs."""
    inv_t = 1.0 / t_k
    dn_dp = 1e-6 * _K1 * inv_t
    dn_de = 1e-6 * ((_K2 - _K1) + _K3 * inv_t) * inv_t
    dn_dt = -1e-6 * (_K1 * (p_hpa - e_hpa) + _K2 * e_hpa
                     + 2.0 * _K3 * e_hpa * inv_t) * inv_t * inv_t
    return dn_dp, dn_dt, dn_de


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


def chord_sensitivities(z_m, n, cos_el):
    """Closed-form partials of `chord_lengths`, in its layout (levels on
    axis 0).

    The chord ds_i depends on the refractive index only through the layer
    mean n_layer_i = (n_i + n_{i+1})/2 and the Snell invariant
    k = n_0 r_0 cos(el), so d(ds)/d(n levels) is tridiagonal plus a rank-one
    level-0 column.  Returns the two factors (each shaped like the chords):

      dds_dnlayer = d(ds_i [km]) / d(n_layer_i),
      dds_dk      = d(ds_i [km]) / d(k [m]),

    with d(ds)/d(rk) = dz (r_top + r_bot) / denom^2 * rk (1/seg_top +
    1/seg_bot), zero where the chord's square-root or denominator clamps
    are active.
    """
    r = phys.EARTH_RADIUS + z_m
    k = n[:1] * r[:1] * cos_el
    n_layer = 0.5 * (n[:-1] + n[1:])
    rk = k / n_layer
    r_bot, r_top = r[:-1], r[1:]
    seg_top = torch.sqrt(torch.clamp_min((r_top - rk) * (r_top + rk), 0.0))
    seg_bot = torch.sqrt(torch.clamp_min((r_bot - rk) * (r_bot + rk), 0.0))
    dz = z_m[1:] - z_m[:-1]
    denom = seg_top + seg_bot
    inv_top = torch.where(seg_top > 0.0,
                          1.0 / torch.clamp_min(seg_top, 1e-30), 0.0)
    inv_bot = torch.where(seg_bot > 0.0,
                          1.0 / torch.clamp_min(seg_bot, 1e-30), 0.0)
    denom_c = torch.clamp_min(denom, 1.0)
    dds_drk = torch.where(
        denom > 1.0,
        dz * (r_top + r_bot) / (denom_c * denom_c) * rk * (inv_top + inv_bot),
        0.0)
    return dds_drk * (-rk / n_layer) * 1e-3, dds_drk * (1.0 / n_layer) * 1e-3


def slant_path_sensitivities(z_m, n, elevation_deg):
    """`chord_sensitivities` with levels on the LAST axis, as in the JAX
    package: z_m, n (..., L); elevation_deg (...) broadcasts against the
    leading axes.  Returns (dds_dnlayer, dds_dk), each (..., L-1)."""
    cos_el = _cos_deg(elevation_deg, z_m)
    dnl, dk = chord_sensitivities(torch.movedim(z_m, -1, 0),
                                  torch.movedim(n, -1, 0), cos_el)
    return torch.movedim(dnl, 0, -1), torch.movedim(dk, 0, -1)


def airmass(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """Total slant path divided by the vertical path (diagnostic); (L,)
    level inputs."""
    ds = slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg)
    return torch.sum(ds) / torch.sum(torch.diff(z_m) * 1e-3)


def local_zenith_angles(z_m, p_hpa, t_k, e_hpa, elevation_deg):
    """Local zenith angle [deg] at each level along the refracted ray; (L,)
    level inputs."""
    n = refractive_index(p_hpa, t_k, e_hpa)
    r = phys.EARTH_RADIUS + z_m
    k = n[0] * r[0] * _cos_deg(elevation_deg, z_m)
    cos_el_local = torch.clamp(k / (n * r), 0.0, 1.0)
    return 90.0 - torch.rad2deg(torch.arccos(cos_el_local))

