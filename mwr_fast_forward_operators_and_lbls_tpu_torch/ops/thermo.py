"""Humidity and thermodynamic conversions, the torch counterpart of
`ops/thermo.py`.

Units: pressure p [hPa], temperature t [K], mixing ratio mr [g/kg], relative
humidity rh [%], vapor pressure e [hPa], vapor density rho [g/m^3], volume
ratio ppmv [ppm by volume].  Every function broadcasts and is differentiable.
"""

import torch

from ..constants import physics as phys


def es_clausius_clapeyron(t):
    """Saturation vapor pressure [hPa]: 6.1078 exp(L/Rv (1/273.15 - 1/T))."""
    return 6.1078 * torch.exp(phys.LV / phys.RV * (1.0 / phys.T0C - 1.0 / t))


def es_magnus(t):
    """Saturation vapor pressure [hPa], Magnus form over water."""
    tc = t - phys.T0C
    return 6.1078 * torch.exp(17.08085 * tc / (234.175 + tc))


def es_ice(t):
    """Saturation vapor pressure [hPa] over ice (Magnus, Murray 1967)."""
    tc = t - phys.T0C
    return 6.1071 * torch.exp(22.4429 * tc / (272.44 + tc))


def rh_to_e(rh, t, over_ice=False):
    """Relative humidity [%] -> vapor pressure [hPa].  `over_ice` is a bool
    or a boolean tensor that broadcasts against t."""
    if isinstance(over_ice, torch.Tensor):
        es = torch.where(over_ice, es_ice(t), es_clausius_clapeyron(t))
    else:
        es = es_ice(t) if over_ice else es_clausius_clapeyron(t)
    return rh / 100.0 * es


def e_to_rh(e, t):
    """Vapor pressure [hPa] -> relative humidity [%] (over water)."""
    return 100.0 * e / es_clausius_clapeyron(t)


def e_to_mr(e, p):
    """Vapor pressure [hPa] -> mixing ratio [g/kg]."""
    return 1000.0 * phys.EPSILON * e / (p - e)


def mr_to_e(mr, p):
    """Mixing ratio [g/kg] -> vapor pressure [hPa]."""
    r = mr / 1000.0
    return p * r / (phys.EPSILON + r)


def rh_to_mr(rh, p, t):
    """Relative humidity [%] -> mixing ratio [g/kg]."""
    return e_to_mr(rh_to_e(rh, t), p)


def mr_to_rh(mr, p, t):
    """Mixing ratio [g/kg] -> relative humidity [%]."""
    return e_to_rh(mr_to_e(mr, p), t)


def mr_to_ppmv(mr):
    """Mixing ratio [g/kg] -> volume mixing ratio [ppmv]."""
    return mr * 1000.0 * phys.MD / phys.MW


def ppmv_to_mr(ppmv):
    """Volume mixing ratio [ppmv] -> mixing ratio [g/kg]."""
    return ppmv / 1000.0 * phys.MW / phys.MD


def e_to_rho(e, t):
    """Vapor pressure [hPa] -> vapor density [g/m^3]: 216.679 * e / T."""
    return 1e5 / phys.RV * e / t


def rho_to_e(rho, t):
    """Vapor density [g/m^3] -> vapor pressure [hPa]."""
    return rho * t * phys.RV / 1e5


def mr_to_rho(mr, p, t):
    """Mixing ratio [g/kg] -> vapor density [g/m^3]."""
    return e_to_rho(mr_to_e(mr, p), t)


def specific_to_mr(q):
    """Specific humidity [g/kg] -> mixing ratio [g/kg]."""
    return q / (1.0 - q / 1000.0)


def mr_to_specific(mr):
    """Mixing ratio [g/kg] -> specific humidity [g/kg]."""
    return mr / (1.0 + mr / 1000.0)


def virtual_temperature(t, mr):
    """Virtual temperature [K] from T [K] and mixing ratio [g/kg]."""
    r = mr / 1000.0
    return t * (1.0 + r / phys.EPSILON) / (1.0 + r)


def iwv_from_profile(rho_gm3, z_m, axis=-1):
    """Integrated water vapor [kg/m^2], trapezoid over height [m]."""
    rho = torch.movedim(rho_gm3 * 1e-3, axis, -1)  # kg/m^3
    z = torch.movedim(z_m, axis, -1)
    mid = 0.5 * (rho[..., 1:] + rho[..., :-1])
    return torch.sum(mid * torch.diff(z, dim=-1), dim=-1)


def barometric_pressure(p0, t, z0, z):
    """Barometric extrapolation of pressure [hPa]."""
    return p0 * torch.exp(-phys.G0 * (z - z0) / (phys.RD * t))


def density_moist(p, t, mr):
    """Moist-air density [kg/m^3] from p [hPa], T [K], mixing ratio [g/kg]."""
    return p * 100.0 / (phys.RD * virtual_temperature(t, mr))


def potential_temperature(t, p, p0=1000.0):
    """theta = T (p0/p)^(R/cp) [K]."""
    return t * (p0 / p) ** 0.2854


def bulk_richardson(z_m, t_k, p_hpa, mr_gkg, u_ms, v_ms):
    """Bulk Richardson number between the surface (level 0, last axis) and
    each level, with winds relative to the surface flow."""
    thv = virtual_temperature(potential_temperature(t_k, p_hpa), mr_gkg)
    du2 = u_ms ** 2 + v_ms ** 2
    num = 9.80665 / thv[..., :1] * (thv - thv[..., :1]) * (z_m - z_m[..., :1])
    return num / torch.clamp_min(du2, 1e-6)
