"""Humidity conversions, the torch counterpart of `ops/thermo.py`.

Only the two conversions the LBL forward needs are ported so far.
"""

from ..constants import physics as phys


def e_to_rho(e, t):
    """Vapor pressure [hPa] -> vapor density [g/m^3]: 216.679 * e / T."""
    return 1e5 / phys.RV * e / t


def rho_to_e(rho, t):
    """Vapor density [g/m^3] -> vapor pressure [hPa]."""
    return rho * t * phys.RV / 1e5
