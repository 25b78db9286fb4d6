"""Physical constants used throughout the framework.

All values CODATA-2018 unless noted. Kept as plain Python floats so they can
be folded into jit-compiled kernels as compile-time constants.
"""

# Speed of light [m/s]
C_LIGHT = 299_792_458.0

# Planck constant [J s]
H_PLANCK = 6.62607015e-34

# Boltzmann constant [J/K]
K_BOLTZ = 1.380649e-23

# h/k [K/GHz] — Planck temperature per unit frequency: h*nu/k = HK_GHZ * f[GHz]
HK_GHZ = H_PLANCK / K_BOLTZ * 1e9  # = 0.0479924307...

# Cosmic microwave background temperature [K]
# (value used by ground-based MW RT codes, e.g. Schroeder & Westwater 1991)
T_COSMIC = 2.728

# Molar gas constant [J/mol/K]
R_GAS = 8.314462618

# Dry-air specific gas constant [J/kg/K]
RD = 287.04

# Water-vapor specific gas constant [J/kg/K]
RV = 461.525

# Ratio of molar masses Mw/Md
EPSILON = 0.621970585

# Gravity [m/s^2]
G0 = 9.80665

# Mean Earth radius [m] (spherical shells for slant-path ray tracing)
EARTH_RADIUS = 6_371_000.0

# Latent heat of vaporization [J/kg] at ~0C (used by the reference's
# Clausius-Clapeyron helper, python_src/preproc/preprocessing4all.py:104-152)
LV = 2.5e6

# Specific heat of dry air at constant pressure [J/kg/K]
CP = 1004.0

# Triple point of water [K]
T0C = 273.15

# Dry-air molar mass [g/mol]
MD = 28.9644
# Water molar mass [g/mol]
MW = 18.01528
