"""Spectroscopy, instrument and climatology tables.

The six table modules (`physics`, `hatpro`, `h2o_lines`, `o2_lines`,
`o3_lines`, `afgl`) import only numpy and dataclasses.  They are this
package's own copy of the tables; `tests/test_torch_imports.py` holds them,
number for number, against the tables of the JAX package.
"""

from . import afgl, h2o_lines, hatpro, o2_lines, o3_lines, physics

H2O_MODELS = h2o_lines.H2O_MODELS
ZENITH_SWEEP_MODELS = h2o_lines.ZENITH_SWEEP_MODELS
H2OModel = h2o_lines.H2OModel
O2_MODELS = o2_lines.O2_MODELS
O2Model = o2_lines.O2Model
O3_FL, O3_S1, O3_B2, O3_W3, O3_X = (o3_lines.O3_FL, o3_lines.O3_S1,
                                    o3_lines.O3_B2, o3_lines.O3_W3,
                                    o3_lines.O3_X)
HATPRO_FREQS_GHZ = hatpro.HATPRO_FREQS_GHZ
ELEVATIONS_DEG = hatpro.ELEVATIONS_DEG
N_LEVELS = hatpro.N_LEVELS
CLIMATOLOGIES = afgl.CLIMATOLOGIES

C_LIGHT = physics.C_LIGHT
H_PLANCK = physics.H_PLANCK
K_BOLTZ = physics.K_BOLTZ
HK_GHZ = physics.HK_GHZ
T_COSMIC = physics.T_COSMIC
RV = physics.RV
EARTH_RADIUS = physics.EARTH_RADIUS
