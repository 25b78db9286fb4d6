"""Spectroscopy, instrument and climatology tables, shared with the JAX
package.

The six table modules of the JAX package (`physics`, `hatpro`, `h2o_lines`,
`o2_lines`, `o3_lines`, `afgl`) import only numpy and dataclasses.  They are
loaded here by file path, so the tables have one source and importing the port
never runs the JAX package's `__init__` (which imports jax).  Each file is
registered as `<this package>.<name>` before it executes, which is what the
dataclass machinery needs to resolve its own module.
"""

import importlib.util
import pathlib
import sys

_TABLE_DIR = (pathlib.Path(__file__).resolve().parents[2]
              / "mwr_fast_forward_operators_and_lbls_tpu" / "constants")


def _load(name: str):
    qualified = f"{__name__}.{name}"
    if qualified in sys.modules:
        return sys.modules[qualified]
    spec = importlib.util.spec_from_file_location(qualified,
                                                  _TABLE_DIR / f"{name}.py")
    if spec is None:
        raise ImportError(f"no table module {name!r} under {_TABLE_DIR}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[qualified] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[qualified]
        raise
    return module


physics = _load("physics")
hatpro = _load("hatpro")
h2o_lines = _load("h2o_lines")
o2_lines = _load("o2_lines")
o3_lines = _load("o3_lines")
afgl = _load("afgl")

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
