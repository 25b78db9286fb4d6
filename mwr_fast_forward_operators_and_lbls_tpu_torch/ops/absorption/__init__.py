"""Gas and hydrometeor absorption coefficients (the plain torch LBL path)."""

from ...constants import H2O_MODELS, O2_MODELS
from ..tensors import promote
from .h2o import h2o_absorption
from .liquid import liquid_absorption
from .n2 import n2_absorption
from .o2 import o2_absorption
from .o3 import o3_absorption

__all__ = ["ABSORPTION_MODELS", "h2o_absorption", "liquid_absorption",
           "n2_absorption", "o2_absorption", "o3_absorption",
           "total_absorption"]

# All nine Rosenkranz releases (R98 .. R24, with the speed-dependent
# R19SD/R20SD variants).
ABSORPTION_MODELS = tuple(H2O_MODELS)


def total_absorption(f_ghz, p_hpa, t_k, rho_gm3, lwc_gm3=None,
                     model: str = "R24", o3_ppmv=None):
    """Total atmospheric absorption [Np/km] for one named model family.

    The sum of H2O lines and continuum, O2 lines and nonresonant term, the dry
    continuum, and optionally cloud liquid and ozone.  Inputs broadcast.
    """
    if model not in H2O_MODELS:
        raise ValueError(f"unknown absorption model {model!r}; "
                         f"have {ABSORPTION_MODELS}")
    f, p, t, rho = promote(f_ghz, p_hpa, t_k, rho_gm3)
    # e = rho*T/217 here, as in the Rosenkranz codes; ops.thermo.rho_to_e
    # (used for the refractive index) carries the CODATA-derived constant.
    e = rho * t / 217.0
    pda = p - e
    alpha = (h2o_absorption(f, p, t, rho, H2O_MODELS[model])
             + o2_absorption(f, p, t, rho, O2_MODELS[model])
             + n2_absorption(f, pda, t, variant=model))
    if lwc_gm3 is not None:
        alpha = alpha + liquid_absorption(f, t, lwc_gm3)
    if o3_ppmv is not None:
        alpha = alpha + o3_absorption(f, p, t, o3_ppmv)
    return alpha
