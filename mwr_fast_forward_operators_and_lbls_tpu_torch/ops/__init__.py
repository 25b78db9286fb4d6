"""Physics ops (thermo, absorption, geometry, RTE) and the CUDA kernels."""

from . import absorption, geometry, rte, thermo  # noqa: F401
