"""Operators: the batched LBL forward, its K-matrix and the monochromatic
spectral forward."""

from .lbl import (LBLConfig, LBLOperator, forward_batch,  # noqa: F401
                  forward_single)
from . import jacobians, spectral  # noqa: F401
