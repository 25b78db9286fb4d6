"""Operators: the batched LBL forward, its K-matrix, the monochromatic
spectral forward, the fast predictor-regression operator and the
optimal-estimation retrieval on it."""

from .lbl import (LBLConfig, LBLOperator, forward_batch,  # noqa: F401
                  forward_single)
from . import fast, jacobians, retrieval, spectral  # noqa: F401
