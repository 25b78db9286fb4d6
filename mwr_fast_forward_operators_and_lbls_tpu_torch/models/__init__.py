"""Operators: the batched LBL forward and its K-matrix."""

from .lbl import (LBLConfig, LBLOperator, forward_batch,  # noqa: F401
                  forward_single)
from . import jacobians  # noqa: F401
