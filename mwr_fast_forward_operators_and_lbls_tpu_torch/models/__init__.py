"""Operators: the batched LBL forward."""

from .lbl import (LBLConfig, LBLOperator, forward_batch,  # noqa: F401
                  forward_single)
