"""Pipeline stages: preprocess -> forward -> merge -> evaluate."""

from .forward import forward_stage  # noqa: F401
from .merge import merge_model_results  # noqa: F401
