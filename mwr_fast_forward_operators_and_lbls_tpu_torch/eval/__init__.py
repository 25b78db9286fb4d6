"""Evaluation layer: sky classification and deviations (statistics, plots
and the report are not ported yet)."""

from . import deviations, sky  # noqa: F401
