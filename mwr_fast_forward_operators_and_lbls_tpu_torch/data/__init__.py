"""Data layer: NetCDF I/O, ingest, cloud water, preprocessing pipeline."""

from .dataset import Dataset, Variable, concat  # noqa: F401
from . import les  # noqa: F401
