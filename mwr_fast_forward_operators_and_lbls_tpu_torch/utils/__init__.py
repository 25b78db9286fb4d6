"""Utility layer: native bindings, geodesic, and timestamp helpers."""

from . import geo, times  # noqa: F401
