"""Geodesic helpers: great-circle distance and nearest-gridbox search.

Replaces the reference's geopy dependency
(reference/python_src/merge_data_into_netCDF/Sc_module.py:56-69,
`find_nearest_gridbox` via geopy.distance.geodesic) with a dependency-free
haversine — accurate to ~0.5 % vs the ellipsoidal geodesic, far below the
grid spacing it is used to search.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_KM = 6371.0088  # IUGG mean radius


def haversine_km(lat1, lon1, lat2, lon2):
    """Great-circle distance [km]; inputs in degrees, broadcastable."""
    lat1, lon1, lat2, lon2 = (np.deg2rad(np.asarray(x, np.float64))
                              for x in (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (np.sin(0.5 * dlat) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(0.5 * dlon) ** 2)
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def nearest_gridbox(lat, lon, grid_lats, grid_lons):
    """Index of the closest (lat, lon) grid point (Sc_module.py:56-69).

    grid_lats/grid_lons: 1-D arrays of equal length (point list) or a
    separable grid — pass meshgridded arrays for 2-D grids and get the flat
    index back.
    """
    d = haversine_km(lat, lon, np.ravel(grid_lats), np.ravel(grid_lons))
    return int(np.argmin(d))
