"""RPG-HATPRO microwave radiometer channel and scan-geometry definitions.

Mirrors the instrument configuration the reference pipeline is built around
(channel list: python_src/proc/PyRTlib_processing.py:87-88;
elevation angles: python_src/preproc/preprocessing4all.py:40;
azimuth grid: preprocessing4all.py:41; 180 vertical levels:
preprocessing4all.py:42).
"""

import numpy as np

# 14 HATPRO channel center frequencies [GHz]:
#  - K-band (22-31 GHz): water-vapor 22.235 line + window -> IWV / humidity profile
#  - V-band (51-58 GHz): O2 60-GHz complex flank -> temperature profile
HATPRO_FREQS_GHZ = np.array(
    [22.24, 23.04, 23.84, 25.44, 26.24, 27.84, 31.40,
     51.26, 52.28, 53.86, 54.94, 56.66, 57.30, 58.00],
    dtype=np.float64,
)

N_CHANNELS = 14
K_BAND = slice(0, 7)
V_BAND = slice(7, 14)

# Boundary-layer scan elevation angles [deg] (90 = zenith, down to 4.2 deg slant)
ELEVATIONS_DEG = np.array(
    [90.0, 30.0, 19.2, 14.4, 11.4, 8.4, 6.6, 5.4, 4.8, 4.2], dtype=np.float64
)
N_ELEVATIONS = 10

# Azimuth grid [deg], 0..355 step 5
AZIMUTHS_DEG = np.arange(0.0, 360.0, 5.0)
N_AZIMUTHS = 72

# Canonical number of vertical levels in the harmonized dataset
N_LEVELS = 180

# Number of profile variants: uncropped / cropped-at-132 m (roof vs ground mount)
N_CROP = 2

# Instruments fielded across the three campaigns (FESSTVaL, Socles, Vital I)
INSTRUMENTS = ("dwdhat", "foghat", "sunhat", "tophat", "joyhat", "hamhat")

# Station-height offsets [m] applied per instrument by the reference MWR reader
# (python_src/preproc/MWR_read_in_module.py:381-417)
INSTRUMENT_HEIGHT_OFFSET_M = {
    "dwdhat": 112.0,
    "foghat": 74.0,
    "sunhat": 110.0,
    "tophat": 0.0,
    "joyhat": 0.0,
    "hamhat": 0.0,
}

# Matching tolerances used when pairing MWR scans with radiosonde launches
# (python_src/preproc/MWR_read_in_module.py:41-43)
MAX_TIME_DIFF_MIN = 15.0
MAX_ELEV_AZI_DIFF_DEG = 0.05


def nominal_bandwidth_ghz() -> np.ndarray:
    """Nominal channel bandwidths [GHz] for SRF convolution (HATPRO G5 spec)."""
    return np.array(
        [0.230, 0.230, 0.230, 0.230, 0.230, 0.230, 0.230,
         0.230, 0.230, 0.230, 0.180, 0.600, 1.000, 2.000],
        dtype=np.float64,
    )
