"""Ozone rotational-line parameters for the microwave window (< 120 GHz).

The reference carries an O3 profile solely to feed ARMS-gb's input schema
(python_src/proc/ARMS_gb_processing.py:94-99,132-136);
the Fortran model consumes it internally.  To match that capability natively
this table vendors the strongest pure-rotational O3 lines below 120 GHz.

Provenance: line centers from the JPL spectral-line catalog (ozone species
tag 48004); intensities are catalog magnitudes converted from
log10(nm^2 MHz) at 300 K to the Hz*cm^2 convention of the other tables
(1 nm^2 MHz = 1e-8 Hz*cm^2).  Air-broadened widths use the representative
HITRAN value for microwave O3 transitions (~0.07 cm^-1/atm) — individual
lines vary by ~10 %, far below this term's sub-0.1 K impact on HATPRO
channels.  The table is intentionally approximate: O3 contributes of order
0.01-0.1 K to 20-60 GHz ground-based TBs; fidelity here is bounded by the
climatological O3 profile, not the spectroscopy.

Units match h2o_lines: FL [GHz], S1 [Hz*cm^2] at 300 K, B2 [-] intensity
temperature coefficient, W3 [GHz/mb] air width, X [-] width exponent.
"""

import numpy as np

# (freq GHz, log10 catalog intensity [nm^2 MHz] at 300 K)
_JPL = [
    (30.0525, -6.8), (30.1812, -6.9), (36.0232, -6.6), (37.8324, -6.4),
    (42.8326, -6.3), (43.6539, -6.6), (61.9273, -6.0), (67.3561, -5.9),
    (76.5313, -5.8), (96.2282, -5.6), (101.7367, -5.4), (103.8784, -5.5),
    (109.5592, -5.5), (110.8360, -5.3), (118.3644, -5.5),
]

N_O3_LINES = len(_JPL)

O3_FL = np.array([f for f, _ in _JPL])
O3_S1 = np.array([10.0 ** lg * 1e-8 for _, lg in _JPL])  # Hz*cm^2 at 300 K
# Rotational levels involved sit at moderate energies; a common coefficient
# captures the ~220-270 K stratospheric range adequately.
O3_B2 = np.full(N_O3_LINES, 1.0)
O3_W3 = np.full(N_O3_LINES, 0.0021)  # 0.07 cm^-1/atm -> GHz/mb
O3_X = np.full(N_O3_LINES, 0.73)
