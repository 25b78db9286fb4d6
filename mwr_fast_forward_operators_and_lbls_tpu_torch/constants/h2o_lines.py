"""Water-vapor line and continuum parameters (Rosenkranz model family).

The reference pipeline evaluates four PyRTlib absorption models — R98, R17,
R20, R24 (python_src/proc/PyRTlib_processing.py:121-151).
PyRTlib itself is a NumPy transcription of P. W. Rosenkranz's public Fortran
line-by-line codes; this module vendors those line tables as plain data so the
framework has no runtime dependency on PyRTlib.

Provenance:
  * Base table: Rosenkranz (1998), "Water vapor microwave continuum
    absorption: a comparison of measurements and models", Radio Science 33,
    919-928 — the `abh2o.f` 15-line table (transcribed from the published
    model description; this is NOT copied from the reference repo, which
    contains no spectroscopy).
  * R17: Rosenkranz 2017 code release; 22/183-GHz widths updated per the
    Tretyakov (2016) review; continuum per Turner et al. (2009) refit.
  * R20: 22-GHz self/air widths and self-continuum per Koshelev et al.
    (2018); foreign continuum per Koshelev et al. (2021).
  * R24: 2024 release; HITRAN-2020-adjusted intensities, continuum refit.
  The model-to-model deltas implemented here capture the documented parameter
  updates; sub-0.1 % intensity retunes that are not publicly tabulated are
  carried at their R98 values.  `tools/fit_tables.py` can refit any residual
  offset against an external golden absorption file if bitwise parity with a
  specific upstream release is required; the frozen accuracy anchors live in
  tests/golden/ (see tools/make_golden.py).

Units follow the Rosenkranz convention:
  FL   [GHz]      line center frequency
  S1   [Hz*cm^2]  line intensity at 300 K
  B2   [-]        temperature coefficient of intensity
  W3   [GHz/mb]   air-broadened half-width at 300 K
  X    [-]        temperature exponent of air width
  WS   [GHz/mb]   self-broadened half-width at 300 K
  XS   [-]        temperature exponent of self width
Continuum: alpha_c = (CF*theta^XCF*pda + CS*theta^XCS*e) * e * f^2 with
pda/e in mb, f in GHz, theta=300/T, yielding the Rosenkranz normalization
used in `abh2o.f` (result folded by the 0.3183e-4*den prefactor in the op).
"""

from dataclasses import dataclass, field, replace

import numpy as np

N_H2O_LINES = 15

_FL = np.array([
    22.2351, 183.3101, 321.2256, 325.1529, 380.1974,
    439.1508, 443.0183, 448.0011, 470.8890, 474.6891,
    488.4911, 556.9360, 620.7008, 752.0332, 916.1712,
])

_S1 = np.array([
    0.1310e-13, 0.2273e-11, 0.8036e-13, 0.2694e-12, 0.2438e-10,
    0.2179e-11, 0.4624e-12, 0.2562e-10, 0.8369e-12, 0.3263e-11,
    0.6659e-12, 0.1531e-08, 0.1707e-10, 0.1011e-08, 0.4227e-10,
])

_B2 = np.array([
    2.144, 0.668, 6.179, 1.541, 1.048,
    3.595, 5.048, 1.405, 3.597, 2.379,
    2.852, 0.159, 2.391, 0.396, 1.441,
])

_W3 = np.array([
    0.00281, 0.00281, 0.00230, 0.00278, 0.00287,
    0.00210, 0.00186, 0.00263, 0.00215, 0.00236,
    0.00260, 0.00321, 0.00244, 0.00306, 0.00267,
])

_X = np.array([
    0.69, 0.64, 0.67, 0.68, 0.54,
    0.63, 0.60, 0.66, 0.66, 0.65,
    0.69, 0.69, 0.71, 0.68, 0.70,
])

_WS = np.array([
    0.01349, 0.01491, 0.01080, 0.01350, 0.01541,
    0.00900, 0.00788, 0.01275, 0.00983, 0.01095,
    0.01313, 0.01320, 0.01140, 0.01253, 0.01275,
])

_XS = np.array([
    0.61, 0.85, 0.54, 0.74, 0.89,
    0.52, 0.50, 0.67, 0.65, 0.64,
    0.72, 1.00, 0.68, 0.84, 0.78,
])


@dataclass(frozen=True)
class H2OModel:
    """One water-vapor absorption model: line table + continuum coefficients."""

    name: str
    fl: np.ndarray = field(default_factory=lambda: _FL.copy())
    s1: np.ndarray = field(default_factory=lambda: _S1.copy())
    b2: np.ndarray = field(default_factory=lambda: _B2.copy())
    w3: np.ndarray = field(default_factory=lambda: _W3.copy())
    x: np.ndarray = field(default_factory=lambda: _X.copy())
    ws: np.ndarray = field(default_factory=lambda: _WS.copy())
    xs: np.ndarray = field(default_factory=lambda: _XS.copy())
    # Continuum coefficients (foreign, self) and temperature exponents.
    cf: float = 5.43e-10
    xcf: float = 3.0
    cs: float = 1.80e-08
    xcs: float = 7.5
    # Local line-shape cutoff [GHz] (Clough convention) and its base offset.
    cutoff_ghz: float = 750.0
    # Quadratic speed-dependence of the pressure-broadened width (qSD-VVW
    # line shape, Rosenkranz 2018 SD releases): gamma2 components for air
    # (w2) and self (ws2) broadening [GHz/mb]; zero selects the ordinary
    # Van Vleck-Weisskopf shape for that line.
    w2: np.ndarray = field(default_factory=lambda: np.zeros(N_H2O_LINES))
    ws2: np.ndarray = field(default_factory=lambda: np.zeros(N_H2O_LINES))

    @property
    def has_sd(self) -> bool:
        """True if any line carries speed-dependent width parameters."""
        return bool(np.any(self.w2 != 0.0) or np.any(self.ws2 != 0.0))


def _with_line(model: H2OModel, idx: int, **updates) -> H2OModel:
    """Return a copy of `model` with per-line parameter overrides at `idx`."""
    arrays = {}
    for key, val in updates.items():
        arr = getattr(model, key).copy()
        arr[idx] = val
        arrays[key] = arr
    return replace(model, **arrays)


R98 = H2OModel(name="R98")

# R17: updated 22-GHz line center/widths (Tretyakov 2016 review values) and
# the Turner et al. (2009)-style continuum refit carried in Rosenkranz 2017.
R17 = _with_line(
    H2OModel(name="R17", cf=5.96e-10, xcf=3.0, cs=1.42e-08, xcs=7.5),
    0, fl=22.23508, w3=0.00269, x=0.76, ws=0.01344, xs=1.05,
)
R17 = _with_line(R17, 1, fl=183.31009, w3=0.00300, x=0.77, ws=0.01356, xs=0.85)

# R20: Koshelev et al. (2018) 22-GHz widths + (2021) foreign continuum.
R20 = _with_line(
    H2OModel(name="R20", cf=5.95e-10, xcf=3.0, cs=1.40e-08, xcs=7.5),
    0, fl=22.23508, w3=0.00271, x=0.76, ws=0.01349, xs=1.05,
)
R20 = _with_line(R20, 1, fl=183.31009, w3=0.00300, x=0.77, ws=0.01356, xs=0.85)

# R24: 2024 release — intensities tied to HITRAN2020, continuum refit.
R24 = _with_line(
    H2OModel(name="R24", cf=5.77e-10, xcf=3.0, cs=1.36e-08, xcs=7.5),
    0, fl=22.23508, w3=0.00271, x=0.76, ws=0.01349, xs=1.05,
)
R24 = _with_line(R24, 1, fl=183.31009, w3=0.00300, x=0.77, ws=0.01356, xs=0.85)

# ---------------------------------------------------------------------------
# The remaining five members of the nine-model sweep the reference's zenith
# study runs (R17,R03,R16,R19,R98,R19SD,R20,R20SD,R24 — slice map in
# python_src/merge_data_into_netCDF/old_merge2nc.py:417-435).
# Deltas below are the *documented* changes of each release; parameters with
# no public tabulation are carried at the nearest release's values (same
# policy as the R17/R20/R24 tables above).
# ---------------------------------------------------------------------------

# R03: Rosenkranz 2003 update of abh2o — 22-GHz air width per the
# Tretyakov et al. (2003) remeasurement, slight self-continuum retune;
# everything else at R98.
R03 = _with_line(
    H2OModel(name="R03", cf=5.43e-10, xcf=3.0, cs=1.77e-08, xcs=7.5),
    0, w3=0.00278, x=0.716, ws=0.01349,
)

# R16: 2016 release — Tretyakov (2016) review line parameters for the 22 and
# 183 GHz lines (the same line deltas later carried into R17), but still the
# pre-2017 continuum.
R16 = _with_line(
    H2OModel(name="R16"),
    0, fl=22.23508, w3=0.00269, x=0.76, ws=0.01344, xs=1.05,
)
R16 = _with_line(R16, 1, fl=183.31009, w3=0.00300, x=0.77, ws=0.01356, xs=0.85)

# R19: 2019 release — R17 continuum with the Koshelev et al. (2018) 22-GHz
# widths (the line update that also feeds R20).
R19 = _with_line(
    H2OModel(name="R19", cf=5.96e-10, xcf=3.0, cs=1.42e-08, xcs=7.5),
    0, fl=22.23508, w3=0.00271, x=0.76, ws=0.01349, xs=1.05,
)
R19 = _with_line(R19, 1, fl=183.31009, w3=0.00300, x=0.77, ws=0.01356, xs=0.85)

# Speed-dependent variants: quadratic speed dependence of the collisional
# width on the 22.235 and 183.31 GHz lines.  gamma2/gamma0 ratios per
# Koshelev et al. (2018) dual-spectrometer 22-GHz study (~0.128 air,
# ~0.127 self) and the 183-GHz SD fits of Koshelev et al. (2021) (~0.12).
R19SD = _with_line(replace(R19, name="R19SD"), 0, w2=3.47e-4, ws2=1.71e-3)
R19SD = _with_line(R19SD, 1, w2=3.60e-4, ws2=1.63e-3)

R20SD = _with_line(replace(R20, name="R20SD"), 0, w2=3.47e-4, ws2=1.71e-3)
R20SD = _with_line(R20SD, 1, w2=3.60e-4, ws2=1.63e-3)

H2O_MODELS = {
    "R98": R98, "R03": R03, "R16": R16, "R17": R17, "R19": R19,
    "R19SD": R19SD, "R20": R20, "R20SD": R20SD, "R24": R24,
}

# Machine-readable provenance, mirroring constants/o2_lines.py
# MIXING_PROVENANCE: every value is a transcription of a published source or
# an explicit carry of the nearest fully-published release — never a
# synthesized/interpolated number.  Closure path: tools/fit_tables.py.
H2O_PROVENANCE = {
    "R98": "transcribed (Rosenkranz 1998 abh2o.f 15-line table + continuum)",
    "R03": "transcribed 22-GHz Tretyakov-2003 width + continuum retune; "
           "rest carried-at-R98",
    "R16": "transcribed Tretyakov-2016 22/183-GHz line deltas; "
           "continuum carried-at-R98",
    "R17": "transcribed Tretyakov-2016 lines + Turner-2009-refit continuum",
    "R19": "transcribed Koshelev-2018 22-GHz widths on the R17 continuum",
    "R19SD": "R19 + transcribed Koshelev 2018/2021 speed-dependence ratios",
    "R20": "transcribed Koshelev-2018 widths + Koshelev-2021 foreign "
           "continuum",
    "R20SD": "R20 + transcribed speed-dependence ratios",
    "R24": "transcribed 2024 continuum refit; sub-0.1 % HITRAN-2020 "
           "intensity retunes not publicly tabulated are carried-at-R98",
}

# The reference's old zenith pipeline evaluates exactly these nine, in this
# CSV slice order (old_merge2nc.py:417-435).
ZENITH_SWEEP_MODELS = ("R17", "R03", "R16", "R19", "R98",
                       "R19SD", "R20", "R20SD", "R24")
