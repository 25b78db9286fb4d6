"""Cloud-layer detection and adiabatic liquid/ice water from RH profiles.

Re-implementation (behavioral parity, ground->top ordering) of the
reference's Nandan et al. (2022) 8-step scheme and Chakraborty & Maitra
(2011) adiabatic LWC scaling (reference/python_src/preproc/
derive_cloud_water.py:146-363, 68-142):

  1. convert RH over liquid to RH over ice below 0 C
  2-4. preliminary cloud layers where RH > min threshold, with
     height-dependent (min, max, inter) thresholds per Nandan Table:
     (92,95,84) below 2 km / (90,93,82) 2-6 km / (88,90,78) 6-12 km /
     (75,80,70) above 12 km
  5. drop layers based below 500 m thinner than 400 m
  6. drop layers that never reach the max threshold
  7. merge layers separated by < 300 m gaps (or gap RH > inter threshold)
  8. drop layers thinner than 100 m

LWC: lwc_ad = rho * cp/L * (Gamma_d - Gamma_s) * dz, scaled by
(1.239 - 0.145 ln(dh)) with dh the height above cloud base; phase split at
273.15 / 233.15 K (mixed treated as liquid); LWP/IWP column integrals.

Host-side NumPy (data ingest, not a TPU hot path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# (min_rh, max_rh, inter_rh) per height band  [% over water/ice]
RH_THRESHOLDS = (
    (2_000.0, (92.0, 95.0, 84.0)),
    (6_000.0, (90.0, 93.0, 82.0)),
    (12_000.0, (88.0, 90.0, 78.0)),
    (np.inf, (75.0, 80.0, 70.0)),
)

# Chakraborty & Maitra (2011) adiabatic constants (as used by the reference)
CP = 1003.5        # J/kg/K
L_FREEZE = 334944.0  # J/kg
R_L = 287.06       # J/kg/K
GAMMA_D = 9.76e-3  # K/m
GAMMA_S = 6.5e-3   # K/m

T_LIQ = 273.15     # warmer than this at both bounds -> liquid cloud
T_ICE = 233.15     # colder than this at both bounds -> ice cloud


def _es_liq_pa(t_c):
    return 610.78 * np.exp(2.5e6 / 462.0 * (1.0 / 273.15 - 1.0 / (273.15 + t_c)))


def _es_ice_pa(t_c):
    return 610.78 * np.exp(2.840e6 / 462.0 * (1.0 / 273.15 - 1.0 / (273.15 + t_c)))


def _band(z: float):
    for zmax, thresh in RH_THRESHOLDS:
        if z < zmax:
            return thresh
    return RH_THRESHOLDS[-1][1]


@dataclass
class CloudLayers:
    bases_m: np.ndarray   # (n_layers,)
    tops_m: np.ndarray    # (n_layers,)
    mask: np.ndarray      # (L,) bool, True inside cloud


def detect_cloud_layers(z_m, t_k, rh_pct) -> CloudLayers:
    """Nandan steps 1-8.  Inputs ascending (ground -> top), shape (L,)."""
    z = np.asarray(z_m, float)
    t = np.asarray(t_k, float)
    rh = np.asarray(rh_pct, float).copy()

    # 1) RH over ice below freezing
    cold = t < 273.15
    tc = t - 273.15
    rh[cold] = rh[cold] * _es_liq_pa(tc[cold]) / _es_ice_pa(tc[cold])

    # 2-4) preliminary layers: RH > band min threshold
    above = np.zeros(z.shape, bool)
    for i in range(z.size):
        above[i] = np.isfinite(rh[i]) and rh[i] > _band(z[i])[0]
    layers = _runs(above)

    # 5) low thin layers
    layers = [
        (b, tpp) for (b, tpp) in layers
        if not (z[b] < 500.0 and (z[tpp] - z[b]) < 400.0)
    ]

    # 6) max threshold reached inside layer?
    kept = []
    for b, tpp in layers:
        if np.any(rh[b:tpp + 1] > _band(z[b])[1]):
            kept.append((b, tpp))
    layers = kept

    # 7) merge across small / moist gaps
    merged = []
    for b, tpp in layers:
        if merged:
            pb, pt = merged[-1]
            gap = z[b] - z[pt]
            gap_rh = rh[pt + 1:b]
            inter = _band(z[pb])[2]
            if gap < 300.0 or (gap_rh.size > 0 and np.nanmin(gap_rh) > inter):
                merged[-1] = (pb, tpp)
                continue
        merged.append((b, tpp))
    layers = merged

    # 8) thin layers
    layers = [(b, tpp) for (b, tpp) in layers if (z[tpp] - z[b]) >= 100.0]

    mask = np.zeros(z.shape, bool)
    for b, tpp in layers:
        mask[b:tpp + 1] = True
    return CloudLayers(
        bases_m=np.array([z[b] for b, _ in layers]),
        tops_m=np.array([z[tpp] for _, tpp in layers]),
        mask=mask,
    )


def _runs(mask: np.ndarray) -> list:
    """Contiguous True runs as (start, end) inclusive index pairs."""
    out = []
    i = 0
    n = mask.size
    while i < n:
        if mask[i]:
            j = i
            while j + 1 < n and mask[j + 1]:
                j += 1
            out.append((i, j))
            i = j + 1
        else:
            i += 1
    return out


def adiabatic_water(z_m, p_hpa, t_k, layers: CloudLayers):
    """LWC/IWC [kg/m^3 and kg/kg] + LWP/IWP [kg/m^2] for detected layers.

    Phase rule (derive_cloud_water.py:88-124): both bounds > 273.15 K ->
    liquid; both < 233.15 K -> ice; in between -> mixed, treated as liquid.
    """
    z = np.asarray(z_m, float)
    p = np.asarray(p_hpa, float)
    t = np.asarray(t_k, float)
    L = z.size
    lwc_m3 = np.zeros(L)
    lwc_kg = np.zeros(L)
    iwc_m3 = np.zeros(L)
    iwc_kg = np.zeros(L)

    for base, top in zip(layers.bases_m, layers.tops_m):
        ib = int(np.nanargmin(np.abs(z - base)))
        it = int(np.nanargmin(np.abs(z - top)))
        t_base, t_top = t[ib], t[it]
        if t_base < T_ICE and t_top < T_ICE:
            wc_m3, wc_kg = iwc_m3, iwc_kg
        else:
            wc_m3, wc_kg = lwc_m3, lwc_kg  # liquid or mixed-as-liquid
        for j in range(ib + 1, it + 1):
            rho = p[j] * 100.0 / R_L / t[j]
            dz = z[j] - z[j - 1]
            wc_ad = rho * CP / L_FREEZE * (GAMMA_D - GAMMA_S) * dz
            dh = z[j] - base
            with np.errstate(divide="ignore", invalid="ignore"):
                wc = wc_ad * (1.239 - 0.145 * np.log(dh))
            if not np.isfinite(wc) or wc < 0.0:
                wc = 0.0
            wc_m3[j] = wc
            wc_kg[j] = wc / rho

    dzg = np.gradient(z)
    lwp = float(np.abs(np.sum(lwc_m3 * dzg)))
    iwp = float(np.abs(np.sum(iwc_m3 * dzg)))
    return {
        "lwc_kg_m3": lwc_m3, "lwc_kg_kg": lwc_kg, "lwp_kg_m2": lwp,
        "iwc_kg_m3": iwc_m3, "iwc_kg_kg": iwc_kg, "iwp_kg_m2": iwp,
    }


def derive_cloud_features(z_m, p_hpa, t_k, rh_pct) -> dict:
    """Full pipeline: detect layers then derive water contents.

    The `derive_cloud_features` entry point of the reference
    (derive_cloud_water.py:146), reduced to the physically meaningful inputs
    (z, p, T, RH) and returning a dict plus the layer diagnostic.
    """
    layers = detect_cloud_layers(z_m, t_k, rh_pct)
    out = adiabatic_water(z_m, p_hpa, t_k, layers)
    out["layers"] = layers
    # invariants promoted to assertions (SURVEY.md section 4: the reference
    # only prints warnings, derive_cloud_water.py:214-224)
    assert layers.bases_m.shape == layers.tops_m.shape
    assert np.all(layers.tops_m >= layers.bases_m)
    return out
