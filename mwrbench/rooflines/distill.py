"""The needed work of one call of `fast.train_step`, from the cell's sizes: B
profiles of L levels, C channels, E elevations, K = L - 1 layers and the
regression's 72 features.

  product   the forward product (C, 72) x (72, K B), each multiply-add one
            FMA, at the fp32 peak; no bytes (the features of the layer
            means can be formed where they are used, from the profiles);
  k2mid     K2 on layer-mean extinction (`counts.k2_roofline` with
            `alpha_is_mid`), the forward RTE;
  k2v       K2's backward, `k2v_roofline` below;
  backward  the gradient of the weights, X^T g: (72, K B) x (K B, C), as
            the forward product.

Adam's update of 72 C weights, the loss and its seed, and the clamp's gate
are elementwise over at most C K B values and counted as nothing.

`k2v_roofline` follows `counts.py`'s convention (the fp32 pipe, divides and
square roots, transcendentals, each input read once and each output
written once), each quantity on the indices it depends on.  What the
function needs, per (elevation, channel, layer, profile): the opacity, its
running sum and the transmittance (one exponential), the closed-form
emission factors with the layer's own transmittance e^-d from two
consecutive ones (one divide for g_top / d, which is also dg_bot/dd), the
layer's emission into the radiance, its derivative E'_k T_k, the suffix sum
S_k, W_k, the layer's term cot dtb/dR W_k ds_k and its sum over the
elevations; per (elevation, layer, profile) the chord (`counts`' chord);
per (channel, level, profile) the Planck radiance; per (elevation,
channel, profile) the cosmic term and dtb/dR.  Bytes: alpha_mid (C, K, B)
read and dL/dalpha_mid written, z, n, T (L, B), the cotangent (E, C, B),
the channels and cos(elevation).  With `as_coded` it counts the body of
`csrc/rte_vjp.cu` instead: the chord in each (elevation, channel) warp, the
two shuffle scans, the emission factors by K5's 10-term series below an
opacity of 0.5 (a share `series_fraction` of the layers) and the closed
form above it, each walk forming them anew.
"""

from . import counts

N_FEATURES = 72

_LAYER_NEEDED = ("fmul fadd fexp "        # d, its running sum, T_k
                 "fadd fmul fadd fmul fdiv fmul fadd "   # g_top/d, g_top, g_bot
                 "fmul*3 fadd*2 "         # E_k T_k into the radiance
                 "fadd fmul*3 fadd "      # dg_top; E'_k T_k
                 "fadd*3 "                # S_k, W_k
                 "fmul*2 fadd")           # the term and the elevation sum
_THREAD_NEEDED = ("fmul fexp "            # ctt
                  "fdiv fexp fadd fmul*3 fdiv "          # dtb/dR
                  "fmul")                 # times the cotangent
_PLANCK = "fdiv*2 fexp"
_SERIES = "fmul*9 fadd*9"                 # one 10-term Horner series
_CODED = {
    # each warp's chord: sqrtf twice, the quotient, the clamps
    "layer_chord": "fmul fdiv*2 fadd cmp*3 fdiv fmul",
    # walk 1: d, the 5-step scan, T_k, g_bot from expm1f, the radiance
    "layer": ("fmul fadd*5 cmp*5 fadd fexp fexp fadd fmul fmul*3 fadd "
              # walk 2: d, expm1f, E and E', the scan, W_k, the term
              "fmul fexp fadd fmul fmul*6 fadd*2 fadd*5 cmp*5 fadd*3 "
              "fmul*2 fadd"),
    # per walk, the emission factors' series (g_top/d; in walk 2 also
    # dg_top) or the closed form (expf, the quotient)
    "layer_series": f"{_SERIES} {_SERIES} {_SERIES}",
    "layer_closed": "fexp fadd fmul fadd fmul fdiv fexp fadd fmul fadd fmul "
                    "fdiv fadd",
    "level": _PLANCK,
    "thread": f"fmul {_PLANCK} fexp fdiv fexp fadd fmul*3 fdiv fmul",
}


def product_roofline(batch: int, n_levels: int, n_channels: int):
    """One (C, 72) x (72, K B) product, or its transpose's."""
    fma = float(N_FEATURES) * n_channels * (n_levels - 1) * batch
    return counts.Roofline(fma, 0.0, 0.0, 0.0)


def k2v_roofline(batch: int, n_levels: int = 180, n_channels: int = 14,
                 n_elevations: int = 10, as_coded: bool = False,
                 series_fraction: float = 1.0) -> counts.Roofline:
    """K2v, `forward_lb_vjp`: dL/dalpha_mid (C, K, B) from alpha_mid, z,
    n, T and the cotangent of tb (E, C, B)."""
    threads = float(batch) * n_channels * n_elevations
    layers = threads * (n_levels - 1)
    levels = float(batch) * n_channels * n_levels
    if as_coded:
        times = {"layer": layers, "layer_chord": layers,
                 "layer_series": layers * series_fraction,
                 "layer_closed": layers * (1.0 - series_fraction),
                 "level": levels, "thread": threads}
        ops = counts._charge(_CODED, counts._FLOAT, times)
    else:
        paths = float(batch) * n_elevations
        body = {"layer": _LAYER_NEEDED, "chord": counts._CHORD,
                "path": "fadd fmul*2", "level": _PLANCK,
                "thread": _THREAD_NEEDED, "freq": f"fmul {_PLANCK}"}
        times = {"layer": layers, "chord": paths * (n_levels - 1),
                 "path": paths, "level": levels, "thread": threads,
                 "freq": n_channels}
        ops = counts._charge(body, counts._FLOAT, times)
    fields = float(n_channels) * (n_levels - 1) * batch
    hbm = (4.0 * (2 * fields + 3 * n_levels * batch + threads + n_channels)
           + 8.0 * n_elevations)
    return ops.roofline(hbm)


def distill_call(workload: dict, config: dict) -> dict:
    """{"product": [..], "k2mid": [..], "k2v": [..], "backward": [..]} of
    `Roofline`s, one a launch of a call."""
    b, n_lev = workload["batch"], config["n_levels"]
    n_ch, n_el = len(config["channels_ghz"]), len(config["elevations_deg"])
    return {"product": [product_roofline(b, n_lev, n_ch)],
            "k2mid": [counts.k2_roofline(b, n_lev, n_ch, n_el,
                                         alpha_is_mid=True)],
            "k2v": [k2v_roofline(b, n_lev, n_ch, n_el)],
            "backward": [product_roofline(b, n_lev, n_ch)]}
