"""Plain-torch mirrors of the kernels' arithmetic, for the tests only: each
follows its kernel's order of operations (with IEEE divides where the kernel
takes an approximate reciprocal), so that a CPU test can hold the arithmetic
against float64 apart from the tables' rounding.  Nothing of the port's paths
calls them.
"""

import numpy as np
import torch

from ...constants import H2O_MODELS
from .. import geometry
from ..absorption.h2o import _GL_W, _GL_X
from .absorption import HEADER_FIELDS, pack_tables, table_layout
from .spectral import _check_model, line_state


def absorption_spectral_merged(f_ghz, p, t, rho, lwc, model: str = "R24",
                               o3=None, whole_grid: bool = False):
    """K6's main pass in plain torch, in its order of operations: the state
    of `line_state`, then one rational per line and frequency in
    q = d1 d2 + w^2, where d1 = (f - f0) - dnu is the distance to the
    (shifted) line centre, d2 = d1 + c that to its mirror image, c =
    2 (f0 + dnu) and w the width.  With A = d1^2 + w^2 and B = d2^2 + w^2
    the two Lorentzian halves n1 / A + n2 / B of an O2 line are
    (n1 B + n2 A) / (A B), and A + B = c^2 + 2 q, A B = q^2 + w^2 c^2,
    n1 B + n2 A = k2 + q k3 with the per-point coefficients k2, k3 of
    `line_state`; an H2O line inside the cutoff on both sides is the same
    with n1 = n2.  Two O2 lines share one divide, (n_a D_b + n_b D_a) /
    (D_a D_b), and an odd line out goes alone.  Then the line sums
    times f^2, and the liquid term from two reciprocals.  Divides are IEEE
    here; the kernel takes an approximate reciprocal in the line loops.
    Returns (F, *shape).

    q is formed from the difference d1 and never expanded in f: as
    (f^2 - (c / 2)^2) + w^2 it cancels at the line centres aloft.

    K1 (`csrc/absorption.cu`) has the same arithmetic with two differences,
    which `whole_grid` and `o3` bring in: an H2O line takes the merged form
    only where both halves lie inside the cutoff for all frequencies given
    (K6 decides per tile of eight, this function per frequency), and the O3
    lines of `o3` [ppmv, the points' shape], one merged rational each with
    the density scale folded into the strength, join the H2O sum.
    """
    _check_model(model)
    lay = table_layout(model, o3 is not None)
    table = torch.as_tensor(pack_tables(model, o3 is not None), dtype=p.dtype,
                            device=p.device)
    cut = table[HEADER_FIELDS.index("cutoff")]
    fdep_on = bool(table[HEADER_FIELDS.index("n2_fdep")] != 0.0)
    fl = table[lay.h2o:lay.h2o + lay.n_h2o]
    f0 = table[lay.o2:lay.o2 + lay.n_o2]
    h2o = H2O_MODELS[model]
    sd = (np.asarray(h2o.w2) != 0.0) | (np.asarray(h2o.ws2) != 0.0)
    st = line_state(p, t, rho, lwc, model)
    f = torch.as_tensor(f_ghz, dtype=p.dtype, device=p.device)
    f = f.reshape((-1,) + (1,) * p.ndim)

    acc_h2o = torch.zeros((f.shape[0], *p.shape), dtype=p.dtype,
                          device=p.device)
    for line in range(lay.n_h2o):
        wsq, sw, sb, sn, c0, gamma2 = (
            st["h2o"][k][..., line][None]
            for k in ("wsq", "sw", "sb", "sn", "c0", "gamma2"))
        d1, d2 = f - fl[line], f + fl[line]
        a, b = d1 * d1 + wsq, d2 * d2 + wsq
        near_in, far_in = d1.abs() < cut, d2.abs() < cut
        if sd[line]:
            near = torch.zeros_like(acc_h2o)
            for x_k, w_k in zip(_GL_X, _GL_W):
                cr = c0 + gamma2 * float(x_k)
                near = near + (sn * float(w_k) * cr) / (cr * cr + d1 * d1)
        else:
            near = sw / a
        apart = (torch.where(near_in, near - sb, 0.0)
                 + torch.where(far_in, sw / b - sb, 0.0))
        # both halves as one rational in q = d1 d2 + w^2, with c = 2 fl:
        # A + B = c^2 + 2 q and A B = q^2 + w^2 c^2
        csq = 4.0 * fl[line] * fl[line]
        q = d1 * d2 + wsq
        both = ((sw * csq + q * (2.0 * sw)) / (q * q + wsq * csq)
                - 2.0 * sb)
        merge = near_in & far_in & (not sd[line])
        acc_h2o = acc_h2o + torch.where(merge.all() if whole_grid else merge,
                                        both, apart)

    if o3 is not None:
        fl3, s1, b2, w3, x3 = table[lay.o3:lay.gl].reshape(5, lay.n_o3)
        ti = 300.0 / t
        o3_scale = (0.3183e-4 * (7.2429e12 * p * o3 / t))[None]
        ti25 = ti ** 2.5
        for line in range(lay.n_o3):
            width = (w3[line] * p * ti ** x3[line])[None]
            wsq = width * width
            s_line = (s1[line] * ti25 * torch.exp(b2[line] * (1.0 - ti)))[None]
            sw = (s_line * o3_scale * (1.0 / (fl3[line] * fl3[line]))) * width
            csq = 4.0 * fl3[line] * fl3[line]
            q = (f - fl3[line]) * (f + fl3[line]) + wsq
            acc_h2o = acc_h2o + ((sw * csq + q * (2.0 * sw))
                                 / (q * q + wsq * csq))

    def o2_rational(line):
        """Numerator and denominator of one O2 line's merged halves."""
        dnu, c2, dfsq, k2, k3 = (
            st["o2"][k][..., line][None]
            for k in ("dnu", "c2", "dfsq", "k2", "k3"))
        d1 = (f - f0[line]) - dnu
        q = d1 * (d1 + c2) + dfsq
        return k2 + q * k3, q * q + dfsq * (c2 * c2)

    acc_o2 = torch.zeros_like(acc_h2o)
    paired = lay.n_o2 - lay.n_o2 % 2
    for line in range(0, paired, 2):
        (na, da), (nb, db) = o2_rational(line), o2_rational(line + 1)
        acc_o2 = acc_o2 + (na * db + nb * da) / (da * db)
    for line in range(paired, lay.n_o2):
        num, den = o2_rational(line)
        acc_o2 = acc_o2 + num / den

    sc = {k: v[None] for k, v in st["scalars"].items()}
    f2 = f * f
    h2o_term = f2 * (acc_h2o + sc["con_b"])
    nonres = sc["k_nr"] * f2 / (f2 + sc["dfnr2"])
    o2_term = torch.clamp_min(sc["o2s"] * (nonres + f2 * acc_o2), 0.0)
    fdep = (0.5 + 0.5 / (1.0 + (f / 450.0) * (f / 450.0)) if fdep_on
            else torch.ones_like(f))
    n2_term = sc["n2k"] * (fdep * f2)
    u = f * sc["inv_fp"]
    v = u * (1.0 / 39.8)
    ru, rv = 1.0 / (1.0 + u * u), 1.0 / (1.0 + v * v)
    re = 3.52 + sc["e01"] * ru + sc["e12"] * rv
    im = -(sc["e01"] * (u * ru) + sc["e12"] * (v * rv))
    aimag = 3.0 * im / ((re + 2.0) * (re + 2.0) + im * im)
    return h2o_term + o2_term + n2_term + sc["wk"] * (aimag * f)


def absorption_lb_merged(freqs, p, t, rho, lwc, model: str = "R24", o3=None):
    """K1's arithmetic (`csrc/absorption.cu`) in the inputs' dtype,
    (F, L, B): the per-point line state, one rational in q = d1 d2 + w^2 per
    line, two O2 lines per divide, the O3 lines' density scale folded into
    their strengths, f^2 applied once after the sums
    (`absorption_spectral_merged` with K1's two differences)."""
    return absorption_spectral_merged(list(freqs), p, t, rho, lwc, model,
                                      o3=o3, whole_grid=True)


def staged_chords(elevations, z, n, float64: bool = True) -> torch.Tensor:
    """The slant paths (E, L-1, B) [km] as K2 forms them
    (`csrc/rte.cu::chord_km`): `geometry.chord_lengths` on the float32 z [m]
    and n (L, B) in float64 arithmetic (with cos(elevation) in float64),
    rounded to float32.  With `float64` False the same in float32, where
    r = R_E + z is quantized to half a metre: what the float64 chord
    removes."""
    work = torch.float64 if float64 else torch.float32
    cos_el = torch.cos(torch.deg2rad(
        torch.as_tensor(elevations, dtype=work, device=z.device)))
    zw, nw = z.float().to(work), n.float().to(work)
    return torch.stack([geometry.chord_lengths(zw, nw, c)
                        for c in cos_el]).float()


def planck_series(x, t):
    """The Planck radiance in K, x / expm1(x / t) with x = h f / k, by the
    series the staged RTE body takes where u = x / t < 0.25:
    t (1 - u / 2 + u^2 / 12 - u^4 / 720)."""
    u = x / t
    u2 = u * u
    return t * ((1.0 - 0.5 * u) + u2 * (1.0 / 12.0 - u2 * (1.0 / 720.0)))
