"""Plain-torch mirrors of the kernels' arithmetic, for the tests only: each
follows its kernel's order of operations (with IEEE divides where the kernel
takes an approximate reciprocal), so that a CPU test can hold the arithmetic
against float64 apart from the tables' rounding.  Nothing of the port's paths
calls them.
"""

import numpy as np
import torch

from ...constants import H2O_MODELS
from ...constants import physics as phys
from .. import geometry, rte
from ..absorption.h2o import _GL_W, _GL_X
from .absorption import (H2O_FIELDS, HEADER_FIELDS, O2_FIELDS, pack_tables,
                         table_layout, tangent_groups)
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


def _dmul(a, b):
    """The product of two (value, d/dT, d/drho) triples."""
    return (a[0] * b[0], a[1] * b[0] + a[0] * b[1], a[2] * b[0] + a[0] * b[2])


def _dscale(k, a):
    return tuple(k * x for x in a)


def _tangents_group(f, p, t, rho, lwc, head, h2o, o2, gl):
    """One group of K4 (`csrc/absorption_tangents.cu`): alpha, dalpha/dT,
    dalpha/drho at the channels f (G, 1, ...) for points of any one shape,
    in the order of the kernel's operations."""
    cut = head["cutoff"]
    f_lo, f_hi = float(f.min()), float(f.max())
    # the point: every power of ti from one log2, its tangent x ti^x (-1/T)
    ti = 300.0 / t
    m_t = ti * (-1.0 / 300.0)
    ti_t = ti * m_t
    th1 = ti - 1.0
    l2 = torch.log2(ti)

    def pow_ti(x):
        v = torch.exp2(x * l2)
        return v, v * (x * m_t)

    pvap = (rho * t / 217.0, rho * (1.0 / 217.0), t * (1.0 / 217.0))
    pda = (p - pvap[0], -pvap[1], -pvap[2])
    zero = torch.zeros_like(f * p)
    acc = (zero, zero, zero)

    # O2 lines: one merged rational each, whose q has tangents that do not
    # depend on the channel
    b = pow_ti(head["o2_x"])
    hf = head["h2o_factor"]
    den = (0.001 * (pda[0] * b[0] + hf * pvap[0] * ti),
           0.001 * ((pda[1] * b[0] + pda[0] * b[1])
                    + hf * (pvap[1] * ti + pvap[0] * ti_t)),
           0.001 * (pda[2] * b[0] + hf * pvap[2] * ti))
    pe2 = (den[0] * den[0], 2.0 * den[0] * den[1], 2.0 * den[0] * den[2])
    ybase = ((0.001 * p * b[0], 0.001 * p * b[1], torch.zeros_like(p))
             if head["mixing_basis_p"] != 0.0 else den)
    o2c = dict(zip(O2_FIELDS, o2))
    for line in range(o2.shape[1]):
        f0, w300, be = (o2c[k][line] for k in ("f", "w300", "be"))
        df = _dscale(w300, den)
        dfsq = _dscale(w300 * w300, pe2)
        sv = o2c["s300"][line] / (f0 * f0) * torch.exp(-be * th1)
        sn = (sv, sv * (-be * ti_t))
        yy = o2c["y1"][line] * th1 + o2c["y0"][line]
        yy_t = o2c["y1"][line] * ti_t
        y = (ybase[0] * yy, ybase[1] * yy + ybase[0] * yy_t, ybase[2] * yy)
        gg = o2c["g1"][line] * th1 + o2c["g0"][line]
        gg_t = o2c["g1"][line] * ti_t
        dfg = _dmul(df, (pe2[0] * gg + 1.0, pe2[1] * gg + pe2[0] * gg_t,
                         pe2[2] * gg))
        nn = o2c["dnu1"][line] * th1 + o2c["dnu0"][line]
        nn_t = o2c["dnu1"][line] * ti_t
        dnu = (pe2[0] * nn, pe2[1] * nn + pe2[0] * nn_t, pe2[2] * nn)
        c2 = (2.0 * dnu[0] + 2.0 * f0, 2.0 * dnu[1], 2.0 * dnu[2])
        dfg_s = (sn[0] * dfg[0], sn[1] * dfg[0] + sn[0] * dfg[1],
                 sn[0] * dfg[2])
        sy = (sn[0] * y[0], sn[1] * y[0] + sn[0] * y[1], sn[0] * y[2])
        yc = _dmul(sy, c2)
        c2sq = (c2[0] * c2[0], 2.0 * c2[0] * c2[1], 2.0 * c2[0] * c2[2])
        k1 = _dmul(dfsq, c2sq)
        k2 = tuple(a - b for a, b in zip(_dmul(dfg_s, c2sq),
                                         _dscale(2.0, _dmul(dfsq, yc))))
        k3 = tuple(2.0 * a + b for a, b in zip(dfg_s, yc))
        q_t = dfsq[1] - c2[0] * dnu[1]
        q_r = dfsq[2] - c2[0] * dnu[2]
        n_t, n_r = k2[1] + q_t * k3[0], k2[2] + q_r * k3[0]
        d1 = (f - f0) - dnu[0]
        q = d1 * (d1 + c2[0]) + dfsq[0]
        dv = q * q + k1[0]
        s = (q * k3[0] + k2[0]) / dv
        acc = (acc[0] + s,
               acc[1] + ((q * k3[1] + n_t) - s * (q * (2.0 * q_t) + k1[1]))
               / dv,
               acc[2] + ((q * k3[2] + n_r) - s * (q * (2.0 * q_r) + k1[2]))
               / dv)

    # the clamped O2 term, N2, cloud liquid and the water continuum, over f^2
    f2 = f * f
    dfnr = _dscale(head["wb300"], den)
    ti_inv = t / 300.0
    knr = head["nonres"]
    k_nr = (knr * dfnr[0] * ti_inv,
            knr * (dfnr[1] * ti_inv + dfnr[0] * (1.0 / 300.0)),
            knr * dfnr[2] * ti_inv)
    dfnr2 = (dfnr[0] * dfnr[0], 2.0 * dfnr[0] * dfnr[1],
             2.0 * dfnr[0] * dfnr[2])
    ti3 = (ti * ti * ti, 3.0 * ti * ti * ti_t)
    o2s = _dscale(head["o2_scale"], (pda[0] * ti3[0],
                                     pda[1] * ti3[0] + pda[0] * ti3[1],
                                     pda[2] * ti3[0]))
    rn = 1.0 / (f2 + dfnr2[0])
    nr = k_nr[0] * rn
    inner = (acc[0] + nr, acc[1] + (k_nr[1] - nr * dfnr2[1]) * rn,
             acc[2] + (k_nr[2] - nr * dfnr2[2]) * rn)
    o2_term = _dmul(o2s, inner)
    on = o2_term[0] > 0.0
    total = tuple(torch.where(on, x, 0.0) for x in o2_term)
    n2t = pow_ti(head["n2_exp"])
    pda2 = (pda[0] * pda[0], 2.0 * pda[0] * pda[1], 2.0 * pda[0] * pda[2])
    n2k = _dscale(head["n2_coef"], (pda2[0] * n2t[0],
                                    pda2[1] * n2t[0] + pda2[0] * n2t[1],
                                    pda2[2] * n2t[0]))
    fdep = (0.5 + 0.5 / (1.0 + (f / 450.0) * (f / 450.0))
            if head["n2_fdep"] != 0.0 else torch.ones_like(f))
    total = tuple(a + fdep * b for a, b in zip(total, n2k))
    tcf, tcs = pow_ti(head["xcf"]), pow_ti(head["xcs"])
    cf, cs = head["cf"], head["cs"]
    con_a = (cf * tcf[0] * pda[0] + cs * tcs[0] * pvap[0],
             (cf * tcf[1] * pda[0] + cf * tcf[0] * pda[1])
             + (cs * tcs[1] * pvap[0] + cs * tcs[0] * pvap[1]),
             cf * tcf[0] * pda[2] + cs * tcs[0] * pvap[2])
    con_b = _dmul(con_a, pvap)
    theta1, theta1_t = 1.0 - ti, -ti_t
    eps0, eps0_t = 77.66 - 103.3 * theta1, -103.3 * theta1_t
    eps1, eps1_t = 0.0671 * eps0, 0.0671 * eps0_t
    inv_fp = 1.0 / (20.1 * torch.exp(7.88 * theta1))
    inv_fp_t = -inv_fp * (7.88 * theta1_t)
    e01, e01_t = eps0 - eps1, eps0_t - eps1_t
    e12, e12_t = eps1 - 3.52, eps1_t
    u, u_t = f * inv_fp, f * inv_fp_t
    v, v_t = u * (1.0 / 39.8), u_t * (1.0 / 39.8)
    ru, rv = 1.0 / (u * u + 1.0), 1.0 / (v * v + 1.0)
    ru_t, rv_t = -2.0 * u * u_t * ru * ru, -2.0 * v * v_t * rv * rv
    re = 3.52 + e01 * ru + e12 * rv
    re_t = e01_t * ru + e01 * ru_t + e12_t * rv + e12 * rv_t
    im = -(e01 * (u * ru) + e12 * (v * rv))
    im_t = -(e01_t * (u * ru) + e01 * (u_t * ru + u * ru_t)
             + e12_t * (v * rv) + e12 * (v_t * rv + v * rv_t))
    dd = (re + 2.0) * (re + 2.0) + im * im
    aimag = 3.0 * im / dd
    aimag_t = (3.0 * im_t - aimag * 2.0 * ((re + 2.0) * re_t + im * im_t)) / dd
    lk = -0.06286 * lwc * f * (1.0 / f2)
    acc = (total[0] + (lk * aimag + con_b[0]),
           total[1] + (lk * aimag_t + con_b[1]), total[2] + con_b[2])

    # H2O lines: one rational in q where both halves lie inside the cutoff
    # for the whole group, the halves apart otherwise
    h_v, h_r = 0.3183e-4 * (3.344e16 * rho), 0.3183e-4 * 3.344e16
    ti25 = pow_ti(2.5)
    cut2 = cut * cut
    two_base = (zero, zero, zero)
    hc = dict(zip(H2O_FIELDS, h2o))
    gl_x, gl_w = gl[:16], gl[16:]

    def add_line(into, sn, aw, res, res_w):
        return (into[0] + sn[0] * res,
                into[1] + (sn[1] * res + aw[0] * res_w),
                into[2] + (sn[2] * res + aw[1] * res_w))

    for line in range(h2o.shape[1]):
        fl = hc["fl"][line]
        flf = float(fl)
        sd = bool(hc["w2"][line] != 0.0) or bool(hc["ws2"][line] != 0.0)
        tix, tixs = pow_ti(hc["x"][line]), pow_ti(hc["xs"][line])
        a, a_t = hc["w3"][line] * tix[0], hc["w3"][line] * tix[1]
        bw, bw_t = hc["ws"][line] * tixs[0], hc["ws"][line] * tixs[1]
        w = (a * pda[0] + bw * pvap[0],
             (a_t * pda[0] + a * pda[1]) + (bw_t * pvap[0] + bw * pvap[1]),
             a * pda[2] + bw * pvap[2])
        wsq = w[0] * w[0]
        s = (hc["s1"][line] / (fl * fl)) * ti25[0] \
            * torch.exp(hc["b2"][line] * (1.0 - ti))
        s_t = s * m_t * (2.5 - hc["b2"][line] * ti)
        sn = (s * h_v, s_t * h_v, s * h_r)
        rcut = 1.0 / (cut2 + wsq)
        bv = w[0] * rcut
        bv_w = rcut - 2.0 * bv * bv
        aw = (sn[0] * w[1], sn[0] * w[2])
        both = all(abs(x) < float(cut) for x in
                   (f_lo - flf, f_hi - flf, f_lo + flf, f_hi + flf))
        if both and not sd:
            csq = 4.0 * fl * fl
            two_base = add_line(two_base, sn, aw, 2.0 * bv, 2.0 * bv_w)
            q = (f - fl) * (f + fl) + wsq
            e = 2.0 * q + csq
            den_q = q * q + wsq * csq
            sh = w[0] * e / den_q
            sh_w = ((e + 4.0 * wsq) - sh * (2.0 * w[0] * e)) / den_q
            acc = add_line(acc, sn, aw, sh, sh_w)
            continue
        d1, d2 = f - fl, f + fl
        near_in, far_in = d1.abs() < cut, d2.abs() < cut
        far = w[0] / (d2 * d2 + wsq)
        res = torch.where(far_in, far - bv, 0.0)
        res_w = torch.where(far_in, (1.0 / (d2 * d2 + wsq) - 2.0 * far * far)
                            - bv_w, 0.0)
        if not sd:
            near = w[0] / (d1 * d1 + wsq)
            res = res + torch.where(near_in, near - bv, 0.0)
            res_w = res_w + torch.where(
                near_in, (1.0 / (d1 * d1 + wsq) - 2.0 * near * near) - bv_w,
                0.0)
        acc = add_line(acc, sn, aw, res, res_w)
        if sd:
            a2, a2_t = hc["w2"][line] * tix[0], hc["w2"][line] * tix[1]
            b2, b2_t = hc["ws2"][line] * tixs[0], hc["ws2"][line] * tixs[1]
            g2 = (a2 * pda[0] + b2 * pvap[0],
                  (a2_t * pda[0] + a2 * pda[1])
                  + (b2_t * pvap[0] + b2 * pvap[1]),
                  a2 * pda[2] + b2 * pvap[2])
            c0 = tuple(x - 1.5 * y for x, y in zip(w, g2))
            ci2 = d1 * d1
            vs = ps = qs = 0.0
            for xk, wk in zip(gl_x, gl_w):
                cr = g2[0] * xk + c0[0]
                dk = cr * cr + ci2
                sh = cr / dk
                wd = wk * (1.0 / dk - 2.0 * sh * sh)
                vs = vs + wk * sh
                ps = ps + wd
                qs = qs + wd * xk
            res = vs - bv
            res_t = ps * c0[1] + (qs * g2[1] - bv_w * w[1])
            res_r = ps * c0[2] + (qs * g2[2] - bv_w * w[2])
            acc = (acc[0] + torch.where(near_in, sn[0] * res, 0.0),
                   acc[1] + torch.where(near_in, sn[1] * res + sn[0] * res_t,
                                        0.0),
                   acc[2] + torch.where(near_in, sn[2] * res + sn[0] * res_r,
                                        0.0))
    return tuple(f2 * (x - y) for x, y in zip(acc, two_base))


def absorption_tangents_grouped(freqs, p, t, rho, lwc, model: str = "R24",
                                group=None):
    """K4's arithmetic (`csrc/absorption_tangents.cu`) in the inputs' dtype:
    alpha, dalpha/dT and dalpha/drho, each (F, *shape).

    The channels go in groups of `group` (the kernel's rule,
    `tangent_groups`, when None), the last group filled up with its last
    channel, and each group forms its own line state.  Every power of
    ti = 300 / T is exp2(x log2 ti) with the tangent x ti^x (-1 / T); the
    strengths carry 1 / f_line^2 (and the H2O density scale); an O2 line is
    K1's one rational (k2 + q k3) / (q^2 + k1), an H2O line whose halves lie
    inside the cutoff for the whole group is w (c^2 + 2 q) / (q^2 + w^2 c^2),
    each with its tangents by the quotient rule from the same divide; the
    other terms are taken over f^2 into the same sum, which is multiplied by
    f^2 once at the end.  The tangents come from these formulas, not from
    automatic differentiation.  Divides are IEEE here; the kernel takes an
    approximate reciprocal in the line loops.
    """
    _check_model(model)
    lay = table_layout(model, False)
    table = torch.as_tensor(pack_tables(model, False), dtype=p.dtype,
                            device=p.device)
    head = {k: float(v) for k, v in zip(HEADER_FIELDS,
                                        table[:len(HEADER_FIELDS)])}
    h2o = table[lay.h2o:lay.o2].reshape(len(H2O_FIELDS), lay.n_h2o)
    o2 = table[lay.o2:lay.o3].reshape(len(O2_FIELDS), lay.n_o2)
    gl = table[lay.gl:]
    freqs = list(freqs)
    nf = len(freqs)
    per = tangent_groups(nf)[1] if group is None else group
    parts = [[], [], []]
    for s0 in range(0, nf, per):
        slots = [freqs[min(s0 + c, nf - 1)] for c in range(per)]
        f = torch.as_tensor(slots, dtype=p.dtype, device=p.device)
        got = _tangents_group(f.reshape((-1,) + (1,) * p.ndim), p, t, rho,
                              lwc, head, h2o, o2, gl)
        for part, x in zip(parts, got):
            part.append(x[:min(per, nf - s0)])
    return tuple(torch.cat(part) for part in parts)


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


# Horner coefficients of g_top / d and of dg_top / dd in K5's emission
# series (`csrc/adjoint.cu::emission`), lowest order first, signs alternating.
_G_TOP_OVER_D = (1 / 2, 1 / 3, 1 / 8, 1 / 30, 1 / 144, 1 / 840, 1 / 5760,
                 1 / 45360, 1 / 403200, 1 / 3991680)
_DG_TOP = (1 / 2, 2 / 3, 3 / 8, 2 / 15, 5 / 144, 1 / 140, 7 / 5760,
           1 / 5670, 1 / 44800, 1 / 399168)


def _alternating_horner(coefs, d):
    acc = torch.full_like(d, coefs[-1])
    for c in coefs[-2::-1]:
        acc = c - d * acc
    return acc


def k5_emission(d):
    """(g_bot, g_top, dg_bot, dg_top) of layers of opacity d.  In float32
    as K5 forms them: the 10-term series below d = 0.5, the closed form
    above.  In float64 those of the plain version
    (`rte._emission_factors`, `_emission_factor_derivs`), whose float64
    series ends at 2e-4: the kernel's truncation (up to 5e-11 near d = 0.5)
    would hide the order of the sums that a float64 run compares."""
    if d.dtype == torch.float64:
        return (*rte._emission_factors(d), *rte._emission_factor_derivs(d))
    small = d < 0.5
    closed = torch.where(small, 1.0, d)
    em = torch.exp(-closed)
    g_top_over_d = torch.where(small, _alternating_horner(_G_TOP_OVER_D, d),
                               (1.0 - (1.0 + closed) * em) / (closed * closed))
    g_top = d * g_top_over_d
    dg_top = torch.where(small, _alternating_horner(_DG_TOP, d),
                         em - g_top_over_d)
    return -torch.expm1(-d) - g_top, g_top, g_top_over_d, dg_top


def kmatrix_chunked(freqs, mode: str, alpha, da, ds, t_k, dds_dnl=None,
                    dds_dk=None, dn=None, r0cos=None, da2=None,
                    chunks: int = 8):
    """K5's chunked walk (`csrc/adjoint.cu`) in plain torch, for every
    (elevation, channel, profile) column at once: the L-1 layers split into
    min(chunks, L-1) contiguous chunks, as the kernel splits them over the
    warps of a block, and three walks with a combine after each.

    1. Up, the opacity of each chunk alone.  Combined: the opacity below
       each chunk and the column's.
    2. Up from that opacity: the transmittance T_k below each layer, and the
       chunk's share of the radiance.  Combined: the radiance, dtb/dR, and
       for each chunk the suffix S that enters it from above, the sum of
       the shares above it taken from the top down.
    3. Down from that suffix: every level strictly inside the chunk.  The
       chunk's top level keeps its own share for later (the kernel's row of
       that level still holds the T of the chunk above), and the chunk
       leaves its bottom carries and its part of the Snell sum.  Combined:
       each top level from its share and the carries of the chunk above,
       level 0 from chunk 0's carries and the whole Snell sum.

    mode, shapes and outputs as `adjoint._launch`: [K] or, for "rho_lwc",
    [k_rho, k_lwc] (E, F, L, B), with k_lwc from da2.  Only the order of
    the sums differs from the sequential walk; the emission factors are
    `k5_emission`'s.
    """
    planck_on, geo, two = {"lwc": (False, False, False),
                           "rho": (False, True, False),
                           "t": (True, True, False),
                           "rho_lwc": (False, True, True)}[mode]
    n_lay = ds.shape[1]
    n_chunks = min(chunks, n_lay)
    edges = [c * n_lay // n_chunks for c in range(n_chunks + 1)]
    x = phys.HK_GHZ * torch.as_tensor(freqs, dtype=alpha.dtype,
                                      device=alpha.device)[None, :, None]
    a = alpha[None]                                   # (1, F, L, B)
    dsr = ds[:, None]                                 # (E, 1, L-1, B)
    tl = t_k[None, None]                              # (1, 1, L, B)

    def planck(t):
        return x / torch.expm1(x / t)

    def planck_dt(t):
        u = x / t
        em = torch.expm1(u)
        return u * u * (em + 1.0) / (em * em)

    def d_of(k):
        return 0.5 * (a[:, :, k] + a[:, :, k + 1]) * dsr[:, :, k]

    zero = torch.zeros_like(d_of(0))                  # (E, F, B)
    # walk 1 and its combine
    opacity = []
    for k0, k1 in zip(edges[:-1], edges[1:]):
        acc = zero
        for k in range(k0, k1):
            acc = acc + d_of(k)
        opacity.append(acc)
    below, total = [], zero
    for acc in opacity:
        below.append(total)
        total = total + acc

    # walk 2 and its combine
    trans, radiance = {}, []
    for c, (k0, k1) in enumerate(zip(edges[:-1], edges[1:])):
        ctau, acc = below[c], zero
        b_bot = planck(tl[:, :, k0])
        for k in range(k0, k1):
            d = d_of(k)
            trans[k] = torch.exp(-ctau)
            ctau = ctau + d
            b_top = planck(tl[:, :, k + 1])
            g_bot, g_top, _, _ = k5_emission(d)
            acc = acc + (g_bot * b_bot + g_top * b_top) * trans[k]
            b_bot = b_top
        radiance.append(acc)
    atm = zero
    for acc in radiance:
        atm = atm + acc
    entering = []
    for c in range(n_chunks):
        acc = zero
        for j in range(n_chunks - 1, c, -1):
            acc = acc + radiance[j]
        entering.append(acc)
    ctt = planck(torch.as_tensor(phys.T_COSMIC, dtype=alpha.dtype)) * \
        torch.exp(-total)
    b = atm + ctt
    lg = torch.log1p(x / b)
    dtb_dr = x * x / (b * (b + x) * lg * lg)

    levels = [[None] * (n_lay + 1) for _ in range(1 + two)]

    def store(lev, lev_alpha, lev_planck, lev_geo):
        k = lev_alpha * da[None, :, lev]
        if planck_on:
            k = k + lev_planck
        if geo:
            k = k + lev_geo * dn[None, None, lev]
        levels[0][lev] = k
        if two:
            levels[1][lev] = lev_alpha * da2[None, :, lev]

    # walk 3: per chunk the shares of its top level, its carries at the
    # bottom and its part of the Snell sum
    top, carries, snell = [], [], []
    for c, (k0, k1) in enumerate(zip(edges[:-1], edges[1:])):
        suffix = entering[c]
        carry_alpha = carry_planck = carry_geo = s_k = zero
        b_top = planck(tl[:, :, k1])
        bp_top = planck_dt(tl[:, :, k1]) if planck_on else None
        for k in range(k1 - 1, k0 - 1, -1):
            amid = 0.5 * (a[:, :, k] + a[:, :, k + 1])
            dsk = dsr[:, :, k]
            d = amid * dsk
            t_below = trans[k]
            b_bot = planck(tl[:, :, k])
            g_bot, g_top, dg_bot, dg_top = k5_emission(d)
            w = (dg_bot * b_bot + dg_top * b_top) * t_below - suffix - ctt
            suffix = suffix + (g_bot * b_bot + g_top * b_top) * t_below
            half = 0.5 * dtb_dr * w * dsk
            lev_alpha, carry_alpha = carry_alpha + half, half
            lev_planck = lev_geo = zero
            if planck_on:
                bp_bot = planck_dt(tl[:, :, k])
                lev_planck = carry_planck + dtb_dr * g_top * t_below * bp_top
                carry_planck = dtb_dr * g_bot * t_below * bp_bot
                bp_top = bp_bot
            if geo:
                g_ds = dtb_dr * w * amid
                half_geo = 0.5 * g_ds * dds_dnl[:, None, k]
                lev_geo, carry_geo = carry_geo + half_geo, half_geo
                s_k = s_k + g_ds * dds_dk[:, None, k]
            if k + 1 < k1:
                store(k + 1, lev_alpha, lev_planck, lev_geo)
            else:
                top.append((lev_alpha, lev_planck, lev_geo))
            b_top = b_bot
        carries.append((carry_alpha, carry_planck, carry_geo))
        snell.append(s_k)

    # the combine: each chunk's top level, then level 0
    for c, k1 in enumerate(edges[1:]):
        above = carries[c + 1] if c + 1 < n_chunks else (zero,) * 3
        store(k1, *(ca + own for ca, own in zip(above, top[c])))
    s_k = zero
    for part in snell:
        s_k = s_k + part
    carry_alpha, carry_planck, carry_geo = carries[0]
    if geo:
        carry_geo = carry_geo + s_k * r0cos[:, None]
    store(0, carry_alpha, carry_planck, carry_geo)
    return [torch.stack(lev, dim=2) for lev in levels]


def _warp_scan_up(v):
    """Inclusive prefix sums over the last axis (32 lanes) in the order of a
    warp's shuffle-up scan: add the lane `off` below, off = 1, 2, .. 16."""
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], -1)
    return v


def _warp_scan_down(v):
    """Inclusive suffix sums over the last axis (32 lanes) in the order of a
    warp's shuffle-down scan: add the lane `off` above."""
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :-off] + v[..., off:], v[..., -off:]], -1)
    return v


def _warp_sum(v):
    """The sum over the last axis (32 lanes) in the order of a warp's
    shuffle-down tree, as lane 0 holds it."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _horner(c, th):
    """sum_n c[n] th^n and sum_n n c[n] th^(n-1) by Horner's rule, as the
    fast-K kernel's `poly` forms them; c is a list of N >= 2 terms."""
    n_terms = len(c)
    v, dv = c[-1], (n_terms - 1) * c[-1]
    for n in range(n_terms - 2, 0, -1):
        v, dv = v * th + c[n], dv * th + n * c[n]
    return v * th + c[0], dv


def fastk_preamble(w, z, p, t, rho, lwc, elevations):
    """The fast-K kernel's preamble and chords (`csrc/fastk.cu`) in plain
    torch: what `jacobians.fast_k_inputs` gives, in its keys and shapes,
    from the (B, L) profiles, the weights w (72, C) and the elevations
    [deg], in the profiles' dtype, in the kernel's order of operations.

    1. Levels: e = rho T Rv / 1e5, the refractivity, n = 1 + 1e-6 N in
       float64, dn_t and dn_rho through e.
    2. Layers: in float64, the scaled layer means; of the four hats of
       log p (in the profiles' dtype) the two around it, i0 = [lp > k1] +
       [lp > k2] and i0 + 1, the others being zero; for each of the two
       hats the weights of each group of monomials (p^2, r p, r^2, w times
       powers of theta, p theta^3) as a polynomial in theta and its
       derivative by Horner's rule, the groups combined and scaled by the
       hat; dtheta/dT and dr/drho applied last; then the clamp at zero,
       and one rounding to the profiles' dtype.  The kernel fuses each
       product and sum into an FMA.
    3. Chords, per (profile, elevation): the Snell invariant n_0 r_0
       cos(el), r_k = k / n_layer as k times 1 / n_layer, r -+ r_k and their
       product in float64, the rest in the profiles' dtype.
    """
    from ...models import fast

    dtype = t.dtype
    f64 = torch.float64
    w = w.to(dtype)
    # 1. levels
    e = rho * t * phys.RV / 1e5
    n = 1.0 + 1e-6 * geometry.refractivity(p, t, e).to(f64)
    inv_t = 1.0 / t
    dn_de = 1e-6 * ((geometry._K2 - geometry._K1) + geometry._K3 * inv_t) \
        * inv_t
    dn_dt = -1e-6 * (geometry._K1 * (p - e) + geometry._K2 * e
                     + 2.0 * geometry._K3 * e * inv_t) * inv_t * inv_t
    dn_t = dn_dt + dn_de * (rho * phys.RV / 1e5)
    dn_rho = dn_de * (t * phys.RV / 1e5)

    # 2. layers
    def mid(a):
        return 0.5 * (a[:, :-1].to(f64) + a[:, 1:].to(f64))

    pm = mid(p)
    ps, th, r, wl = pm * 1e-3, 300.0 / mid(t), mid(rho) * 0.1, mid(lwc)
    pm_h = pm.to(dtype)
    hats = fast._hats(pm_h)                                  # (4, B, K)
    lp = torch.log(torch.clamp_min(pm_h, 1e-3))
    knots = torch.as_tensor(fast._LOGP_KNOTS, dtype=dtype)
    i0 = (lp > knots[1]).long() + (lp > knots[2]).long()     # (B, K)
    acc = [0.0] * 3
    for q in range(2):
        hb = i0 + q
        h = torch.gather(hats, 0, hb[None])[0][..., None].to(f64)
        wq = [w[hb * 18 + j].to(f64) for j in range(18)]     # (B, K, C)
        thc = th[..., None]
        o2, d_o2 = _horner(wq[0:6], thc)
        h2o, d_h2o = _horner(wq[6:11], thc)
        slf, d_slf = _horner(wq[11:14], thc)
        liq, d_liq = _horner(wq[14:17], thc)
        dry = wq[17] * thc * thc
        psc, rc, lc = ps[..., None], r[..., None], wl[..., None]
        sums = (psc * psc * o2 + rc * psc * h2o + rc * rc * slf + lc * liq
                + psc * dry * thc,
                psc * psc * d_o2 + rc * psc * d_h2o + rc * rc * d_slf
                + lc * d_liq + 3.0 * psc * dry,
                psc * h2o + 2.0 * rc * slf)
        acc = [a + h * s_q for a, s_q in zip(acc, sums)]
    live = acc[0] > 0.0
    alpha_mid = torch.clamp_min(acc[0], 0.0).to(dtype)
    d_tm = torch.where(live, acc[1] * (-(th * th) / 300.0)[..., None],
                       0.0).to(dtype)
    d_rm = torch.where(live, acc[2] * 0.1, 0.0).to(dtype)

    # 3. chords
    cos_el = torch.cos(torch.deg2rad(torch.as_tensor(elevations, dtype=f64)))
    r_lev = phys.EARTH_RADIUS + z.to(f64)                    # (B, L)
    r0 = r_lev[:, :1]
    snell = n[:, :1] * r0 * cos_el                           # (B, E)
    inv_nl = 1.0 / (0.5 * (n[:, :-1] + n[:, 1:]))            # (B, K)
    rk = snell[:, :, None] * inv_nl[:, None]                 # (B, E, K)
    r_bot, r_top = r_lev[:, None, :-1], r_lev[:, None, 1:]
    seg_top, seg_bot = (torch.sqrt(torch.clamp_min(
        ((rr - rk) * (rr + rk)).to(dtype), 0.0)) for rr in (r_top, r_bot))
    span = (z[:, 1:] - z[:, :-1])[:, None] * (r_top + r_bot).to(dtype)
    denom = seg_top + seg_bot
    denom_c = torch.clamp_min(denom, 1.0)
    ds = span / denom_c * 1e-3
    inv_top, inv_bot = (torch.where(s > 0.0, 1.0 / torch.clamp_min(s, 1e-30),
                                    0.0) for s in (seg_top, seg_bot))
    rkf, inl = rk.to(dtype), inv_nl.to(dtype)[:, None]
    dds_drk = torch.where(denom > 1.0, span / (denom_c * denom_c) * rkf
                          * (inv_top + inv_bot), 0.0)
    return dict(alpha_mid=alpha_mid, d_tm=d_tm, d_rm=d_rm, ds=ds,
                dds_dnl=dds_drk * (-rkf * inl) * 1e-3,
                dds_dk=dds_drk * inl * 1e-3, t=t, dn_t=dn_t, dn_rho=dn_rho,
                r0cos=(r0 * cos_el).to(dtype))


def _column_walks(x, d, b_lev, b_up, live):
    """The two walks of `csrc/rte_walk.cuh` over every column at once, the
    layers on the last axis padded to whole chunks of 32 lanes: x = hf/k of
    the columns' channels, d the layers' opacities, b_lev and b_up the
    Planck radiance at each layer's bottom and top, live 1 on a layer and
    0 past the last.

    1. Up: a shuffle-up scan of the layers' opacities, with the opacity of
       the chunks below carried in, gives T_k below each layer; the lanes
       sum their layers' share E_k T_k of the radiance.
    2. Down, from the top chunk: a shuffle-down scan of E_k T_k, with the
       sum of the chunks above carried in, gives S_k = sum_{j>k} E_j T_j
       directly, then W_k = E'_k T_k - S_k - ctt.

    Returns g_bot, g_top (`k5_emission`'s), T_k, dtb/dR (with a trailing
    axis of 1) and W_k."""
    n_chunks = d.shape[-1] // 32
    g_bot, g_top, dg_bot, dg_top = k5_emission(d)
    zero = torch.zeros_like(d[..., 0])
    trans, atm_lanes, carry = [], torch.zeros_like(d[..., :32]), zero
    for i in range(n_chunks):
        sl = slice(32 * i, 32 * i + 32)
        incl = _warp_scan_up(d[..., sl])
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                         -1)
        trans.append(torch.exp(-(carry[..., None] + excl)) * live[..., sl])
        atm_lanes = atm_lanes + (g_bot[..., sl] * b_lev[..., sl]
                                 + g_top[..., sl] * b_up[..., sl]) * trans[i]
        carry = carry + incl[..., 31]
    trans = torch.cat(trans, -1)
    atm = _warp_sum(atm_lanes)
    ctt = (x / torch.expm1(x / torch.as_tensor(phys.T_COSMIC,
                                               dtype=d.dtype)))[..., 0] \
        * torch.exp(-carry)
    b = atm + ctt
    lg = torch.log1p(x[..., 0] / b)
    dtb_dr = (x[..., 0] * x[..., 0] / (b * (b + x[..., 0]) * lg * lg))[...,
                                                                       None]
    et = (g_bot * b_lev + g_top * b_up) * trans
    e_prime = (dg_bot * b_lev + dg_top * b_up) * trans
    w, carry_s = [None] * n_chunks, zero
    for i in range(n_chunks - 1, -1, -1):
        sl = slice(32 * i, 32 * i + 32)
        rincl = _warp_scan_down(et[..., sl])
        rexcl = torch.cat([rincl[..., 1:], torch.zeros_like(rincl[..., :1])],
                          -1)
        w[i] = e_prime[..., sl] - (carry_s[..., None] + rexcl) \
            - ctt[..., None]
        carry_s = carry_s + rincl[..., 0]
    return g_bot, g_top, trans, dtb_dr, torch.cat(w, -1)


def fastk_warp_walk(freqs, alpha_mid, d_tm, d_rm, ds, dds_dnl, dds_dk, t,
                    dn_t, dn_rho, r0cos, wrt=("t", "rho")):
    """The fast-K kernel's walk (`csrc/fastk.cu`) in plain torch, for every
    (profile, elevation, channel) column at once: a warp of 32 lanes walks
    the layers in chunks of 32, lane j of chunk i on layer 32 i + j, as
    `_column_walks`; then, chunk by chunk down, the layer's terms: lane j
    stores level k + 1 from its layer's top terms and the bottom terms of
    layer k + 1 (lane j + 1's, or for lane 31 those of the chunk above,
    carried down).  Level 0 takes the bottom terms of layer 0 and the
    rank-one sum.

    Shapes and outputs as `fastk.fastk_adjoint`; the emission factors are
    `k5_emission`'s.  Only the order of the sums differs from the plain
    version.
    """
    dtype, dev = t.dtype, t.device
    batch, lev = t.shape
    n_lay = lev - 1
    n_chunks = -(-n_lay // 32)
    pad = 32 * n_chunks - n_lay
    x = phys.HK_GHZ * torch.as_tensor(freqs, dtype=dtype,
                                      device=dev)[None, None, :, None]

    def lanes(a):
        """(B, E or 1, C or 1, 32 n_chunks), zero past the last layer."""
        return torch.nn.functional.pad(a, (0, pad))

    def planck(tk):
        return x / torch.expm1(x / tk)

    def planck_dt(tk):
        u = x / tk
        em = torch.expm1(u)
        return u * u * (em + 1.0) / (em * em)

    tl = t[:, None, None, :]                              # (B, 1, 1, L)
    b_lev = lanes(planck(tl[..., :-1]))                   # B at level k
    b_up = lanes(planck(tl[..., 1:]))                     # B at level k + 1
    bp_up = lanes(planck_dt(tl[..., 1:]))
    amid = lanes(alpha_mid.transpose(1, 2)[:, None])      # (B, 1, C, .)
    dsl = lanes(ds[:, :, None])                           # (B, E, 1, .)
    live = lanes(torch.ones_like(ds[:, :1, None]))        # 1 on a layer
    d = amid * dsl
    g_bot, g_top, trans, dtb_dr, w_all = _column_walks(x, d, b_lev, b_up,
                                                       live)
    zero = torch.zeros_like(d[..., 0])                    # (B, E, C)
    dn = {"t": dn_t, "rho": dn_rho}
    outs = {name: [None] * n_chunks for name in wrt}
    carries = {key: zero for key in ("t", "rho", "geo", "planck")}
    snell = torch.zeros_like(d[..., :32])
    for i in range(n_chunks - 1, -1, -1):
        sl = slice(32 * i, 32 * i + 32)
        w = w_all[..., sl]
        g_mid = dtb_dr * w * dsl[..., sl]
        g_ds = dtb_dr * w * amid[..., sl]
        # the layer's bottom (level k) and top (level k + 1) terms, zero
        # past the last layer
        own = {"geo": 0.5 * g_ds * lanes(dds_dnl[:, :, None])[..., sl]}
        snell = snell + g_ds * lanes(dds_dk[:, :, None])[..., sl]
        for name, part in (("t", d_tm), ("rho", d_rm)):
            if name in wrt:
                own[name] = 0.5 * g_mid * lanes(
                    part.transpose(1, 2)[:, None])[..., sl]
        bottom_planck = dtb_dr * g_bot[..., sl] * trans[..., sl]
        top_planck = dtb_dr * g_top[..., sl] * trans[..., sl]
        own["planck"] = bottom_planck

        def above(key):
            return torch.cat([own[key][..., 1:], carries[key][..., None]],
                             -1)

        geo = own["geo"] + above("geo")
        for name in wrt:
            k = own[name] + above(name)
            if name == "t":
                k = k + (top_planck + above("planck")) * bp_up[..., sl]
            outs[name][i] = k + geo * lanes(dn[name][..., 1:][:, None,
                                                               None])[..., sl]
        carries = {key: own[key][..., 0] if key in own else zero
                   for key in carries}
    s_k = _warp_sum(snell)
    result = {}
    for name in wrt:
        lev0 = carries[name] + (carries["geo"] + s_k * r0cos[..., None]) \
            * dn[name][:, None, None, 0]
        if name == "t":
            lev0 = lev0 + carries["planck"] * planck_dt(tl[..., :1])[..., 0]
        result[name] = torch.cat([lev0[..., None],
                                  torch.cat(outs[name], -1)[..., :n_lay]],
                                 -1)
    return result


def rte_vjp_walk(freqs, elevations, alpha_mid, z, n, t, g_tb):
    """K2v (`csrc/rte_vjp.cu`) in plain torch: each (profile, elevation)
    warp forms its chords as FK does (the Snell invariant and r - r_k,
    r + r_k in float64, the square roots in the inputs' dtype), walks its
    columns up (T_k, the radiance) and down (S_k by a shuffle-down scan from
    the top, W_k) in chunks of 32 layers, and the terms cot dtb/dR W_k ds_k
    are summed over the elevations.  Shapes as `rte.forward_lb_vjp`; the
    emission factors are `k5_emission`'s.  Only the order of the sums
    differs from the kernel."""
    dtype, f64 = t.dtype, torch.float64
    n_lay = t.shape[0] - 1
    n_chunks = -(-n_lay // 32)
    pad = 32 * n_chunks - n_lay
    cos_el = torch.cos(torch.deg2rad(torch.as_tensor(elevations, dtype=f64)))
    zb, nb = z.T.to(f64), n.T.to(f64)                        # (B, L)
    r_lev = phys.EARTH_RADIUS + zb
    snell = nb[:, :1] * r_lev[:, :1] * cos_el                # (B, E)
    rk = snell[:, :, None] / (0.5 * (nb[:, :-1] + nb[:, 1:]))[:, None]
    r_bot, r_top = r_lev[:, None, :-1], r_lev[:, None, 1:]
    seg_top, seg_bot = (torch.sqrt(torch.clamp_min(
        ((rr - rk) * (rr + rk)).to(dtype), 0.0)) for rr in (r_top, r_bot))
    span = (z.T[:, 1:] - z.T[:, :-1])[:, None] * (r_top + r_bot).to(dtype)
    ds = span / torch.clamp_min(seg_top + seg_bot, 1.0) * 1e-3  # (B, E, K)

    x = phys.HK_GHZ * torch.as_tensor(freqs, dtype=dtype)[None, None, :, None]

    def lanes(a):
        return torch.nn.functional.pad(a, (0, pad))

    tl = t.T[:, None, None, :]                               # (B, 1, 1, L)
    b_lev, b_up = (lanes(x / torch.expm1(x / tk))
                   for tk in (tl[..., :-1], tl[..., 1:]))
    dsl = lanes(ds[:, :, None])                              # (B, E, 1, .)
    d = lanes(alpha_mid.permute(2, 0, 1)[:, None]) * dsl
    _, _, _, dtb_dr, w = _column_walks(
        x, d, b_lev, b_up, lanes(torch.ones_like(ds[:, :1, None])))
    terms = g_tb.permute(2, 0, 1)[..., None] * dtb_dr * w * dsl
    g = terms[..., :n_lay]                                   # (B, E, C, K)
    out = g[:, 0]
    for e in range(1, g.shape[1]):
        out = out + g[:, e]
    return out.permute(1, 2, 0)
