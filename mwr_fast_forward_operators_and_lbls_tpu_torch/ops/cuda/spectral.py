"""Spectral absorption kernel K6 (`csrc/absorption_spectral.cu`), its wrapper
and plain version.

`absorption_spectral` maps a runtime frequency grid (F,) and point arrays p,
T, rho, LWC of any one shape to alpha (F, *shape) [Np/km], frequency-major:
level-major (L, B) points give the (F, L, B) layout the RTE kernels read.
It launches K6 or runs `absorption_spectral_reference` by the package's
rule (`ops.cuda.launches`).  There is no O3 term, as on the TPU.

K6 is two passes.  The first computes, once per call, what depends on the
point alone: `line_state` is its plain version and documents the layout.
The second evaluates one merged rational per line and frequency from that
state; `_mirrors.absorption_spectral_merged` follows its order of operations
in plain torch (with IEEE divides), so the CPU tests can hold the arithmetic
against float64.
"""

import dataclasses
import types

import numpy as np
import torch

from ...constants import H2O_MODELS, O2_MODELS, o3_lines
from ..absorption import (h2o_absorption, liquid_absorption, n2_absorption,
                          o2_absorption, o3_absorption, total_absorption)
from ..spans import span
from . import _build, count_launch, launches
from .absorption import (H2O_FIELDS, HEADER_FIELDS, O2_FIELDS, O3_FIELDS,
                         check_points, line_tables, pack_tables, table_layout)

# Bytes of one (frequency, point, line) intermediate of the plain version,
# which runs in sub-chunks of frequency: a handful of them are live at once,
# about 2 GiB in all.
PLAIN_INTERMEDIATE_BYTES = 2 ** 28


def _check_model(model: str):
    if model not in H2O_MODELS:
        raise ValueError(f"unknown absorption model {model!r}; have "
                         f"{tuple(H2O_MODELS)}")


def _check_f_range(f: torch.Tensor, f_range):
    """Raise ValueError unless every frequency of `f` lies in
    f_range = (fmin, fmax) [GHz]; None checks nothing."""
    if f_range is None:
        return
    lo, hi = (float(v) for v in f_range)
    fmin, fmax = float(f.min()), float(f.max())
    if fmin < lo or fmax > hi:
        raise ValueError(f"frequencies [{fmin}, {fmax}] GHz lie outside "
                         f"f_range ({lo}, {hi})")


def _plain_chunk(n_points: int, model: str, itemsize: int) -> int:
    """Frequencies per sub-chunk of the plain version: the widest
    intermediate is (F_sub, N, n_o2) or, for the qSD releases,
    (F_sub, N, n_h2o, 16)."""
    h2o = H2O_MODELS[model]
    cols = max(O2_MODELS[model].f.size,
               h2o.fl.size * (16 if h2o.has_sd else 1))
    return max(1, PLAIN_INTERMEDIATE_BYTES // (n_points * cols * itemsize))


def absorption_spectral_reference(f_ghz, p, t, rho, lwc, model: str = "R24",
                                  f_range=None):
    """Plain version of K6: `total_absorption` over the (F, *shape)
    broadcast, in sub-chunks of frequency."""
    _check_model(model)
    f = torch.as_tensor(f_ghz, dtype=p.dtype, device=p.device).reshape(-1)
    _check_f_range(f, f_range)
    out = torch.empty((f.numel(), *p.shape), dtype=p.dtype, device=p.device)
    step = _plain_chunk(p.numel(), model, p.element_size())
    lead = (-1,) + (1,) * p.ndim
    for s in range(0, f.numel(), step):
        out[s:s + step] = total_absorption(f[s:s + step].reshape(lead),
                                           p[None], t[None], rho[None],
                                           lwc[None], model=model)
    return out


def absorption_spectral_float64(f_ghz, p, t, rho, lwc, model: str = "R24",
                                o3=None):
    """The function on exactly the kernel's inputs, in float64: the points,
    the grid and the line tables as the float32 numbers K6 reads (a line
    centre rounds by up to 1.9 kHz at 60 GHz, which alone moves alpha by
    some 6e-6 of a frequency's maximum where the lines are 30 MHz wide).
    Differences from it are the arithmetic's.  With `o3` [ppmv] the O3
    lines are in, as K1 has them."""
    def rounded(tables):
        kw = {}
        for field in dataclasses.fields(tables):
            v = getattr(tables, field.name)
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                kw[field.name] = v.astype(np.float32).astype(np.float64)
            elif isinstance(v, float):
                kw[field.name] = float(np.float32(v))
        return dataclasses.replace(tables, **kw)

    _check_model(model)
    p, t, rho, lwc = (a.double()[None] for a in (p, t, rho, lwc))
    f = torch.as_tensor(f_ghz, device=p.device).to(torch.float32).double()
    f = f.reshape((-1,) + (1,) * (p.ndim - 1))
    alpha = (h2o_absorption(f, p, t, rho, rounded(H2O_MODELS[model]))
             + o2_absorption(f, p, t, rho, rounded(O2_MODELS[model]))
             + n2_absorption(f, p - rho * t / 217.0, t, variant=model)
             + liquid_absorption(f, t, lwc))
    if o3 is not None:
        lines = types.SimpleNamespace(**{
            k: getattr(o3_lines, k).astype(np.float32).astype(np.float64)
            for k in O3_FIELDS})
        alpha = alpha + o3_absorption(f, p, t, o3.double()[None], lines)
    return alpha


# ---- the state pass: what depends on the point alone ----------------------
#
# K6's first kernel writes `state` (n_state, N) float32, one row per slot
# (keep in step with the enums of csrc/absorption_spectral.cu):
#   rows 0..8, the scalars of STATE_SCALARS;
#   then per H2O line 3 rows, wsq, sw, sb: the squared width, and the
#     strength s h2o_scale / fl^2 times the width and times the Clough base;
#     for a release with qSD lines 3 more, sn, c0, gamma2: that strength
#     alone and the two parameters of the quadrature;
#   then per O2 line 5 rows, dnu, c2, dfsq, k2, k3: the pressure shift,
#     c = 2 (f0 + dnu), the squared width, and the two coefficients of the
#     merged numerator k2 + q k3 (`_mirrors.absorption_spectral_merged`):
#     k2 = s (dfg c^2 - 2 dfsq y c), k3 = s (2 dfg + y c) with s the
#     strength over f0^2 and y the mixing coefficient.
STATE_SCALARS = ("con_b", "k_nr", "dfnr2", "o2s", "n2k", "inv_fp", "e01",
                 "e12", "wk")
O2_SLOTS = 5


def h2o_slots(model: str) -> int:
    return 6 if H2O_MODELS[model].has_sd else 3


def n_state(model: str) -> int:
    """Rows of K6's per-point state for one release."""
    return (len(STATE_SCALARS) + h2o_slots(model) * H2O_MODELS[model].fl.size
            + O2_SLOTS * O2_MODELS[model].f.size)


def line_state(p, t, rho, lwc, model: str = "R24") -> dict:
    """Plain version of K6's state pass, in the inputs' dtype: {"scalars":
    {name: (...)}, "h2o": {name: (..., n_h2o)}, "o2": {name: (..., n_o2)}}
    for points of any one shape, from the packed table's numbers."""
    lay = table_layout(model, False)
    table = torch.as_tensor(pack_tables(model, False), dtype=p.dtype,
                            device=p.device)
    head = dict(zip(HEADER_FIELDS, table[:len(HEADER_FIELDS)]))
    h2o = dict(zip(H2O_FIELDS, table[lay.h2o:lay.o2].reshape(-1, lay.n_h2o)))
    o2 = dict(zip(O2_FIELDS, table[lay.o2:lay.o3].reshape(-1, lay.n_o2)))
    p, t, rho, lwc = (a[..., None] for a in (p, t, rho, lwc))

    ti = 300.0 / t
    th1 = ti - 1.0
    pvap = rho * t / 217.0
    pda = p - pvap
    # H2O lines
    tix, tixs = ti ** h2o["x"], ti ** h2o["xs"]
    width = h2o["w3"] * pda * tix + h2o["ws"] * pvap * tixs
    wsq = width * width
    s = h2o["s1"] * ti ** 2.5 * torch.exp(h2o["b2"] * (1.0 - ti))
    base = width / (head["cutoff"] * head["cutoff"] + wsq)
    sn = s * (0.3183e-4 * (3.344e16 * rho)) * (1.0 / (h2o["fl"] * h2o["fl"]))
    gamma2 = h2o["w2"] * pda * tix + h2o["ws2"] * pvap * tixs
    lines_h2o = dict(wsq=wsq, sw=sn * width, sb=sn * base, sn=sn,
                     c0=width - 1.5 * gamma2, gamma2=gamma2)
    con_b = (head["cf"] * ti ** head["xcf"] * pda
             + head["cs"] * ti ** head["xcs"] * pvap) * pvap
    # O2 lines
    b = ti ** head["o2_x"]
    den = 0.001 * (pda * b + head["h2o_factor"] * pvap * ti)
    pe2 = den * den
    dfnr = head["wb300"] * den
    ybase = torch.where(head["mixing_basis_p"] != 0.0, 0.001 * p * b, den)
    df = o2["w300"] * den
    sn = (o2["s300"] * torch.exp(-o2["be"] * th1)) * (1.0 / (o2["f"] * o2["f"]))
    dnu = pe2 * (o2["dnu0"] + o2["dnu1"] * th1)
    c2 = 2.0 * (o2["f"] + dnu)
    dfsq = df * df
    dfg_s = sn * (df * (1.0 + pe2 * (o2["g0"] + o2["g1"] * th1)))
    yc = (sn * (ybase * (o2["y0"] + o2["y1"] * th1))) * c2
    lines_o2 = dict(dnu=dnu, c2=c2, dfsq=dfsq,
                    k2=dfg_s * (c2 * c2) - 2.0 * dfsq * yc,
                    k3=2.0 * dfg_s + yc)
    # continua and cloud liquid
    theta1 = 1.0 - ti
    eps0 = 77.66 - 103.3 * theta1
    eps1 = 0.0671 * eps0
    scalars = dict(
        con_b=con_b, k_nr=head["nonres"] * dfnr / ti, dfnr2=dfnr * dfnr,
        o2s=head["o2_scale"] * pda * (ti * ti * ti),
        n2k=head["n2_coef"] * pda * pda * ti ** head["n2_exp"],
        inv_fp=1.0 / (20.1 * torch.exp(7.88 * theta1)), e01=eps0 - eps1,
        e12=eps1 - 3.52, wk=-0.06286 * lwc)
    return {"scalars": {k: v[..., 0] for k, v in scalars.items()},
            "h2o": lines_h2o, "o2": lines_o2}


def _launch(f_ghz, p, t, rho, lwc, model, f_range, lines=True):
    """Check the inputs and launch K6: the state pass, then (with `lines`)
    the main pass.  Returns (state (n_state, N), alpha (F, *shape) or
    None)."""
    _check_model(model)
    dev = p.device
    f = (f_ghz if torch.is_tensor(f_ghz)
         else torch.from_numpy(np.asarray(f_ghz, np.float32)))
    f = f.to(device=dev, dtype=torch.float32).contiguous()
    if f.ndim != 1 or f.numel() == 0:
        raise ValueError(f"f_ghz: expected (F,) with F >= 1, got "
                         f"{tuple(f.shape)}")
    _check_f_range(f, f_range)
    layout = table_layout(model, False)
    tables = line_tables(model, False, dev)
    check_points(dict(p=p, t=t, rho=rho, lwc=lwc), tables, layout)
    rows, n = n_state(model), p.numel()
    scratch = torch.empty(rows * n + f.numel(), dtype=torch.float32,
                          device=dev)
    out = (torch.empty((f.numel(), *p.shape), dtype=torch.float32,
                       device=dev) if lines else None)
    with torch.cuda.device(dev):
        err = _build.library().mwr_absorption_spectral(
            p.data_ptr(), t.data_ptr(), rho.data_ptr(), lwc.data_ptr(),
            f.data_ptr(), f.numel(), tables.data_ptr(), layout.n_h2o,
            layout.n_o2, layout.h2o, layout.o2, layout.gl, h2o_slots(model),
            n, int(lines), scratch.data_ptr(), out.data_ptr() if lines else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"spectral absorption kernel launch failed: CUDA "
                           f"error {err}")
    return scratch[:rows * n].reshape(rows, n), out


def resident_warps(model: str = "R24") -> int:
    """Warps of K6's main pass that the current CUDA device keeps resident
    per SM for `model`'s state, from the occupancy calculator."""
    _check_model(model)
    layout = table_layout(model, False)
    warps = _build.library().mwr_absorption_spectral_resident_warps(
        layout.n_h2o, layout.n_o2, h2o_slots(model))
    if warps < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-warps}")
    return warps


def line_state_pass(p, t, rho, lwc, model: str = "R24"):
    """K6's state pass alone on CUDA float32 points: the (n_state, N) rows
    that `line_state` documents.  Not counted as a launch of K6."""
    return _launch(torch.ones(1, device=p.device), p, t, rho, lwc, model,
                   None, lines=False)[0]


def absorption_spectral(f_ghz, p, t, rho, lwc, model: str = "R24",
                        f_range=None, use_kernels: bool = True):
    """Monochromatic absorption: frequencies f_ghz (F,) [GHz] and p [hPa],
    T [K], rho [g/m^3], LWC [g/m^3] of one shape -> alpha (F, *shape)
    [Np/km].

    f_ghz is a sequence, a numpy array or a tensor; on the kernel path a
    contiguous float32 tensor on the points' device is used as it is.
    f_range = (fmin, fmax), when given, is checked against the frequencies:
    ValueError if one lies outside it.  K6 or the plain version by
    `launches(p, use_kernels)`; K6 takes contiguous points and reads the
    release's packed `line_tables(model, False, device)`; the per-point
    state lives in a scratch tensor allocated here.
    """
    if not launches(p, use_kernels):
        return absorption_spectral_reference(f_ghz, p, t, rho, lwc, model,
                                             f_range)
    with span("cuda.absorption_spectral"):
        out = _launch(f_ghz, p, t, rho, lwc, model, f_range)[1]
        count_launch(absorption_spectral)
        return out


absorption_spectral.launches = 0
