"""Absorption kernels K1 (`csrc/absorption.cu`) and K4
(`csrc/absorption_tangents.cu`), their wrappers and plain versions.

`absorption_lb` maps (L, B) level arrays to alpha (F, L, B) [Np/km];
`absorption_tangents_lb` returns alpha with its elementwise partials in T and
rho (K4, the same function with both tangents carried through it), and on
request dalpha/dLWC, the liquid term at unit content.  Each launches its
kernel or runs its plain torch version by the package's rule
(`ops.cuda.launches`).

K1 evaluates one merged rational per line from a per-point state, as K6
does: `_mirrors.absorption_lb_merged` follows its order of operations in
plain torch and `absorption_lb_float64` is the function in float64 on the
float32 numbers the kernel reads, so the tests can tell the arithmetic's
error from the tables'.  K4 has the same algebra with both tangents, in
groups of channels: `_mirrors.absorption_tangents_grouped`.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...constants import H2O_MODELS, O2_MODELS, o3_lines
from ..absorption import liquid_absorption, total_absorption
from ..absorption.h2o import _GL_W, _GL_X
from ..spans import span
from ..tensors import constant_vector
from . import _build, count_launch, launches

# Scalar slots at the head of the packed table, in the order of the `Header`
# enum in csrc/absorption.cu.
HEADER_FIELDS = ("cutoff", "cf", "xcf", "cs", "xcs", "o2_x", "wb300",
                 "h2o_factor", "nonres", "o2_scale", "mixing_basis_p",
                 "n2_coef", "n2_exp", "n2_fdep")
N_HEADER = 16
H2O_FIELDS = ("fl", "s1", "b2", "w3", "x", "ws", "xs", "w2", "ws2")
O2_FIELDS = ("f", "s300", "be", "w300", "y0", "y1", "g0", "g1", "dnu0",
             "dnu1")
O3_FIELDS = ("O3_FL", "O3_S1", "O3_B2", "O3_W3", "O3_X")
# The most channels one launch of K1 or K4 takes (kMaxChannels in
# csrc/absorption.cuh).
MAX_CHANNELS = 32


@dataclasses.dataclass(frozen=True)
class LineTables:
    """Column offsets of the packed line table read by K1.

    The table is a header of scalars, then one column of `n_<species>`
    floats per field of H2O_FIELDS, O2_FIELDS and O3_FIELDS, then the 16
    Gauss-Laguerre nodes and the 16 weights.
    """

    n_h2o: int
    n_o2: int
    n_o3: int

    @property
    def h2o(self) -> int:
        return N_HEADER

    @property
    def o2(self) -> int:
        return self.h2o + len(H2O_FIELDS) * self.n_h2o

    @property
    def o3(self) -> int:
        return self.o2 + len(O2_FIELDS) * self.n_o2

    @property
    def gl(self) -> int:
        return self.o3 + len(O3_FIELDS) * self.n_o3

    @property
    def size(self) -> int:
        return self.gl + len(_GL_X) + len(_GL_W)


def table_layout(model: str, o3: bool) -> LineTables:
    return LineTables(n_h2o=H2O_MODELS[model].fl.size,
                      n_o2=O2_MODELS[model].f.size,
                      n_o3=o3_lines.O3_FL.size if o3 else 0)


def pack_tables(model: str, o3: bool) -> np.ndarray:
    """The packed float64 table of one release (and O3 when asked for)."""
    h2o, o2 = H2O_MODELS[model], O2_MODELS[model]
    dry98 = model in ("R98", "R03")   # the 1998 dry continuum, n2.py
    header = dict(
        cutoff=h2o.cutoff_ghz, cf=h2o.cf, xcf=h2o.xcf, cs=h2o.cs,
        xcs=h2o.xcs, o2_x=o2.x, wb300=o2.wb300, h2o_factor=o2.h2o_factor,
        nonres=o2.nonres_coeff, o2_scale=o2.scale,
        mixing_basis_p=float(o2.mixing_basis == "p"),
        n2_coef=6.4e-14 if dry98 else 6.5e-14,
        n2_exp=3.55 if dry98 else 3.6, n2_fdep=0.0 if dry98 else 1.0)
    head = np.zeros(N_HEADER)
    head[:len(HEADER_FIELDS)] = [header[k] for k in HEADER_FIELDS]
    parts = [head]
    parts += [np.asarray(getattr(h2o, k), np.float64) for k in H2O_FIELDS]
    parts += [np.asarray(getattr(o2, k), np.float64) for k in O2_FIELDS]
    if o3:
        parts += [np.asarray(getattr(o3_lines, k), np.float64)
                  for k in O3_FIELDS]
    parts += [_GL_X, _GL_W]
    table = np.concatenate(parts)
    assert table.size == table_layout(model, o3).size
    return table


@functools.lru_cache(maxsize=64)
def line_tables(model: str, o3: bool, device) -> torch.Tensor:
    """The packed table as a float32 tensor on `device` (cached; treat it
    as read-only)."""
    return torch.as_tensor(pack_tables(model, o3), dtype=torch.float32,
                           device=device)


def absorption_lb_reference(freqs, p, t, rho, lwc, model: str = "R24",
                            o3=None):
    """Plain version of K1: `total_absorption` in the (F, L, B) layout."""
    f = torch.as_tensor(freqs, dtype=p.dtype, device=p.device)[:, None, None]
    return total_absorption(f, p[None], t[None], rho[None], lwc[None],
                            model=model,
                            o3_ppmv=None if o3 is None else o3[None])


def absorption_lb_float64(freqs, p, t, rho, lwc, model: str = "R24", o3=None):
    """The function in float64 on exactly the float32 numbers K1 reads (the
    points, the channels, the line tables), (F, L, B): differences from it
    are the arithmetic's."""
    from . import spectral        # which imports this module
    return spectral.absorption_spectral_float64(
        list(freqs), p, t, rho, lwc, model, o3=o3)


def absorption_tangents_lb_float64(freqs, p, t, rho, lwc, model: str = "R24"):
    """alpha, dalpha/dT and dalpha/drho (F, L, B) in float64 on exactly the
    float32 numbers K4 reads: two jvp passes of `absorption_lb_float64`."""
    p, t, rho, lwc = (a.double() for a in (p, t, rho, lwc))

    def alpha_of(t_, rho_):
        return absorption_lb_float64(freqs, p, t_, rho_, lwc, model)

    alpha, da_t = torch.func.jvp(lambda x: alpha_of(x, rho), (t,),
                                 (torch.ones_like(t),))
    _, da_rho = torch.func.jvp(lambda x: alpha_of(t, x), (rho,),
                               (torch.ones_like(rho),))
    return alpha, da_t, da_rho


def absorption_partials_lb(freqs, p, t, rho, lwc, model: str = "R24",
                           wrt=("t", "rho")):
    """alpha (F, L, B) and {name: dalpha/dname (F, L, B)} for each name of
    `wrt` in {"p", "t", "rho"}, in plain torch.

    Absorption at a level depends only on the state at that level, so a
    forward-mode pass seeded with ones gives the whole diagonal of
    dalpha/dname: one `torch.func.jvp` per name.
    """
    state = dict(p=p, t=t, rho=rho)

    def alpha_of(name, value):
        s = {**state, name: value}
        return absorption_lb_reference(freqs, s["p"], s["t"], s["rho"], lwc,
                                       model)

    alpha, partials = None, {}
    for name in wrt:
        alpha, partials[name] = torch.func.jvp(
            functools.partial(alpha_of, name), (state[name],),
            (torch.ones_like(state[name]),))
    if alpha is None:
        alpha = absorption_lb_reference(freqs, p, t, rho, lwc, model)
    return alpha, partials


def dalpha_dlwc_lb(freqs, t):
    """dalpha/dLWC (F, L, B) [Np/km per g/m^3] at the channels `freqs`
    [GHz] on (L, B) T [K]: liquid absorption at unit content (cloud
    absorption is linear in the LWC)."""
    f = constant_vector(freqs, t.dtype, t.device)
    return liquid_absorption(f[:, None, None], t[None],
                             torch.ones_like(t)[None])


def absorption_tangents_lb_reference(freqs, p, t, rho, lwc,
                                     model: str = "R24",
                                     with_lwc: bool = False):
    """Plain version of K4: alpha, dalpha/dT and dalpha/drho, each (F, L, B),
    from two jvp passes of `absorption_lb_reference`; with `with_lwc`,
    `dalpha_dlwc_lb` fourth."""
    alpha, d = absorption_partials_lb(freqs, p, t, rho, lwc, model)
    if with_lwc:
        return alpha, d["t"], d["rho"], dalpha_dlwc_lb(freqs, t)
    return alpha, d["t"], d["rho"]


def check_points(arrays: dict, tables, layout: LineTables, ndim=None):
    """Check the point arrays and the packed table an absorption kernel
    reads: contiguous, one shape (of `ndim` axes when given), the table's
    dtype and one device."""
    ref = arrays["p"]
    for name, a in arrays.items():
        if (a.device != ref.device or a.shape != ref.shape
                or a.dtype != tables.dtype
                or (ndim is not None and a.ndim != ndim)):
            raise ValueError(f"{name}: expected {tuple(ref.shape)} "
                             f"{tables.dtype} on {ref.device}, got "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < ref.numel() < 2 ** 31:
        raise ValueError(f"{ref.numel()} points out of range")
    if (tables.device != ref.device or tables.dtype != torch.float32
            or tables.shape != (layout.size,) or not tables.is_contiguous()):
        raise ValueError(f"tables: expected ({layout.size},) float32 on "
                         f"{ref.device}, got {tuple(tables.shape)} "
                         f"{tables.dtype} on {tables.device}")


def _check_inputs(freqs, arrays: dict, tables, layout: LineTables):
    check_points(arrays, tables, layout, ndim=2)
    if not 1 <= len(freqs) <= MAX_CHANNELS:
        raise ValueError(f"the absorption kernels take 1..{MAX_CHANNELS} "
                         f"channels, got {len(freqs)}")


def absorption_lb(freqs, p, t, rho, lwc, model: str = "R24", o3=None,
                  tables=None, use_kernels: bool = True):
    """(L, B) p [hPa], T [K], rho [g/m^3], LWC [g/m^3] and optional O3
    [ppmv] -> alpha (F, L, B) [Np/km] at the channels `freqs` [GHz].

    K1 or the plain version by `launches(p, use_kernels)`; K1 takes 1 to
    MAX_CHANNELS channels in one launch (its body is instantiated for each
    count), contiguous arrays and `tables`, the packed `line_tables(model,
    o3 is not None, device)`, built and cached here when not given.
    """
    if not launches(p, use_kernels):
        return absorption_lb_reference(freqs, p, t, rho, lwc, model, o3)
    with span("cuda.absorption_lb"):
        with_o3 = o3 is not None
        arrays = dict(p=p, t=t, rho=rho, lwc=lwc)
        if with_o3:
            arrays["o3"] = o3
        layout, tables = _kernel_args(freqs, arrays, model, with_o3, tables)
        out = torch.empty((len(freqs), *p.shape), dtype=torch.float32,
                          device=p.device)
        # K1 takes its channels by value: an array on the host, which the C
        # entry point copies into the kernel's arguments before it returns
        f = (ctypes.c_float * len(freqs))(*freqs)
        with torch.cuda.device(p.device):
            err = _build.library().mwr_absorption_lb(
                p.data_ptr(), t.data_ptr(), rho.data_ptr(), lwc.data_ptr(),
                o3.data_ptr() if with_o3 else None, ctypes.addressof(f),
                len(freqs),
                tables.data_ptr(), layout.size, layout.n_h2o, layout.n_o2,
                layout.n_o3, layout.h2o, layout.o2, layout.o3, layout.gl,
                p.numel(), out.data_ptr(),
                torch.cuda.current_stream(p.device).cuda_stream)
        if err:
            raise RuntimeError(f"absorption kernel launch failed: CUDA "
                               f"error {err}")
        count_launch(absorption_lb)
        return out


absorption_lb.launches = 0


def resident_warps(n_channels: int = 14, model: str = "R24",
                   o3: bool = False) -> int:
    """Warps of K1 that the current CUDA device keeps resident per SM at
    `n_channels` channels, from the occupancy calculator."""
    layout = table_layout(model, o3)
    warps = _build.library().mwr_absorption_resident_warps(
        n_channels, layout.size, layout.n_h2o + layout.n_o2 + layout.n_o3)
    if warps < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-warps}")
    return warps


def _kernel_args(freqs, arrays: dict, model: str, with_o3: bool, tables):
    """Check the inputs of K1/K4; return the table layout and the packed
    table (built and cached when `tables` is None)."""
    device = arrays["p"].device
    layout = table_layout(model, with_o3)
    if tables is None:
        tables = line_tables(model, with_o3, device)
    _check_inputs(freqs, arrays, tables, layout)
    return layout, tables


# K4's channel groups (csrc/absorption_tangents.cu): a thread evaluates one
# group of at most TANGENT_GROUP_MAX channels, the groups on the grid's y
# axis, TANGENT_THREADS points a block.
TANGENT_GROUP_MAX = 8
TANGENT_THREADS = 128


def tangent_groups(n_channels: int) -> tuple:
    """(groups, channels a group) of K4 at `n_channels`: groups of at most
    TANGENT_GROUP_MAX channels, as even as they come (14: two of 7)."""
    groups = -(-n_channels // TANGENT_GROUP_MAX)
    return groups, -(-n_channels // groups)


def tangent_blocks(n_points: int, n_channels: int) -> int:
    """Blocks of one K4 launch on `n_points` points at `n_channels`."""
    return -(-n_points // TANGENT_THREADS) * tangent_groups(n_channels)[0]


def absorption_tangents_lb(freqs, p, t, rho, lwc, model: str = "R24",
                           tables=None, use_kernels: bool = True,
                           with_lwc: bool = False):
    """(L, B) p [hPa], T [K], rho [g/m^3], LWC [g/m^3] -> alpha,
    dalpha/dT [Np/km/K] and dalpha/drho [Np/km per g/m^3], each (F, L, B),
    in one pass that carries both tangents; with `with_lwc`, dalpha/dLWC
    [Np/km per g/m^3] (F, L, B) fourth, from the same pass.

    K4 or the plain version by `launches(p, use_kernels)`; K4 takes 1 to
    MAX_CHANNELS channels, in the `tangent_groups` of one launch,
    contiguous arrays and `tables`, the packed `line_tables(model, False,
    device)` (K4 has no O3 term), built and cached here when not given.
    """
    if not launches(p, use_kernels):
        return absorption_tangents_lb_reference(freqs, p, t, rho, lwc, model,
                                                with_lwc)
    with span("cuda.absorption_tangents_lb"):
        layout, tables = _kernel_args(
            freqs, dict(p=p, t=t, rho=rho, lwc=lwc), model, False, tables)
        out = torch.empty((4 if with_lwc else 3, len(freqs), *p.shape),
                          dtype=torch.float32, device=p.device)
        # K4 takes its channels by value, as K1 does
        f = (ctypes.c_float * len(freqs))(*freqs)
        with torch.cuda.device(p.device):
            err = _build.library().mwr_absorption_tangents_lb(
                p.data_ptr(), t.data_ptr(), rho.data_ptr(), lwc.data_ptr(),
                ctypes.addressof(f), len(freqs), tables.data_ptr(),
                layout.n_h2o, layout.n_o2, layout.h2o, layout.o2, layout.gl,
                p.numel(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), out[3].data_ptr() if with_lwc else None,
                torch.cuda.current_stream(p.device).cuda_stream)
        if err:
            raise RuntimeError(f"absorption tangent kernel launch failed: "
                               f"CUDA error {err}")
        if count_launch(absorption_tangents_lb):
            absorption_tangents_lb.lwc_launches += with_lwc
        return tuple(out)


absorption_tangents_lb.launches = 0
# the launches that wrote dalpha/dLWC
absorption_tangents_lb.lwc_launches = 0


def tangent_resident_warps(n_channels: int = 14, model: str = "R24") -> int:
    """Warps of K4 that the current CUDA device keeps resident per SM at
    `n_channels` channels, from the occupancy calculator."""
    layout = table_layout(model, False)
    warps = _build.library().mwr_absorption_tangents_resident_warps(
        n_channels, layout.n_h2o, layout.n_o2)
    if warps < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-warps}")
    return warps
