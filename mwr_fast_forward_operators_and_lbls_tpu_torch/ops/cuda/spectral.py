"""Spectral absorption kernel K6 (`csrc/absorption_spectral.cu`), its wrapper
and plain version.

`absorption_spectral` maps a runtime frequency grid (F,) and point arrays p,
T, rho, LWC of any one shape to alpha (F, *shape) [Np/km], frequency-major:
level-major (L, B) points give the (F, L, B) layout the RTE kernels read.
On CPU tensors it runs `absorption_spectral_reference`; on CUDA tensors it
launches K6 or raises.  There is no O3 term, as on the TPU.
"""

import numpy as np
import torch

from ...constants import H2O_MODELS, O2_MODELS
from ..absorption import total_absorption
from . import _build
from .absorption import check_points, line_tables, table_layout

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


def absorption_spectral(f_ghz, p, t, rho, lwc, model: str = "R24",
                        f_range=None):
    """Monochromatic absorption: frequencies f_ghz (F,) [GHz] and p [hPa],
    T [K], rho [g/m^3], LWC [g/m^3] of one shape -> alpha (F, *shape)
    [Np/km].

    f_ghz is a sequence, a numpy array or a tensor; on the kernel path a
    contiguous float32 tensor on the points' device is used as it is.
    f_range = (fmin, fmax), when given, is checked against the frequencies:
    ValueError if one lies outside it.  CPU tensors take the plain version.
    CUDA tensors (float32, contiguous) launch K6 on the release's packed
    `line_tables(model, False, device)`.
    """
    if p.device.type == "cpu":
        return absorption_spectral_reference(f_ghz, p, t, rho, lwc, model,
                                             f_range)
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
    out = torch.empty((f.numel(), *p.shape), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().mwr_absorption_spectral(
            p.data_ptr(), t.data_ptr(), rho.data_ptr(), lwc.data_ptr(),
            f.data_ptr(), f.numel(), tables.data_ptr(), layout.size,
            layout.n_h2o, layout.n_o2, layout.h2o, layout.o2, layout.gl,
            p.numel(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"spectral absorption kernel launch failed: CUDA "
                           f"error {err}")
    absorption_spectral.launches += 1
    return out


absorption_spectral.launches = 0
