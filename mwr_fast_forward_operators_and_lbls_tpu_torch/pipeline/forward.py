"""Forward stage: harmonized dataset -> model brightness temperatures.

Torch counterpart of the JAX package's `pipeline/forward.py`, the L2 layer of
the reference pipeline (three separate processes driving PyRTlib in-process
and RTTOV-gb / ARMS-gb through file protocols,
reference/python_src/proc/{PyRTlib,RTTOV_gb,ARMS_gb}_processing.py).

Output variables appended to the dataset (reference parity,
RTTOV_gb_processing.py:364-434 and PyRTlib_processing.py:161-195):

    TBs_LBL_<model>   (time, N_Channels, elevation, Crop)   [K]
    TBs_Fast          (time, N_Channels, elevation, Crop)   [K]
    ttrans_Fast       (time, N_Channels, elevation, Crop)   surface-to-space
    levtrans_Fast     (time, N_Channels, N_Levels, elevation, Crop)
    Jacobian_{T,ppmv,liq}_LBL (time, N_Channels, elevation, N_Levels, Crop)

For each crop the stage screens the profiles on the host (`_screen`),
uploads them (`_upload`: pinned host memory, copies on a side stream that
the compute stream waits on) and runs `_stage_device`: a loop over chunks
of `batch_size` time steps through the port's entry points
(`lbl.forward_batch` per model on kernels K1 and K2, `fast.fast_forward_batch`
on K2 over layer-mean extinction, `jacobians.kmatrix_batch_fast` on K4, K5a
and K5b), each chunk's outputs written on the device straight into the
public layouts, crop on the last axis (`_allocate`).  Both crops are
uploaded and enqueued before any result is read; then the invalid profiles'
outputs are set to NaN on the device (`_mask`) and each variable comes to
the host in one copy (`_pull`), ready to use.  A ragged last chunk is run
as it is: no entry point needs a fixed batch.

NaN-profile screening follows the reference's validity protocol
(check_for_nans, PyRTlib_processing.py:71-79): invalid profiles produce NaN
outputs rather than aborting the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import hatpro
from ..data import preprocess
from ..data.dataset import Dataset, Variable
from ..models import fast as fast_mod
from ..models import jacobians as jac_mod
from ..models import lbl as lbl_mod
from ..ops.cuda.absorption import line_tables
from ..ops.tensors import resolve_device

JAC_WRT = ("t", "rho", "lwc")


def _valid_mask(profiles: dict) -> np.ndarray:
    """(B,) True where every level of every variable is finite."""
    mask = np.ones(profiles["z"].shape[0], bool)
    for v in profiles.values():
        mask &= np.isfinite(np.asarray(v)).all(axis=1)
    return mask


def _screen(profiles: dict):
    """Replace invalid profiles by a benign stand-in so the batched kernel
    stays NaN-free; caller masks the outputs back to NaN."""
    mask = _valid_mask(profiles)
    if mask.all():
        return profiles, mask
    good = int(np.argmax(mask)) if mask.any() else None
    out = {}
    for k, v in profiles.items():
        v = np.array(v, copy=True)
        if good is None:
            stand_in = np.linspace(1.0, 2.0, v.shape[1], dtype=v.dtype)
            if k == "p":
                stand_in = np.linspace(1000.0, 100.0, v.shape[1], dtype=v.dtype)
            if k == "t":
                stand_in = np.full(v.shape[1], 250.0, v.dtype)
            if k == "z":
                stand_in = np.linspace(0.0, 20000.0, v.shape[1], dtype=v.dtype)
            v[~mask] = stand_in
        else:
            v[~mask] = v[good]
        out[k] = v
    return out, mask


def _upload(profiles: dict, compress: bool, device: torch.device):
    """Ship one crop's profile payload to `device`.

    compress=False: the float32 profiles.  compress=True (opt-in): fp16
    ANOMALY encoding, as in the JAX package: each variable is sent as
    (v - median_profile) in float16 plus the (L,) float32 reference row,
    which `_stage_device` adds back on the device.  Straight fp16 would be
    useless (T ~ 300 K rounds to ~0.15-1 K steps), but the anomalies span
    only tens of units, so fp16's 11-bit mantissa keeps the reconstruction
    error ~1e-2 units, and the payload is half the bytes.

    On CUDA the payload is staged in pinned host memory and copied with
    `non_blocking` on a side stream; the current stream waits on an event
    recorded after the copies, so the host goes on to the next crop while
    they run.  Returns (payload, ref or None) as tensors on `device`.
    """
    if compress:
        ref = {k: np.median(np.asarray(v, np.float32), axis=0)
               for k, v in profiles.items()}
        host = {k: (np.asarray(v, np.float32) - ref[k]).astype(np.float16)
                for k, v in profiles.items()}
    else:
        ref = None
        host = {k: np.asarray(v, np.float32) for k, v in profiles.items()}
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in host.items()}
    ref_host = (None if ref is None
                else {k: torch.from_numpy(r) for k, r in ref.items()})
    if device.type != "cuda":
        return host, ref_host
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(compute)

    def send(t):
        with torch.cuda.stream(side):
            d = t.pin_memory().to(device, non_blocking=True)
        d.record_stream(compute)
        return d

    payload = {k: send(v) for k, v in host.items()}
    ref_dev = (None if ref_host is None
               else {k: send(r) for k, r in ref_host.items()})
    compute.wait_event(side.record_event())
    return payload, ref_dev


def _stage_tables(models: tuple, use_kernels: bool,
                  device: torch.device) -> dict:
    """The packed line table of each model, which K1 and K4 read, built once
    per stage ({} where the kernels do not run: the plain versions need
    none)."""
    if not (use_kernels and device.type == "cuda"):
        return {}
    return {m: line_tables(m, False, device) for m in models}


def _allocate(n_time: int, n_lev: int, models: tuple, with_fast: bool,
              with_jacobians: bool, device: torch.device) -> dict:
    """The stage's outputs on `device` in the public layouts, both crops on
    the last axis, NaN until written: {"lbl": {model: (n, F, E, 2)},
    "fast": {"tb", "ttrans": (n, F, E, 2), "levtrans": (n, F, L, E, 2)},
    "jac": {name: (n, F, E, L, 2)}}, the last two only when asked for."""
    nc, ne = hatpro.N_CHANNELS, hatpro.N_ELEVATIONS

    def nan(*shape):
        return torch.full(shape + (2,), float("nan"), dtype=torch.float32,
                          device=device)

    out = {"lbl": {m: nan(n_time, nc, ne) for m in models}}
    if with_fast:
        out["fast"] = {"tb": nan(n_time, nc, ne),
                       "ttrans": nan(n_time, nc, ne),
                       "levtrans": nan(n_time, nc, n_lev, ne)}
    if with_jacobians:
        out["jac"] = {name: nan(n_time, nc, ne, n_lev) for name in JAC_WRT}
    return out


def _stage_device(dev: dict, ref: dict | None, fast_params: dict | None,
                  models: tuple, use_kernels: bool, batch_size: int,
                  tables: dict, out: dict, crop: int) -> None:
    """One crop's device work, written into `out` (`_allocate`) at `crop`:
    a loop over chunks of `batch_size` time steps through the entry points.

    Each chunk is computed as the entry point computes it on those
    profiles; the stage adds no arithmetic but exp(-tau) for ttrans and the
    fp16 payload's reconstruction.  The K-matrix is the last model's, and
    is computed when `out` has room for it.
    """
    if ref is not None:
        dev = {k: v.float() + ref[k][None, :] for k, v in dev.items()}
    n = dev["z"].shape[0]
    if "fast" in out:
        fcfg = fast_mod.FastConfig(use_kernels=use_kernels,
                                   outputs=("tb", "tau_total", "trans_level"))
    kcfg = lbl_mod.LBLConfig(model=models[-1], use_kernels=use_kernels)
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        chunk = {k: v[s:e] for k, v in dev.items()}
        for m in models:
            cfg = lbl_mod.LBLConfig(model=m, use_kernels=use_kernels,
                                    outputs=("tb",))
            tb = lbl_mod.forward_batch(chunk, cfg, tables.get(m))["tb"]
            out["lbl"][m][s:e, ..., crop] = tb.permute(0, 2, 1)  # (b, F, E)
        if "fast" in out:
            res = fast_mod.fast_forward_batch(fast_params, chunk, fcfg)
            dst = out["fast"]
            dst["tb"][s:e, ..., crop] = res["tb"].permute(0, 2, 1)
            dst["ttrans"][s:e, ..., crop] = torch.exp(
                -res["tau_total"]).permute(0, 2, 1)
            dst["levtrans"][s:e, ..., crop] = res["trans_level"].permute(
                0, 2, 3, 1)                                   # (b, F, L, E)
        if "jac" in out:
            k = jac_mod.kmatrix_batch_fast(chunk, kcfg, wrt=JAC_WRT,
                                           tables=tables.get(models[-1]))
            for name in JAC_WRT:
                out["jac"][name][s:e, ..., crop] = k[name].permute(
                    0, 2, 1, 3)                               # (b, F, E, L)


def _leaves(out: dict) -> list:
    return [v for items in out.values() for v in items.values()]


def _mask(out: dict, mask: np.ndarray, crop: int) -> None:
    """Set the outputs of the invalid profiles of `crop` to NaN."""
    if mask.all():
        return
    leaves = _leaves(out)
    bad = torch.from_numpy(np.flatnonzero(~mask)).to(leaves[0].device)
    for v in leaves:
        v.select(-1, crop).index_fill_(0, bad, float("nan"))


def _pull(out: dict) -> dict:
    """Each output variable as a numpy array: one device-to-host copy per
    variable, both crops at once.

    From the card the copy lands in one pinned staging buffer, reused for
    every variable (a copy into pageable memory runs at a fraction of the
    link's rate), and goes on to pageable memory in a host copy that torch
    spreads over its threads; the caller's arrays are never pinned.  The
    copy into the staging buffer waits for the stream, so the buffer is
    complete when it is read.
    """
    leaves = _leaves(out)
    if not leaves[0].is_cuda:
        return {group: {k: v.numpy() for k, v in items.items()}
                for group, items in out.items()}
    staging = torch.empty(max(v.numel() for v in leaves),
                          dtype=torch.float32, pin_memory=True)

    def fetch(v):
        buf = staging[:v.numel()].view(v.shape)
        buf.copy_(v)
        return torch.empty(v.shape, dtype=v.dtype).copy_(buf).numpy()

    return {group: {k: fetch(v) for k, v in items.items()}
            for group, items in out.items()}


def forward_stage(ds: Dataset,
                  models: tuple = ("R98", "R17", "R20", "R24"),
                  fast_params: dict | None = None,
                  with_jacobians: bool = False,
                  batch_size: int = 256,
                  fused: bool | None = None,
                  compress_upload: bool = False,
                  device=None) -> Dataset:
    """Run the native LBL (all `models`) and optionally the fast operator and
    K-matrix over every (time, Crop) profile at the 10 BL-scan elevations;
    append results to `ds` in the reference layout.

    device: where the stage computes; None is the CUDA card, and raises
      RuntimeError where there is none (`device="cpu"` runs it on the CPU).
    fused: None or True runs the kernels (on the CPU their wrappers take
      their plain versions); False runs the plain torch path on any device.
    fast_params: {"w": (72, C)} as the port's tensors or the JAX package's
      weights as numpy arrays; carried onto `device`
      (`fast.params_from_numpy`).
    compress_upload: opt-in fp16-anomaly payload encoding (see `_upload`).
    """
    dev = resolve_device(device)
    use_kernels = fused is None or bool(fused)
    models = tuple(models)
    if fast_params is not None:
        fast_params = fast_mod.params_from_numpy(fast_params, dev)
    out = _allocate(ds.dims["time"], ds.dims["N_Levels"], models,
                    fast_params is not None, with_jacobians, dev)
    tables = _stage_tables(models, use_kernels, dev)
    # Upload and enqueue BOTH crops before reading any result: crop 1's
    # screening and upload overlap crop 0's device work.
    for crop in (0, 1):
        raw = preprocess.profiles_for_forward(ds, crop=crop)
        profiles, mask = _screen(raw)
        if not mask.any():
            continue
        payload, ref = _upload(profiles, compress_upload, dev)
        _stage_device(payload, ref, fast_params, models, use_kernels,
                      batch_size, tables, out, crop)
        _mask(out, mask, crop)
    res = _pull(out)

    mdims = ("time", "N_Channels", "elevation", "Crop")
    for m in models:
        ds[f"TBs_LBL_{m}"] = Variable(
            mdims, res["lbl"][m],
            {"units": "K",
             "long_name": f"native LBL brightness temperatures ({m} "
                          "absorption)",
             "comment": "replaces TBs_PyRTlib_" + m})
    if fast_params is not None:
        fast_tb, fast_ttrans, fast_levtrans = (
            res["fast"][k] for k in ("tb", "ttrans", "levtrans"))
        ds["TBs_Fast"] = Variable(mdims, fast_tb, {
            "units": "K",
            "long_name": "fast predictor-regression operator TBs",
            "comment": "replaces TBs_RTTOV_gb / TBs_ARMS_gb"})
        ds["ttrans_Fast"] = Variable(mdims, fast_ttrans, {
            "long_name": "surface-to-space transmittance"})
        ds["levtrans_Fast"] = Variable(
            ("time", "N_Channels", "N_Levels", "elevation", "Crop"),
            fast_levtrans, {"long_name": "level-to-surface transmittance"})
    name_map = {"t": "T", "rho": "rho", "lwc": "liq"}
    for name, arr in res.get("jac", {}).items():
        ds[f"Jacobian_{name_map[name]}_LBL"] = Variable(
            ("time", "N_Channels", "elevation", "N_Levels", "Crop"), arr,
            {"long_name": f"dTB/d{name} K-matrix (autodiff)",
             "comment": "replaces Jacobian_*_RTTOV_gb (Fortran adjoint)"})
    return ds
