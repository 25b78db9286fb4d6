"""Drive the PyTorch/CUDA port's line-by-line forward, K-matrix,
monochromatic spectral forward, primitive-rate microbenchmark with the
kernels' bounds, fast operator and retrieval on one GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  It builds the port's kernels from `csrc/` and goes through
twenty-one phases, each printing its own lines:

  0. the card (nvidia-smi name and power limit), torch/CUDA versions, the
     kernel build time, each kernel instantiation's registers and spills
     (K4's and K5's without spills), the warps of K1, K2's staged body, K4,
     K5, K6 and K3's staged body resident per SM, and K4's blocks at the
     K-matrix shape against its resident slots;
  1. the absorption kernel (K1) against its plain torch version on the card
     and against the function in float64 on the kernel's float32 tables;
  2. the RTE kernel (K2) against its plain torch version on the card and
     against the plain version in float64 (its chords are float64), with the
     size of the copies each case takes and the same bits from both sizes,
     and the TB error at 4.2 degrees against float64 beside that of the plain
     float32 version, whose chords are float32;
  3. the forward path, `forward_batch` on 1024 HATPRO profiles x 180 levels,
     model R24, with both kernels' launch counts, against the plain path and
     the frozen fp64 TB golden;
  4. CUDA-event times (median of 20 after warm-up) of each kernel and of the
     whole forward against the plain versions, of K2 on layer means, at the
     retrieval's batch and with 4-byte copies, of the
     four-release sweep `forward_all_models`, and peak device memory; here
     and in phases 9 and
     13, each kernel's time also inside a CUDA graph of 20 calls, which
     leaves the host out;
  5. the absorption tangent kernel (K4) against its plain version and
     against the function in float64 on the kernel's float32 tables, all
     nine releases, 256 profiles x 180 levels;
  6. the K-matrix adjoint kernel (K5) for t, rho, lwc and rho+lwc against
     its plain version run in float64, 256 profiles x 10 elevations x 14
     channels x 180 levels, and its LWC columns again on alpha rounded from
     the float64 function;
  7. the K-matrix path, `kmatrix_batch_fast` on 256 profiles for t, rho and
     lwc, with the launch counts of K4 and both K5 wrappers;
  8. that K-matrix against the plain path in float64 on the card, and its
     physical signs;
  9. CUDA-event times of K4 (with its blocks against its resident slots),
     K5 and the K-matrix against the plain versions,
     of `forward_batch` at the same batch, of the output permute alone, and
     peak device memory; K5 t on 32 profiles in a graph, one block per
     (elevation, channel);
 10. the spectral absorption kernel (K6): its state pass against the plain
     `line_state` in float64; the kernel against its plain version and
     against the function in float64 on the kernel's float32 tables (with
     the plain float32 version's error beside it): R24 on one full chunk (32
     x 180 points x 8192 frequencies) and on the 51-54 GHz window of the 50k
     grid, all nine releases on 256 points x 2048 frequencies, a grid with a
     tail tile; R03's 1998 dry continuum; the refusal of an f_range that
     excludes the grid;
 11. the given-path RTE kernel (K3) against its plain version: its staged
     body at the spectral chunk shape, on layer means and on a batch that
     leaves a tile of profiles part empty, its other body at the HATPRO scan
     shape with trans_level and at an odd shape (F=100, B=30, L=37);
 12. the spectral path, `forward_spectral` plus `srf_convolve` on 32
     profiles x 180 levels x 50,000 frequencies (R24, zenith, chunks of
     8192), with the launch counts of K6 and K3, against the plain path, the
     channel forward at the 14 channel centres, the spectrum's line
     structure and a float64 SRF product;
 13. CUDA-event times of K6 and K3 per chunk, of K6's state pass alone, of
     K3's other body, of the plain versions on one chunk, and of the whole
     spectrum with the SRF, with peak device memory;
 14. the chain kernel (K7) against its plain version and a float64
     recurrence for each primitive (the fma chain's length shows in its
     value, the others' only in their time), the card's fma, divide and exp
     rates (and those of the approximate intrinsics), the time at k and at
     2k applications, the rates at two occupancies, and `measure_peaks`
     with the copy bandwidth and K7's launch count;
 15. the bound (the least time the card could take for the function, from
     `parallel/profiling.py`) of every kernel at its main-path shape, at the
     published peaks and at the rates phase 14 measured, what bounds it, the
     kernel's share of it, and beside it the arithmetic of the body as it
     is coded;
 16. the fast operator: `fit_closed_form` on 64 profiles (K1 once), then
     `fast_forward_batch` on 1024 profiles x 10 elevations x 14 channels x
     180 levels through K2 on layer-mean extinction, with the launch counts,
     against the plain path, the LBL teacher and a float64 regression
     product, with TF32 allowed process-wide;
 17. the closed-form fast-operator K-matrix against `torch.func.jacrev`;
 18. the retrieval, `retrieve_batch` on 64 profiles x 180 levels, 3
     iterations: posterior against prior errors, the fit to the
     observations, the degrees of freedom;
 19. CUDA-event times of fast serving, one distillation step, the fast K
     and the retrieval, with peak device memory, and a `torch.profiler`
     trace of fast serving, of the retrieval and of the K-matrix: device
     time by kernel and the device's idle share;
 20. the campaign forward stage, `pipeline.forward_stage`: (a) a synthetic
     campaign (3 sondes, one instrument's L1/L2 files) through
     `preprocess_files`, a NetCDF round trip, `distill_on_dataset` and the
     stage with all four releases, the fast operator and the K-matrix, its
     shapes and physics, NaN screening and `merge.analysis_dataset`; (b)
     the stage at 1000 times x 2 crops x 180 levels (bench.py's stage
     shape, from `demo_batch`), batch_size=256, with the launch counts of
     K1, K2, K4 and K5, each output against the entry point called directly
     on the same profiles, batch_size=100 against 256, the TBs against the
     plain path; its wall (median of 3), the split into screening, upload,
     device and pull, device time and idle share from a profiler trace,
     spectra/s against phase 4's `forward_batch`, the R24-only stage, the
     fp16 upload on and off, peak device memory and the host outputs' size.

It then prints one JSON line of per-kernel results and, last, one JSON line
naming the device.  Any failed check raises, and the exit code is not 0.
Without a CUDA device it exits with 1 and prints no result.
"""

import dataclasses
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "mwr_fast_forward_operators_and_lbls_tpu_torch"
B, L = 1024, 180        # the HATPRO boundary-layer scan shape of bench.py
BK = 256                # the K-matrix batch of bench.py (BASELINE config 4)
WRT = ("t", "rho", "lwc")
REPEATS = 20
BS, NF_SPEC, CHUNK = 32, 50_000, 8192   # the spectral shape of bench.py
N_STAGE_TIME = 1000     # the forward-stage shape of bench.py: x 2 crops
STAGE_MODELS = ("R98", "R17", "R20", "R24")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def timed_ms(fn, repeats=REPEATS, warmup=3):
    """Median CUDA-event time [ms] of fn() over `repeats` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls=20, replays=5):
    """Device time [ms] of one fn() without the host: `calls` calls are
    captured into one CUDA graph, which is replayed `replays` times between
    CUDA events; the median over the replays, per call.  fn must launch on
    the current stream and synchronise nothing."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def level_major(profiles):
    return {k: v.T.contiguous() for k, v in profiles.items()}


def off_16_bytes(a):
    """A contiguous copy of `a` that starts 4 bytes into its storage: the
    RTE kernel copies it in 4-byte pieces."""
    view = torch.empty(a.numel() + 1, dtype=a.dtype,
                       device=a.device)[1:].view(a.shape)
    view.copy_(a)
    return view


def k_error(got, ref):
    """max |got - ref| / max(|ref|, 1e-3 max |ref|): relative, with a floor
    where K crosses zero."""
    ref = ref.double()
    floor = 1e-3 * ref.abs().max()
    return float(((got.double() - ref).abs()
                  / torch.clamp_min(ref.abs(), floor)).max())


def peak_mib(fn):
    """Peak device memory [MiB] that fn() allocates above what is live
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - live) / 2 ** 20


def ptxas_report(log: str):
    """(source, kernel, report) for each kernel instantiation in nvcc's
    `-Xptxas -v` log; kernel names are demangled when c++filt is there."""
    entries, src, key = {}, None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            key = (src, m.group(1))
            entries[key] = {"regs": "?", "spill": ""}
        elif key is None:
            continue
        elif m := re.search(r"Used (\d+) registers", line):
            entries[key]["regs"] = m.group(1)
        elif "spill" in line:
            entries[key]["spill"] = line.strip()
    names = [name for _, name in entries]
    if shutil.which("c++filt") and names:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                 .removeprefix("void ") for n in names]
    return [(s_, name, f"{e['regs']} registers, {e['spill']}")
            for ((s_, _), e), name in zip(entries.items(), names)]


def stage_dataset(n_time):
    """A harmonized dataset of `n_time` times x 2 identical crops x L
    levels from `demo_batch`, as bench.py builds its forward-stage input."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data.dataset import (
        Dataset, Variable)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl

    profs = {k: v.numpy().astype(np.float64)
             for k, v in lbl.demo_batch(n_time, L, device="cpu").items()}
    p, t, rho = profs["p"], profs["t"], profs["rho"]
    e = rho * t / 216.679
    mr = 1000.0 * 0.622 * e / np.maximum(p - e, 1e-3)
    liq = profs["lwc"] / 1000.0 / (p * 100.0 / (287.04 * t))
    ds = Dataset()
    for name, x in (("Level_Pressure", p), ("Level_Temperature", t),
                    ("Level_H2O", mr), ("Level_z", profs["z"]),
                    ("Level_Liquid", liq)):
        # (B, L) ground -> top  ->  (N_Levels top -> ground, time, Crop)
        lev = np.repeat(x.T[::-1, :, None], 2, axis=2).astype("f4")
        ds[name] = Variable(("N_Levels", "time", "Crop"), lev)
    return ds


def stage_outputs(ds):
    """{name: array} of the stage's output variables in `ds`."""
    return {k: v.data for k, v in ds.variables.items()
            if k.startswith(("TBs_LBL_", "TBs_Fast", "ttrans_", "levtrans_",
                             "Jacobian_"))}


def stage_tolerance(name, want):
    """What two runs of the stage that differ only in how they batch may
    differ by: 1e-5 K on TBs, 1e-6 on transmittances, 1e-5 max |K| on the
    K-matrices."""
    if name.startswith("Jacobian_"):
        return 1e-5 * float(np.nanmax(np.abs(want)))
    return 1e-5 if name.startswith("TBs_") else 1e-6


def same_data(a, b):
    """Equal arrays, NaN where NaN; a string variable `a` against the
    character array NetCDF classic reads back."""
    if a.dtype.kind == "U":
        b = np.array([row.tobytes().decode().rstrip("\x00") for row in b])
    nan = a.dtype.kind in "fc"
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=nan)


def stage_campaign(root):
    """Phase 20 (a): a synthetic campaign through the data layer, the
    distillation, the stage and the merge."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
        netcdf, preprocess, synthetic)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward_stage, merge)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.utils import native

    t0 = time.perf_counter()
    sondes, mwr_files = [], {"joyhat": []}
    for i, stamp in enumerate(("20240805_102936", "20240806_102936",
                               "20240807_102936")):
        sondes.append(synthetic.write_sonde_nc_arms(
            str(root / f"{stamp}.nc"), seed=i))
        launch = np.datetime64(f"2024-08-0{5 + i}T10:29:36")
        mwr_files["joyhat"].append(synthetic.write_mwr_l1(
            str(root / f"mwr_l1_{i}.nc"), launch, seed=10 + i))
        for j, prod in enumerate(("ta", "hua", "prw", "clwvi")):
            mwr_files["joyhat"].append(synthetic.write_mwr_l2(
                str(root / f"mwr0_l2_{prod}_{i}.nc"), launch, prod,
                seed=20 + 10 * j + i))
    ds = preprocess.preprocess_files(sondes, "Vital", "Juelich", mwr_files)
    path = str(root / "harmonized.nc")
    netcdf.write(path, ds)
    back = netcdf.read(path)
    check(set(back.variables) == set(ds.variables) and all(
        same_data(v.data, back[k].data) for k, v in ds.variables.items()),
        "NetCDF round trip")
    ds = back
    params = fast.distill_on_dataset(ds)
    check(params["w"].is_cuda and bool(torch.isfinite(params["w"]).all()),
          "distill_on_dataset on the card")
    out = forward_stage(ds.copy(), STAGE_MODELS, params, with_jacobians=True)
    nt = ds.dims["time"]
    shapes = {"TBs_LBL_R24": (nt, 14, 10, 2), "TBs_Fast": (nt, 14, 10, 2),
              "ttrans_Fast": (nt, 14, 10, 2),
              "levtrans_Fast": (nt, 14, L, 10, 2),
              "Jacobian_T_LBL": (nt, 14, 10, L, 2)}
    outs = stage_outputs(out)
    check(len(outs) == len(STAGE_MODELS) + 6, f"outputs {sorted(outs)}")
    check(all(outs[k].shape == v for k, v in shapes.items()),
          f"stage shapes {[(k, outs[k].shape) for k in shapes]}")
    check(all(np.isfinite(v).all() for v in outs.values()),
          "stage outputs not finite")
    # the physics checks of tests/test_pipeline.py; K_T of the opaque
    # 58 GHz channel is positive at the lowest level and zero at the top
    tb = outs["TBs_LBL_R24"]
    tt = outs["ttrans_Fast"]
    k_t = outs["Jacobian_T_LBL"]
    fast_dev = float(np.abs(outs["TBs_Fast"] - tb).max())
    check(bool(np.all(tb[:, 0, -1, 0] > tb[:, 0, 0, 0])), "K-band TB order")
    check(bool(np.all(tt[:, 0, -1, 0] <= tt[:, 0, 0, 0] + 1e-6)),
          "transmittance order")
    check(fast_dev < 0.3, f"fast vs LBL {fast_dev} K")
    check(bool(np.all(k_t[:, 13, 0, 0, :] > 0))
          and np.abs(k_t[:, 13, 0, -1, :]).max() <= 1e-6 * np.abs(k_t).max(),
          "K_T at 58 GHz")
    killed = ds.copy()
    killed["Level_Temperature"].data[:, 0, :] = np.nan
    tb_k = forward_stage(killed, ("R24",))["TBs_LBL_R24"].data
    check(np.isnan(tb_k[0]).all() and np.isfinite(tb_k[1:]).all(),
          "NaN screening")
    ana = merge.analysis_dataset(out.copy(), compat=True)
    check("cloud_flag" in ana and "Deviations_Fast_R24" in ana
          and "TBs_PyRTlib_R24" in ana, "analysis_dataset")
    print(f"phase 20: campaign of 3 sondes + joyhat L1/L2: harmonized "
          f"{dict(ds.dims)}, NetCDF round trip equal; distill_on_dataset w "
          f"{tuple(params['w'].shape)} on {params['w'].device}; stage with "
          f"{STAGE_MODELS}, fast, K: {len(outs)} outputs, finite, physics "
          f"checks hold (max|fast - LBL R24| {fast_dev:.4f} K); profile 0 "
          f"killed -> NaN; analysis_dataset {len(ana.variables)} variables; "
          f"native ncio library loaded: {native.available()}; "
          f"{time.perf_counter() - t0:.1f} s")


def forward_stage_phase(dev, fb_rate, counted):
    """Phase 20: the campaign forward stage.  Returns the launches of each
    kernel wrapper in `counted` ({name: wrapper}) during one stage call at
    bench.py's shape."""
    import tempfile

    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import preprocess
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        fast, jacobians, lbl)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
        path_times)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward as fwd)

    scratch = ROOT / "build" / "torch_kernels"
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        stage_campaign(pathlib.Path(tmp))

    # (b) bench.py's stage: 1000 times x 2 crops x 180 levels
    n = N_STAGE_TIME
    ds = stage_dataset(n)
    counted["absorption_lb"].launches = 0
    params = fast.distill_on_dataset(ds, crop=0)
    fit_k1 = counted["absorption_lb"].launches

    def stage(models=STAGE_MODELS, with_fast=True, with_jacobians=True,
              **kw):
        return fwd.forward_stage(ds.copy(), models,
                                 params if with_fast else None,
                                 with_jacobians=with_jacobians, **kw)

    stage()                                   # warm-up
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    out = stage_outputs(stage())
    launches = {name: fn.launches for name, fn in counted.items()}
    chunks = 2 * -(-n // 256)
    want = {"absorption_lb": len(STAGE_MODELS) * chunks,
            "forward_lb": (len(STAGE_MODELS) + 1) * chunks,
            "absorption_tangents_lb": chunks, "kmatrix_assembled_lb": chunks,
            "kmatrix_assembled_rho_lwc_lb": chunks, "absorption_spectral": 0,
            "downwelling_lb": 0, "chain": 0}
    print(f"phase 20: launches during forward_stage ({n} times x 2 crops, "
          f"batch_size=256: {chunks} chunks, {STAGE_MODELS}, fast, K): "
          f"{launches}; K1 during distill_on_dataset {fit_k1}")
    check(launches == want, f"stage launches {launches}, want {want}")
    check(fit_k1 == 1, f"distill_on_dataset K1 launches {fit_k1}")
    check(all(np.isfinite(v).all() for v in out.values()),
          "stage outputs not finite")

    # each output against the entry point called directly on all n
    # profiles of the crop
    direct_err = {}
    kcfg = lbl.LBLConfig(model=STAGE_MODELS[-1])
    fcfg = fast.FastConfig(outputs=("tb", "tau_total", "trans_level"))
    for crop in (0, 1):
        prof = {k: torch.from_numpy(v).to(dev) for k, v in
                preprocess.profiles_for_forward(ds, crop=crop).items()}
        direct = {f"TBs_LBL_{m}": lbl.forward_batch(
            prof, lbl.LBLConfig(model=m, outputs=("tb",)))["tb"].permute(
                0, 2, 1) for m in STAGE_MODELS}
        res = fast.fast_forward_batch(params, prof, fcfg)
        direct["TBs_Fast"] = res["tb"].permute(0, 2, 1)
        direct["ttrans_Fast"] = torch.exp(-res["tau_total"]).permute(0, 2, 1)
        direct["levtrans_Fast"] = res["trans_level"].permute(0, 2, 3, 1)
        k = jacobians.kmatrix_batch_fast(prof, kcfg, wrt=WRT)
        for name, tag in (("t", "T"), ("rho", "rho"), ("lwc", "liq")):
            direct[f"Jacobian_{tag}_LBL"] = k[name].permute(0, 2, 1, 3)
        for name, v in direct.items():
            err = float(np.abs(out[name][..., crop] - v.cpu().numpy()).max())
            direct_err[name] = max(direct_err.get(name, 0.0), err)
        del prof, direct, res, k
    print("phase 20: max|stage - entry point called directly on the crop's "
          f"{n} profiles|: " + "; ".join(f"{k} {v:.3e}"
                                         for k, v in direct_err.items()))
    check(all(v <= stage_tolerance(k, out[k]) for k, v in direct_err.items()),
          f"stage vs direct calls {direct_err}")

    out100 = stage_outputs(stage(batch_size=100))
    bs_err = {k: float(np.abs(out100[k] - v).max()) for k, v in out.items()}
    del out100
    print("phase 20: max|batch_size=100 - batch_size=256|: "
          + "; ".join(f"{k} {v:.3e}" for k, v in bs_err.items()))
    check(all(v <= stage_tolerance(k, out[k]) for k, v in bs_err.items()),
          f"batch_size dependence {bs_err}")
    plain = stage_outputs(stage(with_jacobians=False, fused=False))
    plain_err = {k: float(np.abs(plain[k] - out[k]).max())
                 for k in plain if k.startswith("TBs_")}
    del plain
    print("phase 20: max|kernels - plain path (fused=False) on the card|: "
          + "; ".join(f"{k} {v:.3e} K" for k, v in plain_err.items())
          + " (bound 1e-2)")
    check(max(plain_err.values()) <= 1e-2, f"stage vs plain {plain_err}")

    # times
    def wall_s(fn, repeats=3):
        fn()
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    wall = wall_s(stage)
    t0 = time.perf_counter()
    screened = [fwd._screen(preprocess.profiles_for_forward(ds, crop=c))
                for c in (0, 1)]
    t_screen = time.perf_counter() - t0
    t_upload = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ups = [fwd._upload(p, False, dev) for p, _ in screened]
        torch.cuda.synchronize()
        t_upload.append(time.perf_counter() - t0)
    t_upload = statistics.median(t_upload)
    tables = fwd._stage_tables(STAGE_MODELS, True, dev)
    res = fwd._allocate(n, L, STAGE_MODELS, True, True, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for crop, (p, r) in enumerate(ups):
        fwd._stage_device(p, r, params, STAGE_MODELS, True, 256, tables,
                          res, crop)
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t0
    t_pull = []
    for _ in range(3):
        t0 = time.perf_counter()
        fwd._pull(res)
        t_pull.append(time.perf_counter() - t0)
    t_pull = statistics.median(t_pull)
    # the device-to-host part alone: the same bytes into pinned buffers made
    # beforehand; and the same bytes straight into pageable memory
    pinned = [(torch.empty(v.shape, pin_memory=True), v)
              for v in fwd._leaves(res)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h, v in pinned:
        h.copy_(v, non_blocking=True)
    torch.cuda.synchronize()
    t_pull_pinned = time.perf_counter() - t0
    del pinned
    t0 = time.perf_counter()
    for v in fwd._leaves(res):
        v.cpu()
    t_pull_pageable = time.perf_counter() - t0
    del res, ups
    device_ms, n_kernels, top = path_times.device_profile(stage, 1, 4)
    peak = peak_mib(stage)
    host_bytes = {k: v.nbytes for k, v in out.items()}
    spectra = n * 2 * len(lbl.LBLConfig().elevations_deg)
    rate = spectra * len(STAGE_MODELS) / wall
    print(f"phase 20: forward_stage {n} x 2 crops x {L} levels, "
          f"{STAGE_MODELS}, fast, K, batch_size=256: wall {wall * 1e3:.1f} "
          f"ms (median of 3) = {rate:.6g} spectra/s, "
          f"{rate / fb_rate:.4f} of phase 4's forward_batch rate "
          f"({fb_rate:.6g} spectra/s); alone: host screening "
          f"{t_screen * 1e3:.1f} ms, upload {t_upload * 1e3:.1f} ms "
          f"({t_upload / wall:.4f} of the wall), device work (enqueue to "
          f"synchronise) {t_device * 1e3:.1f} ms, pull {t_pull * 1e3:.1f} ms "
          f"(of the same bytes: {t_pull_pinned * 1e3:.1f} ms into pinned "
          f"buffers made beforehand, {t_pull_pageable * 1e3:.1f} ms straight "
          f"into pageable memory), the rest "
          f"{(wall - t_screen - t_upload - t_device - t_pull) * 1e3:.1f} ms")
    if device_ms == 0.0:
        print("phase 20: the profiler saw no device time: idle share not "
              "measured")
    else:
        print(f"phase 20: forward_stage profiler over 1 call: "
              f"{round(n_kernels)} device kernels and copies, device time "
              f"{device_ms:.1f} ms against the wall {wall * 1e3:.1f} ms: the "
              f"device idles {max(0.0, 1.0 - device_ms / (wall * 1e3)):.3f} "
              f"of the call; most of it: " + "; ".join(
                  f"{name} {t:.2f} ms x{c:g}" for name, c, t in top))
    print(f"phase 20: forward_stage peak device memory {peak:.1f} MiB above "
          f"the live tensors; host outputs "
          f"{sum(host_bytes.values()) / 1e9:.3f} GB (Jacobians "
          f"{sum(v for k, v in host_bytes.items() if 'Jacobian' in k) / 1e9:.3f}"
          f" GB, levtrans {host_bytes['levtrans_Fast'] / 1e9:.3f} GB)")

    walls_r24 = {c: wall_s(lambda c=c: stage(("R24",), False, False,
                                             compress_upload=c))
                 for c in (False, True)}
    tb_plain = stage(("R24",), False, False)["TBs_LBL_R24"].data
    tb_comp = stage(("R24",), False, False,
                    compress_upload=True)["TBs_LBL_R24"].data
    comp_err = float(np.abs(tb_plain - tb_comp).max())
    rate_r24 = spectra / walls_r24[False]
    print(f"phase 20: R24-only stage (bench.py's): wall "
          f"{walls_r24[False] * 1e3:.1f} ms = {rate_r24:.6g} spectra/s, "
          f"{rate_r24 / fb_rate:.4f} of forward_batch's; with the fp16 "
          f"upload {walls_r24[True] * 1e3:.1f} ms, max|dTB| {comp_err:.3e} K "
          f"(bound 0.05)")
    check(comp_err < 0.05, f"compressed upload {comp_err} K")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from mwr_fast_forward_operators_and_lbls_tpu_torch.anchors import (
        standard_profiles)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
        H2O_MODELS, hatpro)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        fast, jacobians, lbl, retrieval, spectral)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (geometry,
                                                                   thermo)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        _build)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.chain import (
        OPS as CHAIN_OPS, chain, chain_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
        path_times, profiling)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        absorption as k1_mod)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (  # noqa: E501
        absorption_lb, absorption_lb_float64, absorption_lb_reference,
        absorption_tangents_lb, absorption_tangents_lb_float64,
        absorption_tangents_lb_reference, tangent_blocks,
        tangent_resident_warps)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        adjoint as k5_mod)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.adjoint import (  # noqa: E501
        kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
        kmatrix_assembled_rho_lwc_lb, kmatrix_assembled_rho_lwc_lb_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.absorption import (  # noqa: E501
        n2_absorption)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
        downwelling_lb, downwelling_lb_reference, forward_lb,
        forward_lb_body, forward_lb_reference, staged_resident_warps)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        spectral as k6)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.spectral import (  # noqa: E501
        absorption_spectral, absorption_spectral_reference)

    # the plain versions are the reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = lbl.LBLConfig(model="R24")
    freqs, elevs = cfg.freqs_ghz, cfg.elevations_deg

    # ---- phase 0: card, versions, build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"phase 0: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({lib_path.name})")
    for src, name, report in ptxas_report(
            lib_path.with_suffix(".log").read_text()):
        print(f"phase 0: ptxas: {src} {name}: {report}")
        if src in ("adjoint.cu", "absorption_tangents.cu"):
            check(not re.search(r"[1-9]\d* bytes spill", report),
                  f"{src} {name} spills: {report}")
    for what, warps, least in (
            (f"K1, F={len(freqs)}, R24",
             k1_mod.resident_warps(len(freqs), "R24"), 24),
            ("K1, F=16, R20SD with O3",
             k1_mod.resident_warps(16, "R20SD", True), 24),
            (f"K2 staged body, F={len(freqs)} L={L}",
             staged_resident_warps(L, kernel="K2", n_channels=len(freqs)),
             42),
            (f"K2 staged body on layer means with trans_level, "
             f"F={len(freqs)} L={L}",
             staged_resident_warps(L, True, "K2", len(freqs), True), 42),
            (f"K2 staged body with 4-byte copies, F={len(freqs)} L={L}",
             staged_resident_warps(L, False, "K2", len(freqs), False, False),
             42),
            (f"K4, F={len(freqs)}, R24",
             tangent_resident_warps(len(freqs), "R24"), 24),
            ("K4, F=16, R20SD", tangent_resident_warps(16, "R20SD"), 24),
            ("K6 main pass, R24", k6.resident_warps("R24"), 32),
            ("K6 main pass, R20SD", k6.resident_warps("R20SD"), 32),
            (f"K3 staged body, L={L}", staged_resident_warps(L), 32),
            *((f"K5 {which}, L={L}", k5_mod.resident_warps(which, L), 32)
              for which in ("t", "rho", "lwc", "rho_lwc"))):
        print(f"phase 0: {what}: {warps} warps resident per SM (of 64)")
        check(warps >= least, f"{what}: {warps} warps per SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k4_blocks = tangent_blocks(BK * L, len(freqs))
    k4_slots = (tangent_resident_warps(len(freqs), "R24")
                // (k1_mod.TANGENT_THREADS // 32) * sms)
    print(f"phase 0: K4 at the K-matrix shape, B={BK} L={L} F={len(freqs)}: "
          f"{k4_blocks} blocks of 128 points against {k4_slots} resident "
          f"slots ({k4_slots // sms} an SM on {sms} SMs): "
          f"{-(-k4_blocks // k4_slots)} wave(s)")

    # ---- phase 1: K1 against its plain version --------------------------
    def k1_case(model, batch, with_o3):
        prof = level_major(lbl.demo_batch(batch, L, device=dev))
        o3 = lbl._afgl_o3(prof["z"]) if with_o3 else None
        args = (freqs, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
        got = absorption_lb(*args, o3=o3)
        ref = absorption_lb_reference(*args, o3=o3)
        # float64 on the float32 numbers the kernel reads, 128 profiles at a
        # time
        ref64 = torch.cat([absorption_lb_float64(
            freqs, *(prof[k][:, s:s + 128] for k in ("p", "t", "rho", "lwc")),
            model, o3=None if o3 is None else o3[:, s:s + 128])
            for s in range(0, batch, 128)], dim=2)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {model} not finite")
        err = (got - ref).abs().amax(dim=(1, 2))
        scale = ref.abs().amax(dim=(1, 2))
        rel = float((err / scale).max())
        scale64 = ref64.abs().amax(dim=(1, 2))
        rel64 = float(((got.double() - ref64).abs().amax(dim=(1, 2))
                       / scale64).max())
        plain64 = float(((ref.double() - ref64).abs().amax(dim=(1, 2))
                         / scale64).max())
        print(f"phase 1: K1 {model} B={batch} L={L} o3={with_o3}: "
              f"max|dalpha| {float(err.max()):.3e} Np/km, "
              f"max per-channel relative {rel:.3e} (bound 1e-4); against "
              f"float64 on the float32 tables {rel64:.3e} (bound 5e-6), the "
              f"plain float32 version {plain64:.3e}")
        check(rel <= 1e-4, f"K1 {model} o3={with_o3} relative error {rel}")
        check(rel64 <= 5e-6, f"K1 {model} o3={with_o3} error {rel64} vs "
                             f"float64")
        return float(err.max())

    k1_err = k1_case("R24", B, False)
    k1_case("R24", B, True)
    for model in H2O_MODELS:
        k1_case(model, 256, False)

    # ---- phase 2: K2 against its plain version --------------------------
    def k2_inputs(batch):
        prof = level_major(lbl.demo_batch(batch, L, device=dev))
        alpha = absorption_lb(freqs, prof["p"], prof["t"], prof["rho"],
                              prof["lwc"], "R24")
        n = geometry.refractive_index(
            prof["p"], prof["t"], thermo.rho_to_e(prof["rho"], prof["t"]))
        return alpha, prof["z"], n, prof["t"]

    def k2_case(batch, alpha_is_mid, want_trans, aligned=True):
        alpha, z, n, t = k2_inputs(batch)
        if alpha_is_mid:
            alpha = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).contiguous()
        owned = alpha
        if not aligned:
            alpha = off_16_bytes(alpha)
        args = (freqs, elevs, alpha, z, n, t, alpha_is_mid, want_trans)
        body = forward_lb_body(alpha, len(elevs), alpha_is_mid)
        got = forward_lb(*args)
        ref = forward_lb_reference(*args)
        # the chords are float64: held to the plain version in float64 too,
        # as K5 is
        ref64 = forward_lb_reference(freqs, elevs, alpha.double(), z.double(),
                                     n.double(), t.double(), alpha_is_mid,
                                     want_trans)
        torch.cuda.synchronize()
        check(set(got) == set(ref), "K2 output keys")
        errs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
        errs64 = {k: float((got[k].double() - ref64[k]).abs().max())
                  for k in ref}
        print(f"phase 2: K2 B={batch} E={len(elevs)} F={len(freqs)} L={L} "
              f"alpha_is_mid={alpha_is_mid} trans_level={want_trans}: the "
              f"{body} body: "
              + ", ".join(f"max|d {k}| {v:.3e}" for k, v in errs.items())
              + "; against the plain version in float64: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs64.items()))
        check(all(bool(torch.isfinite(v).all()) for v in got.values()),
              "K2 output not finite")
        check(errs["tb"] <= 5e-3, f"K2 tb error {errs['tb']} K > 5e-3 K")
        check(errs64["tb"] <= 2e-3,
              f"K2 tb error {errs64['tb']} K vs float64 > 2e-3 K")
        if want_trans:
            check(errs64["trans_level"] <= 1e-5,
                  f"K2 trans_level error {errs64['trans_level']} > 1e-5")
        if not aligned:
            # the same numbers wherever alpha lies
            same = forward_lb(freqs, elevs, owned, z, n, t, alpha_is_mid,
                              want_trans)
            check(all(torch.equal(got[k], same[k]) for k in got),
                  "K2's result depends on where alpha lies")
        return errs["tb"], body

    wide, narrow = "staged", "staged, 4-byte copies"
    k2_err, k2_body = k2_case(B, False, False)
    check(k2_body == wide, f"K2 at B={B}: {k2_body}")
    k2_case(B, False, True)
    check(k2_case(B, True, False)[1] == wide, "K2 on layer means")
    check(k2_case(B, True, True, aligned=False)[1] == narrow,
          "a view off the 16-byte boundary takes 4-byte copies")
    check(k2_case(64, True, False)[1] == wide, "K2 at the retrieval's B")
    check(k2_case(3, True, False)[1] == narrow, "K2 at B=3")
    k2_case(3, True, True)

    # the chord at 4.2 degrees: TB against float64 from the kernel, whose
    # chords are float64, and from the plain float32 version, whose chords
    # are float32
    low = (elevs[-1],)
    alpha, z, n, t = k2_inputs(B)
    same64 = forward_lb_reference(freqs, low, alpha.double(), z.double(),
                                  n.double(), t.double())["tb"]
    path64 = lbl.forward_batch(
        {k: v.double() for k, v in lbl.demo_batch(B, L, device=dev).items()},
        dataclasses.replace(cfg, dtype="float64", use_kernels=False,
                            elevations_deg=low, outputs=("tb",))
    )["tb"].permute(1, 2, 0)
    chord_err = {}
    for what, tb_low in (
            ("the kernel (float64 chords)",
             forward_lb(freqs, low, alpha, z, n, t)["tb"]),
            ("the plain float32 version (float32 chords)",
             forward_lb_reference(freqs, low, alpha, z, n, t)["tb"])):
        chord_err[what] = (float((tb_low.double() - same64).abs().max()),
                           float((tb_low.double() - path64).abs().max()))
        print(f"phase 2: TB at {low[0]} deg, B={B}, {what}: max|dTB| "
              f"{chord_err[what][0]:.3e} K against the plain version in "
              f"float64 on the same float32 alpha, z, n, T; "
              f"{chord_err[what][1]:.3e} K against forward_batch in float64 "
              f"from the profiles")
    kernel_chord, plain_chord = (v[0] for v in chord_err.values())
    check(kernel_chord <= 1e-3 and kernel_chord <= plain_chord,
          f"the float64 chord does not pay: {chord_err}")

    # ---- phase 3: the main path -----------------------------------------
    profiles = lbl.demo_batch(B, L, device=dev)
    main_cfg = dataclasses.replace(cfg, outputs=("tb",))
    absorption_lb.launches = 0
    forward_lb.launches = 0
    out = lbl.forward_batch(profiles, main_cfg)
    launches = {"absorption_lb": absorption_lb.launches,
                "forward_lb": forward_lb.launches}
    torch.cuda.synchronize()
    print(f"phase 3: launches during the main path: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    main_alpha = torch.empty((len(freqs), L, B), device=dev)
    main_body = forward_lb_body(main_alpha, len(elevs))
    print(f"phase 3: at the main path's shape (F={len(freqs)} L={L} B={B}, "
          f"E={len(elevs)}) K2 runs as: {main_body} (16-byte copies); K1 and "
          f"K2 have one body each")
    check(main_body == wide, f"the main path takes K2 as {main_body}")
    del main_alpha
    tb = out["tb"]
    check(tuple(tb.shape) == (B, len(elevs), len(freqs)),
          f"tb shape {tuple(tb.shape)}")
    check(bool(torch.isfinite(tb).all()), "tb not finite")
    plain = lbl.forward_batch(
        profiles, dataclasses.replace(main_cfg, use_kernels=False))["tb"]
    e2e_err = float((tb - plain).abs().max())
    print(f"phase 3: tb {tuple(tb.shape)} in [{float(tb.min()):.2f}, "
          f"{float(tb.max()):.2f}] K; max|dTB| vs plain path on the card "
          f"{e2e_err:.3e} K (bound 1e-2)")
    check(e2e_err <= 1e-2, f"main path vs plain {e2e_err} K")

    golden = json.loads((ROOT / "tests" / "golden" /
                         "tb_standard.json").read_text())
    std = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
           for k, v in standard_profiles().items()}
    for model, want in golden["tb"].items():
        gcfg = dataclasses.replace(
            main_cfg, model=model,
            elevations_deg=tuple(golden["elevations_deg"]))
        got = lbl.forward_batch(std, gcfg)["tb"].double().cpu()
        err = float((got - torch.tensor(want, dtype=torch.float64))
                    .abs().max())
        print(f"phase 3: standard profiles {model}: max|dTB| vs "
              f"tb_standard.json {err:.3e} K (bound 0.05)")
        check(err < 0.05, f"{model} drifts {err} K from the golden")

    # ---- phase 4: times ----------------------------------------------------
    prof = level_major(profiles)
    k1_args = (freqs, prof["p"], prof["t"], prof["rho"], prof["lwc"], "R24")
    # "in a graph" is `graph_ms`: the kernel without the host's share of an
    # event pair around one call of its wrapper
    graph_times = {}
    k1_ms = timed_ms(lambda: absorption_lb(*k1_args))
    k1_plain_ms = timed_ms(lambda: absorption_lb_reference(*k1_args))
    graph_times["absorption_lb"] = graph_ms(lambda: absorption_lb(*k1_args))
    alpha, z, n, t = k2_inputs(B)
    rows = {}
    for want_trans in (False, True):
        k2_args = (freqs, elevs, alpha, z, n, t, False, want_trans)
        rows[want_trans] = (timed_ms(lambda: forward_lb(*k2_args)),
                            timed_ms(lambda: forward_lb_reference(*k2_args)),
                            graph_ms(lambda: forward_lb(*k2_args)))
    graph_times["forward_lb"] = rows[False][2]
    print(f"phase 4: K1 absorption B={B} L={L} F={len(freqs)}: kernel "
          f"{k1_ms:.4f} ms ({graph_times['absorption_lb']:.4f} ms in a graph), "
          f"plain {k1_plain_ms:.4f} ms")
    for want_trans, (k_ms, p_ms, g_ms) in rows.items():
        print(f"phase 4: K2 RTE B={B} E={len(elevs)} F={len(freqs)} L={L} "
              f"trans_level={want_trans}: kernel {k_ms:.4f} ms ({g_ms:.4f} "
              f"ms in a graph), plain {p_ms:.4f} ms")
    # K2's other shapes, in a graph: layer means (fast serving), the
    # retrieval's batch, and 4-byte copies of the same data, which a view of
    # alpha that starts 4 bytes into its storage takes
    alpha_mid = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).contiguous()
    graph_times["forward_lb[alpha_is_mid]"] = graph_ms(
        lambda: forward_lb(freqs, elevs, alpha_mid, z, n, t, True))
    a64, z64, n64, t64 = k2_inputs(64)
    a64 = (0.5 * (a64[:, :-1] + a64[:, 1:])).contiguous()
    k2_b64_ms = graph_ms(lambda: forward_lb(freqs, elevs, a64, z64, n64, t64,
                                            True))
    off16 = off_16_bytes(alpha)
    k2_narrow_ms = [graph_ms(lambda: forward_lb(freqs, elevs, off16, z, n, t,
                                                False, want_trans))
                    for want_trans in (False, True)]
    print(f"phase 4: K2 in a graph: on layer means "
          f"{graph_times['forward_lb[alpha_is_mid]']:.4f} ms; at the "
          f"retrieval's B=64 on layer means {k2_b64_ms:.4f} ms; with 4-byte "
          f"copies on the same B={B} {k2_narrow_ms[0]:.4f} ms, with "
          f"trans_level {k2_narrow_ms[1]:.4f} ms")
    del off16, a64, alpha_mid
    for outputs in (("tb",), ("tb", "tau_total", "t_mr", "trans_level")):
        line = []
        for use_kernels in (True, False):
            run_cfg = dataclasses.replace(cfg, outputs=outputs,
                                          use_kernels=use_kernels)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = timed_ms(lambda: lbl.forward_batch(profiles, run_cfg))
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            rate = B * len(elevs) / (ms * 1e-3)
            line.append(f"{'kernels' if use_kernels else 'plain'} "
                        f"{ms:.4f} ms = {rate:.6g} spectra/s, peak "
                        f"{peak:.1f} MiB")
            if use_kernels and outputs == ("tb",):
                fb_rate = rate
        print(f"phase 4: forward_batch B={B} outputs={outputs}: "
              + "; ".join(line))
    sweep_ms = timed_ms(lambda: lbl.forward_all_models(profiles, cfg))
    sweep = lbl.forward_all_models(profiles, cfg)
    torch.cuda.synchronize()
    check(all(tuple(v.shape) == (B, len(elevs), len(freqs))
              and bool(torch.isfinite(v).all()) for v in sweep.values()),
          "forward_all_models output")
    print(f"phase 4: forward_all_models B={B}, {tuple(sweep)}: "
          f"{sweep_ms:.4f} ms = "
          f"{len(sweep) * B * len(elevs) / (sweep_ms * 1e-3):.6g} spectra/s")

    # ---- phase 5: K4 against its plain version --------------------------
    kprof = level_major(lbl.demo_batch(BK, L, device=dev))
    k4_args = {m: (freqs, kprof["p"], kprof["t"], kprof["rho"], kprof["lwc"],
                   m) for m in H2O_MODELS}
    k4_err = None
    for model, args in k4_args.items():
        got = absorption_tangents_lb(*args)
        ref = absorption_tangents_lb_reference(*args)
        # float64 on the float32 numbers the kernel reads, 128 profiles at a
        # time: what is left is the arithmetic's error
        ref64 = [torch.cat(part, dim=2) for part in zip(*(
            absorption_tangents_lb_float64(
                freqs, *(a[:, s:s + 128] for a in args[1:5]), model)
            for s in range(0, BK, 128)))]
        torch.cuda.synchronize()
        errs = []
        for name, g, r, r64, bound in zip(
                ("alpha", "dalpha/dT", "dalpha/drho"), got, ref, ref64,
                (1e-4, 1e-3, 1e-3)):
            check(bool(torch.isfinite(g).all()), f"K4 {model} {name}")
            err = (g - r).abs().amax(dim=(1, 2))
            rel = float((err / r.abs().amax(dim=(1, 2))).max())
            scale64 = r64.abs().amax(dim=(1, 2))
            rel64 = float(((g.double() - r64).abs().amax(dim=(1, 2))
                           / scale64).max())
            plain64 = float(((r.double() - r64).abs().amax(dim=(1, 2))
                             / scale64).max())
            errs.append(float(err.max()))
            print(f"phase 5: K4 {model} B={BK} L={L}: {name} max|d| "
                  f"{float(err.max()):.3e}, max per-channel relative "
                  f"{rel:.3e} (bound {bound:g}); against float64 on the "
                  f"float32 tables {rel64:.3e}, the plain float32 version "
                  f"{plain64:.3e}")
            check(rel <= bound, f"K4 {model} {name} relative error {rel}")
        if model == "R24":
            k4_err = max(errs)
            alpha_rounded = ref64[0].float().contiguous()

    # ---- phase 6: K5 against its plain version in float64 ---------------
    cfg_k = dataclasses.replace(cfg, model="R24")
    alpha, da_t, da_rho = absorption_tangents_lb(*k4_args["R24"])
    da = {"t": da_t, "rho": da_rho,
          "lwc": jacobians._dalpha_dlwc(cfg_k, kprof["t"])}
    geom = jacobians._slant_geometry(kprof, cfg_k, ("t", "rho"))

    def geo(name):
        return (geom["dds_dnl"], geom["dds_dk"], geom["dn"][name],
                geom["r0cos"])

    k5_calls = {
        "t": (kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
              (freqs, "t", alpha, da["t"], geom["ds"], kprof["t"],
               *geo("t"))),
        "rho": (kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
                (freqs, "rho", alpha, da["rho"], geom["ds"], kprof["t"],
                 *geo("rho"))),
        "lwc": (kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
                (freqs, "lwc", alpha, da["lwc"], geom["ds"], kprof["t"])),
        "rho_lwc": (kmatrix_assembled_rho_lwc_lb,
                    kmatrix_assembled_rho_lwc_lb_reference,
                    (freqs, alpha, da["rho"], da["lwc"], geom["ds"],
                     kprof["t"], *geo("rho"))),
    }

    def as64(args):
        return [a.double() if torch.is_tensor(a) else a for a in args]

    k5_err = {}
    for which, (kernel, plain, args) in k5_calls.items():
        got, ref, ref32 = kernel(*args), plain(*as64(args)), plain(*args)
        if which != "rho_lwc":
            got, ref, ref32 = (got,), (ref,), (ref32,)
        torch.cuda.synchronize()
        for g, r, r32 in zip(got, ref, ref32):
            check(tuple(g.shape) == (len(elevs), len(freqs), L, BK)
                  and bool(torch.isfinite(g).all()), f"K5 {which} output")
            err, err32 = k_error(g, r), k_error(r32, r)
            k5_err[which] = max(k5_err.get(which, 0.0),
                                float((g.double() - r).abs().max()))
            print(f"phase 6: K5 {which} B={BK} E={len(elevs)} "
                  f"F={len(freqs)} L={L}: kernel vs plain float64 {err:.3e} "
                  f"(bound 1e-3); plain float32 vs float64 {err32:.3e}")
            check(err <= 1e-3, f"K5 {which} error {err}")
    # the same for the LWC columns on alpha rounded from the float64 function
    # (K4's alpha stands within 1e-6 of it): how far alpha's last bits alone
    # move the error
    for which in ("lwc", "rho_lwc"):
        kernel, plain, args = k5_calls[which]
        args = (args[0], alpha_rounded, *args[2:]) if which == "rho_lwc" \
            else (*args[:2], alpha_rounded, *args[3:])
        got, ref = kernel(*args), plain(*as64(args))
        k_lwc = (got[1], ref[1]) if which == "rho_lwc" else (got, ref)
        print(f"phase 6: K5 {which} k_lwc on alpha rounded from float64: "
              f"kernel vs plain float64 {k_error(*k_lwc):.3e}")

    # ---- phase 7: the K-matrix path ---------------------------------------
    kprofiles = lbl.demo_batch(BK, L, device=dev)
    k_counters = {"absorption_tangents_lb": absorption_tangents_lb,
                  "kmatrix_assembled_lb": kmatrix_assembled_lb,
                  "kmatrix_assembled_rho_lwc_lb": kmatrix_assembled_rho_lwc_lb}
    for fn in k_counters.values():
        fn.launches = 0
    kmat = jacobians.kmatrix_batch_fast(kprofiles, cfg_k, wrt=WRT)
    k_launches = {name: fn.launches for name, fn in k_counters.items()}
    torch.cuda.synchronize()
    print(f"phase 7: launches during the K-matrix path: {k_launches}")
    check(all(v > 0 for v in k_launches.values()),
          f"a kernel of the K-matrix path was not launched: {k_launches}")
    for name in WRT:
        check(tuple(kmat[name].shape) == (BK, len(elevs), len(freqs), L),
              f"K {name} shape {tuple(kmat[name].shape)}")
        check(bool(torch.isfinite(kmat[name]).all()), f"K {name} not finite")

    # ---- phase 8: against the plain path in float64, physical signs -------
    kmat64 = jacobians.kmatrix_batch_fast(
        {k: v.double() for k, v in kprofiles.items()},
        dataclasses.replace(cfg_k, dtype="float64", use_kernels=False),
        wrt=WRT)
    for name in WRT:
        err = k_error(kmat[name], kmat64[name])
        print(f"phase 8: K {name} {tuple(kmat[name].shape)}: max|K| "
              f"{float(kmat64[name].abs().max()):.4g}; kernels vs plain "
              f"float64 {err:.3e} (bound 1e-3)")
        check(err <= 1e-3, f"K {name} error {err}")
    sums = kmat["t"][:, 0, freqs.index(58.0)].sum(-1)
    print(f"phase 8: sum over levels of k_t at 58.0 GHz, zenith: "
          f"[{float(sums.min()):.4f}, {float(sums.max()):.4f}] "
          f"(bound (0.7, 1.3))")
    check(bool(((sums > 0.7) & (sums < 1.3)).all()), "k_t sum at 58 GHz")
    cloud = kprofiles["lwc"] > 0                                 # (B, L)
    for f_ghz in (22.24, 31.4):
        k_lwc = kmat["lwc"][:, 0, freqs.index(f_ghz)][cloud]
        print(f"phase 8: k_lwc at {f_ghz} GHz, zenith, in the cloud layer "
              f"({int(cloud.sum())} levels): min {float(k_lwc.min()):.4g}")
        check(cloud.any() and bool((k_lwc > 0).all()),
              f"k_lwc at {f_ghz} GHz")

    # ---- phase 9: times ----------------------------------------------------
    k4_ms = timed_ms(lambda: absorption_tangents_lb(*k4_args["R24"]))
    k4_plain_ms = timed_ms(
        lambda: absorption_tangents_lb_reference(*k4_args["R24"]))
    graph_times["absorption_tangents_lb"] = graph_ms(
        lambda: absorption_tangents_lb(*k4_args["R24"]))
    k5_ms = {}
    for which in ("t", "rho_lwc"):
        kernel, plain, args = k5_calls[which]
        k5_ms[which] = (timed_ms(lambda: kernel(*args)),
                        timed_ms(lambda: plain(*args)))
        graph_times[kernel.__name__] = graph_ms(lambda: kernel(*args))
    print(f"phase 9: K4 tangents B={BK} L={L} F={len(freqs)}: kernel "
          f"{k4_ms:.4f} ms ({graph_times['absorption_tangents_lb']:.4f} ms in "
          f"a graph), plain {k4_plain_ms:.4f} ms; {k4_blocks} blocks against "
          f"{k4_slots} resident slots")
    for which, (k_ms, p_ms) in k5_ms.items():
        print(f"phase 9: K5 {which} B={BK} E={len(elevs)} F={len(freqs)} "
              f"L={L}: kernel {k_ms:.4f} ms "
              f"({graph_times[k5_calls[which][0].__name__]:.4f} ms in a "
              f"graph), plain {p_ms:.4f} ms")
    # the lone block: one block per (elevation, channel) at B=32, and no
    # more blocks than SMs, shows a column's walk with nothing beside it
    n_lone = min(len(elevs), max(1, sms // len(freqs)))
    lone_args = list(k5_calls["t"][2])
    for i in (4, 6, 7, 9):           # ds, dds_dnl, dds_dk, r0cos: (E, ...)
        lone_args[i] = lone_args[i][:n_lone]
    lone_args = [a[..., :32].contiguous() if torch.is_tensor(a) else a
                 for a in lone_args]
    lone_ms = graph_ms(lambda: kmatrix_assembled_lb(*lone_args))
    print(f"phase 9: K5 t B=32 E={n_lone} F={len(freqs)} L={L} "
          f"({n_lone * len(freqs)} blocks on {sms} SMs, one an SM): "
          f"{lone_ms:.4f} ms in a graph")
    check(n_lone * len(freqs) <= sms, "K5 lone blocks outnumber the SMs")
    line = []
    for use_kernels in (True, False):
        run_cfg = dataclasses.replace(cfg_k, use_kernels=use_kernels)
        ms = timed_ms(lambda: jacobians.kmatrix_batch_fast(kprofiles, run_cfg,
                                                           wrt=WRT))
        peak = peak_mib(lambda: jacobians.kmatrix_batch_fast(
            kprofiles, run_cfg, wrt=WRT))
        line.append(f"{'kernels' if use_kernels else 'plain'} {ms:.4f} ms, "
                    f"peak {peak:.1f} MiB above the live tensors")
        if use_kernels:
            kmat_ms = ms
    fwd_cfg = dataclasses.replace(cfg_k, outputs=("tb",))
    fwd_ms = timed_ms(lambda: lbl.forward_batch(kprofiles, fwd_cfg))
    print(f"phase 9: kmatrix_batch_fast B={BK} wrt={WRT}: " + "; ".join(line))
    print(f"phase 9: forward_batch B={BK} outputs=('tb',): {fwd_ms:.4f} ms; "
          f"K-matrix / forward = {kmat_ms / fwd_ms:.2f}")
    k_elfb = kmatrix_assembled_lb(*k5_calls["t"][2])
    perm_ms = timed_ms(lambda: k_elfb.permute(3, 0, 1, 2).contiguous())
    print(f"phase 9: output permute (E, F, L, B) -> (B, E, F, L) of one "
          f"variable ({k_elfb.numel() * 4 / 1e6:.1f} MB): {perm_ms:.4f} ms")

    # ---- phase 10: K6 against its plain version --------------------------
    spec_profiles = lbl.demo_batch(BS, L, device=dev)
    sprof = level_major(spec_profiles)
    f_spec = torch.from_numpy(np.linspace(20.0, 64.0, NF_SPEC)
                              .astype(np.float32)).to(dev)
    f_chunk = f_spec[:CHUNK]
    pick = torch.linspace(0, L * BS - 1, 256, device=dev).long()
    points256 = {k: v.reshape(-1)[pick] for k, v in sprof.items()}

    def share_of_max(got, ref):
        """max |got - ref| as a share of each frequency's maximum of ref."""
        axes = tuple(range(1, ref.ndim))
        return float(((got.double() - ref.double()).abs().amax(dim=axes)
                      / ref.abs().amax(dim=axes)).max())

    def float64_on_float32_tables(f, prof, model):
        """`k6.absorption_spectral_float64`, 512 frequencies at a time."""
        return torch.cat([k6.absorption_spectral_float64(
            f[s:s + 512], prof["p"], prof["t"], prof["rho"], prof["lwc"],
            model) for s in range(0, f.numel(), 512)])

    def k6_case(model, prof, f, what):
        args = (f, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
        got = absorption_spectral(*args)
        ref = absorption_spectral_reference(*args)
        ref64 = float64_on_float32_tables(f, prof, model)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K6 {model} not finite")
        axes = tuple(range(1, got.ndim))
        err = (got - ref).abs().amax(dim=axes)
        rel, rel64 = share_of_max(got, ref), share_of_max(got, ref64)
        plain64 = share_of_max(ref, ref64)
        print(f"phase 10: K6 {model} {what} x F={f.numel()}: max|dalpha| "
              f"{float(err.max()):.3e} Np/km, max per-frequency relative "
              f"{rel:.3e} (bound 1e-4); against float64 on the float32 "
              f"tables {rel64:.3e} (bound 5e-6), the plain float32 version "
              f"{plain64:.3e}")
        check(rel <= 1e-4, f"K6 {model} {what} relative error {rel}")
        check(rel64 <= 5e-6, f"K6 {model} {what} error {rel64} vs float64")
        return got, float(err.max())

    # the state pass against its plain version in float64, row by row
    state = k6.line_state_pass(sprof["p"], sprof["t"], sprof["rho"],
                               sprof["lwc"], "R20SD")
    st64 = k6.line_state(*(sprof[k].reshape(-1).double()
                           for k in ("p", "t", "rho", "lwc")), "R20SD")
    state64 = torch.stack(
        [st64["scalars"][k] for k in k6.STATE_SCALARS]
        + [st64["h2o"][k][:, line] for line in range(st64["h2o"]["sw"].shape[1])
           for k in ("wsq", "sw", "sb", "sn", "c0", "gamma2")]
        + [st64["o2"][k][:, line] for line in range(st64["o2"]["dnu"].shape[1])
           for k in ("dnu", "c2", "dfsq", "k2", "k3")])
    torch.cuda.synchronize()
    check(tuple(state.shape) == (k6.n_state("R20SD"), L * BS),
          f"K6 state shape {tuple(state.shape)}")
    st_err = float(((state.double() - state64).abs().amax(dim=1)
                    / state64.abs().amax(dim=1).clamp_min(1e-300)).max())
    print(f"phase 10: K6 state pass R20SD {tuple(state.shape)} against "
          f"line_state in float64: max per-row relative {st_err:.3e} (bound "
          f"1e-5)")
    check(st_err <= 1e-5, f"K6 state pass error {st_err}")
    del state, state64, st64

    alpha_chunk, k6_err = k6_case("R24", sprof, f_chunk,
                                  f"L={L} x B={BS} points")
    f_window = f_spec[(f_spec >= 51.0) & (f_spec <= 54.0)].contiguous()
    k6_case("R24", sprof, f_window, f"L={L} x B={BS} points, 51-54 GHz,")
    f_centre = f_spec[(f_spec > 60.08) & (f_spec < 60.53)].contiguous()
    ref64_exact = absorption_spectral_reference(
        f_centre.double(), *(sprof[k].double()
                             for k in ("p", "t", "rho", "lwc")), "R24")
    tables_moved = share_of_max(
        float64_on_float32_tables(f_centre, sprof, "R24"), ref64_exact)
    print(f"phase 10: rounding the line tables to float32 alone moves alpha "
          f"by {tables_moved:.3e} of each frequency's maximum (float64, the "
          f"{f_centre.numel()} frequencies of the 50k grid within 0.225 GHz "
          f"of the 60.306 GHz line)")
    del ref64_exact
    f2048 = torch.linspace(20.0, 64.0, 2048, device=dev)
    for model in H2O_MODELS:
        k6_case(model, points256, f2048, "256 points")
    k6_case("R24", points256, f2048[:2045], "256 points, a tail tile of 5,")
    k6_case("R20SD", {k: v[:77] for k, v in points256.items()}, f2048[:1003],
            "77 points, a tail tile of 3,")

    # R03 takes the 1998 dry continuum (ops/absorption/n2.py); in cold dry
    # air at 1000 hPa over 20-45 GHz the 2017 form would be off by > 1e-4
    dry = {"p": 1000.0, "t": 220.0, "rho": 0.05, "lwc": 0.0}
    dry = {k: torch.full((256,), v, device=dev) for k, v in dry.items()}
    f_win = torch.linspace(20.0, 45.0, 64, device=dev)
    got = absorption_spectral(f_win, dry["p"], dry["t"], dry["rho"],
                              dry["lwc"], "R03")
    ref = absorption_spectral_reference(f_win, dry["p"], dry["t"],
                                        dry["rho"], dry["lwc"], "R03")
    pda = (dry["p"] - dry["rho"] * dry["t"] / 217.0)[None]
    n2_gap = (n2_absorption(f_win[:, None], pda, dry["t"][None], "R98")
              - n2_absorption(f_win[:, None], pda, dry["t"][None], "R16"))
    r03_err = float(((got - ref).abs() / ref.abs()).max())
    r03_gap = float((n2_gap.abs() / ref.abs()).min())
    print(f"phase 10: K6 R03 dry continuum: max relative |dalpha| vs plain "
          f"{r03_err:.3e} (bound 2e-5); the 2017 form would differ by at "
          f"least {r03_gap:.3e}")
    check(r03_err <= 2e-5 and r03_gap > 1e-4, "K6 R03 dry continuum")
    try:
        absorption_spectral(f_chunk, *(sprof[k] for k in
                                       ("p", "t", "rho", "lwc")),
                            f_range=(30.0, 64.0))
    except ValueError as exc:
        print(f"phase 10: f_range (30, 64) on a 20-64 GHz grid raised: {exc}")
    else:
        raise RuntimeError("check failed: an f_range that excludes the grid "
                           "did not raise")

    # ---- phase 11: K3 against its plain version --------------------------
    e_spec = thermo.rho_to_e(sprof["rho"], sprof["t"])
    ds_zenith = geometry.slant_path_lengths_lb(
        sprof["z"], sprof["p"], sprof["t"], e_spec, 90.0)[None].contiguous()

    def k3_case(f, alpha, ds, t, want_trans, what):
        got = downwelling_lb(f, alpha, ds, t, want_trans_level=want_trans)
        ref = downwelling_lb_reference(f, alpha, ds, t,
                                       want_trans_level=want_trans)
        torch.cuda.synchronize()
        check(set(got) == set(ref), "K3 output keys")
        check(all(bool(torch.isfinite(v).all()) for v in got.values()),
              "K3 output not finite")
        errs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
        print(f"phase 11: K3 {what} trans_level={want_trans}: "
              + ", ".join(f"max|d {k}| {v:.3e}" for k, v in errs.items()))
        check(errs["tb"] <= 5e-3, f"K3 tb error {errs['tb']} K > 5e-3 K")
        if want_trans:
            check(errs["trans_level"] <= 1e-5,
                  f"K3 trans_level error {errs['trans_level']} > 1e-5")
        return errs["tb"]

    k3_err = k3_case(f_chunk, alpha_chunk, ds_zenith, sprof["t"], False,
                     f"E=1 F={CHUNK} B={BS} L={L}")
    alpha, z, n, t = k2_inputs(B)
    ds_scan = torch.stack([geometry.chord_lengths(z, n, c) for c in
                           torch.cos(torch.deg2rad(torch.tensor(
                               elevs, device=dev)))]).contiguous()
    k3_case(freqs, alpha, ds_scan, t, True,
            f"E={len(elevs)} F={len(freqs)} B={B} L={L}")
    alpha_mid_chunk = (0.5 * (alpha_chunk[:, :-1]
                              + alpha_chunk[:, 1:])).contiguous()
    got = downwelling_lb(f_chunk, alpha_mid_chunk, ds_zenith, sprof["t"],
                         alpha_is_mid=True)
    ref = downwelling_lb_reference(f_chunk, alpha_mid_chunk, ds_zenith,
                                   sprof["t"], alpha_is_mid=True)
    mid_err = float((got["tb"] - ref["tb"]).abs().max())
    print(f"phase 11: K3 E=1 F={CHUNK} B={BS} L={L} on layer means: "
          f"max|d tb| {mid_err:.3e}")
    check(mid_err <= 5e-3, f"K3 on layer means: tb error {mid_err} K")
    # three elevations; 28 profiles leave the staged body's tile part
    # empty, 30 are not a multiple of 4 and take the other body
    ds_three = torch.cat([ds_zenith, 2.0 * ds_zenith,
                          4.0 * ds_zenith]).contiguous()
    for nb in (28, 30):
        k3_case(f_chunk[:100], alpha_chunk[:100, :37, :nb].contiguous(),
                ds_three[:, :36, :nb].contiguous(),
                sprof["t"][:37, :nb].contiguous(), False,
                f"E=3 F=100 B={nb} L=37")

    # ---- phase 12: the spectral path ---------------------------------------
    f_np = f_spec.cpu().numpy()
    srf = np.zeros((len(freqs), NF_SPEC), np.float32)
    for c, (fc, bw) in enumerate(zip(hatpro.HATPRO_FREQS_GHZ,
                                     hatpro.nominal_bandwidth_ghz())):
        srf[c] = np.exp(-0.5 * ((f_np - fc) / max(bw, 1e-3)) ** 2)
    srf = torch.from_numpy(srf).to(dev)

    def spectral_run(use_kernels=True):
        out = spectral.forward_spectral(spec_profiles, f_spec, (90.0,), "R24",
                                        freq_chunk=CHUNK,
                                        use_kernels=use_kernels)
        return out, spectral.srf_convolve(out["tb"], srf)

    absorption_spectral.launches = 0
    downwelling_lb.launches = 0
    spec, tb_srf = spectral_run()
    s_launches = {"absorption_spectral": absorption_spectral.launches,
                  "downwelling_lb": downwelling_lb.launches}
    torch.cuda.synchronize()
    print(f"phase 12: launches during the spectral path: {s_launches}")
    check(all(v > 0 for v in s_launches.values()),
          f"a kernel of the spectral path was not launched: {s_launches}")
    tb = spec["tb"]
    check(tuple(tb.shape) == (BS, 1, NF_SPEC), f"tb shape {tuple(tb.shape)}")
    check(bool(torch.isfinite(tb).all())
          and bool(torch.isfinite(spec["tau_total"]).all()), "tb not finite")
    plain, plain_srf = spectral_run(use_kernels=False)
    s_err = float((tb - plain["tb"]).abs().max())
    srf_err = float((tb_srf - plain_srf).abs().max())
    print(f"phase 12: tb {tuple(tb.shape)} in [{float(tb.min()):.2f}, "
          f"{float(tb.max()):.2f}] K; max|dTB| vs plain path on the card "
          f"{s_err:.3e} K (bound 1e-2); after the SRF {srf_err:.3e} K")
    check(s_err <= 1e-2, f"spectral path vs plain {s_err} K")

    cc_cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 14.4),
                           outputs=("tb", "tau_total"))
    cc_want = lbl.forward_batch(spec_profiles, cc_cfg)
    cc_got = spectral.forward_spectral(spec_profiles, freqs, (90.0, 14.4),
                                       "R24")
    cc_err = float((cc_got["tb"] - cc_want["tb"]).abs().max())
    print(f"phase 12: at the 14 channel centres, (90, 14.4) deg: max|dTB| vs "
          f"forward_batch {cc_err:.3e} K (bound 2e-2)")
    check(cc_err <= 2e-2, f"spectral vs channel forward {cc_err} K")

    tau = spec["tau_total"][:, 0]
    i22, i26, i60 = (int((f_spec - g).abs().argmin())
                     for g in (22.235, 26.0, 60.0))
    r22 = float((tau[:, i22] / tau[:, i26]).min())
    r60 = float((tau[:, i60] / tau[:, i26]).min())
    print(f"phase 12: zenith tau ratios, min over profiles: 22.235/26 GHz "
          f"{r22:.3f} (bound > 1.2), 60/26 GHz {r60:.2f} (bound > 10)")
    check(r22 > 1.2 and r60 > 10.0, "spectral line structure")

    srf64 = srf.double() / srf.double().sum(-1, keepdim=True)
    srf_ref = tb.double() @ srf64.T
    srf_err64 = float((tb_srf.double() - srf_ref).abs().max())
    print(f"phase 12: srf_convolve {tuple(tb_srf.shape)} vs the float64 "
          f"product: max|d| {srf_err64:.3e} K (bound 1e-3)")
    check(srf_err64 <= 1e-3, f"srf_convolve error {srf_err64} K")

    # ---- phase 13: times ---------------------------------------------------
    k6_args = (f_chunk, sprof["p"], sprof["t"], sprof["rho"], sprof["lwc"],
               "R24")
    k3_args = (f_chunk, alpha_chunk, ds_zenith, sprof["t"])
    k6_ms = timed_ms(lambda: absorption_spectral(*k6_args))
    k3_ms = timed_ms(lambda: downwelling_lb(*k3_args))
    k6_plain_ms = timed_ms(lambda: absorption_spectral_reference(*k6_args),
                           repeats=3, warmup=1)
    k3_plain_ms = timed_ms(lambda: downwelling_lb_reference(*k3_args),
                           repeats=3, warmup=1)
    print(f"phase 13: K6 absorption per chunk ({BS * L} points x {CHUNK} "
          f"frequencies): kernel {k6_ms:.4f} ms, plain {k6_plain_ms:.4f} ms")
    # The same without the host: the wrappers' Python costs more than these
    # kernels take, and an event pair around one call times both.
    k6_device_ms = graph_times["absorption_spectral"] = graph_ms(
        lambda: absorption_spectral(*k6_args))
    k3_device_ms = graph_times["downwelling_lb"] = graph_ms(
        lambda: downwelling_lb(*k3_args))
    state_ms = graph_ms(lambda: k6.line_state_pass(*k6_args[1:]))
    print(f"phase 13: device time in a CUDA graph of 20 calls: K6 "
          f"{k6_device_ms:.4f} ms, of which its state pass ({BS * L} points) "
          f"{state_ms:.4f} ms; K3 {k3_device_ms:.4f} ms")
    print(f"phase 13: K3 RTE per chunk (E=1 F={CHUNK} B={BS} L={L}): kernel "
          f"{k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms")
    k3_other_ms = graph_ms(lambda: downwelling_lb(*k3_args,
                                                  want_trans_level=True))
    print(f"phase 13: K3's other body on the same chunk (with trans_level, "
          f"{alpha_chunk.numel() * 4 / 1e6:.0f} MB more to write): "
          f"{k3_other_ms:.4f} ms in the graph")
    spec_ms = timed_ms(spectral_run)
    spec_peak = peak_mib(spectral_run)
    levels = lbl.level_major_profiles(spec_profiles, lbl.LBLConfig())
    plain_chunk_ms = timed_ms(lambda: spectral._forward_chunk(
        levels, f_chunk, ds_zenith, "R24", False), repeats=3, warmup=1)
    plain_chunk_peak = peak_mib(lambda: spectral._forward_chunk(
        levels, f_chunk, ds_zenith, "R24", False))
    rate = BS * NF_SPEC / (spec_ms * 1e-3) / 1e6
    plain_rate = BS * CHUNK / (plain_chunk_ms * 1e-3) / 1e6
    print(f"phase 13: forward_spectral + srf_convolve, B={BS} L={L} "
          f"F={NF_SPEC} in chunks of {CHUNK}: {spec_ms:.4f} ms = {rate:.6g} M "
          f"frequency points/s, peak {spec_peak:.1f} MiB above the live "
          f"tensors")
    print(f"phase 13: plain path, one chunk of {CHUNK}: {plain_chunk_ms:.4f} "
          f"ms = {plain_rate:.6g} M frequency points/s, peak "
          f"{plain_chunk_peak:.1f} MiB above the live tensors")
    perm = downwelling_lb(*k3_args)["tb"]
    perm_ms = timed_ms(lambda: perm.permute(2, 0, 1).contiguous())
    print(f"phase 13: per-chunk output permute (E, F, B) -> (B, E, F) of tb "
          f"({perm.numel() * 4 / 1e6:.2f} MB): {perm_ms:.4f} ms")

    # ---- phase 14: K7 against its plain version, the card's rates --------
    n_chain = profiling.CHAIN_ELEMENTS
    rng14 = np.random.default_rng(14)
    # half uniform in [0, 1), half log-uniform in [1e-9, 1e-7): there the
    # fma chain's 1e-9 a step changes the value many times over
    x_chain = torch.from_numpy(np.concatenate([
        rng14.random(n_chain // 2, dtype=np.float32),
        (10.0 ** rng14.uniform(-9.0, -7.0, n_chain // 2)).astype(np.float32),
    ])).to(dev)
    small = x_chain < 1e-7
    # Against the float64 recurrence on the kernel's float32 constants: each
    # of the fma chain's k steps, the scaling and the seven additions of the
    # sum rounds once, at most 2^-24 relative, and all terms are positive;
    # the plain version rounds twice a step.  The div and exp chains contract
    # to a fixed point, so their values hold the primitive's form, not k
    # (the time at 2k below does); the approximate intrinsics are good to
    # ~1e-6.
    u24 = 2.0 ** -24
    k_fma = CHAIN_OPS["fma"][1]
    chain_bounds = {"fma": ((k_fma + 8) * u24, (3 * k_fma + 16) * u24),
                    "div": (1e-6, 1e-6), "exp": (1e-6, 1e-6),
                    "div_fast": (1e-4, 1e-4), "exp_fast": (1e-4, 1e-4)}
    k7_err = {}
    for op, (bound64, bound) in chain_bounds.items():
        got = chain(x_chain, op)
        ref = chain_reference(x_chain, op)
        ref64 = chain_reference(x_chain.double(), op)
        torch.cuda.synchronize()
        check(got.shape == x_chain.shape and bool(torch.isfinite(got).all()),
              f"K7 {op} output")
        rel = float(((got - ref).abs() / ref.abs()).max())
        rel64 = float(((got.double() - ref64).abs() / ref64.abs()).max())
        k7_err[op] = float((got - ref).abs().max())
        print(f"phase 14: K7 {op} k={CHAIN_OPS[op][1]} n={n_chain}: max "
              f"relative error vs the float64 recurrence {rel64:.3e} (bound "
              f"{bound64:.3e}), vs plain {rel:.3e} (bound {bound:.3e})")
        check(rel64 <= bound64 and rel <= bound,
              f"K7 {op} error {rel64} {rel}")
    # the chain's length: one step short moves the small inputs by over 1e-3
    # of the value, and out(2k) - out(k) there is 8 k b
    ref64_k, ref64_short, ref64_2k = (
        chain_reference(x_chain.double(), "fma", k)
        for k in (k_fma, k_fma - 1, 2 * k_fma))
    moved = float(((ref64_k - ref64_short) / ref64_k)[small].min())
    grew = (chain(x_chain, "fma", 2 * k_fma).double()
            - chain(x_chain, "fma", k_fma).double())[small]
    grew_ref = (ref64_2k - ref64_k)[small]
    grew_err = float(((grew - grew_ref).abs() / grew_ref).max())
    print(f"phase 14: K7 fma: one step of {k_fma} less would move the small "
          f"inputs by at least {moved:.3e} relative; out(2k) - out(k) there "
          f"vs the float64 recurrence: max relative error {grew_err:.3e} "
          f"(bound 1e-4)")
    check(moved > 100 * chain_bounds["fma"][0] and grew_err <= 1e-4,
          f"K7 fma chain length: {moved} {grew_err}")
    del ref64_k, ref64_short, ref64_2k, grew, grew_ref
    rates, k7_ms = {}, {}
    for op in chain_bounds:
        k = CHAIN_OPS[op][1]
        # k and 2k in turns, after one measurement that is thrown away: the
        # card's clock settles under load, and a step of it between the two
        # lengths would show as a ratio off 2
        profiling.chain_rate(op, dev, k)
        pairs = [(profiling.chain_rate(op, dev, k),
                  profiling.chain_rate(op, dev, 2 * k)) for _ in range(3)]
        rate_k = statistics.median(r for r, _ in pairs)
        rate_2k = statistics.median(r for _, r in pairs)
        ratio = 2.0 * rate_k / rate_2k
        rates[op] = rate_k
        k7_ms[op] = 8 * k * n_chain / rate_k * 1e3
        print(f"phase 14: K7 {op}: {rate_k:.4e} applications/s "
              f"({k7_ms[op]:.4f} ms at k={k}); time at 2k / time at k = "
              f"{ratio:.3f} (bound 1.8-2.2; each the median of 3 "
              f"measurements taken in turns)")
        check(1.8 <= ratio <= 2.2, f"K7 {op} time does not scale with k")
    # an SM holds 32 blocks: blocks of one warp leave it half its 64 warps
    for threads, what in ((256, "64 warps/SM"), (32, "32 warps/SM")):
        at = {op: profiling.chain_rate(op, dev, threads=threads)
              for op in ("fma", "div", "exp")}
        line = ", ".join(f"{op} {rate:.4e}" for op, rate in at.items())
        print(f"phase 14: K7 rates at most {what} (blocks of {threads}): "
              f"{line}")
    chain.launches = 0
    peaks = profiling.measure_peaks(dev)
    k7_launches = chain.launches
    torch.cuda.synchronize()
    print(f"phase 14: measure_peaks: "
          + ", ".join(f"{k} {v:.4e}" for k, v in peaks.items())
          + f" (fma, div, exp per s; hbm B/s from a 1 GiB copy); K7 "
          f"launches {k7_launches}")
    check(k7_launches > 0, "measure_peaks did not launch K7")
    published = profiling.DEFAULT_PEAKS
    for k in ("fma", "div", "exp", "hbm"):
        print(f"phase 14: {k}: measured / published = "
              f"{peaks[k] / published[k]:.3f}")
        check(0.05 < peaks[k] / published[k] <= 1.05,
              f"measured {k} rate {peaks[k]} against {published[k]}")
    k7_plain_ms = timed_ms(lambda: chain_reference(x_chain, "fma"),
                           repeats=3, warmup=1)
    print(f"phase 14: K7 fma chain: kernel {k7_ms['fma']:.4f} ms, plain "
          f"{k7_plain_ms:.4f} ms")

    # ---- phase 15: every kernel's bound and share -------------------------
    alpha, z, n, t = k2_inputs(B)
    alpha_mid_b = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).contiguous()
    k2_mid_args = (freqs, elevs, alpha_mid_b, z, n, t, True, False)
    k2_mid_ms = timed_ms(lambda: forward_lb(*k2_mid_args))
    k2_mid_plain_ms = timed_ms(lambda: forward_lb_reference(*k2_mid_args))
    small_k2 = profiling.small_dtau_share(alpha_mid_b[None] * ds_scan[:, None])
    small_k3 = profiling.small_dtau_share(
        0.5 * (alpha_chunk[:, :-1] + alpha_chunk[:, 1:])[None]
        * ds_zenith[:, None])
    alpha_k = absorption_tangents_lb(*k4_args["R24"])[0]
    series_k5 = profiling.small_dtau_share(
        0.5 * (alpha_k[:, :-1] + alpha_k[:, 1:])[None]
        * geom["ds"][:, None], 0.5)
    planck_k3 = profiling.planck_series_share(f_chunk, sprof["t"])
    planck_k2 = profiling.planck_series_share(freqs, t)
    print(f"phase 15: share of layer opacities on the series branch: K2 "
          f"{small_k2:.4f}, K3 {small_k3:.4f} (< 0.03), K5 {series_k5:.4f} "
          f"(< 0.5); share of the (frequency, level, profile) whose Planck "
          f"radiance the series serves: K2 {planck_k2:.4f}, K3 "
          f"{planck_k3:.4f}")
    nE, nF = len(elevs), len(freqs)
    f_chunk_np = f_chunk.cpu().numpy()
    # name -> (id, ms, the roofline as a function of as_coded)
    bound_rows = {
        "absorption_lb": ("K1", k1_ms, lambda c: profiling.k1_roofline(
            B * L, freqs, as_coded=c)),
        "forward_lb": ("K2", rows[False][0], lambda c: profiling.k2_roofline(
            B, L, nF, nE, small_dtau_fraction=small_k2,
            planck_series_fraction=planck_k2, as_coded=c)),
        "forward_lb[alpha_is_mid]": (
            "K2 mid", k2_mid_ms, lambda c: profiling.k2_roofline(
                B, L, nF, nE, alpha_is_mid=True,
                small_dtau_fraction=small_k2,
                planck_series_fraction=planck_k2, as_coded=c)),
        "downwelling_lb": ("K3", k3_ms, lambda c: profiling.k2_roofline(
            BS, L, CHUNK, 1, given_paths=True, small_dtau_fraction=small_k3,
            planck_series_fraction=planck_k3, as_coded=c)),
        "absorption_tangents_lb": ("K4", k4_ms, lambda c:
                                   profiling.k4_roofline(BK * L, freqs,
                                                         as_coded=c)),
        "kmatrix_assembled_lb": ("K5a", k5_ms["t"][0], lambda c:
                                 profiling.k5_roofline(BK, L, nF, nE, "t",
                                                       series_k5, c)),
        "kmatrix_assembled_rho_lwc_lb": (
            "K5b", k5_ms["rho_lwc"][0], lambda c: profiling.k5_roofline(
                BK, L, nF, nE, "rho_lwc", series_k5, c)),
        "absorption_spectral": ("K6", k6_ms, lambda c: profiling.k6_roofline(
            BS * L, f_chunk_np, as_coded=c)),
        "chain": ("K7", k7_ms["fma"],
                  lambda c: profiling.k7_roofline(n_chain, "fma")),
    }
    bounds = {}
    for name, (kid, ms, make) in bound_rows.items():
        roof = make(False)
        b_pub = roof.time_bound_s() * 1e3
        b_meas = roof.time_bound_s(peaks) * 1e3
        by = roof.bound_by()
        bounds[name] = (b_pub, "bytes" if by == "bytes" else "operations")
        line = (f"phase 15: {kid} {name}: {ms:.4f} ms; the function's bound "
                f"at the published peaks {b_pub:.4f} ms by {by}, share "
                f"{b_pub / ms:.4f}")
        if name in graph_times:
            line += (f" ({graph_times[name]:.4f} ms in a graph, share "
                     f"{b_pub / graph_times[name]:.4f})")
            check(b_pub <= graph_times[name],
                  f"{kid} runs under its bound in a graph")
        if kid != "K7":     # K7's own time is what defines the measured rate
            coded = make(True)
            line += (f"; at the measured rates {b_meas:.4f} ms by "
                     f"{roof.bound_by(peaks)}, share {b_meas / ms:.4f}; the "
                     f"body as coded at the published peaks "
                     f"{coded.time_bound_s() * 1e3:.4f} ms by "
                     f"{coded.bound_by()}, its additive model at the "
                     f"measured rates "
                     f"{profiling.pipeline_model_time(coded, peaks) * 1e3:.4f}"
                     f" ms")
            check(roof.time_bound_s() <= coded.time_bound_s()
                  and roof.div_ops <= coded.div_ops
                  and roof.exp_ops <= coded.exp_ops,
                  f"{kid}: the function's count is above the body's")
        print(line)
        check(0.0 < b_pub / ms <= 1.0,
              f"{kid} share {b_pub / ms} of the published bound")
        check(kid == "K7" or b_meas / ms <= 1.0,
              f"{kid} share {b_meas / ms} of the bound at the measured rates")
    for op in ("div", "exp"):
        roof = profiling.k7_roofline(n_chain, op)
        print(f"phase 15: K7 {op} chain: {k7_ms[op]:.4f} ms; bound at the "
              f"published peaks {roof.time_bound_s() * 1e3:.4f} ms by "
              f"{roof.bound_by()}, share "
              f"{roof.time_bound_s() * 1e3 / k7_ms[op]:.4f}")

    # ---- phase 16: the fast operator --------------------------------------
    fcfg = fast.FastConfig(outputs=("tb", "tau_total"))
    absorption_lb.launches = 0
    params = fast.fit_closed_form({k: v[:64] for k, v in profiles.items()},
                                  fcfg)
    fit_launches = absorption_lb.launches
    print(f"phase 16: fit_closed_form on 64 profiles: K1 launches "
          f"{fit_launches}; w {tuple(params['w'].shape)} {params['w'].dtype}")
    check(fit_launches == 1 and bool(torch.isfinite(params["w"]).all()),
          "fit_closed_form")
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the product must not care
    absorption_lb.launches = 0
    forward_lb.launches = 0
    fast_out = fast.fast_forward_batch(params, profiles, fcfg)
    fast_launches = {"forward_lb": forward_lb.launches,
                     "absorption_lb": absorption_lb.launches}
    torch.cuda.synchronize()
    print(f"phase 16: launches during fast serving: {fast_launches}")
    check(fast_launches == {"forward_lb": 1, "absorption_lb": 0},
          f"fast serving launches {fast_launches}")
    tb_fast = fast_out["tb"]
    check(tuple(tb_fast.shape) == (B, nE, nF)
          and tuple(fast_out["tau_total"].shape) == (B, nE, nF)
          and bool(torch.isfinite(tb_fast).all()), "fast tb")
    lev = lbl.level_major_profiles(profiles, lbl.LBLConfig())
    a_serv = fast.serving_extinction(params, lev["p"], lev["t"], lev["rho"],
                                     lev["lwc"])                # (C, L-1, B)
    x32 = fast.layer_features(*(profiles[k]
                                for k in ("p", "t", "rho", "lwc")))
    a_64 = torch.clamp_min(x32.double() @ params["w"].double(),
                           0.0).permute(2, 1, 0)
    a_tf32 = torch.clamp_min(x32 @ params["w"], 0.0).permute(2, 1, 0)
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    scale = a_64.abs().amax(dim=(1, 2))
    prod_err = float(((a_serv.double() - a_64).abs().amax(dim=(1, 2))
                      / scale).max())
    tf32_err = float(((a_tf32.double() - a_64).abs().amax(dim=(1, 2))
                      / scale).max())
    print(f"phase 16: regression product (14 x 72) x (72 x {(L - 1) * B}) "
          f"with allow_tf32 on process-wide: max per-channel relative error "
          f"vs float64 {prod_err:.3e} (bound 1e-4: weights up to 300 on "
          f"features of order 1 cancel to five decades of extinction); the "
          f"same product as a TF32-allowed matmul {tf32_err:.3e}")
    check(prod_err <= 1e-4, f"regression product error {prod_err}")
    fast_plain = fast.fast_forward_batch(
        params, profiles, dataclasses.replace(fcfg, use_kernels=False))
    fast_err = float((tb_fast - fast_plain["tb"]).abs().max())
    tau_err = float(((fast_out["tau_total"] - fast_plain["tau_total"]).abs()
                     / fast_plain["tau_total"]).max())
    teacher = lbl.forward_batch(profiles, main_cfg)["tb"]
    d_teacher = tb_fast - teacher
    rms_teacher = float(d_teacher.pow(2).mean().sqrt())
    max_teacher = float(d_teacher.abs().max())
    print(f"phase 16: fast tb {tuple(tb_fast.shape)}: max|dTB| vs the plain "
          f"path {fast_err:.3e} K (bound 1e-2), max relative dtau "
          f"{tau_err:.3e}; vs the LBL teacher RMS {rms_teacher:.4f} K (bound "
          f"0.05), max {max_teacher:.4f} K (bound 0.5)")
    check(fast_err <= 1e-2, f"fast serving vs plain {fast_err} K")
    check(rms_teacher < 0.05 and max_teacher < 0.5,
          f"fast vs teacher {rms_teacher} {max_teacher}")

    # ---- phase 17: the fast-operator K-matrix ------------------------------
    few = {k: v[:4] for k, v in profiles.items()}
    kcfg = fast.FastConfig(outputs=("tb",))
    k_closed = jacobians.kmatrix_fast_adjoint_batch(params, few, kcfg)
    k_auto = jacobians.kmatrix_fast_batch(params, few, kcfg,
                                          wrt=("t", "rho"))
    one = jacobians.kmatrix_fast_adjoint_single(
        params, *(few[k][0] for k in ("z", "p", "t", "rho", "lwc")), kcfg)
    torch.cuda.synchronize()
    for name in ("t", "rho"):
        check(tuple(k_closed[name].shape) == (4, nE, nF, L), f"fast K {name}")
        kscale = float(k_auto[name].abs().max())
        err = float((k_closed[name] - k_auto[name]).abs().max()) / kscale
        err1 = float((one[name] - k_auto[name][0]).abs().max()) / kscale
        print(f"phase 17: fast K {name} {tuple(k_closed[name].shape)}: "
              f"max|K| {kscale:.4g}; closed form vs jacrev {err:.3e} of it, "
              f"single profile {err1:.3e} (bound 2e-3)")
        check(err <= 2e-3 and err1 <= 2e-3, f"fast K {name} error {err}")

    # ---- phase 18: the retrieval -------------------------------------------
    BR = 64
    rprof = lbl.demo_batch(BR, L, device=dev)
    rparams = fast.fit_closed_form({k: v[:32] for k, v in rprof.items()},
                                   kcfg)
    tb_obs = fast.fast_forward_batch(rparams, rprof, kcfg)["tb"]
    ocfg = retrieval.OEMConfig(n_iter=3)
    t_prior, rho_prior = rprof["t"] + 1.5, rprof["rho"] * 0.8

    def retrieve_run():
        return retrieval.retrieve_batch(rparams, tb_obs, rprof["z"],
                                        rprof["p"], t_prior, rho_prior, ocfg,
                                        rprof["lwc"])

    forward_lb.launches = 0
    ret = retrieve_run()
    oem_launches = forward_lb.launches
    torch.cuda.synchronize()

    def rms(a):
        return float(a.pow(2).mean().sqrt())

    rms_t = (rms(t_prior - rprof["t"]), rms(ret["t"] - rprof["t"]))
    rms_r = (rms(rho_prior - rprof["rho"]), rms(ret["rho"] - rprof["rho"]))
    fit = float((ret["tb_fit"] - tb_obs).abs().mean())
    dofs = ret["dofs"]
    print(f"phase 18: retrieve_batch B={BR} L={L} n_iter=3: K2 launches "
          f"{oem_launches}; T RMS prior {rms_t[0]:.4f} -> posterior "
          f"{rms_t[1]:.4f} K; rho RMS prior {rms_r[0]:.4f} -> posterior "
          f"{rms_r[1]:.4f} g/m^3; mean|tb_fit - tb_obs| {fit:.4f} K (bound "
          f"0.5); cost {[round(float(c), 4) for c in ret['cost'].mean(0)]} "
          f"K^2; dofs [{float(dofs.min()):.3f}, {float(dofs.max()):.3f}] "
          f"(bound (0, {2 * L}))")
    check(oem_launches == ocfg.n_iter + 1, f"OEM K2 launches {oem_launches}")
    check(all(bool(torch.isfinite(v).all()) for v in ret.values()),
          "retrieval not finite")
    check(rms_t[1] < rms_t[0] and rms_r[1] < rms_r[0],
          f"posterior RMS not below prior: T {rms_t}, rho {rms_r}")
    check(fit < 0.5, f"retrieval fit {fit} K")
    check(bool(((dofs > 0) & (dofs < 2 * L)).all()), "retrieval dofs")

    # ---- phase 19: times of the fast path ----------------------------------
    fast_ms = timed_ms(lambda: fast.fast_forward_batch(params, profiles,
                                                       fcfg))
    fast_peak = peak_mib(lambda: fast.fast_forward_batch(params, profiles,
                                                         fcfg))
    fast_plain_ms = timed_ms(lambda: fast.fast_forward_batch(
        params, profiles, dataclasses.replace(fcfg, use_kernels=False)),
        repeats=5, warmup=1)
    feat_ms = timed_ms(lambda: fast.serving_extinction(
        params, lev["p"], lev["t"], lev["rho"], lev["lwc"]))
    print(f"phase 19: fast_forward_batch B={B} outputs={fcfg.outputs}: "
          f"kernels {fast_ms:.4f} ms = {B * nE / (fast_ms * 1e-3):.6g} "
          f"spectra/s, peak {fast_peak:.1f} MiB above the live tensors; "
          f"plain {fast_plain_ms:.4f} ms; features + product alone "
          f"{feat_ms:.4f} ms; K2 on layer means {k2_mid_ms:.4f} ms")
    dprof = {k: v[:512] for k, v in profiles.items()}
    dtargets = teacher[:512]
    dparams = {"w": params["w"].clone()}
    optimizer = fast.make_optimizer(dparams)
    with torch.no_grad():
        loss0 = float(fast.distill_loss(dparams, dprof, dtargets, fcfg))
    first = float(fast.train_step(dparams, optimizer, dprof, dtargets, fcfg))
    step_ms = timed_ms(lambda: fast.train_step(dparams, optimizer, dprof,
                                               dtargets, fcfg),
                       repeats=10, warmup=2)
    step_peak = peak_mib(lambda: fast.train_step(dparams, optimizer, dprof,
                                                 dtargets, fcfg))
    with torch.no_grad():
        loss1 = float(fast.distill_loss(dparams, dprof, dtargets, fcfg))
    print(f"phase 19: distillation step B=512 (plain path, autograd, Adam): "
          f"{step_ms:.4f} ms, peak {step_peak:.1f} MiB above the live "
          f"tensors; loss at the closed-form fit {loss0:.6f} K^2 (the first "
          f"step returned {first:.6f}), {loss1:.6f} K^2 after the 14 steps "
          f"taken here")
    check(np.isfinite(loss1) and abs(first - loss0) <= 1e-3 * loss0 + 1e-9,
          f"distillation loss {loss0} {first} {loss1}")
    for what, fn, calls, ms in (
            ("fast serving", lambda: fast.fast_forward_batch(
                params, profiles, fcfg), 10, fast_ms),
            ("retrieval", retrieve_run, 2, None),
            ("the K-matrix", lambda: jacobians.kmatrix_batch_fast(
                kprofiles, cfg_k, wrt=WRT), 5, kmat_ms)):
        if ms is None:
            ms = timed_ms(fn, repeats=5, warmup=1)
        device_ms, n_kernels, top = path_times.device_profile(fn, calls, 4)
        n_kernels = round(n_kernels)
        if device_ms == 0.0:
            print(f"phase 19: {what}: the profiler saw no device time: idle "
                  f"share not measured")
            continue
        print(f"phase 19: {what}, profiler over {calls} calls: {n_kernels} "
              f"device kernels and copies per call, device time "
              f"{device_ms:.4f} ms per call against {ms:.4f} ms by CUDA "
              f"events: the device idles "
              f"{max(0.0, 1.0 - device_ms / ms):.3f} of the call; most of "
              f"it: " + "; ".join(f"{name} {t:.4f} ms x{c}"
                                  for name, c, t in top))
    fastk_ms = timed_ms(lambda: jacobians.kmatrix_fast_adjoint_batch(
        rparams, rprof, kcfg), repeats=10)
    oem_ms = timed_ms(retrieve_run, repeats=5, warmup=1)
    oem_peak = peak_mib(retrieve_run)
    fastk_peak = peak_mib(lambda: jacobians.kmatrix_fast_adjoint_batch(
        rparams, rprof, kcfg))
    print(f"phase 19: kmatrix_fast_adjoint_batch B={BR}: {fastk_ms:.4f} ms = "
          f"{fastk_ms / BR:.5f} ms/profile, peak {fastk_peak:.1f} MiB above "
          f"the live tensors; retrieve_batch B={BR} n_iter=3: "
          f"{oem_ms:.4f} ms = {oem_ms / BR:.5f} ms/profile, peak "
          f"{oem_peak:.1f} MiB above the live tensors")

    # ---- phase 20: the campaign forward stage -----------------------------
    stage_launches = forward_stage_phase(dev, fb_rate, {
        "absorption_lb": absorption_lb, "forward_lb": forward_lb,
        "absorption_tangents_lb": absorption_tangents_lb,
        "kmatrix_assembled_lb": kmatrix_assembled_lb,
        "kmatrix_assembled_rho_lwc_lb": kmatrix_assembled_rho_lwc_lb,
        "absorption_spectral": absorption_spectral,
        "downwelling_lb": downwelling_lb, "chain": chain})

    kernel_rows = [
        {"name": "absorption_lb", "route": "cuda",
         "source": f"{PKG}/csrc/absorption.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "absorption_kernel.py:803",
         "launches": launches["absorption_lb"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "forward_lb", "route": "cuda",
         "source": f"{PKG}/csrc/rte.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "rte_kernel.py:400",
         "launches": launches["forward_lb"], "max_abs_err": k2_err,
         "ms": rows[False][0], "plain_ms": rows[False][1]},
        {"name": "absorption_tangents_lb", "route": "cuda",
         "source": f"{PKG}/csrc/absorption_tangents.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "absorption_kernel.py:846",
         "launches": k_launches["absorption_tangents_lb"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms},
        {"name": "kmatrix_assembled_lb", "route": "cuda",
         "source": f"{PKG}/csrc/adjoint.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "adjoint_kernel.py:215",
         "launches": k_launches["kmatrix_assembled_lb"],
         "max_abs_err": max(k5_err[w] for w in ("t", "rho", "lwc")),
         "ms": k5_ms["t"][0], "plain_ms": k5_ms["t"][1]},
        {"name": "kmatrix_assembled_rho_lwc_lb", "route": "cuda",
         "source": f"{PKG}/csrc/adjoint.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "adjoint_kernel.py:284",
         "launches": k_launches["kmatrix_assembled_rho_lwc_lb"],
         "max_abs_err": k5_err["rho_lwc"], "ms": k5_ms["rho_lwc"][0],
         "plain_ms": k5_ms["rho_lwc"][1]},
        {"name": "absorption_spectral", "route": "cuda",
         "source": f"{PKG}/csrc/absorption_spectral.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "spectral_kernel.py:558",
         "launches": s_launches["absorption_spectral"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms},
        {"name": "downwelling_lb", "route": "cuda",
         "source": f"{PKG}/csrc/rte.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/"
                     "rte_kernel.py:479",
         "launches": s_launches["downwelling_lb"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "chain", "route": "cuda",
         "source": f"{PKG}/csrc/chain.cu",
         "replaces": "mwr_fast_forward_operators_and_lbls_tpu/parallel/"
                     "profiling.py:116",
         "launches": k7_launches, "max_abs_err": k7_err["fma"],
         "ms": k7_ms["fma"], "plain_ms": k7_plain_ms,
         "rates_per_s": rates},
    ]
    for row in kernel_rows:
        # no single PyTorch call computes any of these functions
        row["bound_ms"], row["bound_by"] = bounds[row["name"]]
        row["library_ms"] = None
    # also without the host's share of an event pair (K7's time is one)
    for row in kernel_rows:
        row["device_ms"] = graph_times.get(row["name"], row["ms"])
        row["launches_forward_stage"] = stage_launches[row["name"]]
    kernel_rows[1].update(
        launches_fast_path=fast_launches["forward_lb"], body=main_body,
        alpha_is_mid_ms=k2_mid_ms, alpha_is_mid_plain_ms=k2_mid_plain_ms,
        alpha_is_mid_device_ms=graph_times["forward_lb[alpha_is_mid]"],
        alpha_is_mid_bound_ms=bounds["forward_lb[alpha_is_mid]"][0],
        narrow_copies_device_ms=k2_narrow_ms[0])
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
