"""Drive the PyTorch/CUDA port's line-by-line forward, K-matrix,
monochromatic spectral forward, primitive-rate microbenchmark with the
kernels' bounds, fast operator, retrieval, forward stage, command line,
multi-device splits, literature checkpoints, tools and bench on one GPU
and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  It builds the port's kernels from `csrc/` and goes through
twenty-six phases, each printing its own lines:

  0. the card (nvidia-smi name and power limit), torch/CUDA versions,
     whether matplotlib and h5py import on the host, the
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
     nine releases, 256 profiles x 180 levels, and its fourth output,
     dalpha/dLWC, against the liquid term in float64 (at zero LWC too);
  6. the K-matrix adjoint kernel (K5) for t, rho, lwc and rho+lwc against
     its plain version run in float64, 256 profiles x 10 elevations x 14
     channels x 180 levels, and its LWC columns again on alpha rounded from
     the float64 function; the K-matrix's float64 slant-geometry kernel
     against its plain version (every output within 2 float32 ulp);
  7. the K-matrix path, `kmatrix_batch_fast` on 256 profiles for t, rho and
     lwc, with the launch counts of K4 (one of them writing dalpha/dLWC),
     the geometry kernel and both K5 wrappers;
  8. that K-matrix against the plain path in float64 on the card, and its
     physical signs;
  9. CUDA-event times of K4 (with its blocks against its resident slots),
     the geometry kernel (with its bound by bytes), K5 and the K-matrix
     against the plain versions,
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
 19. CUDA-event times of fast serving, one distillation step (K2 forward,
     K2v backward), the fast K and the retrieval, with peak device memory,
     and a `torch.profiler` trace of fast serving, of the retrieval and of the K-matrix: device
     time by kernel and the device's idle share; the fast K at B=1024: its
     kernel, from the profiles, against the plain route in float64, row by
     row, and the times (alone and in a graph) of the kernel, of the torch
     prologue it took over (beside it the prologue plus the kernel that
     took its ten inputs, as measured for that kernel), of the plain
     version and of the entry point through each, beside the least bytes'
     bound; then `retrieve_batch` at B=1024, 5 iterations, against the
     plain route in float64 on the CPU; and the distillation step at the
     benchmark cell's B=4096 (`distill_phase`): the kernel path (K2, its
     backward K2v) beside the plain path, launches, times, peak memory, the
     loss and gradient against the cell's float64 reference within the
     cell's limits, and K2v alone against its plain version in float64 and
     in a graph against its bound;
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
     fp16 upload on and off, peak device memory and the host outputs' size;
 21. the command line, `cli.main([...])` without --device (the card), each
     subcommand with the launch counts of the kernels it reaches: (a) the
     synthetic campaign of phase 20 through run-all and run-all --resume
     (four releases, fast operator, K-matrix, compat names) or, where
     matplotlib does not import, through preprocess, distill and forward
     and then the analysis dataset and stats CSV of evaluate, results.nc
     equal to the bit to `forward_stage` called directly, the stats rows
     finite, each stage's wall; (b) retrieve on its TBs_Fast, equal to
     `retrieve_batch` called directly; (c) spectral at its defaults (50,000
     frequencies), equal to `forward_spectral`; (d) simulate-rttov on 8
     profiles at two zenith angles, TBs and transmittances equal to
     `forward_batch` as printed, K against the plain path in float64; (e)
     simulate-arms with O3, equal to `forward_batch`; (f) forward at phase
     20's scale from a NetCDF file, equal to the stage called directly and
     to phase 20's outputs, its wall (median of 3) split into NetCDF read,
     stage and NetCDF write, and the file's size; (g) `fast.distill` stopped
     at 10 steps and resumed from its checkpoint to 20, equal to 20 steps
     in one call;
 22. the multi-device layer (`parallel/`) on meshes of the one card, with
     the launch counts of each call: (a) `forward_sharded` on
     `single_device_mesh()` at B=1024 x L=180, R24, tb, equal to the bit to
     `forward_batch`; (b) the same on a virtual data=4 mesh of the card, at
     B=1024 and at B=1021 (padded to 1024); (c) `forward_spectral_sharded`
     plus `srf_convolve` at 32 x 180 x 50,000 on a spectral=2 mesh against
     phase 12's spectrum; (d) `scaling.measure` at 1, 2 and 4 entries and
     `cli.main(["bench"])`, each row printed with the card's name and power
     limit; (e) `dryrun_multichip(4)` on the card; (f) `run_checkpoints` for
     the nine releases with the tb rows on the card, all ok, against the
     same call on the CPU;
 23. the port's tools (`tools/`), each with the launch counts of its calls:
     (a) `perf_probe.probe` at B=1024 x L=180 (the headline forward split
     into K1, K2 and the glue, printed as its JSON line), K2 of the timed K1
     output equal to the bit to `forward_batch`; (b) `make_golden.main`
     into a scratch directory under build/torch_kernels/ (every checkpoint
     row of the nine releases ok, the tb rows through K1 and K2), compared
     with tests/golden/: absorption within 1e-9 relative, tb_standard
     within 1e-6 K, literature.json equal; (c) `fit_tables.main` in float64:
     the +4 % h2o_s1 retune of tests/test_golden.py recovered in 250 steps,
     20 steps against the same on the CPU, and the per-line refit of the
     R19 ECS-like perturbation in 900 steps, each with its wall; (d)
     `campaign_demo.run_chain` at 520 sondes x 3 campaigns (every stage but
     the report, which needs matplotlib: where it does not import,
     `campaign_demo.main` is shown to stop before any work), the four
     releases and the fast operator, with the launches of K1 and K2,
     results.nc equal to the bit to `forward_stage` called directly on
     harmonized.nc, each stage's wall and the summary JSON; tests/golden/
     unchanged;
 24. the port's bench (`python -m ...bench`, bench.py's seven
     measurements): (a) `--quick` in a process of its own, its line with
     bench.py's top keys; (b) the full bench in this process at bench.py's
     sizes, its JSON line printed: its keys those of bench.py (read from
     its text) plus `device` and `power_limit_w` (equal to nvidia-smi's),
     every number finite and > 0, every `*_roofline_frac` at most 1, the
     launches of each kernel as predicted from the bench's timing table,
     and each timed call's output equal to the bit to its entry point
     called directly on the same inputs;
 25. the Radiometrics MP-3000A's 22 channels (`mp3000a_phase`): K1's body
     at 22 channels and K4 in three groups of 8 slots, their registers,
     spills (none in any of K1's bodies past 16 channels) and resident
     warps; K1 and K2 at the archive cells' B=4096 (K2 on its 16-byte
     copies; K1 also at its ceiling of 32 in a graph), K4 at the K-matrix's
     B=256, each against its plain version (K1 also against float64 on its
     tables, K2 against its plain version in float64), timed as a wrapper
     call, in a graph and plain, and set against its bound; the launches
     of `forward_batch`, `forward_all_models` and `kmatrix_batch_fast`
     against the plain path in float64 at B=128 and B=130 (K2's 16-byte
     and 4-byte copies); and the digests of HATPRO's 14-channel TBs and K
     (`hatpro_digests`), which have to equal those of commit a275ac1 (K1
     and K4 at 16 channels and fewer) on the card they were taken on.

It then prints one JSON line of per-kernel results (with the launches of
the main path, of phase 20's stage call, of phase 21's CLI calls, of
phase 22's sharded calls, of phase 23's tools and of phase 24's bench)
and, last, one JSON line naming the device.  Any
failed check raises, and the exit code is not 0.
Without a CUDA device it exits with 1 and prints no result.
"""

import dataclasses
import hashlib
import importlib.util
import json
import math
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
N_CAMPAIGN_SONDES = 520  # the JAX tools/campaign_demo.py's archive
# the fast-K kernel as it was when it took the torch prologue's ten inputs
# (commit f168307), at B=1024 in a CUDA graph (NVIDIA H100 80GB HBM3, 700 W)
FK_TEN_INPUTS_GRAPH_MS = 0.3844


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


def max_ulps(got, want) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (+0 and -0 are one value)."""
    def ordered(a):
        bits = a.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return int((ordered(got) - ordered(want)).abs().max())


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


def device_profile(fn, calls: int = 5, n_top: int = 6):
    """(device ms per call, device kernels and copies per call, the `n_top`
    largest as (name, launches per call, ms per call)), from a
    `torch.profiler` trace of `calls` calls."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        rows.append((event.key[:48], event.count / calls, us * 1e-3 / calls))
    rows.sort(key=lambda r: -r[2])
    return (sum(r[2] for r in rows), sum(r[1] for r in rows), rows[:n_top])


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


def write_campaign(root):
    """The synthetic campaign's raw files in `root`: 3 sondes and one
    instrument's L1 and L2 files.  Returns (sondes, {"joyhat": files})."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import synthetic

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
    return sondes, mwr_files


def stage_campaign(root):
    """Phase 20 (a): a synthetic campaign through the data layer, the
    distillation, the stage and the merge."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
        netcdf, preprocess)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward_stage, merge)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.utils import native

    t0 = time.perf_counter()
    sondes, mwr_files = write_campaign(root)
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
    bench.py's shape, that shape's harmonized dataset and the call's
    outputs ({name: array})."""
    import tempfile

    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import preprocess
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        fast, jacobians, lbl)
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
            "downwelling_lb": 0, "chain": 0, "forward_lb_vjp": 0}
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
    plain = stage_outputs(stage(with_jacobians=False, use_kernels=False))
    plain_err = {k: float(np.abs(plain[k] - out[k]).max())
                 for k in plain if k.startswith("TBs_")}
    del plain
    print("phase 20: max|kernels - plain path (use_kernels=False) on the card|: "
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
    res = fwd._allocate(n, L, STAGE_MODELS, True, True, dev)
    tables = fwd._stage_tables(STAGE_MODELS, True, res)
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
    device_ms, n_kernels, top = device_profile(stage, 1, 4)
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
    return launches, ds, out


def cli_phase(dev, counted, stage_ds, stage_out):
    """Phase 21: the command line on the card, through `cli.main` as a user
    runs it (no --device: the card).  (a) the campaign: run-all, or where
    matplotlib is missing the same calls without the figure step; (b)
    retrieve; (c) spectral; (d) simulate-rttov; (e) simulate-arms; (f)
    forward at phase 20's scale; (g) resumable distillation.  Returns the
    launches of each kernel wrapper in `counted` summed over the CLI calls
    of (a)-(f), the three timed repeats of (f) left out."""
    import csv
    import tempfile

    from mwr_fast_forward_operators_and_lbls_tpu_torch.cli.main import (
        main as cli)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
        netcdf, preprocess)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.eval import (
        deviations, report)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.interop import (
        arms_gb, rttov_gb)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        fast, jacobians, lbl, retrieval, spectral)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward_stage, merge)

    total = dict.fromkeys(counted, 0)

    def run(argv, count=True):
        """One CLI call: (launches by wrapper, wall s)."""
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc = cli([str(a) for a in argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli {argv[0]}: exit code {rc}")
        launches = {k: fn.launches for k, fn in counted.items()}
        if count:
            for k, v in launches.items():
                total[k] += v
        return launches, wall

    def want(**kw):
        return {k: kw.get(k, 0) for k in counted}

    def shown(launches):
        return {k: v for k, v in launches.items() if v}

    def equal_bits(direct, got):
        """Variables of `direct` not equal to the bit to `got`'s."""
        return [k for k, v in direct.items() if not same_data(v, got[k])]

    models = ",".join(STAGE_MODELS)
    chunks = 2 * -(-3 // 256)          # 3 sondes, 2 crops, batch_size 256
    forward_want = want(absorption_lb=len(STAGE_MODELS) * chunks,
                        forward_lb=(len(STAGE_MODELS) + 1) * chunks,
                        absorption_tangents_lb=chunks,
                        kmatrix_assembled_lb=chunks,
                        kmatrix_assembled_rho_lwc_lb=chunks)
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    scratch = ROOT / "build" / "torch_kernels"
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = pathlib.Path(tmp)
        write_campaign(root)
        work = root / "work"
        harm, params_path, results = (str(work / n) for n in (
            "harmonized.nc", "fast_params.npz", "results.nc"))
        common = ["--sondes", f"{root}/2024*_*.nc", "--campaign", "Vital",
                  "--location", "Juelich", "--mwr", f"joyhat={root}/mwr*.nc"]
        walls = {}
        # (a) the campaign at the full width: 180 levels, 14 channels, 10
        # elevations, 2 crops, the four releases, the fast operator, K
        if have_mpl:
            run_all = ["run-all", *common, "--workdir", work, "--models",
                       models, "--distill", "--with-jacobians", "--compat"]
            launches, walls["run-all"] = run(run_all)
            again, walls["run-all --resume"] = run(run_all + ["--resume"])
            a_want = {k: v + (k == "absorption_lb")
                      for k, v in forward_want.items()}
            check(launches == a_want and again == a_want,
                  f"run-all launches {launches}, {again}, want {a_want}")
            print(f"phase 21: (a) run-all, then run-all --resume: launches "
                  f"{shown(launches)} each")
            print("phase 21: (a) run_all.log:\n" + "\n".join(
                "  " + line for line in
                (work / "run_all.log").read_text().splitlines()))
        else:
            print("phase 21: (a) matplotlib is not importable on this host: "
                  "run-all and evaluate stop before any work (their figure "
                  "step needs it); their calls without the figure step "
                  "follow: preprocess, distill, forward, then the analysis "
                  "dataset and the stats CSV that evaluate -o --stats-csv "
                  "writes")
            work.mkdir()
            pre, walls["preprocess"] = run(["preprocess", *common, "-o",
                                            harm])
            fit, walls["distill"] = run(["distill", "-i", harm, "-o",
                                         params_path])
            fwd, walls["forward"] = run([
                "forward", "-i", harm, "-o", results, "--models", models,
                "--fast-params", params_path, "--with-jacobians",
                "--compat"])
            t0 = time.perf_counter()
            ana = merge.analysis_dataset(netcdf.read(results), compat=True)
            netcdf.write(str(work / "analysis.nc"), ana)
            report.write_stats_csv(report.stats_table(ana),
                                   str(work / "stats.csv"))
            walls["analysis dataset + stats CSV"] = time.perf_counter() - t0
            print(f"phase 21: (a) launches: preprocess {shown(pre)}, distill "
                  f"{shown(fit)}, forward {shown(fwd)}")
            check(pre == want() and fit == want(absorption_lb=1)
                  and fwd == forward_want,
                  f"campaign launches {pre}, {fit}, {fwd}")
        ds = netcdf.read(harm)
        params = fast.load_params(params_path)
        direct = deviations.compat_aliases(forward_stage(
            ds.copy(), STAGE_MODELS, params, with_jacobians=True))
        got = netcdf.read(results)
        outputs = stage_outputs(got)
        check(set(got.variables) == set(direct.variables),
              f"results.nc variables {sorted(got.variables)}")
        bad = equal_bits({k: v.data for k, v in direct.variables.items()},
                         {k: v.data for k, v in got.variables.items()})
        check(not bad, f"results.nc differs from forward_stage: {bad}")
        check(all(np.isfinite(v).all() for v in outputs.values()),
              "results.nc outputs not finite")
        with open(work / "stats.csv") as fh:
            rows = list(csv.DictReader(fh))
        filled = [r for r in rows if int(r["n"])]
        check(filled and all(np.isfinite(float(r[k])) for r in filled
                             for k in ("bias", "std", "rmse")),
              "stats CSV rows not finite")
        print(f"phase 21: (a) results.nc: {len(got.variables)} variables, "
              f"every one equal to the bit to forward_stage called directly "
              f"on harmonized.nc ({len(outputs)} model outputs, finite); "
              f"stats.csv {len(rows)} rows, the {len(filled)} with samples "
              f"finite ({len(rows) - len(filled)} of instruments the "
              f"campaign lacks, n = 0); walls: " + "; ".join(
                  f"{k} {v:.3f} s" for k, v in walls.items()))

        # (b) retrieve on the fast operator's TBs
        ret = str(work / "retrieved.nc")
        rl, wall = run(["retrieve", "-i", results, "-o", ret,
                        "--fast-params", params_path, "--tb-var",
                        "TBs_Fast"])
        ocfg = retrieval.OEMConfig()
        check(rl == want(forward_lb=ocfg.n_iter + 1), f"retrieve {rl}")
        raw = preprocess.profiles_for_forward(got, crop=0)
        obs = np.transpose(np.asarray(got["TBs_Fast"].data,
                                      np.float64)[..., 0], (0, 2, 1))
        valid = np.isfinite(obs).all(axis=(1, 2))
        for k in ("z", "p", "t", "rho"):
            valid &= np.isfinite(raw[k]).all(axis=1)
        idx = np.flatnonzero(valid)

        def on_card(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        out = retrieval.retrieve_batch(
            params, on_card(obs[idx]), *(on_card(raw[k][idx]) for k in (
                "z", "p", "t", "rho")), ocfg, on_card(raw["lwc"][idx]))
        rds = netcdf.read(ret)
        t_ret, rho_ret = (rds[k].data[idx] for k in ("Retrieved_T",
                                                     "Retrieved_rho"))
        check(idx.size > 0 and np.isfinite(t_ret).all()
              and np.isfinite(rho_ret).all(), "retrieval not finite")
        check(np.array_equal(t_ret, out["t"].cpu().numpy())
              and np.array_equal(rho_ret, out["rho"].cpu().numpy()),
              "retrieve differs from retrieve_batch")
        print(f"phase 21: (b) retrieve --tb-var TBs_Fast on {idx.size} "
              f"profiles: launches {shown(rl)}; Retrieved_T/rho finite and "
              f"equal to the bit to retrieve_batch called directly; "
              f"T in [{t_ret.min():.2f}, {t_ret.max():.2f}] K; {wall:.3f} s")

        # (c) spectral at its defaults
        spec = str(work / "spectrum.nc")
        sl, wall = run(["spectral", "-i", harm, "-o", spec])
        n_chunks = -(-50_000 // 4096)
        check(sl == want(absorption_spectral=n_chunks,
                         downwelling_lb=n_chunks), f"spectral {sl}")
        raw = preprocess.profiles_for_forward(ds, crop=0)
        mask = np.ones(raw["z"].shape[0], bool)
        for v in raw.values():
            mask &= np.isfinite(v).all(axis=1)
        f = np.linspace(20.0, 64.0, 50_000).astype(np.float32)
        sp = spectral.forward_spectral(
            {k: on_card(v[mask]) for k, v in raw.items()}, f, (90.0,),
            "R24", freq_chunk=4096)
        sd = netcdf.read(spec)
        check(np.array_equal(sd["TB_spectrum"].data,
                             sp["tb"][:, 0].cpu().numpy())
              and np.array_equal(sd["tau_spectrum"].data,
                                 sp["tau_total"][:, 0].cpu().numpy()),
              "spectral differs from forward_spectral")
        tb = sd["TB_spectrum"].data
        print(f"phase 21: (c) spectral {tb.shape} (50,000 frequencies, "
              f"20-64 GHz, zenith, R24, chunks of 4096): launches "
              f"{shown(sl)}; TB_spectrum in [{tb.min():.2f}, {tb.max():.2f}]"
              f" K, equal to the bit to forward_spectral called directly; "
              f"{wall:.3f} s")

        # (d) simulate-rttov: 8 profiles, two zenith angles, with liquid
        demo = {k: v.numpy().astype(np.float64)
                for k, v in lbl.demo_batch(8, L, device="cpu").items()}
        rprofs = []
        for i in range(8):
            p, t, rho, lwc = (demo[k][i, ::-1] for k in ("p", "t", "rho",
                                                           "lwc"))
            e = rho * t / 216.679
            rprofs.append(rttov_gb.RttovProfile(
                p_hpa=p, t_k=t, ppmv=1e6 * e / p,
                liquid_kgkg=lwc / 1000.0 / (p * 100.0 / (287.04 * t)),
                zenith_deg=(0.0, 60.0)[i % 2]))
        dat, rep = root / "prof_plev.dat", root / "output_example_k.dat"
        rttov_gb.write_profiles_dat(str(dat), rprofs, clear_sky=False)
        rtl, wall = run(["simulate-rttov", "-i", dat, "-o", rep])
        check(rtl == want(absorption_lb=2, forward_lb=2,
                          absorption_tangents_lb=2, kmatrix_assembled_lb=2,
                          kmatrix_assembled_rho_lwc_lb=2),
              f"simulate-rttov {rtl}")
        back = rttov_gb.parse_profiles_dat(str(dat), n_levels=L)
        res = rttov_gb.parse_output_report(str(rep), n_levels=L)
        check(len(res) == 8 and all(
            np.isfinite(r.tb).all() and np.isfinite(r.jacobians).all()
            for r in res), "the report does not read back")

        def printed(a, fmt):
            return np.array([float(format(x, fmt)) for x in np.ravel(a)]
                            ).reshape(np.shape(a))

        k_err = dict.fromkeys(("T", "ppmv", "liquid"), 0.0)
        for zen in (0.0, 60.0):
            idx = [i for i, q in enumerate(back) if q.zenith_deg == zen]
            cols = [rttov_gb._columns(back[i]) for i in idx]
            batch = {k: torch.from_numpy(np.stack([c[k] for c in cols])).to(
                device=dev, dtype=torch.float32) for k in cols[0]}
            cfg = lbl.LBLConfig(elevations_deg=(90.0 - zen,),
                                outputs=("tb", "tau_total", "trans_level"))
            o = {k: v[:, 0].cpu().numpy()
                 for k, v in lbl.forward_batch(batch, cfg).items()}
            b64 = {k: v.double() for k, v in batch.items()}
            k64 = {n: v[:, 0] for n, v in jacobians.kmatrix_batch_fast(
                b64, dataclasses.replace(cfg, dtype="float64",
                                         use_kernels=False),
                wrt=("t", "rho", "lwc")).items()}
            k64["ppmv"] = jacobians.kmatrix_ppmv_from_rho(
                k64["rho"], b64["p"], b64["t"])
            for j, i in enumerate(idx):
                r = res[i]
                check(np.array_equal(r.tb, printed(o["tb"][j], "12.5f"))
                      and np.array_equal(r.total_transmittance, printed(
                          np.exp(-o["tau_total"][j]), "12.5f"))
                      and np.array_equal(r.level_transmittance, printed(
                          o["trans_level"][j].T[::-1], "10.6f")),
                      f"report profile {i} differs from forward_batch")
                for c, (name, key) in enumerate((("T", "t"),
                                                 ("ppmv", "ppmv"),
                                                 ("liquid", "lwc")), 1):
                    ref = k64[key][j].cpu().numpy().T[::-1]
                    k_err[name] = max(k_err[name], float(
                        np.abs(r.jacobians[..., c] - ref).max()
                        / np.abs(ref).max()))
        print(f"phase 21: (d) simulate-rttov, 8 profiles x {L} levels at "
              f"zenith 0 and 60 deg: launches {shown(rtl)}; the report reads "
              f"back; its TBs and transmittances equal forward_batch called "
              f"directly as printed; K vs the plain path in float64 on the "
              f"card, of max |K|: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in k_err.items())
              + f" (bound 1e-3); {wall:.3f} s")
        check(max(k_err.values()) <= 1e-3, f"report K error {k_err}")

        # (e) simulate-arms: 8 profiles with the O3 column
        b = {k: v.numpy().astype(np.float64) for k, v in lbl.demo_batch(
            8, L, seed=100, device="cpu").items()}
        z, p, t, rho, lwc = (b[k][:, ::-1].T for k in ("z", "p", "t", "rho",
                                                       "lwc"))
        e = rho * t / 216.679
        mr = 1000.0 * 0.622 * e / (p - e)
        nc_in, nc_out = root / "elevation_0.nc", root / "elevation_0_out.nc"
        arms_gb.write_input_nc(
            str(nc_in), level_pressure=p, level_temperature=t, level_h2o=mr,
            level_ppmv=1e6 * e / p,
            level_liquid=lwc / 1000.0 / (p * 100.0 / (287.04 * t)),
            level_z=z, level_rh=np.full_like(p, 50.0),
            surface_pressure=p[-1], temperature_2m=t[-1], h2o_2m=mr[-1],
            surface_altitude=z[-1], elevation_deg=30.0, clear_sky=False)
        al, wall = run(["simulate-arms", "-i", nc_in, "-o", nc_out,
                        "--with-o3"])
        check(al == want(absorption_lb=1, forward_lb=1),
              f"simulate-arms {al}")
        prof = arms_gb.read_input_nc(str(nc_in))
        tb = lbl.forward_batch(
            {k: on_card(np.ascontiguousarray(v))
             for k, v in arms_gb._profiles(prof, True).items()},
            lbl.LBLConfig(elevations_deg=(prof["elevation_deg"],),
                          outputs=("tb",), include_o3=True))["tb"]
        sim = arms_gb.read_sim_bt(str(nc_out), zero_is_missing=False)
        check(np.array_equal(sim, tb[:, 0].cpu().numpy().astype(
            np.float64).T), "Sim_BT differs from forward_batch")
        print(f"phase 21: (e) simulate-arms --with-o3, 8 profiles x {L} "
              f"levels at 30 deg: launches {shown(al)}; Sim_BT {sim.shape} "
              f"in [{sim.min():.2f}, {sim.max():.2f}] K, equal to the bit to "
              f"forward_batch called directly; {wall:.3f} s")

        # (f) forward at phase 20's scale: 1000 times x 2 crops x L levels
        big = root / "stage"
        big.mkdir()
        harm_big, res_big = big / "harmonized.nc", big / "results.nc"
        netcdf.write(str(harm_big), stage_ds)
        argv = ["forward", "-i", harm_big, "-o", res_big, "--models",
                models, "--fast-params", params_path, "--with-jacobians",
                "--batch-size", "256"]
        fl, _ = run(argv)
        n_big = 2 * -(-stage_ds.dims["time"] // 256)
        check(fl == want(absorption_lb=len(STAGE_MODELS) * n_big,
                         forward_lb=(len(STAGE_MODELS) + 1) * n_big,
                         absorption_tangents_lb=n_big,
                         kmatrix_assembled_lb=n_big,
                         kmatrix_assembled_rho_lwc_lb=n_big),
              f"forward at scale {fl}")
        cli_walls = [run(argv, count=False)[1] for _ in range(3)]
        size = res_big.stat().st_size
        parts = {"read": [], "stage": [], "write": []}
        for _ in range(3):
            t0 = time.perf_counter()
            d = netcdf.read(str(harm_big))
            t1 = time.perf_counter()
            d = forward_stage(d, STAGE_MODELS, params, with_jacobians=True,
                              batch_size=256)
            t2 = time.perf_counter()
            netcdf.write(str(big / "direct.nc"), d)
            t3 = time.perf_counter()
            (big / "direct.nc").unlink()
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(v)
        parts = {k: statistics.median(v) for k, v in parts.items()}
        wall = statistics.median(cli_walls)
        got = stage_outputs(netcdf.read(str(res_big)))
        mine = stage_outputs(d)
        bad = equal_bits(mine, got)
        bad20 = equal_bits({k: v for k, v in stage_out.items()
                            if "Fast" not in k}, got)
        check(not bad and not bad20,
              f"forward at scale differs: from the stage {bad}, from phase "
              f"20 {bad20}")
        print(f"phase 21: (f) forward {stage_ds.dims['time']} times x 2 "
              f"crops x {L} levels, {STAGE_MODELS}, fast, K, batch_size=256: "
              f"launches {shown(fl)}; wall {wall * 1e3:.1f} ms (median of "
              f"3: {', '.join(f'{w * 1e3:.1f}' for w in cli_walls)}) = "
              f"NetCDF read {parts['read'] * 1e3:.1f} + stage "
              f"{parts['stage'] * 1e3:.1f} + NetCDF write "
              f"{parts['write'] * 1e3:.1f} ms (each alone, median of 3) + "
              f"the rest {(wall - sum(parts.values())) * 1e3:.1f} ms; "
              f"results.nc {size / 1e9:.3f} GB "
              f"({size / parts['write'] / 1e9:.2f} GB/s written); every output equal to the bit to the stage "
              f"called directly, the LBL TBs and the K-matrices to phase "
              f"20's")
        # the CLI writes over the results.nc of its previous call, the parts
        # above into a new file each time
        over = []
        for _ in range(3):
            t0 = time.perf_counter()
            netcdf.write(str(res_big), d)
            over.append(time.perf_counter() - t0)
        print(f"phase 21: (f) NetCDF write of the same outputs over the "
              f"existing results.nc: {statistics.median(over) * 1e3:.1f} ms "
              f"(median of 3), into a new file "
              f"{parts['write'] * 1e3:.1f} ms")
        del got, mine, d
        for path in big.iterdir():
            path.unlink()

        # (g) resumable distillation on the card: stopped after 2k steps,
        # resumed to 4k, against 4k steps in one call
        gprof = lbl.demo_batch(256, L, device=dev)
        k = 5
        t0 = time.perf_counter()
        whole, h_whole = fast.distill(gprof, fast.FastConfig(), steps=4 * k,
                                      log_every=1)
        run_dir = str(root / "distill")
        _, h1 = fast.distill(gprof, fast.FastConfig(), steps=2 * k,
                             log_every=1, checkpoint_dir=run_dir,
                             checkpoint_every=k)
        resumed, h2 = fast.distill(gprof, fast.FastConfig(), steps=4 * k,
                                   log_every=1, checkpoint_dir=run_dir,
                                   checkpoint_every=k)
        same = torch.equal(whole["w"], resumed["w"])
        print(f"phase 21: (g) distill on 256 profiles x {L} levels, "
              f"checkpoints every {k} steps: stopped at {2 * k}, resumed to "
              f"{4 * k}: weights equal to the bit to {4 * k} steps in one "
              f"call: {same} (max|dw| "
              f"{float((whole['w'] - resumed['w']).abs().max()):.3e}); "
              f"losses equal: {h1 + h2 == h_whole}; checkpoints kept "
              f"{sorted(p.name for p in (root / 'distill').iterdir())}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(same and h1 + h2 == h_whole, "resumed distillation differs")
    print(f"phase 21: launches by the CLI's calls, (f)'s timed repeats left "
          f"out: {shown(total)}")
    return total


def parallel_phase(dev, counted, smi, spec_profiles, f_spec, spec_tb, srf,
                   spec_srf):
    """Phase 22: the multi-device layer on the card.  (a) `forward_sharded`
    on `single_device_mesh()`; (b) on a virtual data=4 mesh of the card, at
    B and at B - 3; (c) `forward_spectral_sharded` plus `srf_convolve` on a
    spectral=2 mesh against phase 12's spectrum; (d) `scaling.measure` at
    1, 2 and 4 entries and `cli.main(["bench"])`; (e) `dryrun_multichip(4)`;
    (f) `run_checkpoints` for the nine releases, the tb rows on the card.
    Returns the launches of each kernel wrapper in `counted` summed over the
    calls of (a), (b), (c), (e) and (f); (d)'s timing loops are left out,
    as are the unsharded references."""
    import contextlib
    import io

    from mwr_fast_forward_operators_and_lbls_tpu_torch import anchors
    from mwr_fast_forward_operators_and_lbls_tpu_torch.cli.main import (
        main as cli)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        lbl, spectral)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
        dryrun, make_mesh, scaling, sharding, single_device_mesh)

    total = dict.fromkeys(counted, 0)

    def run(fn, count=True):
        """fn() with every count set to 0 just before it and read just
        after: (result, launches of the kernels it reached)."""
        for wrapper in counted.values():
            wrapper.launches = 0
        res = fn()
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in counted.items()}
        if count:
            for k, v in launches.items():
                total[k] += v
        return res, {k: v for k, v in launches.items() if v}

    cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    profiles = lbl.demo_batch(B, L, device=dev)
    want = lbl.forward_batch(profiles, cfg)["tb"]

    # (a) the one-card mesh
    out, got = run(lambda: sharding.forward_sharded(
        profiles, single_device_mesh(), cfg)["tb"])
    same = torch.equal(out, want)
    print(f"phase 22: (a) forward_sharded on single_device_mesh(), B={B} "
          f"L={L}, R24, tb: launches {got}; equal to the bit to "
          f"forward_batch: {same}")
    check(same and got == {"absorption_lb": 1, "forward_lb": 1},
          f"(a) single-device mesh: {got}, equal {same}")

    # (b) a virtual data=4 mesh of the card, at B and with padding
    mesh4 = make_mesh([dev] * 4)
    for b in (B, B - 3):
        prof = {k: v[:b] for k, v in profiles.items()}
        out, got = run(lambda: sharding.forward_sharded(prof, mesh4,
                                                        cfg)["tb"])
        ref = want[:b] if b == B else lbl.forward_batch(prof, cfg)["tb"]
        same = torch.equal(out, ref)
        print(f"phase 22: (b) forward_sharded on a virtual mesh "
              f"{mesh4.shape} of the card, B={b} (4 shards of "
              f"{-(-b // 4)}): launches {got}; max|dTB| vs forward_batch "
              f"{float((out - ref).abs().max()):.3e} K, equal to the bit: "
              f"{same}")
        check(same and got == {"absorption_lb": 4, "forward_lb": 4},
              f"(b) virtual data=4 mesh, B={b}: {got}, equal {same}")

    # the cost of the split: CUDA events around each call, host included
    single = single_device_mesh()
    placed4, _ = sharding.shard_profiles(profiles, mesh4)
    fb_ms = timed_ms(lambda: lbl.forward_batch(profiles, cfg))
    one_ms = timed_ms(lambda: sharding.forward_sharded(profiles, single, cfg))
    four_ms = timed_ms(lambda: sharding.forward_sharded(profiles, mesh4, cfg))
    placed_ms = timed_ms(lambda: sharding.forward_sharded_placed(
        placed4, mesh4, cfg))
    print(f"phase 22: (b) times at B={B} (median of {REPEATS}, {smi}): "
          f"forward_batch {fb_ms:.4f} ms; forward_sharded on the one-card "
          f"mesh {one_ms:.4f} ms, on the virtual data=4 mesh {four_ms:.4f} ms "
          f"(placed: {placed_ms:.4f} ms)")

    # (c) the spectral split of phase 12's spectrum
    mesh_s = make_mesh([dev] * 2, spectral=2)
    out, got = run(lambda: sharding.forward_spectral_sharded(
        spec_profiles, f_spec, mesh_s, "R24", (90.0,), freq_chunk=CHUNK))
    tb_srf = sharding.srf_convolve(out, srf)
    d_tb = float((out - spec_tb).abs().max())
    d_srf = float((tb_srf - spec_srf).abs().max())
    per_slice = -(-(NF_SPEC // 2) // CHUNK)
    print(f"phase 22: (c) forward_spectral_sharded on {mesh_s.shape}, {BS} x "
          f"{L} x {NF_SPEC} in chunks of {CHUNK}: launches {got} (predicted "
          f"{2 * per_slice} each); max|dTB| vs phase 12's spectrum {d_tb:.3e} "
          f"K (bound 1e-4), equal to the bit: {torch.equal(out, spec_tb)}; "
          f"after the SRF {d_srf:.3e} K")
    check(got == {"absorption_spectral": 2 * per_slice,
                  "downwelling_lb": 2 * per_slice}
          and d_tb <= 1e-4 and d_srf <= 1e-4,
          f"(c) spectral split: {got}, {d_tb} K, {d_srf} K")
    dense_ms = timed_ms(lambda: spectral.forward_spectral(
        spec_profiles, f_spec, (90.0,), "R24", freq_chunk=CHUNK),
        repeats=10)
    split_ms = timed_ms(lambda: sharding.forward_spectral_sharded(
        spec_profiles, f_spec, mesh_s, "R24", (90.0,), freq_chunk=CHUNK),
        repeats=10)
    print(f"phase 22: (c) times (median of 10, {smi}): forward_spectral "
          f"{dense_ms:.4f} ms, forward_spectral_sharded on {mesh_s.shape} "
          f"{split_ms:.4f} ms")

    # (d) the scaling harness and the CLI's bench
    rows, got = run(lambda: scaling.measure(devices=[dev] * 4,
                                            device_counts=(1, 2, 4)),
                    count=False)
    for row in rows:
        print(f"phase 22: (d) scaling.measure, per_device_batch=256 ({smi}): "
              f"{json.dumps(row)}")
    # a warm-up and 3 x 11 timed calls a row, one launch a shard and call
    sweep_want = {"absorption_lb": 34 * 7, "forward_lb": 34 * 7}
    print(f"phase 22: (d) launches during that sweep: {got}")
    check([r["n_devices"] for r in rows] == [1, 2, 4] and got == sweep_want
          and all(r["spectra_per_s"] > 0 for r in rows), f"(d) sweep {got}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (rc, got) = run(lambda: cli(["bench"]), count=False)
    for line in buf.getvalue().splitlines():
        print(f"phase 22: (d) cli bench ({smi}): {line}")
    check(rc == 0 and got == {"absorption_lb": 34, "forward_lb": 34},
          f"(d) cli bench {got}")

    # (e) the dry run on 4 entries of the card
    t0 = time.perf_counter()
    res, got = run(lambda: dryrun.dryrun_multichip(4))
    print(f"phase 22: (e) dryrun_multichip(4): launches {got}, "
          f"{time.perf_counter() - t0:.1f} s; sharded step loss "
          f"{res['loss']:.6f} against {res['loss_unsharded']:.6f}, max|dw| "
          f"{res['w_delta']:.3e}; K {res['k_delta']:.3e} of max |K|")
    check(all(got.get(k, 0) > 0 for k in counted if k != "chain"),
          f"(e) dry run did not reach every kernel: {got}")

    # (f) the literature checkpoints, tb rows on the card and on the CPU
    worst, n_rows = 0.0, 0
    for model in anchors.ALL_RELEASES:
        rows, got = run(lambda: anchors.run_checkpoints(model))
        cpu_rows = anchors.run_checkpoints(model, device="cpu")
        bad = [r["name"] for r in rows if not r["ok"]]
        check(not bad, f"(f) {model} violates its anchors: {bad}")
        check(got == {"absorption_lb": 6, "forward_lb": 6},
              f"(f) {model} launches {got}")
        for r, c in zip(rows, cpu_rows, strict=True):
            d = abs(r["value"] - c["value"])
            check(r["name"] == c["name"]
                  and (d <= 1e-2 if r["kind"] == "tb" else d == 0.0),
                  f"(f) {model} {r['name']}: card {r['value']} cpu "
                  f"{c['value']}")
            if r["kind"] == "tb":
                worst = max(worst, d)
        n_rows += len(rows)
    print(f"phase 22: (f) run_checkpoints, nine releases: {n_rows} rows all "
          f"ok; the tb rows (K1 and K2 6 times a release) within "
          f"{worst:.3e} K of the same call on the CPU (bound 1e-2), the "
          f"other rows equal")
    print(f"phase 22: launches by the sharded entry points, (d) left out: "
          f"{ {k: v for k, v in total.items() if v} }")
    return total



def tools_phase(dev, counted, smi):
    """Phase 23: the port's tools on the card, through the calls a user
    makes: (a) `perf_probe.probe` at B=1024; (b) `make_golden.main` into a
    scratch directory, compared with tests/golden/; (c) `fit_tables.main`
    in float64 on the +4 % h2o_s1 retune and on the per-line ECS
    perturbation of tests/test_golden.py; (d) `campaign_demo.run_chain` at
    the JAX tool's 520 sondes, every stage but the report.  Returns the
    launches of each kernel wrapper in `counted` summed over the tools'
    calls; the references they are compared with are left out."""
    import contextlib
    import hashlib
    import io
    import tempfile

    from mwr_fast_forward_operators_and_lbls_tpu_torch import anchors
    from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
        H2O_MODELS, O2_MODELS)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import netcdf
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.absorption import (
        h2o_absorption, n2_absorption, o2_absorption)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward_stage)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.tools import (
        campaign_demo, fit_tables, make_golden, perf_probe)

    total = dict.fromkeys(counted, 0)

    def run(fn):
        """fn() with every count set to 0 just before it and read just
        after: (result, launches of the kernels it reached, wall s)."""
        for wrapper in counted.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counted.items()}
        for k, v in launches.items():
            total[k] += v
        return res, {k: v for k, v in launches.items() if v}, wall

    golden = ROOT / "tests" / "golden"

    def golden_digest():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(golden.glob("*"))}

    frozen = golden_digest()
    scratch = ROOT / "build" / "torch_kernels"

    # (a) the split of the headline forward
    out, got, wall = run(lambda: perf_probe.probe(B))
    per_call = 1 + perf_probe.ITERS * perf_probe.TRIALS
    want = {"absorption_lb": 2 * per_call + 2, "forward_lb": 2 * per_call + 2}
    print(f"phase 23: (a) perf_probe B={B} L={L} ({smi}), {wall:.1f} s: "
          + json.dumps(out))
    print(f"phase 23: (a) launches {got} (predicted {want}: each device_time "
          f"call runs its function 1 + {perf_probe.ITERS} x "
          f"{perf_probe.TRIALS} times, then K2 once on the timed K1 output "
          f"and forward_batch once); K2 of the timed K1 output equal to the "
          f"bit to forward_batch's tb: {out['k2_of_k1_equals_forward_batch']}")
    check(out["k2_of_k1_equals_forward_batch"],
          "perf_probe: K2 of K1 differs from forward_batch")
    check(got == want, f"perf_probe launches {got}, want {want}")

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)

        # (b) the goldens regenerated on the card
        n_tb = sum(1 + ("relative_to" in cp)
                   for model in anchors.ALL_RELEASES
                   for cp in anchors.CHECKPOINTS
                   if cp["kind"] == "tb" and anchors.applicable(cp, model))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, got, wall = run(lambda: make_golden.main(
                ["--out", str(tmp / "golden")]))
        lines = buf.getvalue().splitlines()
        report = json.loads(lines[-1])
        n_ok = sum(line.lstrip().startswith("[ok ]") for line in lines)
        n_fail = sum(line.lstrip().startswith("[FAIL]") for line in lines)
        print(f"phase 23: (b) make_golden into a scratch directory, "
              f"{wall:.1f} s: {n_ok} checkpoint rows ok, {n_fail} failed, "
              f"over the nine releases; launches {got} (the tb rows: "
              f"{n_tb} forwards); against tests/golden/: {json.dumps(report)}")
        check(rc == 0 and n_fail == 0 and n_ok > 0, f"make_golden rc {rc}, "
              f"{n_fail} rows failed")
        check(got == {"absorption_lb": n_tb, "forward_lb": n_tb},
              f"make_golden launches {got}, want {n_tb} each")
        worst = max(report["absorption_max_rel"].values())
        check(worst <= 1e-9, f"absorption {worst} relative")
        check(report["tb_standard_max_abs_k"] <= 1e-6,
              f"tb_standard {report['tb_standard_max_abs_k']} K")
        check(report["literature_equal"], "literature.json differs")

        # (c) the table fits in float64 on the card
        f = torch.tensor(make_golden.FREQS_GHZ, dtype=torch.float64,
                         device=dev)
        hm, om = fit_tables.apply_scales("R24", {"h2o_s1": 1.04})
        conds = make_golden.CONDITIONS[:4]
        alpha = {}
        for (p, t, rho) in conds:
            e = rho * t / 217.0
            a = (h2o_absorption(f, p, t, rho, hm)
                 + o2_absorption(f, p, t, rho, om)
                 + n2_absorption(f, p - e, t, variant="R24"))
            alpha[f"{p:g}_{t:g}_{rho:g}"] = a.cpu().numpy().tolist()
        (tmp / "retune.json").write_text(json.dumps(
            {"freqs_ghz": make_golden.FREQS_GHZ,
             "conditions": [list(c) for c in conds], "alpha": alpha}))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, got, wall = run(lambda: fit_tables.main(
                ["--golden", str(tmp / "retune.json"), "--steps", "250",
                 "--out", str(tmp / "retune_fit.json")]))
        res = json.loads((tmp / "retune_fit.json").read_text())
        sc = res["scales"]
        golden64 = json.loads((tmp / "retune.json").read_text())
        card20 = fit_tables.fit(golden64, "R24", steps=20)
        cpu20 = fit_tables.fit(golden64, "R24", steps=20, device="cpu")
        d20 = max(abs(card20["scales"][k] / v - 1.0)
                  for k, v in cpu20["scales"].items())
        print(f"phase 23: (c) fit_tables on the card, float64, the +4 % "
              f"h2o_s1 retune, 250 steps ({smi}): wall {wall:.3f} s; h2o_s1 "
              f"{sc['h2o_s1']:.6f} (bounds 1.02-1.06), o2_s {sc['o2_s']:.6f} "
              f"(0.97-1.03); rms log residual "
              f"{res['rms_log_residual_before']:.6e} -> "
              f"{res['rms_log_residual_after']:.6e}; launches {got}; 20 "
              f"steps on the card against 20 on the CPU: max relative "
              f"difference of the scales {d20:.3e} (bound 1e-8)")
        check(res["rms_log_residual_after"]
              < 0.3 * res["rms_log_residual_before"]
              and 1.02 < sc["h2o_s1"] < 1.06 and 0.97 < sc["o2_s"] < 1.03,
              f"retune not recovered: {res}")
        check(not got, f"fit_tables launched kernels: {got}")
        check(d20 <= 1e-8, f"card fit against CPU fit: {d20}")

        base = O2_MODELS["R19"]
        idx = np.arange(base.f.size, dtype=np.float64)
        manifold = (base.f > 50.0) & (base.f < 120.0)
        dy0 = 0.06 * np.max(np.abs(base.y0)) * np.sin(idx / 5.0) * manifold
        dy1 = 0.08 * np.max(np.abs(base.y1)) * np.cos(idx / 7.0) * manifold
        dg0 = 0.10 * max(np.max(np.abs(base.g0)), 0.01) \
            * np.sin(idx / 6.0 + 1.0) * manifold
        truth = dataclasses.replace(base, y0=base.y0 + dy0,
                                    y1=base.y1 + dy1, g0=base.g0 + dg0)
        fv = torch.tensor(np.linspace(50.0, 68.0, 120), dtype=torch.float64,
                          device=dev)
        conds = [(1013.0, 300.0, 5.0), (1013.0, 250.0, 1.0),
                 (700.0, 270.0, 2.0), (400.0, 230.0, 0.2),
                 (850.0, 285.0, 8.0)]
        alpha = {}
        for (p, t, rho) in conds:
            e = rho * t / 217.0
            a = (h2o_absorption(fv, p, t, rho, H2O_MODELS["R19"])
                 + o2_absorption(fv, p, t, rho, truth)
                 + n2_absorption(fv, p - e, t, variant="R19"))
            alpha[f"{p:g}_{t:g}_{rho:g}"] = a.cpu().numpy().tolist()
        (tmp / "ecs.json").write_text(json.dumps(
            {"freqs_ghz": fv.cpu().numpy().tolist(),
             "conditions": [list(c) for c in conds], "alpha": alpha}))
        steps = 900
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, got, wall = run(lambda: fit_tables.main(
                ["--golden", str(tmp / "ecs.json"), "--model", "R19",
                 "--per-line", "--steps", str(steps), "--lr", "0.02",
                 "--l2", "1e-4", "--smooth", "1e-4",
                 "--out", str(tmp / "ecs_fit.json")]))
        res = json.loads((tmp / "ecs_fit.json").read_text())
        fit_y0 = np.asarray(res["deltas"]["y0"])
        w = manifold & (np.abs(dy0) > 0.2 * np.max(np.abs(dy0)))
        corr = float(np.corrcoef(fit_y0[w], dy0[w])[0, 1])
        rel_l2 = float(np.linalg.norm(fit_y0[w] - dy0[w])
                       / np.linalg.norm(dy0[w]))
        print(f"phase 23: (c) fit_tables --per-line on the card, float64, "
              f"the R19 ECS-like perturbation, {steps} steps ({smi}): wall "
              f"{wall:.3f} s = {1e3 * wall / steps:.3f} ms a step; rms log "
              f"residual {res['rms_log_residual_before']:.6e} -> "
              f"{res['rms_log_residual_after']:.6e} (bound 1e-3 and 5 % of "
              f"before); y0 deltas against the injected: correlation "
              f"{corr:.4f} (bound 0.9), relative L2 {rel_l2:.4f} (bound "
              f"0.5); launches {got}")
        check(res["rms_log_residual_after"] < 1e-3
              and res["rms_log_residual_after"]
              < 0.05 * res["rms_log_residual_before"]
              and corr > 0.9 and rel_l2 < 0.5, f"per-line refit: {corr} "
              f"{rel_l2} {res['rms_log_residual_after']}")
        check(not got, f"fit_tables --per-line launched kernels: {got}")

        # (d) the campaign chain at the JAX tool's scale, the report left out
        work = tmp / "campaign"
        if importlib.util.find_spec("matplotlib") is None:
            rc = campaign_demo.main(["--workdir", str(work)])
            print(f"phase 23: (d) matplotlib does not import on this host: "
                  f"campaign_demo.main returned {rc} before any work (the "
                  f"full report draws figures); its stages but the report "
                  f"follow, through campaign_demo.run_chain")
            check(rc == 2 and not work.exists(),
                  f"campaign_demo without matplotlib: rc {rc}")
        n_sondes = N_CAMPAIGN_SONDES
        timings = {}
        (ds, dims, params), got, wall = run(lambda: campaign_demo.run_chain(
            str(work), n_sondes, STAGE_MODELS, None, timings))
        timings["total_s"] = wall
        chunks = 2 * -(-dims["time"] // 256)
        want = {"absorption_lb": len(STAGE_MODELS) * chunks + 1,
                "forward_lb": (len(STAGE_MODELS) + 1) * chunks}
        summary = {"n_sondes_requested": n_sondes, "dims": dims,
                   "backend": torch.cuda.get_device_name(dev),
                   "models": list(STAGE_MODELS) + ["Fast"],
                   "n_forward_spectra": campaign_demo.n_spectra(
                       dims, STAGE_MODELS),
                   "timings_s": timings}
        print(f"phase 23: (d) campaign_demo.run_chain, {n_sondes} sondes, "
              f"{STAGE_MODELS} + fast, every stage but the report ({smi}): "
              f"launches {got} (predicted {want}: {chunks} chunks of 256 "
              f"over {dims['time']} times x 2 crops, K1 once more for the "
              f"fit); stage walls: " + "; ".join(
                  f"{k} {v:.4f}" for k, v in timings.items()))
        print("phase 23: (d) summary " + json.dumps(summary))
        check(got == want, f"campaign launches {got}, want {want}")
        harm = netcdf.read(str(work / "harmonized.nc"))
        direct = stage_outputs(forward_stage(harm, STAGE_MODELS, params))
        results = stage_outputs(netcdf.read(str(work / "results.nc")))
        bad = [k for k, v in direct.items() if not same_data(v, results[k])]
        check(set(results) == set(direct) and not bad,
              f"results.nc differs from forward_stage: {bad}")
        check(all(np.isfinite(v).all() for v in results.values())
              and results["TBs_LBL_R24"].shape == (dims["time"], 14, 10, 2),
              "campaign results not finite or of another shape")
        check("Deviations_Fast_R24" in ds and "cloud_flag" in ds,
              "analysis dataset")
        print(f"phase 23: (d) results.nc: {sorted(results)} each equal to "
              f"the bit to forward_stage called directly on harmonized.nc "
              f"with the chain's weights; finite; analysis.nc "
              f"{len(ds.variables)} variables")
    check(golden_digest() == frozen, "tests/golden/ changed")
    print(f"phase 23: tests/golden/ unchanged ({len(frozen)} files); "
          f"launches by the tools: "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


def bench_py_keys():
    """The root bench.py's JSON keys, read from its text: the top keys, the
    keys of `extra`, and the keys of its two decompositions."""
    import ast

    tree = ast.parse((ROOT / "bench.py").read_text())
    top, extra, decomp = set(), set(), {}
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Dict)):
                keys = {k.value for k in node.value.keys}
                if node.targets[0].id == "result":
                    top |= keys
                elif node.targets[0].id == "decomp":
                    decomp[fn.name] = keys
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.value, ast.Name)
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.ctx, ast.Store)):
                if node.value.id == "result":
                    top.add(node.slice.value)
                elif node.value.id == "extra":
                    extra.add(node.slice.value)
    return top, extra, {"spectral_decomp_ms": decomp["bench_spectral"],
                        "kmatrix_decomp_ms": decomp["bench_kmatrix"]}


def bench_phase(dev, counted, smi):
    """Phase 24: the port's bench.  (a) `python -m ...bench --quick` in a
    process of its own; (b) the full bench in this process at bench.py's
    sizes, its line against bench.py's keys, every timed output against its
    entry point called directly on the same inputs, and the launches it
    made.  Returns those launches of each kernel wrapper in `counted`."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch import bench
    from mwr_fast_forward_operators_and_lbls_tpu_torch.data import preprocess
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        fast, jacobians, lbl, retrieval, spectral)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (  # noqa: E501
        absorption_tangents_lb)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
        downwelling_lb)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.spectral import (  # noqa: E501
        absorption_spectral)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
        forward as fwd)

    top, extra_keys, decomp = bench_py_keys()

    # (a) --quick in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench", "--quick"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"bench --quick exit {proc.returncode}: {proc.stderr[-2000:]}")
    quick = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"phase 24: (a) python -m {PKG}.bench --quick, {wall:.1f} s "
          f"({smi}): {json.dumps(quick)}")
    check(set(quick) == top - {"extra"}, f"--quick keys {sorted(quick)}")

    # (b) the full bench in this process
    for wrapper in counted.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    result, runs = bench.measure()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted.items()}
    print(f"phase 24: (b) bench.measure() at bench.py's sizes, {wall:.1f} s "
          f"({smi}): {json.dumps(result)}")
    extra = result["extra"]
    check(set(result) == top, f"bench keys {sorted(result)}")
    check(set(extra) == extra_keys | {"device", "power_limit_w"},
          f"extra keys {sorted(extra)}")
    for name, keys in decomp.items():
        check(set(extra[name]) == keys, f"{name} keys {sorted(extra[name])}")
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    check(extra["device"] == name
          and extra["power_limit_w"] == float(limit.split()[0]),
          f"device {extra['device']} {extra['power_limit_w']}, smi {smi}")

    def flat(tree, prefix=""):
        """The line's numbers (and nulls) by dotted key; the text keys
        left out."""
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            elif k not in ("metric", "unit", "device", "note"):
                yield prefix + k, v

    numbers = dict(flat(result))
    bad = {k: v for k, v in numbers.items()
           if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0)}
    check(not bad, f"bench numbers not finite and > 0: {bad}")
    over = {k: v for k, v in numbers.items()
            if k.endswith("_roofline_frac") and v > 1.0}
    check(not over, f"a time under its bound: {over}")

    def calls(which):
        iters, trials = bench.TIMING[which]
        return 1 + iters * trials

    spec_chunks = -(-bench.N_FREQS // bench.FREQ_CHUNK)
    stage_chunks = -(-bench.N_STAGE_TIME // bench.STAGE_BATCH)
    stage_calls = 4 * 2 * stage_chunks       # 2 payloads x (warm, timed)
    n_iter = runs["retrieval"].inputs["config"].n_iter
    want = {
        # headline, forward at B=256, distillation targets and fit, the
        # serving and retrieval fits, the stage, crop 0's chunk loop
        "absorption_lb": (calls("headline") + calls("forward_256") + 2 + 1
                          + 1 + stage_calls
                          + calls("stage_device") * stage_chunks),
        # the same but the fits, serving, the retrieval's observations and
        # its n_iter + 1 forwards a call
        "forward_lb": (calls("headline") + calls("forward_256") + 1
                       + calls("serving") + 1
                       + calls("retrieval") * (n_iter + 1) + stage_calls
                       + calls("stage_device") * stage_chunks
                       + calls("distill") + 3),
        # the distillation: its optimizer's first step warms the graphed
        # loss up three times, forward and backward, and captures it, which
        # launches nothing; each step then replays one K2 and one K2v
        "forward_lb_vjp": calls("distill") + 3,
        "absorption_tangents_lb": calls("kmatrix") + calls("kmatrix_parts"),
        "kmatrix_assembled_lb": calls("kmatrix") + calls("kmatrix_parts"),
        "kmatrix_assembled_rho_lwc_lb": calls("kmatrix"),
        "absorption_spectral": (calls("spectral") * spec_chunks
                                + 2 * calls("spectral_parts")),
        "downwelling_lb": (calls("spectral") * spec_chunks
                           + calls("spectral_parts")),
        "chain": 0}
    print(f"phase 24: (b) launches_bench {launches} (predicted {want})")
    check(launches == want, f"bench launches {launches}, want {want}")

    # each timed output against its entry point called directly
    same = {}

    def equal(what, a, b):
        same[what] = bool(torch.equal(a, b))

    run = runs["headline"]
    equal("forward_batch", run.out["tb"], lbl.forward_batch(
        run.inputs["profiles"], run.inputs["config"])["tb"])

    run, inp = runs["spectral"], runs["spectral"].inputs
    whole = spectral.forward_spectral(
        inp["profiles"], inp["f_ghz"], inp["elevations_deg"], "R24",
        freq_chunk=bench.FREQ_CHUNK)
    equal("forward_spectral + srf_convolve", run.out["tb_srf"],
          spectral.srf_convolve(whole["tb"], inp["weights"]))
    lev = inp["levels"]
    equal("K6 alone", run.out["alpha"], absorption_spectral(
        inp["f_chunk"], lev["p"], lev["t"], lev["rho"], lev["lwc"], "R24"))
    chunk = downwelling_lb(inp["f_chunk"], run.out["alpha"], inp["ds"],
                           lev["t"])
    for k in ("tb", "tau_total"):
        equal(f"chunk {k} = K3 of the timed K6", run.out["chunk"][k],
              chunk[k])
        equal(f"chunk {k} = the spectrum's first chunk",
              run.out["chunk"][k].permute(2, 0, 1),
              whole[k][..., :bench.FREQ_CHUNK])

    run, inp = runs["kmatrix"], runs["kmatrix"].inputs
    k = jacobians.kmatrix_batch_fast(inp["profiles"], inp["config"],
                                     inp["wrt"])
    for n in inp["wrt"]:
        equal(f"kmatrix_batch_fast {n}", run.out["k"][n], k[n])
    equal("forward_batch B=256", run.out["tb"], lbl.forward_batch(
        inp["profiles"], inp["forward_config"])["tb"])
    for i, a in enumerate(absorption_tangents_lb(
            inp["config"].freqs_ghz, *inp["tangent_args"],
            inp["config"].model)):
        equal(f"K4 alone [{i}]", run.out["tangents"][i], a)
    equal("K5a alone = the K-matrix's k_t",
          run.out["k_t_lb"].permute(3, 0, 1, 2), k["t"])

    run, inp = runs["distill"], runs["distill"].inputs
    params = {"w": inp["w0"].clone()}
    optimizer = fast.make_optimizer(params)
    for _ in range(run.out["steps"]):
        loss = fast.train_step(params, optimizer, inp["profiles"],
                               inp["targets"], inp["config"])
    equal(f"train_step x {run.out['steps']}: loss", run.out["loss"], loss)
    equal(f"train_step x {run.out['steps']}: w", run.out["w"],
          params["w"].detach())

    run, inp = runs["serving"], runs["serving"].inputs
    res = fast.fast_forward_batch(inp["params"], inp["profiles"],
                                  inp["config"])
    for n in ("tb", "tau_total"):
        equal(f"fast_forward_batch {n}", run.out[n], res[n])

    run, inp = runs["retrieval"], runs["retrieval"].inputs
    res = retrieval.retrieve_batch(
        inp["params"], inp["tb_obs"], inp["z"], inp["p"], inp["t_prior"],
        inp["rho_prior"], inp["config"], inp["lwc"])
    for n in ("t", "rho"):
        equal(f"retrieve_batch {n}", run.out[n], res[n])
    check(all(bool(torch.isfinite(v).all()) for v in run.out.values()),
          "retrieval not finite")

    run = runs["stage"]
    ds, cfg = run.inputs["dataset"], lbl.LBLConfig(outputs=("tb",))
    for key, compress in (("stage", False), ("stage_f16", True)):
        got = run.out[key]["TBs_LBL_R24"]
        direct = np.empty_like(got)
        for crop in (0, 1):
            prof, ref = fwd._upload(fwd._screen(
                preprocess.profiles_for_forward(ds, crop=crop))[0],
                compress, dev)
            if ref is not None:
                prof = {k: v.float() + ref[k][None, :]
                        for k, v in prof.items()}
            for s in range(0, bench.N_STAGE_TIME, bench.STAGE_BATCH):
                tb = lbl.forward_batch(
                    {k: v[s:s + bench.STAGE_BATCH] for k, v in prof.items()},
                    cfg)["tb"]
                direct[s:s + bench.STAGE_BATCH, ..., crop] = (
                    tb.permute(0, 2, 1).cpu().numpy())
        equal(f"forward_stage ({key}) = forward_batch a chunk",
              torch.from_numpy(got), torch.from_numpy(direct))
    equal("crop 0's chunk loop = the stage's crop 0",
          run.out["device"]["R24"].cpu(),
          torch.from_numpy(run.out["stage"]["TBs_LBL_R24"][..., 0]))
    print(f"phase 24: (b) each timed output equal to the bit to its entry "
          f"point called directly on the same inputs: {same}")
    check(all(same.values()), f"bench outputs differ: "
          f"{[k for k, v in same.items() if not v]}")
    return launches


MP3000A = (22.234, 22.5, 23.034, 23.834, 25.0, 26.234, 28.0, 30.0, 51.248,
           51.76, 52.28, 52.804, 53.336, 53.848, 54.4, 54.94, 55.5, 56.02,
           56.66, 57.288, 57.964, 58.8)
B_ARCHIVE = 4096        # the archive cells' batch (mwrbench)


# HATPRO's digests as `hatpro_digests` printed them at commit a275ac1, the
# last version whose K1 and K4 took at most 16 channels, on an NVIDIA H100
# 80GB HBM3; the phase holds every later version to them on that card.  A
# change meant to move HATPRO's TBs or K (any kernel or step they pass
# through) records its own digests here, with its commit.
HATPRO_DIGESTS = ("NVIDIA H100 80GB HBM3",
                  {"tb": "ca4aa251f50f39bc", "k": "ce03e07481823ef4"})


def hatpro_digests(dev) -> dict:
    """sha256 (first 16 hex digits) of HATPRO's 14-channel TBs from
    `forward_batch` (B=1024, R24) and of its K-matrix wrt (t, rho, lwc)
    (B=256), on seeded demo profiles: a version whose K1 and K4 bodies at 16
    channels and fewer are unchanged prints the same."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        jacobians, lbl)
    cfg = lbl.LBLConfig(model="R24")
    tb = lbl.forward_batch(lbl.demo_batch(B, L, seed=25, device=dev),
                           cfg)["tb"]
    kmat = jacobians.kmatrix_batch_fast(
        lbl.demo_batch(BK, L, seed=26, device=dev), cfg, wrt=WRT)

    def digest(*tensors):
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]
    return {"tb": digest(tb), "k": digest(*(kmat[w] for w in WRT))}


def mp3000a_phase(dev, smi, ptxas, peaks) -> dict:
    """Phase 25: the Radiometrics MP-3000A's 22 channels, past the 16 that
    K1 and K4 took before.  K1's body at 22 channels and K2 at the archive
    cells' B=4096 x 180, K4 in three groups of 8 slots at the K-matrix's
    B=256: their registers and spills, resident warps, wrapper time, time
    in a graph and their plain versions' time, their bounds at the
    published peaks and at phase 14's measured `peaks`, and agreement with
    the plain versions; the entry points' launches at a batch of 4n (K2's
    16-byte copies) and of 4n + 2 (its 4-byte copies); HATPRO's digests
    against `HATPRO_DIGESTS`.  Returns the launch counts."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        jacobians, lbl)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (geometry,
                                                                   thermo)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        absorption as k1_mod)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (  # noqa: E501
        absorption_lb, absorption_lb_float64, absorption_lb_reference,
        absorption_tangents_lb, absorption_tangents_lb_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
        forward_lb, forward_lb_body, forward_lb_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
        profiling)
    nf = len(MP3000A)
    per = k1_mod.tangent_groups(nf)
    for src, name, report in ptxas:
        wide = src.startswith("absorption_f")   # K1's bodies past 16
        if wide or name == f"absorption_tangents_kernel<{per[1]}>":
            if not wide or name.endswith(f"<{nf}>"):
                print(f"phase 25: ptxas: {src} {name}: {report}")
            check(not re.search(r"[1-9]\d* bytes spill", report),
                  f"{name} spills: {report}")
    for what, w, least in (
            ("K1", k1_mod.resident_warps(nf, "R24"), 20),
            ("K4", k1_mod.tangent_resident_warps(nf, "R24"), 24)):
        print(f"phase 25: {what} at {nf} channels: {w} warps resident per SM")
        check(w >= least, f"{what} at {nf} channels: {w} warps per SM")
    print(f"phase 25: K1 one launch of its body at {nf} channels; K4 "
          f"{per[0]} groups of {per[1]} slots on the grid's y axis")

    def bound_line(kid, roof, ms, device_ms):
        """The bound at the published peaks and at the measured rates, and
        the shares of the wrapper's and of the graph's time."""
        b_pub = roof.time_bound_s() * 1e3
        b_meas = roof.time_bound_s(peaks) * 1e3
        check(b_pub <= device_ms and b_meas <= device_ms,
              f"{kid} at {nf} channels runs under its bound in a graph")
        return (f"bound {b_pub:.4f} ms by {roof.bound_by()} at the published "
                f"peaks (share {b_pub / ms:.4f}, {b_pub / device_ms:.4f} in a "
                f"graph), {b_meas:.4f} ms by {roof.bound_by(peaks)} at the "
                f"measured rates (share {b_meas / ms:.4f}, "
                f"{b_meas / device_ms:.4f} in a graph)")

    # K1 and K2 at the archive cells' shape
    prof = level_major(lbl.demo_batch(B_ARCHIVE, L, device=dev))
    args = (MP3000A, prof["p"], prof["t"], prof["rho"], prof["lwc"], "R24")
    before = absorption_lb.launches
    alpha = absorption_lb(*args)
    check(absorption_lb.launches - before == 1, "K1 at 22 channels: one "
          "launch")
    plain = absorption_lb_reference(*args)
    sub = tuple(a[:, :64].contiguous() if torch.is_tensor(a) else a
                for a in args)
    want64 = absorption_lb_float64(*sub)
    torch.cuda.synchronize()
    scale = plain.abs().amax(dim=(1, 2))
    err = float(((alpha - plain).abs().amax(dim=(1, 2)) / scale).max())
    err64 = float(((alpha[:, :, :64].double() - want64).abs().amax(dim=(1, 2))
                   / want64.abs().amax(dim=(1, 2))).max())
    check(err <= 1e-4 and err64 <= 5e-6, f"K1 at 22 channels: {err}, {err64}")
    del plain
    k1_ms = timed_ms(lambda: absorption_lb(*args))
    k1_plain_ms = timed_ms(lambda: absorption_lb_reference(*args))
    k1_graph = graph_ms(lambda: absorption_lb(*args))
    k1_14_graph = graph_ms(lambda: absorption_lb(lbl.LBLConfig().freqs_ghz,
                                                 *args[1:]))
    ceiling = tuple(np.linspace(22.24, 58.0, k1_mod.MAX_CHANNELS).tolist())
    k1_32_graph = graph_ms(lambda: absorption_lb(ceiling, *args[1:]))
    print(f"phase 25: K1 B={B_ARCHIVE} L={L} F={nf}: worst per-channel share "
          f"{err:.3e} of the plain version, {err64:.3e} of float64 on its "
          f"tables (64 profiles); kernel {k1_ms:.4f} ms ({k1_graph:.4f} ms "
          f"in a graph; F=14: {k1_14_graph:.4f} ms; F={len(ceiling)}: "
          f"{k1_32_graph:.4f} ms), plain {k1_plain_ms:.4f} ms; "
          + bound_line("K1", profiling.k1_roofline(B_ARCHIVE * L, MP3000A),
                       k1_ms, k1_graph))

    # K2 on the same alpha, against its plain version as phase 2 holds it
    n = geometry.refractive_index(prof["p"], prof["t"],
                                  thermo.rho_to_e(prof["rho"], prof["t"]))
    elevs = lbl.LBLConfig().elevations_deg
    k2_args = (MP3000A, elevs, alpha, prof["z"], n, prof["t"])
    body = forward_lb_body(alpha, len(elevs))
    check(body == "staged", f"K2 at B={B_ARCHIVE}: the {body} body")
    got = forward_lb(*k2_args)["tb"]
    ref = forward_lb_reference(*k2_args)["tb"]
    ref64 = forward_lb_reference(*(a.double() if torch.is_tensor(a) else a
                                   for a in k2_args))["tb"]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K2 at 22 channels: not finite")
    k2_err = float((got - ref).abs().max())
    k2_err64 = float((got.double() - ref64).abs().max())
    check(k2_err <= 5e-3 and k2_err64 <= 2e-3,
          f"K2 at 22 channels: max|dtb| {k2_err} K, {k2_err64} K vs float64")
    del got, ref, ref64
    k2_ms = timed_ms(lambda: forward_lb(*k2_args))
    k2_plain_ms = timed_ms(lambda: forward_lb_reference(*k2_args))
    k2_graph = graph_ms(lambda: forward_lb(*k2_args))
    ds_scan = torch.stack([geometry.chord_lengths(prof["z"], n, c) for c in
                           torch.cos(torch.deg2rad(torch.tensor(
                               elevs, device=dev)))])
    small_k2 = profiling.small_dtau_share(
        (0.5 * (alpha[:, :-1] + alpha[:, 1:]))[None] * ds_scan[:, None])
    planck_k2 = profiling.planck_series_share(MP3000A, prof["t"])
    del ds_scan
    print(f"phase 25: K2 B={B_ARCHIVE} E={len(elevs)} F={nf} L={L}, the "
          f"{body} body: max|d tb| {k2_err:.3e} K against the plain version, "
          f"{k2_err64:.3e} K against it in float64; kernel {k2_ms:.4f} ms "
          f"({k2_graph:.4f} ms in a graph), plain {k2_plain_ms:.4f} ms; "
          + bound_line("K2", profiling.k2_roofline(
              B_ARCHIVE, L, nf, len(elevs), small_dtau_fraction=small_k2,
              planck_series_fraction=planck_k2), k2_ms, k2_graph))
    cfg = lbl.LBLConfig(model="R24", freqs_ghz=MP3000A, outputs=("tb",))
    del alpha, n, prof
    profiles = lbl.demo_batch(B_ARCHIVE, L, device=dev)
    fwd_ms = timed_ms(lambda: lbl.forward_batch(profiles, cfg))
    print(f"phase 25: forward_batch B={B_ARCHIVE} F={nf}: {fwd_ms:.4f} ms = "
          f"{B_ARCHIVE * len(elevs) / (fwd_ms * 1e-3):.6g} spectra/s ({smi})")
    del profiles

    # K4 at the K-matrix's shape
    kprof = level_major(lbl.demo_batch(BK, L, device=dev))
    kargs = (MP3000A, kprof["p"], kprof["t"], kprof["rho"], kprof["lwc"],
             "R24")
    before = absorption_tangents_lb.launches
    got = absorption_tangents_lb(*kargs)
    check(absorption_tangents_lb.launches - before == 1,
          "K4 at 22 channels: one launch")
    want = absorption_tangents_lb_reference(*kargs)
    torch.cuda.synchronize()
    k4_err = [float(((g - w).abs().amax(dim=(1, 2))
                     / w.abs().amax(dim=(1, 2))).max())
              for g, w in zip(got, want)]
    check(k4_err[0] <= 1e-4 and max(k4_err[1:]) <= 1e-3,
          f"K4 at 22 channels: {k4_err}")
    del got, want
    # timed as phase 4 times K4 at 14 channels: without dalpha/dLWC, and
    # with it in a graph
    k4_ms = timed_ms(lambda: absorption_tangents_lb(*kargs))
    k4_plain_ms = timed_ms(lambda: absorption_tangents_lb_reference(*kargs))
    k4_graph = graph_ms(lambda: absorption_tangents_lb(*kargs))
    k4_lwc_graph = graph_ms(lambda: absorption_tangents_lb(*kargs,
                                                           with_lwc=True))
    print(f"phase 25: K4 B={BK} L={L} F={nf}: worst per-channel share of the "
          f"plain version alpha {k4_err[0]:.3e}, d/dT {k4_err[1]:.3e}, "
          f"d/drho {k4_err[2]:.3e}; kernel {k4_ms:.4f} ms ({k4_graph:.4f} ms "
          f"in a graph; with dalpha/dLWC {k4_lwc_graph:.4f} ms), plain "
          f"{k4_plain_ms:.4f} ms; "
          + bound_line("K4", profiling.k4_roofline(BK * L, MP3000A), k4_ms,
                       k4_graph))

    # the entry points: launches, against the plain path in float64, at a
    # batch K2 copies in 16-byte pieces and at one it copies in 4-byte ones
    names = ("absorption_lb", "forward_lb", "absorption_tangents_lb",
             "slant_geometry_lb", "kmatrix_assembled_lb",
             "kmatrix_assembled_rho_lwc_lb")
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        adjoint, geometry as kgeo, rte)
    counters = (absorption_lb, rte.forward_lb, absorption_tangents_lb,
                kgeo.slant_geometry_lb, adjoint.kmatrix_assembled_lb,
                adjoint.kmatrix_assembled_rho_lwc_lb)
    kcfg = lbl.LBLConfig(model="R24", freqs_ghz=MP3000A)
    cfg64 = dataclasses.replace(kcfg, dtype="float64", use_kernels=False)
    launched = {}
    for batch in (128, 130):
        before = [c.launches for c in counters]
        small = lbl.demo_batch(batch, L, device=dev)
        tb = lbl.forward_batch(small, kcfg)["tb"]
        sweep = lbl.forward_all_models(small, kcfg)
        kmat = jacobians.kmatrix_batch_fast(small, kcfg, wrt=WRT)
        launched = {nm: c.launches - b for nm, c, b in zip(names, counters,
                                                           before)}
        check(list(launched.values()) == [5, 5, 1, 1, 1, 1],
              f"launches at 22 channels, B={batch}: {launched}")
        s64 = {k: v.double() for k, v in small.items()}
        d_tb = float((tb.double() - lbl.forward_batch(s64, cfg64)["tb"])
                     .abs().max())
        d_sweep = max(float((sweep[m].double() - lbl.forward_batch(
            s64, dataclasses.replace(cfg64, model=m))["tb"]).abs().max())
            for m in sweep)
        want_k = jacobians.kmatrix_batch_fast(s64, cfg64, wrt=WRT)
        k_err = {w: k_error(kmat[w], want_k[w]) for w in WRT}
        check(d_tb <= 1e-2 and d_sweep <= 1e-2 and max(k_err.values()) <= 1e-3,
              f"entry points at 22 channels, B={batch}: {d_tb}, {d_sweep}, "
              f"{k_err}")
        body = "staged" if batch % 4 == 0 else "staged, 4-byte copies"
        print(f"phase 25: launches by forward_batch, forward_all_models (4 "
              f"releases) and kmatrix_batch_fast at 22 channels, B={batch} "
              f"(K2's {body} body): {launched}; K4's groups a launch "
              f"{per[0]}; max|dTB| "
              f"vs the plain path in float64 {d_tb:.3e} K (the sweep "
              f"{d_sweep:.3e} K); K against it {k_err}")
    digests = hatpro_digests(dev)
    card, parent = HATPRO_DIGESTS
    if torch.cuda.get_device_name(dev) == card:
        check(digests == parent, f"HATPRO's digests {digests} are not "
              f"{parent}: its TBs or K changed (K1 or K4 at 16 channels "
              f"and fewer, or another step of theirs)")
        print(f"phase 25: HATPRO digests (14 channels, R24): {digests}, "
              f"equal to a275ac1's on the {card}")
    else:
        print(f"phase 25: HATPRO digests (14 channels, R24): {digests}; "
              f"a275ac1's were taken on the {card}, not compared")
    return launched


def distill_phase(dev, smi, params, teacher_cfg, peaks):
    """Phase 19's distillation at the benchmark cell's minibatch
    (`hatpro_distill_b4096`: B=4096 x 180 levels, 10 elevations, 14
    channels): `fast.train_step` on the kernel path (K2 forward, K2v
    backward, replayed as CUDA graphs after the first step) beside the
    plain path (autograd of the plain RTE), each with its first step's
    launches of K2 and K2v and those of its later steps, its time, its
    peak memory above the live tensors, and one step checked as the cell
    checks it (`mwrbench/drivers/distill.py::step_numbers`: the loss, the
    gradient against the float64 transposed Jacobian applied to the step's
    own cotangent, the weights against Adam's step replayed in float64),
    beside the cell's limits; then K2v alone against its
    plain version in float64 on 256 profiles, and in a CUDA graph against
    its bound (`mwrbench/rooflines/distill.py`)."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast, lbl
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (geometry,
                                                                   thermo)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
        forward_lb, forward_lb_vjp, forward_lb_vjp_reference)
    from mwrbench import manifest
    from mwrbench.drivers import distill as distill_driver
    from mwrbench.rooflines import distill as distill_counts

    limits = manifest.read_json(
        manifest.workload_path("hatpro_distill_b4096"))["limits"]
    bd = 4096
    prof = lbl.demo_batch(bd, L, seed=27, device=dev)
    targets = lbl.forward_batch(prof, teacher_cfg)["tb"]
    host = {k: v.cpu().numpy() for k, v in prof.items()}
    cfg = fast.FastConfig()
    rows = {}
    for what, c in (("kernels", cfg),
                    ("plain", dataclasses.replace(cfg, use_kernels=False))):
        sp = {"w": params["w"].clone()}
        opt = fast.make_optimizer(sp)
        before = (forward_lb.launches, forward_lb_vjp.launches)
        # the first step's peak: on the kernel path its warm-up and the
        # graphs' memory, which the later steps keep
        peak = peak_mib(lambda: fast.train_step(sp, opt, prof, targets, c))
        launched = (forward_lb.launches - before[0],
                    forward_lb_vjp.launches - before[1])
        before = (forward_lb.launches, forward_lb_vjp.launches)
        ms = timed_ms(lambda: fast.train_step(sp, opt, prof, targets, c),
                      repeats=10, warmup=2)
        later = (forward_lb.launches - before[0],
                 forward_lb_vjp.launches - before[1])
        w = sp["w"]
        state = opt.state[w]
        out = {"before": torch.stack([w.detach(), state["exp_avg"],
                                      state["exp_avg_sq"]]).cpu(),
               "t0": int(state["step"])}
        out["loss"] = fast.train_step(sp, opt, prof, targets, c).cpu()
        out.update(grad=w.grad.cpu(), w1=w.detach().cpu())
        cot = distill_driver.program_cotangent(
            c, out["before"][0], host, targets.cpu().numpy(), dev)
        nums = distill_driver.step_numbers(
            out, host, targets.cpu().numpy(), cot, cfg.freqs_ghz,
            cfg.elevations_deg, opt.defaults["lr"], dev)
        rows[what] = (ms, peak)
        print(f"phase 19: distillation step B={bd} x {L} levels, {what}: "
              f"{ms:.4f} ms = {bd / (ms * 1e-3):.6g} profiles/s ({smi}); "
              f"first step's peak {peak:.1f} MiB above the live tensors; "
              f"launches of K2, K2v in the first step {launched}, in the "
              f"12 steps after it {later}; step {out['t0'] + 1} checked as "
              f"the cell checks it: {nums} (the cell's limits {limits})")
        # the kernels' first step warms the pipeline up three times and
        # captures it (`fast._graphed_loss`), then replays it, as every
        # later step does
        check(launched == ((4, 4) if what == "kernels" else (0, 0)),
              f"distillation step {what}: launches {launched}")
        check(later == ((12, 12) if what == "kernels" else (0, 0)),
              f"distillation steps {what}: launches {later}")
        check(all(nums[k] <= limits[k] for k in limits),
              f"distillation step {what}: {nums}")
    print(f"phase 19: distillation step B={bd}: kernels "
          f"{rows['kernels'][0]:.4f} ms against plain {rows['plain'][0]:.4f} "
          f"ms ({rows['plain'][0] / rows['kernels'][0]:.2f} x); peak "
          f"{rows['kernels'][1]:.1f} against {rows['plain'][1]:.1f} MiB")
    check(rows["kernels"][1] < rows["plain"][1],
          f"kernel step's peak {rows['kernels'][1]} MiB")

    # K2v alone: against its plain version in float64 on 256 profiles,
    # then at the minibatch in a graph against its bound
    lev = level_major(prof)
    n = geometry.refractive_index(lev["p"], lev["t"],
                                  thermo.rho_to_e(lev["rho"], lev["t"]))
    alpha = fast.serving_extinction(params, lev["p"], lev["t"], lev["rho"],
                                    lev["lwc"])
    cot = torch.randn(len(cfg.elevations_deg), len(cfg.freqs_ghz), bd,
                      generator=torch.Generator().manual_seed(19)).to(dev)
    args = (cfg.freqs_ghz, cfg.elevations_deg, alpha, lev["z"], n, lev["t"],
            cot)
    few = [a[..., :256].contiguous() if torch.is_tensor(a) else a
           for a in args]
    got = forward_lb_vjp(*few)
    want = forward_lb_vjp_reference(*(a.double() if torch.is_tensor(a)
                                      else a for a in few))
    k2v_err = float(((got.double() - want).abs().amax(1)
                     / want.abs().amax(1)).max())
    k2v_ms = timed_ms(lambda: forward_lb_vjp(*args))
    k2v_graph = graph_ms(lambda: forward_lb_vjp(*args))
    k2v_plain_ms = timed_ms(lambda: forward_lb_vjp_reference(*args),
                            repeats=5, warmup=1)
    need = distill_counts.k2v_roofline(bd, L, len(cfg.freqs_ghz),
                                       len(cfg.elevations_deg))
    coded = distill_counts.k2v_roofline(bd, L, len(cfg.freqs_ghz),
                                        len(cfg.elevations_deg),
                                        as_coded=True)
    b_pub, b_meas = need.time_bound_s() * 1e3, need.time_bound_s(peaks) * 1e3
    print(f"phase 19: K2v B={bd} E={len(cfg.elevations_deg)} "
          f"C={len(cfg.freqs_ghz)} L={L}: worst (channel, profile) column's "
          f"max|dL/dalpha - plain float64| / its max, 256 profiles, "
          f"{k2v_err:.3e} (bound 1e-3); {k2v_ms:.4f} ms, in a graph "
          f"{k2v_graph:.4f} ms, the plain version {k2v_plain_ms:.4f} ms; bound {b_pub:.4f} ms by {need.bound_by()} "
          f"(share {b_pub / k2v_graph:.3f}), at the measured rates "
          f"{b_meas:.4f} ms (share {b_meas / k2v_graph:.3f}); as coded "
          f"{coded.time_bound_s() * 1e3:.4f} ms by {coded.bound_by()}")
    check(k2v_err <= 1e-3, f"K2v error {k2v_err}")
    check(0.0 < b_pub / k2v_graph <= 1.0, f"K2v share {b_pub / k2v_graph}")


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
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.fastk import (
        fastk_adjoint, fastk_adjoint_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.geometry import (  # noqa: E501
        slant_geometry_lb, slant_geometry_lb_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
        profiling)
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
        forward_lb_body, forward_lb_reference, forward_lb_vjp,
        forward_lb_vjp_reference, staged_resident_warps)
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
    print("phase 0: importable on this host: " + ", ".join(
        f"{m} {importlib.util.find_spec(m) is not None}"
        for m in ("matplotlib", "h5py")))
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"phase 0: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({lib_path.name})")
    for src, name, report in ptxas_report(
            lib_path.with_suffix(".log").read_text()):
        print(f"phase 0: ptxas: {src} {name}: {report}")
        if src in ("adjoint.cu", "absorption_tangents.cu", "fastk.cu",
                   "rte_vjp.cu"):
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
    # dalpha/dLWC as K4's fourth output, against the liquid term in float64
    # on the same float32 T, at zero LWC too; the three others unchanged
    for lwc_name, lwc in (("LWC of the profiles", kprof["lwc"]),
                          ("zero LWC", torch.zeros_like(kprof["lwc"]))):
        args = (*k4_args["R24"][:4], lwc, "R24")
        three = absorption_tangents_lb(*args)
        four = absorption_tangents_lb(*args, with_lwc=True)
        want = jacobians._dalpha_dlwc(cfg, kprof["t"].double())
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(three, four))
        rel = float(((four[3].double() - want).abs().amax(dim=(1, 2))
                     / want.abs().amax(dim=(1, 2))).max())
        print(f"phase 5: K4 R24 B={BK} L={L}, {lwc_name}: dalpha/dLWC max "
              f"per-channel relative {rel:.3e} against float64 (bound 1e-5); "
              f"alpha and both tangents to the bit of a launch without it: "
              f"{same}")
        check(rel <= 1e-5 and same, f"K4 dalpha/dLWC {rel}, same {same}")

    # ---- phase 6: K5 against its plain version in float64 ---------------
    cfg_k = dataclasses.replace(cfg, model="R24")
    alpha, da_t, da_rho = absorption_tangents_lb(*k4_args["R24"])
    da = {"t": da_t, "rho": da_rho,
          "lwc": jacobians._dalpha_dlwc(cfg_k, kprof["t"])}
    geom_args = (elevs, kprof["z"], kprof["p"], kprof["t"], kprof["rho"])
    geom = slant_geometry_lb(*geom_args)
    geom_ref = slant_geometry_lb_reference(*geom_args)
    torch.cuda.synchronize()
    geom_ulps = {k: max_ulps(geom[k], geom_ref[k])
                 for k in ("ds", "dds_dnl", "dds_dk", "r0cos")}
    geom_ulps.update({f"dn_{k}": max_ulps(geom["dn"][k], geom_ref["dn"][k])
                      for k in ("t", "rho")})
    print(f"phase 6: geometry kernel B={BK} E={len(elevs)} L={L} against its "
          f"plain version, float32 ulp at most: {geom_ulps} (bound 2)")
    check(max(geom_ulps.values()) <= 2, f"geometry kernel ulps {geom_ulps}")

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
                  "slant_geometry_lb": slant_geometry_lb,
                  "kmatrix_assembled_lb": kmatrix_assembled_lb,
                  "kmatrix_assembled_rho_lwc_lb": kmatrix_assembled_rho_lwc_lb}
    for fn in k_counters.values():
        fn.launches = 0
    absorption_tangents_lb.lwc_launches = 0
    kmat = jacobians.kmatrix_batch_fast(kprofiles, cfg_k, wrt=WRT)
    k_launches = {name: fn.launches for name, fn in k_counters.items()}
    k_launches["absorption_tangents_lb.lwc"] = (
        absorption_tangents_lb.lwc_launches)
    torch.cuda.synchronize()
    print(f"phase 7: launches during the K-matrix path: {k_launches}")
    check(all(v == 1 for v in k_launches.values()),
          f"the K-matrix path launches each kernel once: {k_launches}")
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
    k4_lwc_ms = timed_ms(
        lambda: absorption_tangents_lb(*k4_args["R24"], with_lwc=True))
    k4_lwc_graph_ms = graph_ms(
        lambda: absorption_tangents_lb(*k4_args["R24"], with_lwc=True))
    geom_ms = timed_ms(lambda: slant_geometry_lb(*geom_args))
    geom_plain_ms = timed_ms(lambda: slant_geometry_lb_reference(*geom_args))
    graph_times["slant_geometry_lb"] = graph_ms(
        lambda: slant_geometry_lb(*geom_args))
    # each input read once, each output written once
    geom_bytes = (4 * 4 * L * BK + 8 * len(elevs)
                  + 4 * (3 * len(elevs) * (L - 1) * BK + 2 * L * BK
                         + len(elevs) * BK))
    geom_bound_ms = geom_bytes / 3.35e12 * 1e3
    print(f"phase 9: geometry kernel B={BK} E={len(elevs)} L={L}: kernel "
          f"{geom_ms:.4f} ms ({graph_times['slant_geometry_lb']:.4f} ms in a "
          f"graph), plain {geom_plain_ms:.4f} ms; {geom_bytes} bytes, bound "
          f"{geom_bound_ms:.4f} ms at 3.35e12 B/s, share "
          f"{geom_bound_ms / graph_times['slant_geometry_lb']:.4f} in a graph")
    k5_ms = {}
    for which in ("t", "rho_lwc"):
        kernel, plain, args = k5_calls[which]
        k5_ms[which] = (timed_ms(lambda: kernel(*args)),
                        timed_ms(lambda: plain(*args)))
        graph_times[kernel.__name__] = graph_ms(lambda: kernel(*args))
    print(f"phase 9: K4 tangents B={BK} L={L} F={len(freqs)}: kernel "
          f"{k4_ms:.4f} ms ({graph_times['absorption_tangents_lb']:.4f} ms in "
          f"a graph), plain {k4_plain_ms:.4f} ms; with dalpha/dLWC "
          f"{k4_lwc_ms:.4f} ms ({k4_lwc_graph_ms:.4f} ms in a graph); "
          f"{k4_blocks} blocks against {k4_slots} resident slots")
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
    print(f"phase 19: distillation step B=512 (K2 forward, K2v backward, "
          f"autograd, Adam): "
          f"{step_ms:.4f} ms, peak {step_peak:.1f} MiB above the live "
          f"tensors; loss at the closed-form fit {loss0:.6f} K^2 (the first "
          f"step returned {first:.6f}), {loss1:.6f} K^2 after the 14 steps "
          f"taken here")
    check(np.isfinite(loss1) and abs(first - loss0) <= 1e-3 * loss0 + 1e-9,
          f"distillation loss {loss0} {first} {loss1}")
    distill_phase(dev, smi, params, main_cfg, peaks)
    for what, fn, calls, ms in (
            ("fast serving", lambda: fast.fast_forward_batch(
                params, profiles, fcfg), 10, fast_ms),
            ("retrieval", retrieve_run, 2, None),
            ("the K-matrix", lambda: jacobians.kmatrix_batch_fast(
                kprofiles, cfg_k, wrt=WRT), 5, kmat_ms)):
        if ms is None:
            ms = timed_ms(fn, repeats=5, warmup=1)
        device_ms, n_kernels, top = device_profile(fn, calls, 4)
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
    # the fast K at the retrieval cell's batch: the kernel alone and the
    # whole entry point, through the kernel and through the plain path,
    # beside the least bytes of the fast K (mwrbench/rooflines/oem.py:
    # z, p, t, rho, lwc and the weights read, K_t and K_rho written); and
    # the torch prologue (`fast_k_inputs`) the kernel took over, which fed
    # the kernel its ten inputs before
    kprof = lbl.demo_batch(B, L, device=dev)
    plain_kcfg = dataclasses.replace(kcfg, use_kernels=False)
    ka = fast.batch_arrays(kprof, torch.float32)
    fk_in = jacobians.fast_k_inputs(params, ka, kcfg.elevations_deg)
    fk_bytes = 4.0 * (5 * B * L + 72 * nF + 2 * B * nE * nF * L)
    fk_bound = {"published": fk_bytes / profiling.DEFAULT_PEAKS["hbm"] * 1e3,
                "measured": fk_bytes / peaks["hbm"] * 1e3}
    fastk_adjoint.launches = 0
    fk_rows = {
        "kernel": (lambda: fastk_adjoint(kcfg.freqs_ghz, kcfg.elevations_deg,
                                         params["w"], **ka)),
        "torch prologue": (lambda: jacobians.fast_k_inputs(
            params, ka, kcfg.elevations_deg)),
        "plain version": (lambda: fastk_adjoint_reference(kcfg.freqs_ghz,
                                                          **fk_in)),
        "entry, kernel": (lambda: jacobians.kmatrix_fast_adjoint_batch(
            params, kprof, kcfg)),
        "entry, plain path": (lambda: jacobians.kmatrix_fast_adjoint_batch(
            params, kprof, plain_kcfg))}
    fk_launches = fastk_adjoint.launches
    fk_one = fk_rows["entry, kernel"]()
    check(fastk_adjoint.launches == fk_launches + 1,
          "the fast K did not launch its kernel once")
    fk_want = fastk_adjoint(kcfg.freqs_ghz, kcfg.elevations_deg,
                            params["w"].double(),
                            **{k: v.double() for k, v in ka.items()},
                            use_kernels=False)
    fk_err = max(float(((fk_one[n].double() - fk_want[n]).abs().amax(-1)
                        / fk_want[n].abs().amax(-1).clamp_min(1e-30)).max())
                 for n in fk_want)
    print(f"phase 19: fast K kernel at B={B} E={nE} C={nF} L={L}: worst "
          f"row's max|K - plain float64| / its max|K| {fk_err:.3e} (bound "
          f"1e-3)")
    check(fk_err <= 1e-3, f"fast K kernel error {fk_err}")
    fk_graph = {}
    for what, fn in fk_rows.items():
        ms = timed_ms(fn, repeats=10)
        fk_graph[what] = g_ms = graph_ms(fn)
        print(f"phase 19: fast K {what}, B={B}: {ms:.4f} ms, in a graph "
              f"{g_ms:.4f} ms; bound {fk_bound['published']:.4f} ms by bytes "
              f"({fk_bytes:.4g} B at the published 3.35e12 B/s; "
              f"{fk_bound['measured']:.4f} ms at the measured copy rate): "
              f"share in a graph {fk_bound['published'] / g_ms:.3f}")
    print(f"phase 19: fast K in a graph: the kernel from the profiles "
          f"{fk_graph['kernel']:.4f} ms against the torch prologue "
          f"{fk_graph['torch prologue']:.4f} ms plus the kernel on its ten "
          f"inputs ({FK_TEN_INPUTS_GRAPH_MS} ms in a graph at commit "
          f"f168307): "
          f"{fk_graph['torch prologue'] + FK_TEN_INPUTS_GRAPH_MS:.4f} ms")
    print(f"phase 19: fast K kernel launches in this phase "
          f"{fastk_adjoint.launches}")
    del fk_in, fk_want, fk_one

    # the retrieval at the cell's batch and steps, kernels against the
    # plain route in float64 on the CPU, on one seed: each profile's widest
    # gap, its largest and its 99th percentile (nearest rank) over the
    # profiles, beside the cell's limits for the latter
    big_obs = fast.fast_forward_batch(params, kprof, kcfg)["tb"]
    big_t0, big_rho0 = kprof["t"] + 1.5, kprof["rho"] * 0.8
    big_cfg = retrieval.OEMConfig()
    big = retrieval.retrieve_batch(params, big_obs, kprof["z"], kprof["p"],
                                   big_t0, big_rho0, big_cfg, kprof["lwc"])
    cpu64 = {k: v.detach().cpu().double()
             for k, v in dict(kprof, t0=big_t0, rho0=big_rho0,
                              obs=big_obs).items()}
    t_cpu = time.perf_counter()
    big64 = retrieval.retrieve_batch(
        {"w": params["w"].cpu()}, cpu64["obs"], cpu64["z"], cpu64["p"],
        cpu64["t0"], cpu64["rho0"], big_cfg, cpu64["lwc"])
    t_cpu = time.perf_counter() - t_cpu
    floor = big_cfg.rho_floor
    gaps = {}
    for name in ("t", "rho", "tb_fit", "dofs"):
        got, want = big[name].cpu().double(), big64[name]
        if name == "rho":
            got, want = torch.log(got + floor), torch.log(want + floor)
        gap = (got - want).reshape(B, -1).abs().amax(1).sort().values
        gaps[name] = (float(gap[-1]), float(gap[math.ceil(0.99 * B) - 1]))
    print(f"phase 19: retrieve_batch B={B} n_iter={big_cfg.n_iter}, kernels "
          f"against the plain route in float64 on the CPU ({t_cpu:.1f} s): "
          "largest / 99th-percentile gap " + "; ".join(
              f"{n} {mx:.4g} / {p99:.4g}" for n, (mx, p99) in gaps.items())
          + " (limits of p99: t 0.1 K, ln(rho + floor) 0.02, tb_fit 0.1 K)")
    check(gaps["t"][1] <= 0.1 and gaps["rho"][1] <= 0.02
          and gaps["tb_fit"][1] <= 0.1, f"retrieval at B={B}: {gaps}")
    del big, big64, cpu64

    # ---- phase 20: the campaign forward stage -----------------------------
    counted = {
        "absorption_lb": absorption_lb, "forward_lb": forward_lb,
        "forward_lb_vjp": forward_lb_vjp,
        "absorption_tangents_lb": absorption_tangents_lb,
        "kmatrix_assembled_lb": kmatrix_assembled_lb,
        "kmatrix_assembled_rho_lwc_lb": kmatrix_assembled_rho_lwc_lb,
        "absorption_spectral": absorption_spectral,
        "downwelling_lb": downwelling_lb, "chain": chain}
    stage_launches, stage_ds, stage_out = forward_stage_phase(dev, fb_rate,
                                                              counted)

    # ---- phase 21: the command line -----------------------------------------
    cli_launches = cli_phase(dev, counted, stage_ds, stage_out)
    del stage_ds, stage_out

    # ---- phase 22: the multi-device splits and the literature checkpoints -
    parallel_launches = parallel_phase(dev, counted, smi, spec_profiles,
                                       f_spec, spec["tb"], srf, tb_srf)

    # ---- phase 23: the tools -----------------------------------------------
    tools_launches = tools_phase(dev, counted, smi)

    # ---- phase 24: the bench -----------------------------------------------
    bench_launches = bench_phase(dev, counted, smi)

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
        row["launches_cli"] = cli_launches[row["name"]]
        row["launches_parallel"] = parallel_launches[row["name"]]
        row["launches_tools"] = tools_launches[row["name"]]
        row["launches_bench"] = bench_launches[row["name"]]
    kernel_rows[1].update(
        launches_fast_path=fast_launches["forward_lb"], body=main_body,
        alpha_is_mid_ms=k2_mid_ms, alpha_is_mid_plain_ms=k2_mid_plain_ms,
        alpha_is_mid_device_ms=graph_times["forward_lb[alpha_is_mid]"],
        alpha_is_mid_bound_ms=bounds["forward_lb[alpha_is_mid]"][0],
        narrow_copies_device_ms=k2_narrow_ms[0])
    # ---- phase 25: the MP-3000A's 22 channels ------------------------------
    mp3000a_phase(dev, smi, ptxas_report(
        lib_path.with_suffix(".log").read_text()), peaks)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
