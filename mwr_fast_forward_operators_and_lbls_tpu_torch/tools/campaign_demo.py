"""Campaign-scale end-to-end run: ~520 sondes x 3 campaigns through the
complete chain.

The counterpart of the JAX package's `tools/campaign_demo.py`.  The
reference processed ~520 matched sondes x 2 crops x 10 elevations through
preprocess -> ARMS -> RTTOV -> PyRTlib -> summarize -> plots
(reference/run_all_procs.sh:1-12, sequential CPU Python).  This tool
fabricates a synthetic multi-campaign raw archive of the same scale (the
real FESSTVaL/Socles/Vital-I files are not distributable), then runs the
port's in-process equivalent with per-stage wall-clock accounting:

    generate raws -> preprocess (3 campaign globs, MWR matching, cloud
    water) -> fit the fast operator -> forward (4 LBL releases + fast
    operator, K1 and K2 on the card) -> analysis dataset -> FULL
    evaluation matrix (campaign x location x seasonal window x sky)

and prints a summary JSON with stage timings and artifact counts (with
`--summary`, also as markdown).  The stages are the functions
`generate_raws`, `stage_preprocess`, `stage_distill`, `stage_forward`,
`stage_analysis` and `stage_report`; `run_chain` runs all but the report.
The stages run on `--device` (the CUDA card when not given; an error before
any work where there is none).  The report draws figures, so `main` stops
before any work where matplotlib does not import.

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.tools.campaign_demo \
        [--n-sondes 520] [--workdir DIR] [--models R98,R17,R20,R24] \
        [--summary FILE] [--keep-raws] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..data import netcdf, preprocess, synthetic
from ..eval import plots, report
from ..models import fast
from ..ops.tensors import device_name, resolve_device
from ..pipeline import forward_stage, merge

CAMPAIGNS = [
    # (campaign, location, instrument, share of sondes)
    ("FESSTVaL", "Falkenberg", "foghat", 0.40),
    ("Socles", "Lindenberg", "sunhat", 0.30),
    ("Vital-I", "Juelich", "joyhat", 0.30),
]


def generate_raws(root: str, n_sondes: int, seed0: int = 0) -> list:
    """Write the synthetic raw archive; returns preprocess_campaigns specs."""
    rng = np.random.default_rng(seed0)
    # launches spread over May-July so the seasonal windows are populated
    t_start = np.datetime64("2024-05-02T00:00:00")
    t_end = np.datetime64("2024-07-30T00:00:00")
    span_s = (t_end - t_start) / np.timedelta64(1, "s")
    specs = []
    k = 0
    for ci, (camp, loc, inst, share) in enumerate(CAMPAIGNS):
        n = int(round(n_sondes * share))
        cdir = os.path.join(root, camp)
        os.makedirs(cdir, exist_ok=True)
        mwr_paths = []
        for i in range(n):
            launch = (t_start + np.timedelta64(
                int(span_s * (i + 0.5) / n + rng.integers(-3600, 3600)), "s")
            ).astype("datetime64[s]")
            stamp = (str(launch).replace("-", "").replace(":", "")
                     .replace("T", "_"))
            synthetic.write_sonde_nc_arms(
                os.path.join(cdir, f"{stamp}.nc"), seed=seed0 + k,
                cloudy=bool(k % 3))   # ~2/3 cloudy, 1/3 clear
            mwr_paths.append(synthetic.write_mwr_l1(
                os.path.join(cdir, f"mwr_l1_{i:04d}.nc"), launch,
                seed=seed0 + k))
            mwr_paths.append(synthetic.write_mwr_l2(
                os.path.join(cdir, f"mwr_l2_prw_{i:04d}.nc"), launch,
                product="prw", seed=seed0 + k))
            mwr_paths.append(synthetic.write_mwr_l2(
                os.path.join(cdir, f"mwr_l2_clwvi_{i:04d}.nc"), launch,
                product="clwvi", seed=seed0 + k))
            k += 1
        specs.append({"pattern": os.path.join(cdir, "2024*_*.nc"),
                      "campaign": camp, "location": loc,
                      "mwr_files": {inst: sorted(mwr_paths)}})
    return specs


def stage_preprocess(specs: list, workdir: str):
    """The harmonized dataset of the archive, written to
    `workdir/harmonized.nc`."""
    ds = preprocess.preprocess_campaigns(specs)
    netcdf.write(os.path.join(workdir, "harmonized.nc"), ds)
    return ds


def stage_distill(ds, device) -> dict:
    """The fast operator's closed-form fit on the harmonized dataset, on
    `device`."""
    dev = resolve_device(device)
    params = fast.distill_on_dataset(ds, fast.FastConfig(), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return params


def stage_forward(ds, models: tuple, params: dict, workdir: str, device):
    """`pipeline.forward_stage` with the LBL releases and the fast
    operator on `device`, written to `workdir/results.nc`."""
    ds = forward_stage(ds, models=models, fast_params=params, device=device)
    netcdf.write(os.path.join(workdir, "results.nc"), ds)
    return ds


def stage_analysis(ds, workdir: str):
    """The analysis dataset, written to `workdir/analysis.nc`."""
    ds = merge.analysis_dataset(ds)
    netcdf.write(os.path.join(workdir, "analysis.nc"), ds)
    return ds


def stage_report(ds, workdir: str) -> dict:
    """The full evaluation matrix in `workdir/matrix`; its manifest."""
    return report.full_report(ds, os.path.join(workdir, "matrix"))


def run_chain(workdir: str, n_sondes: int, models: tuple, device,
              timings: dict) -> tuple:
    """Every stage but the report, each timed into `timings` [s] under the
    JAX tool's keys: returns (analysis dataset, harmonized dims, fast
    weights)."""
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    raws = os.path.join(workdir, "raw")

    t0 = time.perf_counter()
    specs = generate_raws(raws, n_sondes)
    timings["generate_raws_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = stage_preprocess(specs, workdir)
    timings["preprocess_s"] = time.perf_counter() - t0
    dims = dict(ds.dims)
    print(f"preprocess: {dims}  ({timings['preprocess_s']:.1f} s)")

    t0 = time.perf_counter()
    params = stage_distill(ds, dev)
    timings["distill_s"] = time.perf_counter() - t0
    print(f"distill: {timings['distill_s']:.1f} s")

    t0 = time.perf_counter()
    ds = stage_forward(ds, models, params, workdir, dev)
    timings["forward_s"] = time.perf_counter() - t0
    print(f"forward: {len(models)} LBL models + fast, "
          f"{n_spectra(dims, models)} spectra "
          f"({timings['forward_s']:.1f} s incl. NetCDF write)")

    t0 = time.perf_counter()
    ds = stage_analysis(ds, workdir)
    timings["analysis_s"] = time.perf_counter() - t0
    return ds, dims, params


def n_spectra(dims: dict, models: tuple) -> int:
    """Spectra the forward computes: time x 2 crops x 10 elevations x
    (releases + the fast operator)."""
    return dims["time"] * 2 * 10 * (len(models) + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-sondes", type=int, default=520)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "mwr_campaign_demo"))
    ap.add_argument("--models", default="R98,R17,R20,R24")
    ap.add_argument("--summary", default=None,
                    help="write the markdown summary here")
    ap.add_argument("--keep-raws", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the CUDA card when not given (an error where there "
                         "is none); 'cpu' runs the plain torch paths")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # the full report draws figures: without matplotlib stop here, before
    # any work, as the port's run-all does
    try:
        plots._pyplot()
    except ImportError as exc:
        print(f"campaign_demo: the full report draws figures with "
              f"matplotlib, which does not import here ({exc}); nothing "
              f"was run", file=sys.stderr)
        return 2

    models = tuple(args.models.split(","))
    timings = {}
    t_all = time.perf_counter()
    ds, dims, _ = run_chain(args.workdir, args.n_sondes, models, dev,
                            timings)

    t0 = time.perf_counter()
    manifest = stage_report(ds, args.workdir)
    timings["full_report_s"] = time.perf_counter() - t0
    timings["total_s"] = time.perf_counter() - t_all

    summary = {
        "n_sondes_requested": args.n_sondes,
        "dims": dims,
        "backend": device_name(dev),
        "models": list(models) + ["Fast"],
        "n_forward_spectra": n_spectra(dims, models),
        "matrix_cells": len(manifest["cells"]),
        "matrix_figures": manifest["n_figures_total"],
        "matrix_skipped_empty": len(manifest["skipped"]),
        "timings_s": {k: round(v, 1) for k, v in timings.items()},
    }
    print(json.dumps(summary))

    if args.summary:
        camps = ", ".join(f"{c} ({loc})" for c, loc, _, _ in CAMPAIGNS)
        with open(args.summary, "w") as fh:
            fh.write(
                "# Campaign-scale end-to-end run\n\n"
                f"Synthetic multi-campaign archive — {camps} — at the "
                "reference's production scale (~520 matched sondes x 2 "
                "crops x 10 elevations, run_all_procs.sh:1-12), through "
                "preprocess -> distill -> forward (4 LBL releases + fast "
                "operator) -> analysis -> full evaluation matrix.\n\n"
                f"```json\n{json.dumps(summary, indent=1)}\n```\n\n"
                "Stage notes: `preprocess` includes per-sonde MWR scan "
                "matching, thinning, climatology extension and Nandan "
                "cloud-water derivation on the host; `forward` is one "
                "device program per crop (all chunks x all models) plus "
                "the NetCDF write; `full_report` renders every "
                "campaign x location x window x sky cell with figures + "
                "per-elevation stats CSVs.\n")
        print(f"wrote {args.summary}")
    if not args.keep_raws:
        shutil.rmtree(os.path.join(args.workdir, "raw"), ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
