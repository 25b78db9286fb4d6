"""The port's benchmark: the root `bench.py`'s seven measurements on the
CUDA card, printed as its one JSON line.

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.bench \
        [--quick] [--device DEV]

Headline: TB spectra per second of the 14-channel HATPRO slant-path LBL,
`models/lbl.forward_batch` at 1024 profiles x 10 elevations x 180 levels,
R24, `tb` only (kernels K1 and K2).  One spectrum is one (profile,
elevation) pair -> 14 channel TBs, the unit of work of the reference's hot
loop (one `rte.execute()` call per time x crop x elevation).  `extra` holds
the six other measurements of the same run:

  spectral_50k_*     `spectral.forward_spectral` + `srf_convolve`, 32
                     profiles x 50,000 frequencies, chunks of 8192 (K6 and
                     K3 seven times each), the whole call timed; its
                     decomposition times K6 alone and one chunk
                     (`spectral._forward_chunk`) on the first 8192
                     frequencies
  kmatrix_*          `jacobians.kmatrix_batch_fast` at B=256 wrt (t, rho,
                     LWC) (K4, K5a, K5b), against `forward_batch` at B=256
                     timed directly; its decomposition times K4 alone and
                     K5a alone on the inputs the K-matrix makes
  distill_step_ms    one `fast.train_step` at B=512 (on the card K2
                     forward and its backward K2v under autograd, replayed
                     as CUDA graphs after the first step, then fused Adam;
                     the plain path on the CPU); the optimizer steps the
                     weights in place, so each timed call is the next step
  fast_serving_*     `fast.fast_forward_batch` at B=1024, tb and tau_total,
                     weights fit on the first 64 profiles (K2 on layer-mean
                     extinction)
  oem_retrieval_*    `retrieval.retrieve_batch` at B=64 x 180 levels, 3
                     Gauss-Newton steps, per profile
  forward_stage_*    `pipeline.forward_stage` on 1000 times x 2 crops x 180
                     levels, R24, batch_size=256, with and without the fp16
                     payload (host clock, each warmed first); its device
                     time is that of crop 0's chunk loop (`_stage_device`),
                     its upload share that of crop 0's payload (`_upload`)
                     sent twice, once per crop, over the wall

Times are `parallel/profiling.device_time` (CUDA events around back-to-back
calls, the median of the trials, after a warm-up call); the stage's walls
are the host clock.  The roofline shares divide the function's bound at the
H100's published peaks (`profiling.DEFAULT_PEAKS`: `lbl_roofline`,
`k6_roofline`) by the time; the refined shares divide the as-coded model
(what the bodies under `csrc/` execute, `as_coded=True`, through
`profiling.pipeline_model_time`) by it.  `extra` also names the card and
its power limit, as `nvidia-smi --query-gpu=name,power.limit` gives them.

`--device cpu` runs every measurement on the CPU through the plain
versions; the keys that only the card defines are then null: the shares of
the H100's peaks, the upload's share (nothing is uploaded) and the power
limit.  Without `--device` the bench computes on the card and raises where
there is none.  `--quick` prints the headline alone, without `extra`.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .constants import hatpro
from .data import preprocess
from .data.dataset import Dataset, Variable
from .models import fast, jacobians, lbl, retrieval, spectral
from .ops import geometry, thermo
from .ops.cuda.absorption import absorption_tangents_lb
from .ops.cuda.adjoint import kmatrix_assembled_lb
from .ops.cuda.geometry import slant_geometry_lb
from .ops.cuda.spectral import absorption_spectral
from .ops.tensors import resolve_device
from .parallel import profiling
from .pipeline import forward as stage_mod

# The reference's LBL path is sequential CPU PyRTlib; its assumed rate for
# this 14-channel configuration is 1 spectrum/s (a favourable denominator
# for the reference), not any chip's.
BASELINE_SPECTRA_PER_S = 1.0

N_LEVELS = 180
HEADLINE_BATCH = 1024
SPECTRAL_BATCH = 32
N_FREQS = 50_000
FREQ_CHUNK = 8192
KMATRIX_BATCH = 256
DISTILL_BATCH = 512
SERVING_BATCH = 1024
SERVING_FIT = 64            # profiles the serving weights are fit on
RETRIEVAL_BATCH = 64
RETRIEVAL_FIT = 32
N_STAGE_TIME = 1000
STAGE_BATCH = 256
STAGE_MODELS = ("R24",)

# (iters, trials) of each `device_time` call: each runs its function
# 1 + iters x trials times
TIMING = {"headline": (40, 4), "spectral": (10, 3), "spectral_parts": (10, 3),
          "kmatrix": (10, 4), "forward_256": (40, 4),
          "kmatrix_parts": (10, 3), "distill": (20, 3), "serving": (40, 4),
          "retrieval": (4, 3), "stage_device": (12, 4)}


@dataclasses.dataclass
class Run:
    """One measurement: its numbers (seconds and rates, unrounded), the
    output of the last timed call of each function it timed, and the
    inputs those calls were given."""

    numbers: dict
    out: dict
    inputs: dict


def _timed(name, fn, args, device):
    """(seconds per call, the output of the last call) of fn(*args), timed
    by `profiling.device_time` with TIMING[name]."""
    last = []

    def call(*a):
        last[:] = [fn(*a)]
        return last[0]

    iters, trials = TIMING[name]
    seconds = profiling.device_time(call, args, iters=iters, trials=trials,
                                    device=device)
    return seconds, last[0]


def _finite(what: str, *tensors) -> None:
    """Raise where a timed output holds a NaN or an infinity: a speed of a
    wrong result is no result (bench.py asserts it of the headline and the
    spectrum)."""
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError(f"bench: {what} is not finite")


def card(device) -> tuple:
    """(name, power limit [W]) of the card as nvidia-smi gives them;
    (the device's type, None) off the card."""
    if device.type != "cuda":
        return device.type, None
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def bench_headline(device) -> Run:
    """`forward_batch` at HEADLINE_BATCH x N_LEVELS, R24, tb only."""
    batch = HEADLINE_BATCH
    config = lbl.LBLConfig(model="R24", outputs=("tb",))
    profiles = lbl.demo_batch(batch, N_LEVELS, device=device)
    per_call, out = _timed("headline",
                           lambda pr: lbl.forward_batch(pr, config),
                           (profiles,), device)
    _finite("the headline's tb", out["tb"])
    n_elev, freqs = len(config.elevations_deg), config.freqs_ghz
    numbers = {"rate": batch * n_elev / per_call, "per_call_s": per_call}
    if device.type == "cuda":
        bound = profiling.lbl_roofline(batch, N_LEVELS).time_bound_s(
            profiling.DEFAULT_PEAKS)
        t_lb = profiles["t"].T
        coded = (profiling.k1_roofline(batch * N_LEVELS, freqs, "R24",
                                       as_coded=True),
                 profiling.k2_roofline(
                     batch, N_LEVELS, len(freqs), n_elev,
                     planck_series_fraction=profiling.planck_series_share(
                         freqs, t_lb), as_coded=True))
        model_s = sum(profiling.pipeline_model_time(c, profiling.DEFAULT_PEAKS)
                      for c in coded)
        numbers.update(roofline_frac=bound / per_call,
                       refined_frac=model_s / per_call)
    return Run(numbers, {"tb": out["tb"]}, {"profiles": profiles,
                                            "config": config})


def srf_weights(f_ghz) -> np.ndarray:
    """bench.py's SRFs: a Gaussian per HATPRO channel, its nominal
    bandwidth as the standard deviation, (14, F)."""
    w = np.zeros((hatpro.N_CHANNELS, f_ghz.size), np.float32)
    for c, (fc, bw) in enumerate(zip(hatpro.HATPRO_FREQS_GHZ,
                                     hatpro.nominal_bandwidth_ghz())):
        w[c] = np.exp(-0.5 * ((f_ghz - fc) / max(bw, 1e-3)) ** 2)
    return w


def bench_spectral(device) -> Run:
    """`forward_spectral` + `srf_convolve` on SPECTRAL_BATCH profiles x
    N_FREQS frequencies (20-64 GHz), zenith, chunks of FREQ_CHUNK, the
    whole call timed; then K6 alone and one chunk on the first FREQ_CHUNK
    frequencies."""
    batch, nf = SPECTRAL_BATCH, N_FREQS
    profiles = lbl.demo_batch(batch, N_LEVELS, device=device)
    f = np.linspace(20.0, 64.0, nf).astype(np.float32)
    w = torch.from_numpy(srf_weights(f)).to(device)
    elevs = (90.0,)

    def run(pr):
        out = spectral.forward_spectral(pr, f, elevs, "R24",
                                        freq_chunk=FREQ_CHUNK)
        return spectral.srf_convolve(out["tb"], w)

    per_call, tb_srf = _timed("spectral", run, (profiles,), device)
    _finite("the spectrum's channel tb", tb_srf)

    # the first chunk, on the inputs forward_spectral makes for it
    levels = lbl.level_major_profiles(profiles, lbl.LBLConfig())
    z, p, t, rho, lwc = levels.values()
    fc = torch.from_numpy(f[:FREQ_CHUNK]).to(device)
    e_hpa = thermo.rho_to_e(rho, t)
    ds = torch.stack([geometry.slant_path_lengths_lb(z, p, t, e_hpa, el)
                      for el in elevs])
    t_abs, alpha = _timed(
        "spectral_parts",
        lambda *a: absorption_spectral(fc, *a, "R24"), (p, t, rho, lwc),
        device)
    t_chunk, chunk = _timed(
        "spectral_parts",
        lambda lev: spectral._forward_chunk(lev, fc, ds, "R24", True),
        (levels,), device)
    numbers = {"rate": batch * nf / per_call, "per_call_s": per_call,
               "abs_kernel_s": t_abs, "chunk_s": t_chunk}
    if device.type == "cuda":
        n_pts, f_np = batch * N_LEVELS, f[:FREQ_CHUNK]
        bound = profiling.k6_roofline(n_pts, f_np, "R24").time_bound_s(
            profiling.DEFAULT_PEAKS)
        model_s = profiling.pipeline_model_time(
            profiling.k6_roofline(n_pts, f_np, "R24", as_coded=True),
            profiling.DEFAULT_PEAKS)
        numbers.update(roofline_frac=bound / t_abs,
                       refined_frac=model_s / t_abs)
    return Run(numbers, {"tb_srf": tb_srf, "alpha": alpha, "chunk": chunk},
               {"profiles": profiles, "f_ghz": f, "weights": w,
                "elevations_deg": elevs, "f_chunk": fc, "ds": ds,
                "levels": levels})


def bench_kmatrix(device) -> Run:
    """`kmatrix_batch_fast` at KMATRIX_BATCH wrt (t, rho, LWC), and
    `forward_batch` at the same batch; then K4 alone and K5a alone on the
    inputs `kmatrix_batch_fast` makes."""
    batch = KMATRIX_BATCH
    cfg = lbl.LBLConfig(model="R24")
    wrt = ("t", "rho", "lwc")
    profiles = lbl.demo_batch(batch, N_LEVELS, device=device)
    per_call, kmat = _timed(
        "kmatrix", lambda pr: jacobians.kmatrix_batch_fast(pr, cfg, wrt),
        (profiles,), device)
    fwd_cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    fwd_s, fwd = _timed("forward_256",
                        lambda pr: lbl.forward_batch(pr, fwd_cfg),
                        (profiles,), device)

    lev = lbl.level_major_profiles(profiles, cfg)
    freqs = cfg.freqs_ghz
    tangent_args = (lev["p"], lev["t"], lev["rho"], lev["lwc"])
    t_tan, tangents = _timed(
        "kmatrix_parts",
        lambda *a: absorption_tangents_lb(freqs, *a, cfg.model),
        tangent_args, device)
    alpha, da_t, _ = tangents
    g = slant_geometry_lb(cfg.elevations_deg, *(lev[k] for k in
                                                ("z", "p", "t", "rho")))
    adjoint_args = (alpha, da_t, g["ds"], lev["t"], g["dds_dnl"],
                    g["dds_dk"], g["dn"]["t"], g["r0cos"])
    t_adj, k_t = _timed(
        "kmatrix_parts",
        lambda *a: kmatrix_assembled_lb(freqs, "t", *a), adjoint_args,
        device)
    numbers = {"per_call_s": per_call, "forward_s": fwd_s,
               "tangent_kernel_s": t_tan, "adjoint_assembly_t_s": t_adj}
    return Run(numbers, {"k": kmat, "tb": fwd["tb"], "tangents": tangents,
                         "k_t_lb": k_t},
               {"profiles": profiles, "config": cfg, "wrt": wrt,
                "forward_config": fwd_cfg, "tangent_args": tangent_args,
                "adjoint_args": adjoint_args})


def bench_distill_step(device) -> Run:
    """One `fast.train_step` at DISTILL_BATCH: targets from `forward_batch`
    (R24), weights from `fit_closed_form`, Adam at 1e-4
    (`fast.make_optimizer`).  The optimizer steps the weights in place, so
    each timed call takes the next step from where the last one left them;
    `out` holds the loss the last step returned and the weights after it,
    `inputs` the weights before the first."""
    cfg = fast.FastConfig()
    profiles = lbl.demo_batch(DISTILL_BATCH, N_LEVELS, device=device)
    targets = lbl.forward_batch(profiles, lbl.LBLConfig(
        model=cfg.teacher_model, outputs=("tb",)))["tb"]
    params = fast.fit_closed_form(profiles, cfg)
    w0 = params["w"].clone()
    optimizer = fast.make_optimizer(params)
    per_call, loss = _timed(
        "distill",
        lambda pr, tg: fast.train_step(params, optimizer, pr, tg, cfg),
        (profiles, targets), device)
    iters, trials = TIMING["distill"]
    return Run({"per_call_s": per_call},
               {"loss": loss, "w": params["w"].detach(),
                "steps": 1 + iters * trials},
               {"profiles": profiles, "targets": targets, "w0": w0,
                "config": cfg})


def bench_fast_serving(device) -> Run:
    """`fast_forward_batch` at SERVING_BATCH, tb and tau_total, through K2,
    weights fit on the first SERVING_FIT profiles."""
    cfg = fast.FastConfig(outputs=("tb", "tau_total"))
    profiles = lbl.demo_batch(SERVING_BATCH, N_LEVELS, device=device)
    params = fast.fit_closed_form(
        {k: v[:SERVING_FIT] for k, v in profiles.items()}, cfg)
    per_call, out = _timed(
        "serving", lambda pr: fast.fast_forward_batch(params, pr, cfg),
        (profiles,), device)
    return Run({"per_call_s": per_call}, out,
               {"profiles": profiles, "params": params, "config": cfg})


def bench_retrieval(device) -> Run:
    """`retrieve_batch` at RETRIEVAL_BATCH x N_LEVELS, 3 Gauss-Newton
    steps, priors T + 1.5 K and rho x 0.8, on TBs the fast operator
    (weights fit on the first RETRIEVAL_FIT profiles) serves; the numbers
    are per profile.

    The cloud liquid the TBs were served with is held fixed in the
    retrieval, as the command line's `retrieve` holds it.  bench.py leaves
    it out; the retrieval then has a cloud in its observations that its
    state cannot hold, and Gauss-Newton diverges (NaN in the JAX package,
    a matrix that is not positive definite here)."""
    batch = RETRIEVAL_BATCH
    profiles = lbl.demo_batch(batch, N_LEVELS, device=device)
    cfg = fast.FastConfig()
    params = fast.fit_closed_form(
        {k: v[:RETRIEVAL_FIT] for k, v in profiles.items()}, cfg)
    tb_obs = fast.fast_forward_batch(params, profiles, fast.FastConfig(
        outputs=("tb",)))["tb"]
    ocfg = retrieval.OEMConfig(n_iter=3)
    z, p, lwc = profiles["z"], profiles["p"], profiles["lwc"]
    t_prior = profiles["t"] + 1.5
    rho_prior = profiles["rho"] * 0.8

    def run(tb):
        out = retrieval.retrieve_batch(params, tb, z, p, t_prior, rho_prior,
                                       ocfg, lwc)
        return {"t": out["t"], "rho": out["rho"]}

    per_call, out = _timed("retrieval", run, (tb_obs,), device)
    _finite("the retrieval", out["t"], out["rho"])
    return Run({"per_profile_s": per_call / batch}, out,
               {"params": params, "tb_obs": tb_obs, "z": z, "p": p,
                "t_prior": t_prior, "rho_prior": rho_prior, "config": ocfg,
                "lwc": lwc})


def stage_dataset(n_time: int) -> Dataset:
    """bench.py's forward-stage input: `demo_batch(n_time)` as a harmonized
    dataset of n_time times x 2 identical crops x N_LEVELS levels, the
    arithmetic in float32 as bench.py does it."""
    profs = {k: v.numpy() for k, v in
             lbl.demo_batch(n_time, N_LEVELS, device="cpu").items()}
    flip = slice(None, None, -1)

    def lev_var(x):                       # (B, L) ground->top  ->  TOA->gnd
        a = np.asarray(x).T[flip]         # (L, B)
        return Variable(("N_Levels", "time", "Crop"),
                        np.repeat(a[:, :, None], 2, axis=2).astype("f4"))

    p, t, rho = profs["p"], profs["t"], profs["rho"]
    e = rho * t / 216.679
    mr = 1000.0 * 0.622 * e / np.maximum(p - e, 1e-3)
    air = p * 100.0 / (287.04 * t)
    liq = profs["lwc"] / 1000.0 / air
    ds = Dataset()
    ds["Level_Pressure"] = lev_var(p)
    ds["Level_Temperature"] = lev_var(t)
    ds["Level_H2O"] = lev_var(mr)
    ds["Level_z"] = lev_var(profs["z"])
    ds["Level_Liquid"] = lev_var(liq)
    return ds


def bench_forward_stage(device, headline_rate: float) -> Run:
    """`forward_stage` on `stage_dataset(N_STAGE_TIME)`, STAGE_MODELS,
    batch_size=STAGE_BATCH, kernels on, by the host clock (each variant
    warmed first): the float32 payload, then the fp16 one.  Then crop 0's
    chunk loop (`_stage_device`) by `device_time`, and on the card crop 0's
    payload sent twice by `_upload` (one upload per crop)."""
    ds = stage_dataset(N_STAGE_TIME)

    def stage(compress):
        return stage_mod.forward_stage(
            ds, models=STAGE_MODELS, batch_size=STAGE_BATCH,
            compress_upload=compress, device=device)

    walls, outs = {}, {}
    for compress in (False, True):
        stage(compress)                               # warm-up
        t0 = time.perf_counter()
        res = stage(compress)
        walls[compress] = time.perf_counter() - t0
        outs[compress] = {f"TBs_LBL_{m}": res[f"TBs_LBL_{m}"].data
                          for m in STAGE_MODELS}

    raw0, _ = stage_mod._screen(preprocess.profiles_for_forward(ds, crop=0))
    payload, _ = stage_mod._upload(raw0, False, device)
    res = stage_mod._allocate(N_STAGE_TIME, N_LEVELS, STAGE_MODELS, False,
                              False, device)
    tables = stage_mod._stage_tables(STAGE_MODELS, True, res)
    stage_dev_s, _ = _timed(
        "stage_device",
        lambda d: stage_mod._stage_device(d, None, None, STAGE_MODELS, True,
                                          STAGE_BATCH, tables, res, 0),
        (payload,), device)

    spectra = N_STAGE_TIME * 2 * len(lbl.LBLConfig().elevations_deg)
    rate = spectra / walls[False]
    numbers = {"frac": rate / headline_rate, "rate": rate,
               "wall_s": walls[False], "wall_f16_s": walls[True],
               "device_s": stage_dev_s,
               "device_x_kernel": stage_dev_s / (
                   N_STAGE_TIME * len(lbl.LBLConfig().elevations_deg)
                   / headline_rate)}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(2):                # one upload per crop
            stage_mod._upload(raw0, False, device)
        torch.cuda.synchronize(device)
        numbers["upload_frac"] = (time.perf_counter() - t0) / walls[False]
    return Run(numbers,
               {"stage": outs[False], "stage_f16": outs[True],
                "device": {m: res["lbl"][m][..., 0] for m in STAGE_MODELS}},
               {"dataset": ds})


def _round(x, digits):
    return None if x is None else round(x, digits)


def measure(device=None, quick: bool = False):
    """Run the benchmark on `device` (the CUDA card when None; RuntimeError
    before any work where there is none).  Returns the JSON object bench.py
    prints and {name: Run} of the measurements behind it."""
    dev = resolve_device(device)
    runs = {"headline": bench_headline(dev)}
    head = runs["headline"].numbers
    rate = head["rate"]
    result = {
        "metric": "tb_spectra_per_s_per_chip",
        "value": round(rate, 2),
        "unit": "spectra/s (profile x elevation -> 14ch TB, R24 LBL, "
                f"{N_LEVELS} levels)",
        "vs_baseline": round(rate / BASELINE_SPECTRA_PER_S, 2),
    }
    if quick:
        return result, runs
    runs["spectral"] = bench_spectral(dev)
    runs["kmatrix"] = bench_kmatrix(dev)
    runs["distill"] = bench_distill_step(dev)
    runs["serving"] = bench_fast_serving(dev)
    runs["retrieval"] = bench_retrieval(dev)
    runs["stage"] = bench_forward_stage(dev, rate)
    sp, km, st = (runs[k].numbers for k in ("spectral", "kmatrix", "stage"))
    name, power_limit = card(dev)
    extra = {
        # shares of the H100's published peaks: null off the card
        "lbl_roofline_frac": _round(head.get("roofline_frac"), 3),
        "lbl_refined_model_frac": _round(head.get("refined_frac"), 3),
        "spectral_50k_Mfreqpoints_per_s": round(sp["rate"] / 1e6, 2),
        "spectral_roofline_frac": _round(sp.get("roofline_frac"), 3),
        "spectral_refined_model_frac": _round(sp.get("refined_frac"), 3),
        "spectral_decomp_ms": {
            "abs_kernel_ms": round(sp["abs_kernel_s"] * 1e3, 3),
            "chunk_ms": round(sp["chunk_s"] * 1e3, 3),
            "rte_glue_frac_of_chunk": round(
                1.0 - sp["abs_kernel_s"] / sp["chunk_s"], 3),
        },
        "kmatrix_ms_per_batch256": round(km["per_call_s"] * 1e3, 2),
        "kmatrix_x_forward": round(km["per_call_s"] / km["forward_s"], 2),
        "kmatrix_decomp_ms": {
            "tangent_kernel_ms": round(km["tangent_kernel_s"] * 1e3, 3),
            "adjoint_assembly_t_ms": round(
                km["adjoint_assembly_t_s"] * 1e3, 3),
            "note": "each stage timed alone on the inputs "
                    "kmatrix_batch_fast makes; the rest of "
                    "kmatrix_ms_per_batch256 is K5b, the float64 geometry, "
                    "the layouts and the host",
        },
        "distill_step_ms": round(
            runs["distill"].numbers["per_call_s"] * 1e3, 3),
        "fast_serving_ms_per_batch1024": round(
            runs["serving"].numbers["per_call_s"] * 1e3, 3),
        "oem_retrieval_ms_per_profile": round(
            runs["retrieval"].numbers["per_profile_s"] * 1e3, 3),
        "forward_stage_spectra_per_s": round(st["rate"], 1),
        "forward_stage_frac_of_kernel": round(st["frac"], 4),
        # crop 0's payload uploaded twice over the wall: null off the card
        "forward_stage_upload_frac_of_wall": _round(st.get("upload_frac"), 3),
        "forward_stage_wall_s": round(st["wall_s"], 3),
        "forward_stage_wall_s_f16payload": round(st["wall_f16_s"], 3),
        "forward_stage_device_ms": round(st["device_s"] * 1e3, 2),
        "forward_stage_device_x_kernel": round(st["device_x_kernel"], 2),
        "device": name,
        "power_limit_w": power_limit,
    }
    result["extra"] = extra
    return result, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the headline alone, without extra")
    ap.add_argument("--device", default=None,
                    help="the CUDA card when not given (an error where there "
                         "is none); 'cpu' runs the plain torch paths")
    args = ap.parse_args(argv)
    result, _ = measure(args.device, args.quick)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
