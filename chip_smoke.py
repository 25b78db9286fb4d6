"""Drive the PyTorch/CUDA port's line-by-line forward and K-matrix on one GPU
and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  It builds the port's kernels from `csrc/` and goes through ten
phases, each printing its own lines:

  0. the card (nvidia-smi name and power limit), torch/CUDA versions and the
     kernel build time;
  1. the absorption kernel (K1) against its plain torch version on the card;
  2. the RTE kernel (K2) against its plain torch version on the card;
  3. the forward path, `forward_batch` on 1024 HATPRO profiles x 180 levels,
     model R24, with both kernels' launch counts, against the plain path and
     the frozen fp64 TB golden;
  4. CUDA-event times (median of 20 after warm-up) of each kernel and of the
     whole forward against the plain versions, and peak device memory;
  5. the absorption tangent kernel (K4) against its plain version, all nine
     releases, 256 profiles x 180 levels;
  6. the K-matrix adjoint kernel (K5) for t, rho, lwc and rho+lwc against
     its plain version run in float64, 256 profiles x 10 elevations x 14
     channels x 180 levels;
  7. the K-matrix path, `kmatrix_batch_fast` on 256 profiles for t, rho and
     lwc, with the launch counts of K4 and both K5 wrappers;
  8. that K-matrix against the plain path in float64 on the card, and its
     physical signs;
  9. CUDA-event times of K4, K5 and the K-matrix against the plain versions,
     of `forward_batch` at the same batch, of the output permute alone, and
     peak device memory.

It then prints one JSON line of per-kernel results and, last, one JSON line
naming the device.  Any failed check raises, and the exit code is not 0.
Without a CUDA device it exits with 1 and prints no result.
"""

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "mwr_fast_forward_operators_and_lbls_tpu_torch"
B, L = 1024, 180        # the HATPRO boundary-layer scan shape of bench.py
BK = 256                # the K-matrix batch of bench.py (BASELINE config 4)
WRT = ("t", "rho", "lwc")
REPEATS = 20


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


def level_major(profiles):
    return {k: v.T.contiguous() for k, v in profiles.items()}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from mwr_fast_forward_operators_and_lbls_tpu_torch.anchors import (
        standard_profiles)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
        H2O_MODELS)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        jacobians, lbl)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (geometry,
                                                                   thermo)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
        _build)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.absorption import (  # noqa: E501
        absorption_lb, absorption_lb_reference, absorption_tangents_lb,
        absorption_tangents_lb_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.adjoint import (  # noqa: E501
        kmatrix_assembled_lb, kmatrix_assembled_lb_reference,
        kmatrix_assembled_rho_lwc_lb, kmatrix_assembled_rho_lwc_lb_reference)
    from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda.rte import (
        forward_lb, forward_lb_reference)

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
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"phase 0: ptxas: {line.strip()}")

    # ---- phase 1: K1 against its plain version --------------------------
    def k1_case(model, batch, with_o3):
        prof = level_major(lbl.demo_batch(batch, L, device=dev))
        o3 = lbl._afgl_o3(prof["z"]) if with_o3 else None
        args = (freqs, prof["p"], prof["t"], prof["rho"], prof["lwc"], model)
        got = absorption_lb(*args, o3=o3)
        ref = absorption_lb_reference(*args, o3=o3)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {model} not finite")
        err = (got - ref).abs().amax(dim=(1, 2))
        scale = ref.abs().amax(dim=(1, 2))
        rel = float((err / scale).max())
        print(f"phase 1: K1 {model} B={batch} L={L} o3={with_o3}: "
              f"max|dalpha| {float(err.max()):.3e} Np/km, "
              f"max per-channel relative {rel:.3e} (bound 1e-4)")
        check(rel <= 1e-4, f"K1 {model} o3={with_o3} relative error {rel}")
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

    def k2_case(batch, alpha_is_mid, want_trans):
        alpha, z, n, t = k2_inputs(batch)
        if alpha_is_mid:
            alpha = (0.5 * (alpha[:, :-1] + alpha[:, 1:])).contiguous()
        args = (freqs, elevs, alpha, z, n, t, alpha_is_mid, want_trans)
        got = forward_lb(*args)
        ref = forward_lb_reference(*args)
        torch.cuda.synchronize()
        check(set(got) == set(ref), "K2 output keys")
        errs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
        print(f"phase 2: K2 B={batch} E={len(elevs)} F={len(freqs)} L={L} "
              f"alpha_is_mid={alpha_is_mid} trans_level={want_trans}: "
              + ", ".join(f"max|d {k}| {v:.3e}" for k, v in errs.items()))
        check(all(bool(torch.isfinite(v).all()) for v in got.values()),
              "K2 output not finite")
        check(errs["tb"] <= 5e-3, f"K2 tb error {errs['tb']} K > 5e-3 K")
        if want_trans:
            check(errs["trans_level"] <= 1e-5,
                  f"K2 trans_level error {errs['trans_level']} > 1e-5")
        return errs["tb"]

    k2_err = k2_case(B, False, False)
    k2_case(B, False, True)
    k2_case(3, True, False)
    k2_case(3, True, True)

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
    k1_ms = timed_ms(lambda: absorption_lb(*k1_args))
    k1_plain_ms = timed_ms(lambda: absorption_lb_reference(*k1_args))
    alpha, z, n, t = k2_inputs(B)
    rows = {}
    for want_trans in (False, True):
        k2_args = (freqs, elevs, alpha, z, n, t, False, want_trans)
        rows[want_trans] = (timed_ms(lambda: forward_lb(*k2_args)),
                            timed_ms(lambda: forward_lb_reference(*k2_args)))
    print(f"phase 4: K1 absorption B={B} L={L} F={len(freqs)}: kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    for want_trans, (k_ms, p_ms) in rows.items():
        print(f"phase 4: K2 RTE B={B} E={len(elevs)} F={len(freqs)} L={L} "
              f"trans_level={want_trans}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms")
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
        print(f"phase 4: forward_batch B={B} outputs={outputs}: "
              + "; ".join(line))

    # ---- phase 5: K4 against its plain version --------------------------
    kprof = level_major(lbl.demo_batch(BK, L, device=dev))
    k4_args = {m: (freqs, kprof["p"], kprof["t"], kprof["rho"], kprof["lwc"],
                   m) for m in H2O_MODELS}
    k4_err = None
    for model, args in k4_args.items():
        got = absorption_tangents_lb(*args)
        ref = absorption_tangents_lb_reference(*args)
        torch.cuda.synchronize()
        errs = []
        for name, g, r, bound in zip(("alpha", "dalpha/dT", "dalpha/drho"),
                                     got, ref, (1e-4, 1e-3, 1e-3)):
            check(bool(torch.isfinite(g).all()), f"K4 {model} {name}")
            err = (g - r).abs().amax(dim=(1, 2))
            rel = float((err / r.abs().amax(dim=(1, 2))).max())
            errs.append(float(err.max()))
            print(f"phase 5: K4 {model} B={BK} L={L}: {name} max|d| "
                  f"{float(err.max()):.3e}, max per-channel relative "
                  f"{rel:.3e} (bound {bound:g})")
            check(rel <= bound, f"K4 {model} {name} relative error {rel}")
        if model == "R24":
            k4_err = max(errs)

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
    k5_ms = {}
    for which in ("t", "rho_lwc"):
        kernel, plain, args = k5_calls[which]
        k5_ms[which] = (timed_ms(lambda: kernel(*args)),
                        timed_ms(lambda: plain(*args)))
    print(f"phase 9: K4 tangents B={BK} L={L} F={len(freqs)}: kernel "
          f"{k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms")
    for which, (k_ms, p_ms) in k5_ms.items():
        print(f"phase 9: K5 {which} B={BK} E={len(elevs)} F={len(freqs)} "
              f"L={L}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
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

    print(json.dumps({"kernels": [
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
