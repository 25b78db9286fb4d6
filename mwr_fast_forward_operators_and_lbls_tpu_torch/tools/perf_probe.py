"""Measured per-stage decomposition of the headline LBL forward.

The counterpart of the JAX package's `tools/perf_probe.py`.  It splits the
production forward (`models/lbl.forward_batch`, R24, `tb` only, the kernels
on) at `--batch` profiles x 180 levels into its device stages and times each
with `parallel/profiling.device_time` (CUDA events on the card; 40 calls,
median of 4 trials), against the per-category bounds of
`profiling.lbl_roofline` at `profiling.DEFAULT_PEAKS`:

  * the whole forward, `lbl.forward_batch`;
  * K1 alone, `ops/cuda/absorption.py::absorption_lb`, on the (L, B) layout
    that `forward_batch` hands it (`lbl.level_major_profiles`);
  * K2 alone, `ops/cuda/rte.py::forward_lb`, on alpha, z, the refractive
    index and T as `forward_batch` computes them;
  * the glue, the rest of the forward, floored at 0 with the raw value kept.

One check the JAX tool lacks: K2 applied to the K1 output that the probe
timed must give `forward_batch`'s tb to the bit
(`k2_of_k1_equals_forward_batch`), or the split is not what the forward
runs; `main` exits with 1 when it does not.

The JSON has the JAX tool's keys with these differences: "platform" is the
torch device's type and "device" its name.  The JAX tool's "refined" model
counts the Pallas kernels' jaxprs (`count_pallas_ops`), which the port has
not got; in its place the `as_coded_*` keys price what the bodies under
`csrc/` execute as they are coded (`profiling.k1_roofline` and
`k2_roofline` with `as_coded=True`, K2's Planck series share taken from
the run's data) through `profiling.pipeline_model_time`: the fma, divide and
exp times added, the bytes beside them.  The per-point counts
(`as_coded_counts_*_per_pt`) are fp32-pipe instructions, divides,
transcendentals and bytes of device memory (`profiling.Roofline`'s
fields), not jaxpr primitives.

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.tools.perf_probe \
        [--batch 1024] [--device cpu]
"""

import argparse
import json
import sys

import torch

from ..models import lbl
from ..ops import geometry, thermo
from ..ops.cuda.absorption import absorption_lb
from ..ops.cuda.rte import forward_lb
from ..ops.tensors import device_name, resolve_device
from ..parallel import profiling

N_LEVELS = 180
ITERS, TRIALS = 40, 4


def probe(batch: int = 1024, n_levels: int = N_LEVELS, device=None) -> dict:
    """The split of `forward_batch` at `batch` x `n_levels` on `device` (the
    CUDA card when None; RuntimeError before any work where there is none).

    Each `device_time` call runs its function 1 + ITERS x TRIALS times; the
    equality check runs K2 once and `forward_batch` once more, so the call
    launches K1 and K2 each 2 (1 + ITERS x TRIALS) + 2 times.
    """
    dev = resolve_device(device)
    b = batch
    config = lbl.LBLConfig(model="R24", outputs=("tb",))
    freqs = config.freqs_ghz
    elevs = config.elevations_deg
    profiles = lbl.demo_batch(b, n_levels=n_levels, device=dev)

    # level-major inputs as the production path lays them out
    zt, pt, tt, rt, wt = lbl.level_major_profiles(profiles, config).values()

    t_full = profiling.device_time(
        lambda pr: lbl.forward_batch(pr, config), (profiles,),
        iters=ITERS, trials=TRIALS)

    t_abs = profiling.device_time(
        lambda p_, t_, r_, w_: absorption_lb(freqs, p_, t_, r_, w_, "R24"),
        (pt, tt, rt, wt), iters=ITERS, trials=TRIALS)

    alpha = absorption_lb(freqs, pt, tt, rt, wt, "R24")
    e_hpa = thermo.rho_to_e(rt, tt)
    n = geometry.refractive_index(pt, tt, e_hpa)

    t_rte = profiling.device_time(
        lambda a_, z_, n_, t_: forward_lb(freqs, elevs, a_, z_, n_, t_),
        (alpha, zt, n, tt), iters=ITERS, trials=TRIALS)

    # the split is what the forward runs: K2 of the timed K1 output
    tb_split = forward_lb(freqs, elevs, alpha, zt, n, tt)["tb"].permute(
        2, 0, 1)
    same = bool(torch.equal(tb_split,
                            lbl.forward_batch(profiles, config)["tb"]))

    roof = profiling.lbl_roofline(b, n_levels)
    peaks = profiling.DEFAULT_PEAKS
    spectra = b * len(elevs)

    # the as-coded model: what the bodies execute x the published rates
    c_abs = profiling.k1_roofline(b * n_levels, freqs, "R24", as_coded=True)
    c_rte = profiling.k2_roofline(
        b, n_levels, len(freqs), len(elevs),
        planck_series_fraction=profiling.planck_series_share(freqs, tt),
        as_coded=True)
    m_abs = profiling.pipeline_model_time(c_abs, peaks)
    m_rte = profiling.pipeline_model_time(c_rte, peaks)

    def per_point(c):
        return {"fma": round(c.fma_ops / (b * n_levels), 1),
                "div": round(c.div_ops / (b * n_levels), 1),
                "exp": round(c.exp_ops / (b * n_levels), 1),
                "hbm_bytes": round(c.hbm_bytes / (b * n_levels), 1)}

    return {
        "batch": b,
        "platform": dev.type,
        "device": device_name(dev),
        "full_forward_ms": round(t_full * 1e3, 4),
        "absorption_kernel_ms": round(t_abs * 1e3, 4),
        "rte_kernel_ms": round(t_rte * 1e3, 4),
        # Stage times are separately-minimized measurements, so their sum
        # can exceed the full forward by the measurement jitter; the glue
        # residual is floored at 0 with the raw value kept for honesty.
        "glue_ms": round(max(t_full - t_abs - t_rte, 0.0) * 1e3, 4),
        "glue_ms_raw": round((t_full - t_abs - t_rte) * 1e3, 4),
        "spectra_per_s": round(spectra / t_full, 1),
        "strict_bound_ms": round(roof.time_bound_s(peaks) * 1e3, 4),
        "strict_frac": round(roof.time_bound_s(peaks) / t_full, 3),
        "category_bounds_ms": {
            "fma": round(roof.fma_ops / peaks["fma"] * 1e3, 4),
            "div": round(roof.div_ops / peaks["div"] * 1e3, 4),
            "exp": round(roof.exp_ops / peaks["exp"] * 1e3, 4),
            "hbm": round(roof.hbm_bytes / peaks["hbm"] * 1e3, 4),
        },
        "additive_bound_ms": round(
            (roof.fma_ops / peaks["fma"] + roof.div_ops / peaks["div"]
             + roof.exp_ops / peaks["exp"]) * 1e3, 4),
        "as_coded_model_abs_ms": round(m_abs * 1e3, 4),
        "as_coded_model_rte_ms": round(m_rte * 1e3, 4),
        "as_coded_frac_abs": round(m_abs / t_abs, 3),
        "as_coded_frac_rte": round(m_rte / t_rte, 3),
        "as_coded_frac_full": round((m_abs + m_rte) / t_full, 3),
        "as_coded_counts_abs_per_pt": per_point(c_abs),
        "as_coded_counts_rte_per_pt": per_point(c_rte),
        "k2_of_k1_equals_forward_batch": same,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="the CUDA card when not given (an error where there "
                         "is none); 'cpu' runs the plain torch paths")
    args = ap.parse_args(argv)
    out = probe(args.batch, device=args.device)
    print(json.dumps(out, indent=1))
    return 0 if out["k2_of_k1_equals_forward_batch"] else 1


if __name__ == "__main__":
    sys.exit(main())
