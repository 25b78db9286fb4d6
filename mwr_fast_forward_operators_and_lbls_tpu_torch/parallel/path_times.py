"""Time one entry point of the port on the card, host and device apart.

    PYTHONPATH=<checkout> python path_times.py [--path kmatrix|forward]
                                               [--batch B] [--rounds N]

The wall time of a call by CUDA events moves with the host, which shares its
cores; the device time and the number of kernels a call launches do not.
Each round prints the median wall time of 20 calls and, from a
`torch.profiler` trace of 5 more, the device time and the device kernels and
copies per call with the largest of them, and the last line is one JSON
object with all rounds.  The script uses only what every version of the
port has (`lbl.demo_batch`, `lbl.forward_batch`,
`jacobians.kmatrix_batch_fast`), so that two checkouts can be compared with
the same file: run it once per checkout, alternating, back to back on one
card.
"""

import argparse
import json
import statistics

import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (jacobians,
                                                                  lbl)


def wall_ms(fn, repeats: int = 20) -> float:
    """Median over `repeats` of the CUDA-event time of one call [ms]."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_profile(fn, calls: int = 5, n_top: int = 6):
    """(device ms per call, device kernels and copies per call, the `n_top`
    largest as (name, launches per call, ms per call))."""
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("kmatrix", "forward"),
                        default="kmatrix")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--levels", type=int, default=180)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("path_times needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    profiles = lbl.demo_batch(args.batch, args.levels, device=dev)
    cfg = lbl.LBLConfig(model="R24", outputs=("tb",))
    if args.path == "kmatrix":
        def fn():
            return jacobians.kmatrix_batch_fast(profiles, cfg,
                                                wrt=("t", "rho", "lwc"))
    else:
        def fn():
            return lbl.forward_batch(profiles, cfg)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{args.path} B={args.batch} L={args.levels}")
    rounds = []
    for r in range(args.rounds):
        ms = wall_ms(fn)
        device_ms, kernels, top = device_profile(fn)
        rounds.append({"wall_ms": ms, "device_ms": device_ms,
                       "kernels_per_call": kernels})
        print(f"round {r}: wall {ms:.4f} ms; device {device_ms:.4f} ms in "
              f"{kernels:.1f} kernels and copies per call; "
              + "; ".join(f"{name} {t:.4f} ms x{c:g}" for name, c, t in top))
    print(json.dumps({"path": args.path, "batch": args.batch,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
