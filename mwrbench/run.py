"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 -m mwrbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's file (`workloads/<cell>.json`)
names its configuration, its driver (one per entry point, under
`drivers/`) and its traffic.  The run:

  1. checks `BENCHMARK.json` and the import guard, and that the card is
     there (exit 2 where it is not);
  2. set-up: the driver makes the inputs from the seed on the host, moves
     them to the card once and warms up every shape the cell uses (the
     first run in a checkout also builds the kernels); `setup_s` is the
     time from the process's start to the first timed call;
  3. the window: a closed loop with one client for `--seconds`, each call
     issued when the previous one has synchronised; each call's latency is
     the host clock from its issue to that synchronise.  A seeded sample of
     the calls' outputs is kept.  With `--trace 1` a slice of the window
     (`trace_calls` calls, from its middle) runs under `torch.profiler`;
  4. reads the peak device memory, frees the program's inputs, and checks
     the kept outputs against the plain float64 reference
     (`reference/`), each number against its limit in the cell's file;
  5. prints the numbers compared, each beside its limit, as the last lines
     of standard error, and one JSON line last on standard output: the
     end-to-end metrics with `--trace 0`, the per-layer ones with
     `--trace 1`.

It exits 2 without a card, 3 outside a full checkout (no port package),
4 where JAX or the JAX package was loaded, and 1 on any other failure; no
result is printed then.
"""

import time

_T0 = time.perf_counter()

import argparse                 # noqa: E402
import dataclasses              # noqa: E402
import gc                       # noqa: E402
import importlib                # noqa: E402
import importlib.util           # noqa: E402
import json                     # noqa: E402
import math                     # noqa: E402
import os                       # noqa: E402
import random                   # noqa: E402
import sys                      # noqa: E402
from pathlib import Path        # noqa: E402

from . import guard, manifest   # noqa: E402

# every cache the run may write, at fixed paths inside the checkout
OUT_DIR = manifest.ROOT / "build" / "mwrbench"
CACHE_ENV = {"TRITON_CACHE_DIR": OUT_DIR / "triton",
             "TORCH_EXTENSIONS_DIR": OUT_DIR / "torch_extensions"}


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the cell, the window and the trace."""

    workload: dict
    config: dict
    driver: object
    setup_s: float
    latencies_s: list
    window_s: float
    work: dict          # the window's completed work, by kind
    untraced_call_s: float = math.nan
    trace: object = None


def _load_file(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"mwrbench._readers.{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(kind: str, name: str):
    """The `read(ctx)` of metric `name` (kind "end_to_end" or "metrics")."""
    tag = f"{kind}.{name}".replace(".", "_").replace("-", "_")
    return _load_file(manifest.reader_path(kind, name), tag).read


def cell_spec(workload: str, overrides=None) -> tuple:
    """(workload file, config file) of a cell, with `overrides` applied to
    both (the tests' small sizes)."""
    spec = manifest.read_json(manifest.workload_path(workload))
    config = manifest.read_json(manifest.config_path(spec["config"]))
    for key, value in (overrides or {}).items():
        (config if key in config else spec)[key] = value
    return spec, config


def make_driver(spec: dict, config: dict, seed: int, device):
    module = importlib.import_module(f"mwrbench.drivers.{spec['driver']}")
    return module.Driver(config, spec, seed, device)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(driver, seconds: float, seed: int, device, samples: int,
           trace_calls: int = 0, wrap=None):
    """The closed loop.  Returns (latencies [s], window [s], calls that
    raised, kept [(call index, output)], trace path or None, the indices of
    the traced calls)."""
    import torch
    call = driver.call if wrap is None else wrap(driver.call)
    pick = random.Random(seed * 1_000_003 + 17)
    kept, latencies, failed = [], [], 0
    prof, traced, trace_path = None, range(0), None
    start = time.perf_counter()
    i = 0
    while True:
        if trace_calls and prof is None and not traced and (
                time.perf_counter() - start >= 0.5 * seconds):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            traced = range(i, i + trace_calls)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("mwrbench.call"):
                out = call(i)
                _sync(device)
        except Exception as exc:        # a failed call counts; the run goes on
            failed += 1
            print(f"call {i} failed: {exc!r}", file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if out is not None:             # reservoir sample of the outputs
            if len(kept) < samples:
                kept.append((i, driver.keep(out)))
            elif (j := pick.randrange(i + 1)) < samples:
                kept[j] = (i, driver.keep(out))
        i += 1
        if prof is not None and i == traced.stop:
            prof.stop()
            OUT_DIR.mkdir(parents=True, exist_ok=True)
            trace_path = OUT_DIR / "trace.json"
            prof.export_chrome_trace(str(trace_path))
            prof = None
        if t1 - start >= seconds and prof is None and (
                traced or not trace_calls):
            break
    return latencies, t1 - start, failed, kept, trace_path, traced


def measure(workload: str, seed: int, seconds: float, trace: bool, device,
            bench: dict, overrides=None, wrap=None, t0: float = _T0) -> dict:
    """Run one cell; returns the result object (its `checks` last)."""
    import torch
    from . import traceread
    spec, config = cell_spec(workload, overrides)
    t_in = time.perf_counter()
    driver = make_driver(spec, config, seed, device)
    t_warm = time.perf_counter()
    # the peak of the program and its inputs, not of the arithmetic that
    # made them (the stage cell's fit of the fast weights)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver.warm_up()
    _sync(device)
    setup_s = time.perf_counter() - t0
    print(f"setup: start to driver {t_in - t0:.3f} s, inputs "
          f"{t_warm - t_in:.3f} s, warm-up {t0 + setup_s - t_warm:.3f} s",
          file=sys.stderr)

    lat, win_s, failed, kept, trace_path, traced = window(
        driver, seconds, seed, device, spec.get("samples", 4),
        spec.get("trace_calls", 20) if trace else 0, wrap)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    calls = len(lat)
    ctx = Context(spec, config, driver, setup_s, lat, win_s,
                  {k: v * (calls - failed) for k, v in driver.work.items()})
    if trace_path is not None:
        ctx.trace = traceread.read(trace_path)
        rest = [s for i, s in enumerate(lat) if i not in traced]
        ctx.untraced_call_s = sum(rest) / max(len(rest), 1)

    kind = "metrics" if trace else "end_to_end"
    wanted = [m for m in bench["per_layer" if trace else "end_to_end"]
              if manifest.reports(m, workload)]
    metrics = {}
    for m in wanted:
        value = reader(kind, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"{m['name']}: no value in {workload}")

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check(kept, device)
    print(f"setup {setup_s:.3f} s, window {win_s:.3f} s, {len(lat)} calls, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = spec["limits"]
    correct = (failed == 0 and len(kept) > 0
               and all(math.isfinite(v) and v <= limits[k]
                       for k, v in numbers.items()))
    # a number that is not finite (a NaN where the reference has a value)
    # is written as null: JSON has no infinity
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": limits[k]} for k, v in numbers.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": calls, "failed": failed,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = traceread.breakdown(ctx.trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 1
    guard.check("start")
    if importlib.util.find_spec(guard.PORT) is None:
        print(f"no {guard.PORT} package here: run from the root of a full "
              f"checkout", file=sys.stderr)
        return 3
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    import torch
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {need} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), bench)
    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'OVER'}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
