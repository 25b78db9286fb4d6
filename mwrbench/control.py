"""The two readings each limit of `workloads/<cell>.json` is set from.

    python3 -m mwrbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 2]

For every seed of `--seeds`, the program: the cell's set-up and a short
window at its own load, with the outputs kept and checked as a run keeps
and checks them (the lower reading is the largest over the seeds).  For
every seed of `--control-seeds`, the control: the plain reference computed
in bfloat16, the precision below the configurations' float32, put in the
program's place for the same number of kept calls and checked the same way
(the upper reading is the smallest over the seeds).  One process for all
seeds, on the card; the tests call `program_numbers` and `control_numbers`
on the CPU at small sizes.  Prints one JSON line per seed, then the
readings.  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys

import torch

from . import run


def program_numbers(workload, seed, seconds, device, overrides=None) -> dict:
    spec, config = run.cell_spec(workload, overrides)
    driver = run.make_driver(spec, config, seed, device)
    driver.warm_up()
    _, _, failed, kept, _, _ = run.window(driver, seconds, seed, device,
                                          spec.get("samples", 4))
    driver.release()
    gc.collect()
    numbers = driver.check(kept, device)
    return dict(numbers, failed=failed)


def control_numbers(workload, seed, dtype, device, overrides=None) -> dict:
    spec, config = run.cell_spec(workload, overrides)
    driver = run.make_driver(spec, config, seed, device)
    driver.release()
    kept = [(i, driver.keep(driver.control(i, device, dtype)))
            for i in range(spec.get("samples", 4))]
    return driver.check(kept, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",") if s):
        nums = program_numbers(args.workload, seed, args.seconds, device)
        print(json.dumps({"seed": seed, "program": nums}), flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        nums = control_numbers(args.workload, seed, torch.bfloat16,
                               device)
        print(json.dumps({"seed": seed, "control": nums}), flush=True)
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
