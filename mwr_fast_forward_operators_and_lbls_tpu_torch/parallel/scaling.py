"""Scaling-efficiency harness: the sharded LBL forward's throughput as the
mesh grows, at a fixed batch per mesh entry.

Torch counterpart of the JAX package's `parallel/scaling.py`.  Weak scaling
on the workload's natural axis, the profile batch: each entry gets
`per_device_batch` profiles, and efficiency at n entries is
(rate_n / n) / rate_1.  The forward is embarrassingly parallel, so the only
traffic is the gather of the outputs.

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.parallel.scaling

runs it over every visible CUDA device (and raises without one).  On one
card, pass `devices=[torch.device("cuda")] * n` for a virtual mesh; the
tests run it on CPU entries.
"""

import json

import torch

from ..models import lbl
from . import mesh as mesh_mod
from . import profiling
from . import sharding as shard_mod

_VIRTUAL_NOTE = (
    "virtual mesh: the entries share one card (or the host's CPU cores), "
    "so `efficiency` (per-entry rate) necessarily drops ~1/n and is NOT a "
    "weak-scaling measurement; `sharding_overhead_eff` (aggregate-rate "
    "invariance, ~1.0 = communication-free sharding) is the column to read")
_REAL_NOTE = ("real devices, one per entry: `efficiency` is the "
              "weak-scaling number (BASELINE target >= 0.90)")


def measure(per_device_batch: int = 256, n_levels: int = 180,
            device_counts=None, config: lbl.LBLConfig | None = None,
            iters: int = 11, devices=None) -> list:
    """Weak-scaling sweep over the first n of `devices` (default: every
    visible CUDA device; RuntimeError without one) for n in
    `device_counts` (default 1 and all).  Returns one row per n:
    {n_devices, seconds, spectra_per_s, efficiency, sharding_overhead_eff,
    platform, note}, relative to the first row.

    * ``efficiency`` ((rate_n / n) / rate_1) is the weak-scaling number
      where each entry is its own card, and means nothing on a virtual
      mesh, whose entries share one card.
    * ``sharding_overhead_eff`` (rate_n / rate_1, at n times the work in n
      shards) is what a virtual mesh measures honestly: the compute is the
      same hardware's in both runs, so a drop below 1.0 is the cost of the
      split (one host-side forward per shard and the gather copy).

    `seconds` is `profiling.device_time` of `forward_sharded_placed` on the
    placed shards: CUDA events on the lead device, the end event after the
    gather, so every shard's work is inside the window.
    """
    devices = (mesh_mod.visible_devices() if devices is None
               else [torch.device(d) for d in devices])
    if device_counts is None:
        device_counts = sorted({1, len(devices)})
    if config is None:
        config = lbl.LBLConfig(model="R24", outputs=("tb",))
    n_elev = len(config.elevations_deg)
    sweep = mesh_mod.make_mesh(devices)
    results = []
    base_per_dev = base_rate = None
    for n in device_counts:
        if n > len(devices):
            break
        m = mesh_mod.make_mesh(devices[:n])
        n = m.shape[mesh_mod.DATA_AXIS]
        batch = per_device_batch * n
        profiles = lbl.demo_batch(batch, n_levels=n_levels, device=m.lead)
        placed, _ = shard_mod.shard_profiles(profiles, m)
        t = profiling.device_time(
            lambda pr: shard_mod.forward_sharded_placed(pr, m, config),
            (placed,), iters=iters, device=m.lead)
        rate = batch * n_elev / t
        per_dev = rate / n
        if base_per_dev is None:
            base_per_dev, base_rate = per_dev, rate
        results.append({
            "n_devices": n,
            "seconds": t,
            "spectra_per_s": rate,
            "efficiency": per_dev / base_per_dev,
            "sharding_overhead_eff": rate / base_rate,
        })
    # self-describing rows: `efficiency` must not read as weak scaling
    # where the entries share one card
    for row in results:
        row["platform"] = sweep.lead.type
        row["note"] = _VIRTUAL_NOTE if sweep.virtual else _REAL_NOTE
    return results


def main():  # pragma: no cover - hardware entry point
    for row in measure():
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in row.items()}))


if __name__ == "__main__":  # pragma: no cover
    main()
