"""One driver per entry point of the port: `drivers/<name>.py` holds a
class `Driver(config, workload, seed, device)` with

  work        the work one call completes, by kind ({"spectra": n}, ...)
  warm_up()   every shape the cell's traffic uses, once
  call(i)     the i-th call of the window: the entry point on the i-th
              input of the pool; returns its outputs
  keep(out)   a copy of a call's outputs for the check
  release()   drops the program's inputs from the card
  check(kept, device)         {number: value}, each against the reference
  control(i, device, dtype)   what `call(i)` returns, from the reference
                              computed in `dtype` (the control)
"""

import torch

from .. import inputs


def profile_pool(seed: int, pool: int, batch: int, n_levels: int,
                 device) -> tuple:
    """(host, on the card): `pool` distinct batches of `batch` seeded
    profiles, numpy (pool, batch, L) arrays on the host and a list of
    {name: (batch, L) float32 tensor} on `device`, copied there once."""
    flat = inputs.profiles(seed, pool * batch, n_levels)
    host = {k: v.reshape(pool, batch, n_levels) for k, v in flat.items()}
    on_card = [{k: torch.from_numpy(v[j]).to(device) for k, v in host.items()}
               for j in range(pool)]
    return host, on_card


def batch_of(host: dict, j: int) -> dict:
    return {k: v[j] for k, v in host.items()}


def max_abs(a, b) -> float:
    """max |a - b| in float64; inf where either holds a NaN or an
    infinity."""
    d = (a.double() - b.double()).abs()
    return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")
