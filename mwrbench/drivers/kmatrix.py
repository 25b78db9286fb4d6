"""`models.jacobians.kmatrix_batch_fast` wrt (t, rho, lwc) at the
configuration's channels, elevations and levels: a pool of seeded batches
on the card, one call per batch in turn (K4, the float64 slant geometry,
K5a, K5b).

Checked, for each variable: the widest gap |K - K_ref| over the kept calls
as a share of max |K_ref| of that variable, against the float64 reference
that differentiates its own plain forward (`reference.forward.kmatrix`).
"""

import torch

from ..reference import forward as ref
from . import batch_of, max_abs, profile_pool

WRT = ("t", "rho", "lwc")


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
            jacobians, lbl)
        self._kmatrix = jacobians.kmatrix_batch_fast
        self.freqs = tuple(config["channels_ghz"])
        self.elevations = tuple(config["elevations_deg"])
        self.model = workload["model"]
        self.cfg = lbl.LBLConfig(model=self.model, freqs_ghz=self.freqs,
                                 elevations_deg=self.elevations)
        self.host, self.pool = profile_pool(seed, workload["pool"],
                                            workload["batch"],
                                            config["n_levels"], device)
        self.work = {"profiles": workload["batch"]}

    def warm_up(self):
        for j in range(len(self.pool)):
            self.call(j)

    def call(self, i):
        return self._kmatrix(self.pool[i % len(self.pool)], self.cfg, WRT)

    def keep(self, out):
        return {k: v.clone() for k, v in out.items()}

    def release(self):
        self.pool = None

    def _reference(self, j, device, dtype):
        return ref.kmatrix(batch_of(self.host, j), self.freqs,
                           self.elevations, self.model, dtype=dtype,
                           device=device)

    def check(self, kept, device) -> dict:
        n_pool = len(self.host["t"])
        gaps = dict.fromkeys(WRT, 0.0)
        for j in sorted({i % n_pool for i, _ in kept}):
            k_ref = self._reference(j, device, torch.float64)
            for i, k in kept:
                if i % n_pool == j:
                    for name in WRT:
                        scale = float(k_ref[name].abs().max())
                        gaps[name] = max(gaps[name],
                                         max_abs(k[name], k_ref[name]) / scale)
        return {f"k_{name}_rel": g for name, g in gaps.items()}

    def control(self, i, device, dtype):
        return self._reference(i % len(self.host["t"]), device, dtype)
