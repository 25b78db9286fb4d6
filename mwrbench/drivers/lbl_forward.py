"""`models.lbl.forward_batch`, `tb` only, at the configuration's channels,
elevations and levels: a pool of seeded batches on the card, one call per
batch in turn (K1, the refractive index, K2).

Checked: the widest gap |TB - TB_ref| [K] over the kept calls, against the
float64 reference of the whole batch (`reference.forward.lbl_tb`).
"""

import torch

from ..reference import forward as ref
from . import batch_of, max_abs, profile_pool


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from mwr_fast_forward_operators_and_lbls_tpu_torch.models import lbl
        self._forward = lbl.forward_batch
        self.freqs = tuple(config["channels_ghz"])
        self.elevations = tuple(config["elevations_deg"])
        self.model = workload["model"]
        self.cfg = lbl.LBLConfig(model=self.model, freqs_ghz=self.freqs,
                                 elevations_deg=self.elevations,
                                 outputs=("tb",))
        self.host, self.pool = profile_pool(seed, workload["pool"],
                                            workload["batch"],
                                            config["n_levels"], device)
        self.work = {"spectra": workload["batch"] * len(self.elevations)}

    def warm_up(self):
        for j in range(len(self.pool)):
            self.call(j)

    def call(self, i):
        return self._forward(self.pool[i % len(self.pool)], self.cfg)["tb"]

    def keep(self, out):
        return out.clone()

    def release(self):
        self.pool = None

    def _reference(self, j, device, dtype):
        return ref.lbl_tb(batch_of(self.host, j), self.freqs,
                          self.elevations, self.model, dtype=dtype,
                          device=device)

    def check(self, kept, device) -> dict:
        n_pool = len(self.host["t"])
        refs = {}
        gap = 0.0
        for i, tb in kept:
            j = i % n_pool
            if j not in refs:
                refs[j] = self._reference(j, device, torch.float64)
            gap = max(gap, max_abs(tb, refs[j]))
        return {"tb_max_abs_k": gap}

    def control(self, i, device, dtype):
        return self._reference(i % len(self.host["t"]), device, dtype)
