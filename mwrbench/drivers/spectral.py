"""`models.spectral.forward_spectral` + `srf_convolve`: the monochromatic
spectrum of each profile on the configuration's grid, in chunks of
`freq_chunk` (K6 and K3 once a chunk), folded with the channels' spectral
response functions (the float64 product).  A pool of seeded batches on the
card, one call per batch in turn; the grid and the weights live on the card.

Checked: the widest gap |TB_channel - TB_channel,ref| [K] over the kept
calls, against the float64 reference (`reference.forward.spectral_srf`).
"""

import numpy as np
import torch

from .. import inputs
from ..reference import forward as ref
from . import batch_of, max_abs, profile_pool


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
            spectral)
        self._spectral = spectral
        self.f = np.linspace(config["f_min_ghz"], config["f_max_ghz"],
                             config["n_freqs"]).astype(np.float32)
        self.w = inputs.srf_weights(self.f)
        self.f_dev = torch.from_numpy(self.f).to(device)
        self.w_dev = torch.from_numpy(self.w).to(device)
        self.elevations = tuple(config["elevations_deg"])
        self.model = config["model"]
        self.chunk = workload["freq_chunk"]
        self.host, self.pool = profile_pool(seed, workload["pool"],
                                            workload["batch"],
                                            config["n_levels"], device)
        self.work = {"freq_points": workload["batch"] * self.f.size}

    def warm_up(self):
        for j in range(len(self.pool)):
            self.call(j)

    def call(self, i):
        out = self._spectral.forward_spectral(
            self.pool[i % len(self.pool)], self.f_dev, self.elevations,
            self.model, freq_chunk=self.chunk)
        return self._spectral.srf_convolve(out["tb"], self.w_dev)

    def keep(self, out):
        return out.clone()

    def release(self):
        self.pool = self.f_dev = self.w_dev = None

    def _reference(self, j, device, dtype, srf_dtype):
        return ref.spectral_srf(batch_of(self.host, j), self.f, self.w,
                                self.elevations, self.model, dtype=dtype,
                                srf_dtype=srf_dtype, device=device)

    def check(self, kept, device) -> dict:
        n_pool = len(self.host["t"])
        refs = {}
        gap = 0.0
        for i, tb in kept:
            j = i % n_pool
            if j not in refs:
                refs[j] = self._reference(j, device, torch.float64,
                                          torch.float64)
            gap = max(gap, max_abs(tb, refs[j]))
        return {"tb_srf_max_abs_k": gap}

    def control(self, i, device, dtype):
        # the spectrum one step below float32, the product one below float64
        return self._reference(i % len(self.host["t"]), device, dtype,
                               torch.float32)
