"""`models.retrieval.retrieve_batch`, the 1D-Var retrieval the port's CLI
runs (`retrieve`), at the configuration's channels, elevations, levels and
`OEMConfig` values: a pool of seeded batches of observations and priors on
the card, one call per batch in turn, the fast operator's weights fixed.

The inputs, from the seed:

  truth        `inputs.profiles` (stream 0), `pool` x `batch` profiles;
  weights      the frozen closed-form ridge fit (`reference.fast`) onto the
               float64 LBL of `fast_fit_profiles` profiles of stream 30;
  observations the float64 reference LBL (`reference.forward.lbl_tb`) of
               the truth plus N(0, obs_error_k) noise (stream 31), float32;
  priors       the truth plus a draw from Sa (stream 32): T and
               ln(rho + rho_floor) errors of the prior's own sigma_t_k and
               sigma_lnrho and its correlation length; rho clamped at 0,
               float32;
  liquid       held at the truth, as `cli retrieve` holds the dataset's.

Checked against the float64 reference retrieval (`reference.oem`) of the
same inputs, each profile's widest gap of t [K], of ln(rho + rho_floor), of
the fitted TBs [K] and its gap of the degrees of freedom for signal
(infinite where an entry is finite on one side only): their largest over the
kept profiles, the 99th percentile (nearest rank) of the first three, and
the count of entries whose finiteness differs (exact).  The largest gaps
come from the few profiles whose prior lies so far from their solution that
5 steps leave them short of it, where the float32 operator's rounding moves
the path; the percentiles hold the rest of the batch close.

The control is the reference with F and K in the dtype it is given and the
linear algebra in that dtype or float32, whichever is wider, as the port
computes F and K in float32 and its linear algebra in float64: a Cholesky
of a system whose condition number reaches 1e5 has no digit left in
bfloat16.
"""

import math

import numpy as np
import torch

from .. import inputs
from ..reference import fast as ref_fast
from ..reference import forward as ref_forward
from ..reference import oem as ref_oem

NUMBERS = {"t": "t_max_abs_k", "rho": "lnrho_max_abs",
           "tb_fit": "tb_fit_max_abs_k", "dofs": "dofs_max_abs"}
# the 99th percentile over the profiles of each profile's widest gap
P99 = {"t": "t_p99_abs_k", "rho": "lnrho_p99_abs",
       "tb_fit": "tb_fit_p99_abs_k"}
LIMITED = (*NUMBERS.values(), *P99.values(), "nan_mismatch")
OEM_KEYS = ("n_iter", "obs_error_k", "sigma_t_k", "sigma_lnrho",
            "corr_length_levels", "rho_floor")
# the reference's K: profiles a backward pass
REF_BLOCK = 64


def prior_errors(rng, n: int, n_levels: int, sigma: float,
                 corr_len: float):
    """(n, L) draws of N(0, sigma^2 exp(-|i - j| / corr_len)): one block of
    Sa."""
    i = np.arange(n_levels)
    low = np.linalg.cholesky(np.exp(-np.abs(i[:, None] - i[None, :])
                                    / corr_len))
    return sigma * rng.standard_normal((n, n_levels)) @ low.T


def make_inputs(seed: int, config: dict, batch: int, pool: int,
                device) -> dict:
    """Host arrays of the cell: `truth` {z, p, t, rho, lwc} (pool, batch,
    L), `y` (pool, batch, E, C), `t_prior`, `rho_prior` (pool, batch, L),
    all float32, and the weights `w` (72, C)."""
    n_lev, n = config["n_levels"], pool * batch
    freqs, els = config["channels_ghz"], config["elevations_deg"]
    model, floor = config["absorption_model"], config["rho_floor"]
    truth = inputs.profiles(seed, n, n_lev)
    fit_on = inputs.profiles(seed, config["fast_fit_profiles"], n_lev,
                             stream=30)
    w = ref_fast.fit_closed_form(fit_on, freqs, model, device)
    tb = ref_forward.lbl_tb(truth, freqs, els, model, torch.float64,
                            device).cpu().numpy()
    y = tb + config["obs_error_k"] * inputs.generator(
        seed, 31).standard_normal(tb.shape)
    rng = inputs.generator(seed, 32)
    corr = config["corr_length_levels"]
    t_prior = truth["t"] + prior_errors(rng, n, n_lev, config["sigma_t_k"],
                                        corr)
    lnrho = np.log(truth["rho"].astype(np.float64) + floor) + prior_errors(
        rng, n, n_lev, config["sigma_lnrho"], corr)
    rho_prior = np.maximum(np.exp(lnrho) - floor, 0.0)

    def cut(a):
        return np.ascontiguousarray(
            a.reshape(pool, batch, *a.shape[1:]), dtype=np.float32)

    return {"truth": {k: cut(v) for k, v in truth.items()}, "y": cut(y),
            "t_prior": cut(t_prior), "rho_prior": cut(rho_prior), "w": w}


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
            retrieval)
        self._retrieve = retrieval.retrieve_batch
        self.freqs = tuple(config["channels_ghz"])
        self.elevations = tuple(config["elevations_deg"])
        self.oem = {k: config[k] for k in OEM_KEYS}
        self.cfg = retrieval.OEMConfig(freqs_ghz=self.freqs,
                                       elevations_deg=self.elevations,
                                       **self.oem)
        self.host = make_inputs(seed, config, workload["batch"],
                                workload["pool"], device)
        self.params = {"w": torch.from_numpy(self.host["w"]).to(device)}
        self.pool = []
        for j in range(workload["pool"]):
            batch = {k: torch.from_numpy(self.host[k][j]).to(device)
                     for k in ("y", "t_prior", "rho_prior")}
            batch.update({k: torch.from_numpy(v[j]).to(device)
                          for k, v in self.host["truth"].items()})
            self.pool.append(batch)
        self.work = {"profiles": workload["batch"]}

    def warm_up(self):
        for j in range(len(self.pool)):
            self.call(j)

    def call(self, i):
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 is on for float32 products; the "
                               "configuration states tf32 false")
        b = self.pool[i % len(self.pool)]
        return self._retrieve(self.params, b["y"], b["z"], b["p"],
                              b["t_prior"], b["rho_prior"], self.cfg,
                              b["lwc"])

    def keep(self, out):
        return {k: out[k].cpu() for k in NUMBERS}

    def release(self):
        self.pool = self.params = None

    def _reference(self, j, device, dtype):
        h = self.host
        return ref_oem.retrieve(
            h["w"], {k: v[j] for k, v in h["truth"].items()}, h["y"][j],
            h["t_prior"][j], h["rho_prior"][j], self.freqs, self.elevations,
            self.oem, dtype, device, REF_BLOCK,
            torch.promote_types(dtype, torch.float32))

    def check(self, kept, device) -> dict:
        n_pool = len(self.host["y"])
        floor = self.oem["rho_floor"]
        gaps = {name: [] for name in NUMBERS}
        mismatch = 0.0
        for j in sorted({i % n_pool for i, _ in kept}):
            ref = self._reference(j, device, torch.float64)
            for i, out in kept:
                if i % n_pool != j:
                    continue
                for name in NUMBERS:
                    got = out[name].to(device).double()
                    want = ref[name]
                    if tuple(got.shape) != tuple(want.shape):
                        return dict.fromkeys(LIMITED, float("inf"))
                    if name == "rho":
                        got, want = (torch.log(v + floor)
                                     for v in (got, want))
                    got, want = (v.reshape(len(v), -1) for v in (got, want))
                    fin_got, fin_want = got.isfinite(), want.isfinite()
                    differ = fin_got != fin_want
                    mismatch += float(differ.sum())
                    gap = torch.where(fin_got & fin_want, got - want,
                                      0.0).abs().amax(1)
                    gaps[name].append(torch.where(differ.any(1), torch.inf,
                                                  gap))
        nums = {"nan_mismatch": mismatch}
        for name, number in NUMBERS.items():
            per_profile = torch.sort(torch.cat(gaps[name])).values
            nums[number] = float(per_profile[-1])
            if name in P99:
                rank = math.ceil(0.99 * len(per_profile)) - 1
                nums[P99[name]] = float(per_profile[rank])
        return {k: nums[k] for k in LIMITED}

    def control(self, i, device, dtype):
        return self._reference(i % len(self.host["y"]), device, dtype)
