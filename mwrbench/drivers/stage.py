"""`pipeline.forward.forward_stage` on one seeded harmonized dataset of
`n_time` times x 2 crops x the configuration's levels: every release of
the configuration, the fast operator with weights the benchmark fits in
set-up (its own plain closed-form fit on crop 0, as `forward --fast-params`
takes them from a file), and the K-matrix, `batch_size` profiles a chunk;
the outputs come back as host arrays.  The crops are two draws of the
generator; `invalid` of the (time, crop) profiles carry a NaN level, which
the stage screens and masks.

Checked against `reference.stage.outputs` (float64) on every variable the
stage writes: the widest TB gaps [K] of the LBL (every release) and of the
fast operator, the widest transmittance gaps, each K's widest gap as a
share of its max |K|, and the count of entries whose NaN mask differs (an
exact comparison).
"""

import numpy as np
import torch

from .. import inputs
from ..reference import fast as ref_fast
from ..reference import stage as ref_stage

NUMBERS = ("tb_lbl_max_abs_k", "tb_fast_max_abs_k", "ttrans_max_abs",
           "levtrans_max_abs", "jac_t_rel", "jac_rho_rel", "jac_liq_rel",
           "nan_mismatch")


def harmonized(seed: int, n_time: int, n_levels: int, invalid: float):
    """The dataset's level variables, (N_Levels, time, Crop) top -> ground,
    float32, made from two draws of `inputs.profiles` as the port's bench
    makes its stage dataset; a seeded share `invalid` of the (time, crop)
    profiles gets a NaN temperature at one level."""
    crops = [inputs.profiles(seed, n_time, n_levels, stream=10 + c)
             for c in (0, 1)]

    def lev(key_fn):
        a = np.stack([key_fn(c) for c in crops], axis=-1)  # (time, L, 2)
        return np.ascontiguousarray(a.transpose(1, 0, 2)[::-1],
                                    dtype=np.float32)

    def mr(c):
        e = c["rho"] * c["t"] / 216.679
        return 1000.0 * 0.622 * e / np.maximum(c["p"] - e, 1e-3)

    def liq(c):
        return c["lwc"] / 1000.0 / (c["p"] * 100.0 / (287.04 * c["t"]))

    levels = {"Level_Pressure": lev(lambda c: c["p"]),
              "Level_Temperature": lev(lambda c: c["t"]),
              "Level_H2O": lev(mr), "Level_z": lev(lambda c: c["z"]),
              "Level_Liquid": lev(liq)}
    rng = inputs.generator(seed, 20)
    bad = rng.random((n_time, 2)) < invalid
    at = rng.integers(0, n_levels, (n_time, 2))
    for i, c in zip(*np.nonzero(bad)):
        levels["Level_Temperature"][at[i, c], i, c] = np.nan
    return levels


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from mwr_fast_forward_operators_and_lbls_tpu_torch.data import (
            dataset)
        from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
            forward as stage)
        self._stage = stage.forward_stage
        self.freqs = tuple(config["channels_ghz"])
        self.elevations = tuple(config["elevations_deg"])
        self.models = tuple(config["absorption_models"])
        self.batch = workload["batch_size"]
        self.device = device
        self.levels = harmonized(seed, workload["n_time"],
                                 config["n_levels"], workload["invalid"])
        self.ds = dataset.Dataset()
        for k, v in self.levels.items():
            self.ds[k] = dataset.Variable(("N_Levels", "time", "Crop"), v)
        fit_on = ref_stage.profiles_of(self.levels, 0)
        ok = np.all([np.isfinite(v).all(axis=1) for v in fit_on.values()],
                    axis=0)
        self.w = ref_fast.fit_closed_form({k: v[ok] for k, v in
                                           fit_on.items()}, self.freqs,
                                          self.models[-1], device)
        self.params = {"w": torch.from_numpy(self.w).to(device)}
        n_time = workload["n_time"]
        self.work = {"spectra": n_time * 2 * len(self.elevations)
                     * len(self.models)}

    def warm_up(self):
        self.call(0)

    def call(self, i):
        ds = self._stage(self.ds, models=self.models,
                         fast_params=self.params, with_jacobians=True,
                         batch_size=self.batch, device=self.device)
        return {k: v.data for k, v in ds.variables.items()
                if not k.startswith("Level_")}

    def keep(self, out):
        return out              # fresh host arrays every call

    def release(self):
        self.ds = self.params = None

    def _reference(self, device, dtype, product_dtype=None):
        return ref_stage.outputs(self.levels, self.w, self.models,
                                 self.freqs, self.elevations, device, dtype,
                                 product_dtype)

    def check(self, kept, device) -> dict:
        ref = self._reference(device, torch.float64)
        nums = dict.fromkeys(NUMBERS, 0.0)
        for _, out in kept:
            for name, want in ref.items():
                got = out.get(name)
                if got is None or tuple(got.shape) != tuple(want.shape):
                    return dict.fromkeys(NUMBERS, float("inf"))
                got = torch.from_numpy(np.asarray(got)).to(device).double()
                nums["nan_mismatch"] += float(
                    (got.isnan() != want.isnan()).sum())
                both = got.isfinite() & want.isfinite()
                gap = float((got - want).abs()[both].max()) \
                    if bool(both.any()) else 0.0
                if not bool(got[~want.isnan()].isfinite().all()):
                    gap = float("inf")
                key = _number_of(name)
                if key.startswith("jac_"):
                    gap /= float(want[both].abs().max())
                nums[key] = max(nums[key], gap)
        return nums

    def control(self, i, device, dtype):
        # the LBL and the K-matrix one step below float32; the fast
        # operator's float32 product (TF32 off) with TF32 on
        previous = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = self._reference(device, dtype, torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = previous
        return out


def _number_of(name: str) -> str:
    if name.startswith("TBs_LBL_"):
        return "tb_lbl_max_abs_k"
    return {"TBs_Fast": "tb_fast_max_abs_k", "ttrans_Fast": "ttrans_max_abs",
            "levtrans_Fast": "levtrans_max_abs", "Jacobian_T_LBL": "jac_t_rel",
            "Jacobian_rho_LBL": "jac_rho_rel",
            "Jacobian_liq_LBL": "jac_liq_rel"}[name]
