"""`models.fast.train_step`, the fast operator's distillation (the port's
CLI `distill` and `run-all --distill`): one training step a call, the
forward, the TB-space loss, the backward and Adam's update of the
regression's weights, at the configuration's channels, elevations and
levels.  The weights and Adam's state carry on from call to call, as a
training run's do; the calls walk the pool of minibatches in turn.

The inputs, from the seed:

  archive   `inputs.profiles` (stream 0), `pool` x `batch` profiles;
  targets   the float64 reference LBL (`reference.forward.lbl_tb`) of each
            profile, stored float32;
  weights   the frozen closed-form ridge fit (`reference.fast`) onto the
            float64 LBL of `fast_fit_profiles` profiles of stream 30, the
            start of the training run.

The driver runs `fast.FastConfig`, `fast.make_optimizer` and
`fast.train_step`, and in the check `fast.distill_loss`.  Per call it adds
one copy, the weights the step starts from with Adam's two moments, a
(3, 72, C) stack; `keep` takes it with the step's loss, the gradient the
step left on the weights and the weights after the step.

Checked against the float64 reference (`reference.distill`), for each kept
call, on its minibatch, each part of the step on its own:

  loss_rel      the forward: |loss - ref| / |ref|, the reference's loss at
                the weights the step started from;
  grad_rel_max  the backward: the reference's transposed Jacobian of tb at
                those weights applied to the program's own cotangent
                2 (tb - target) / N (minus the gradient of
                `fast.distill_loss` in its targets, at the kept weights),
                against the gradient the step left, the largest over the
                channels of max |g - ref| / max |ref| in the channel's
                column.  Near the fit the residuals are a few mK, the size
                of float32's rounding of tb, so the gradient of the exact
                loss is no yardstick for the backward; this one is;
  update_gap    the optimizer: Adam's step replayed in float64
                (`reference.distill.adam_step`) from the kept weights,
                moments, step count and gradient, against the weights the
                step left, in units of float32's own rounding of the step:
                the largest over the entries of |w1 - ref| / (half the
                float32 spacing at ref + 2^-23 k_t |ref - w0|), with
                k_t = 4 + 1 / (1 - b1^t) + 1 / (1 - b2^t) for the bias
                corrections 1 - b^t, which a float32 evaluation (torch's
                fused Adam) gets to 2^-24 absolute, some 1e-5 relative in
                the first steps.  An update of 1e-4 on a weight of 279 is
                a few float32 spacings, so a gap relative to the update
                would read ~0.3 for a correct step and 1 for a skipped
                one; in these units a correct step reads about 1 and a
                skipped one thousands;
  nan_mismatch  the entries whose finiteness differs (exact).

The control is the reference computed in the dtype it is given, at the
training run's first weights: its loss, its gradient, and its first Adam
step in that dtype.
"""

import numpy as np
import torch

from .. import inputs
from ..reference import distill as ref_distill
from ..reference import fast as ref_fast
from ..reference import forward as ref_forward

LIMITED = ("loss_rel", "grad_rel_max", "update_gap", "nan_mismatch")
# profiles a block of the reference's loss and gradient, and of its targets
REF_BLOCK = 256


def make_inputs(seed: int, config: dict, batch: int, pool: int,
                device) -> dict:
    """Host arrays of the cell: `profiles` {z, p, t, rho, lwc} (pool, batch,
    L), `targets` (pool, batch, E, C), all float32, and the first weights
    `w` (72, C)."""
    n_lev, n = config["n_levels"], pool * batch
    freqs, els = config["channels_ghz"], config["elevations_deg"]
    model = config["teacher_model"]
    archive = inputs.profiles(seed, n, n_lev)
    fit_on = inputs.profiles(seed, config["fast_fit_profiles"], n_lev,
                             stream=30)
    w = ref_fast.fit_closed_form(fit_on, freqs, model, device)
    tb = ref_forward.lbl_tb(archive, freqs, els, model, torch.float64,
                            device, REF_BLOCK).cpu().numpy()

    def cut(a):
        return np.ascontiguousarray(
            a.reshape(pool, batch, *a.shape[1:]), dtype=np.float32)

    return {"profiles": {k: cut(v) for k, v in archive.items()},
            "targets": cut(tb), "w": w}


def _worst(a: float, b: float) -> float:
    """The larger of two gaps, infinite where either is not a number."""
    return max(a, b) if np.isfinite(a) and np.isfinite(b) else float("inf")


def _column_gap(got, want, scale) -> tuple:
    """(the largest over the channels of max |got - want| / max |scale| in
    the channel's column, the entries whose finiteness differs)."""
    fin, fin_ref = torch.isfinite(got), torch.isfinite(want)
    gap = torch.where(fin & fin_ref, got - want, 0.0).abs()
    return (float((gap.amax(0) / scale.abs().amax(0)).max()),
            float((fin != fin_ref).sum()))


def _rounding_units(w1, w1_ref, w0, t: int) -> tuple:
    """(the largest over the entries of |w1 - w1_ref| / (half the float32
    spacing at w1_ref + 2^-23 k_t |w1_ref - w0|), the entries whose
    finiteness differs), for the t-th step (k_t in the module's
    docstring)."""
    b1, b2 = ref_distill.ADAM_BETAS
    k_t = 4.0 + 1.0 / (1.0 - b1 ** t) + 1.0 / (1.0 - b2 ** t)
    fin, fin_ref = torch.isfinite(w1), torch.isfinite(w1_ref)
    ref32 = torch.where(fin_ref, w1_ref, 0.0).float()
    spacing = (torch.nextafter(ref32, torch.full_like(ref32, float("inf")))
               - ref32).double()
    unit = 0.5 * spacing + 2.0 ** -23 * k_t * torch.where(
        fin_ref, w1_ref - w0, 0.0).abs()
    gap = torch.where(fin & fin_ref, w1 - w1_ref, 0.0).abs()
    return float((gap / unit).max()), float((fin != fin_ref).sum())


def step_numbers(out: dict, profiles: dict, targets, cotangent, freqs,
                 elevations, lr: float, device) -> dict:
    """The check of one kept step: `out` as `Driver.keep` gives it,
    `profiles` and `targets` its minibatch (numpy), `cotangent` (B, E, C)
    the program's 2 (tb - target) / N at the kept weights.  The numbers
    under `LIMITED` (the module's docstring)."""
    w0, m0, v0 = out["before"].to(device).double()
    grad = out["grad"].to(device).double()
    w1 = out["w1"].to(device).double()
    if not (grad.shape == w1.shape == w0.shape):
        return dict.fromkeys(LIMITED, float("inf"))
    loss_ref, g_ref = ref_distill.loss_and_vjp(
        w0.cpu().numpy(), profiles, targets, cotangent, freqs, elevations,
        torch.float64, device, REF_BLOCK)
    w1_ref = ref_distill.adam_step(w0, m0, v0, int(out["t0"]), grad, lr)
    loss = float(out["loss"])
    grad_rel, bad_g = _column_gap(grad, g_ref, g_ref)
    update_gap, bad_w = _rounding_units(w1, w1_ref, w0, int(out["t0"]) + 1)
    bad_loss = float(np.isfinite(loss) != np.isfinite(loss_ref))
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    return {"loss_rel": loss_rel if np.isfinite(loss_rel) else float("inf"),
            "grad_rel_max": grad_rel, "update_gap": update_gap,
            "nan_mismatch": bad_g + bad_w + bad_loss}


def program_cotangent(cfg, w, profiles: dict, targets, device):
    """The cotangent the program's backward starts from, 2 (tb - target) /
    N, from its own forward at the weights w: minus the gradient of
    `fast.distill_loss` in its targets, float64 (B, E, C) numpy."""
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast
    prof = {k: torch.as_tensor(v, device=device) for k, v in profiles.items()}
    tgt = torch.as_tensor(targets, device=device).requires_grad_(True)
    with torch.enable_grad():
        loss = fast.distill_loss({"w": torch.as_tensor(w, device=device)},
                                 prof, tgt, cfg)
        (g,) = torch.autograd.grad(loss, tgt)
    return (-g).double().cpu().numpy()


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast
        self._step = fast.train_step
        self.freqs = tuple(config["channels_ghz"])
        self.elevations = tuple(config["elevations_deg"])
        self.lr = config["lr"]
        self.cfg = fast.FastConfig(freqs_ghz=self.freqs,
                                   elevations_deg=self.elevations,
                                   teacher_model=config["teacher_model"],
                                   dtype=config["dtype"])
        self.host = make_inputs(seed, config, workload["batch"],
                                workload["pool"], device)
        self.params = {"w": torch.from_numpy(self.host["w"]).to(device)}
        self.optimizer = fast.make_optimizer(self.params, lr=self.lr)
        self.pool = [({k: torch.from_numpy(v[j]).to(device)
                       for k, v in self.host["profiles"].items()},
                      torch.from_numpy(self.host["targets"][j]).to(device))
                     for j in range(workload["pool"])]
        self.zeros = torch.zeros_like(self.params["w"])
        self.steps = 0
        self.work = {"profiles": workload["batch"]}

    def warm_up(self):
        for j in range(len(self.pool)):
            self.call(j)

    def call(self, i):
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 is on for float32 products; the "
                               "configuration states tf32 false")
        profiles, targets = self.pool[i % len(self.pool)]
        w = self.params["w"]
        state = self.optimizer.state.get(w) or {}
        before = torch.stack([w.detach(),
                              state.get("exp_avg", self.zeros),
                              state.get("exp_avg_sq", self.zeros)])
        t0 = self.steps
        loss = self._step(self.params, self.optimizer, profiles, targets,
                          self.cfg)
        self.steps += 1
        return {"loss": loss, "before": before, "t0": t0, "grad": w.grad,
                "w1": w.detach()}

    def keep(self, out):
        return {k: v.detach().cpu().clone() if torch.is_tensor(v) else v
                for k, v in out.items()}

    def release(self):
        self.pool = self.params = self.optimizer = self.zeros = None

    def _batch(self, j):
        h = self.host
        return {k: v[j] for k, v in h["profiles"].items()}, h["targets"][j]

    def check(self, kept, device) -> dict:
        n_pool = len(self.host["targets"])
        worst = dict.fromkeys(LIMITED, 0.0)
        for i, out in kept:
            profiles, targets = self._batch(i % n_pool)
            cot = program_cotangent(self.cfg, out["before"][0].float(),
                                    profiles, targets, device)
            nums = step_numbers(out, profiles, targets, cot, self.freqs,
                                self.elevations, self.lr, device)
            for k in LIMITED:
                worst[k] = (worst[k] + nums[k] if k == "nan_mismatch"
                            else _worst(worst[k], nums[k]))
        return worst

    def control(self, i, device, dtype):
        w = torch.from_numpy(self.host["w"])
        profiles, targets = self._batch(i % len(self.host["targets"]))
        loss, grad = ref_distill.loss_and_grad(
            w.double().numpy(), profiles, targets, self.freqs,
            self.elevations, dtype, device, REF_BLOCK)
        zeros = torch.zeros_like(w)
        w1 = ref_distill.adam_step(w, zeros, zeros, 0, grad.cpu(), self.lr,
                                   dtype)
        return {"loss": torch.tensor(loss), "t0": 0, "grad": grad.float(),
                "before": torch.stack([w, zeros, zeros]), "w1": w1.float()}
