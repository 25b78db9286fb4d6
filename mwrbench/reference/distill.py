"""The distillation's loss and its gradient in the weights, plain, in the
dtype it is given: the TB-space L2 loss of the port's training step,

    loss = mean over (profile, elevation, channel) of (tb(w) - target)^2,

with tb(w) the frozen fast operator of `fast.py` (the 72 features of the
layer means, the product with w clamped at zero, refraction, chords, the
RTE on layer-mean extinction) and its gradient dloss/dw (72, C) by
reverse-mode autograd through that arithmetic; the transposed Jacobian of
tb(w) applied to a given cotangent of tb (`loss_and_vjp`); and Adam's
update of the weights (`adam_step`).

The profiles are taken in blocks, each block's share of the sum and of the
gradient added in turn, so that a minibatch of 4096 profiles fits; the
profiles do not interact, so the blocks change nothing but the order of the
sums.  TF32 is off for every product.  Imports nothing of the port:
`guard.py` checks it.
"""

import numpy as np
import torch

from . import fast
from .physics import (chord_lengths, downwelling_from_dtau, refractive_index,
                      rho_to_e)

VARIABLES = ("z", "p", "t", "rho", "lwc")


def tb_of(w, x: dict, freqs_ghz, elevations_deg):
    """tb (b, E, C) of the fast operator with weights w, a (72, C) tensor
    (differentiable), on level columns x (b, L) in their dtype: the
    arithmetic of `fast.forward`."""
    like = x["t"]
    f = torch.as_tensor(np.asarray(freqs_ghz, np.float64),
                        device=like.device).to(like.dtype)
    feats = fast.features(x["p"], x["t"], x["rho"], x["lwc"])   # (b, K, 72)
    alpha = torch.clamp_min(feats @ w, 0.0)                      # (b, K, C)
    el = torch.as_tensor(np.asarray(elevations_deg, np.float64),
                         device=like.device).to(like.dtype)
    cos_el = torch.cos(torch.deg2rad(el))
    n = refractive_index(x["p"], x["t"], rho_to_e(x["rho"], x["t"]))
    ds = chord_lengths(x["z"][None], n[None], cos_el[:, None])  # (E, b, K)
    dtau = alpha.permute(2, 0, 1)[None] * ds[:, None]           # (E,C,b,K)
    tb = downwelling_from_dtau(dtau, x["t"], f[None, :, None])[0]
    return tb.permute(2, 0, 1)


def _blocks(w, profiles: dict, targets, freqs_ghz, elevations_deg, dtype,
            device, block: int, cotangent=None):
    """(loss, dloss/dw or, with `cotangent`, J^T cotangent) summed over the
    blocks of profiles, TF32 off for every product."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        leaf = torch.as_tensor(np.asarray(w, np.float64),
                               device=device).to(dtype).requires_grad_(True)
        tgt_all = np.asarray(targets, np.float64)
        count = tgt_all.size
        loss = 0.0
        grad = torch.zeros(leaf.shape, dtype=torch.float64, device=device)
        for s in range(0, len(tgt_all), block):
            x = {k: torch.as_tensor(np.asarray(profiles[k][s:s + block],
                                               np.float64),
                                    device=device).to(dtype)
                 for k in VARIABLES}
            tgt = torch.as_tensor(tgt_all[s:s + block],
                                  device=device).to(dtype)
            with torch.enable_grad():
                tb = tb_of(leaf, x, freqs_ghz, elevations_deg)
                part = torch.sum((tb - tgt) ** 2) / count
                if cotangent is None:
                    (g,) = torch.autograd.grad(part, leaf)
                else:
                    c = torch.as_tensor(cotangent[s:s + block],
                                        device=device).to(dtype)
                    (g,) = torch.autograd.grad(tb, leaf, c)
            loss += float(part.detach())
            grad += g.double()
        return loss, grad
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def loss_and_grad(w, profiles: dict, targets, freqs_ghz, elevations_deg,
                  dtype=torch.float64, device="cpu", block: int = 256):
    """(loss, dloss/dw) of the minibatch `profiles` ((B, L) numpy) against
    `targets` (B, E, C) at the weights w (72, C): the loss a float, the
    gradient a float64 (72, C) tensor on `device`, both computed in
    `dtype`."""
    return _blocks(w, profiles, targets, freqs_ghz, elevations_deg, dtype,
                   device, block)


def loss_and_vjp(w, profiles: dict, targets, cotangent, freqs_ghz,
                 elevations_deg, dtype=torch.float64, device="cpu",
                 block: int = 256):
    """(loss, J^T cotangent): the loss as `loss_and_grad` gives it, and the
    transposed Jacobian of tb(w) at w applied to `cotangent` (B, E, C), a
    float64 (72, C) tensor on `device`.  With the cotangent the program's
    own 2 (tb - target) / N, this is the gradient its backward should give
    from its forward's residuals, whatever their rounding."""
    return _blocks(w, profiles, targets, freqs_ghz, elevations_deg, dtype,
                   device, block, cotangent)


# Adam's constants as Kingma & Ba (2015) give them, and torch.optim.Adam's
# defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def adam_step(w, exp_avg, exp_avg_sq, steps_before: int, grad, lr: float,
              dtype=torch.float64):
    """The weights after one step of Adam (Kingma & Ba 2015, Algorithm 1,
    no weight decay) from w, its moments exp_avg and exp_avg_sq after
    `steps_before` steps (zero before the first) and the gradient `grad`,
    all (72, C) tensors, computed in `dtype`: m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, w - lr m / (1 - b1^t) / (sqrt(v / (1 - b2^t))
    + eps), t the step's number."""
    b1, b2 = ADAM_BETAS
    w, m, v, g = (x.to(dtype) for x in (w, exp_avg, exp_avg_sq, grad))
    t = steps_before + 1
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    denom = torch.sqrt(v) / float(np.sqrt(1.0 - b2 ** t)) + ADAM_EPS
    return w - (lr / (1.0 - b1 ** t)) * (m / denom)
