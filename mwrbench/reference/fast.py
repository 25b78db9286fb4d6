"""The fast operator's plain arithmetic, in the dtype it is given: a frozen
copy of the port's `models/fast.py` feature map (18 scaled monomials of the
layer means times 4 hats over log p), its closed-form ridge fit onto the
LBL layer extinction, and its forward (the product, clamped at zero, then
the RTE on layer-mean extinction)."""

import numpy as np
import torch

from .physics import chord_lengths, downwelling_from_dtau, refractive_index
from .physics import rho_to_e, total_absorption

N_BASE = 18
N_BINS = 4
N_FEATURES = N_BASE * N_BINS
_KNOTS = np.linspace(np.log(5.0), np.log(1013.0), N_BINS)


def _hats(p_mid):
    """The 4 hat functions over log p, stacked on a new axis 0."""
    lp = torch.log(torch.clamp_min(p_mid, 1e-3))
    shape = (N_BINS,) + (1,) * lp.ndim
    k = torch.as_tensor(_KNOTS, device=lp.device).to(lp.dtype).reshape(shape)
    lo = torch.as_tensor(np.concatenate([[_KNOTS[0] - 100.0], _KNOTS[:-1]]),
                         device=lp.device).to(lp.dtype).reshape(shape)
    hi = torch.as_tensor(np.concatenate([_KNOTS[1:], [_KNOTS[-1] + 100.0]]),
                         device=lp.device).to(lp.dtype).reshape(shape)
    up = torch.clamp((lp - lo) / (k - lo), 0.0, 1.0)
    dn = torch.clamp((hi - lp) / (hi - k), 0.0, 1.0)
    return torch.where(lp <= k, up, dn)


def features(p, t, rho, lwc):
    """(..., L-1, 72) from level arrays (..., L)."""
    mid = [0.5 * (x[..., :-1] + x[..., 1:]) for x in (p, t, rho, lwc)]
    ps, th, r, w = mid[0] * 1e-3, 300.0 / mid[1], mid[2] * 0.1, mid[3]
    tp = torch.cumprod(torch.stack([torch.ones_like(th)] + [th] * 5), dim=0)
    base = torch.cat([(ps * ps) * tp, (r * ps) * tp[:5], (r * r) * tp[:3],
                      w * tp[:3], ps * tp[3:4]])              # (18, ..., K)
    x = (_hats(mid[0])[:, None] * base[None]).reshape(N_FEATURES,
                                                      *base.shape[1:])
    return torch.movedim(x, 0, -1)


def fit_closed_form(profiles: dict, freqs_ghz, model: str, device="cpu",
                    ridge: float = 1e-9, block: int = 128) -> np.ndarray:
    """The ridge fit {"w"} (72, C) of the features onto the plain LBL layer
    extinction of `profiles` ((B, L) numpy), weighted by ~1 / alpha, all in
    float64, the normal equations summed over blocks of profiles; returned
    as float32, the weights a user's file would hold."""
    f = torch.as_tensor(np.asarray(freqs_ghz, np.float64), device=device)
    xtx = ridge * torch.eye(N_FEATURES, dtype=torch.float64, device=device)
    xty = 0.0
    for s in range(0, len(profiles["t"]), block):
        x = {k: torch.as_tensor(np.asarray(v[s:s + block], np.float64),
                                device=device) for k, v in profiles.items()}
        alpha = total_absorption(f[:, None, None], x["p"], x["t"], x["rho"],
                                 x["lwc"], model)               # (C, b, L)
        y = (0.5 * (alpha[..., :-1] + alpha[..., 1:])).permute(1, 2, 0)
        xf = features(x["p"], x["t"], x["rho"], x["lwc"]).reshape(
            -1, N_FEATURES)
        yf = y.reshape(-1, y.shape[-1])
        wgt = 1.0 / torch.clamp(yf.mean(dim=-1, keepdim=True), 1e-4, 10.0)
        xtx = xtx + (xf * wgt).T @ xf
        xty = xty + (xf * wgt).T @ yf
    return torch.linalg.solve(xtx, xty).float().cpu().numpy()


def forward(w, x: dict, freqs_ghz, elevations_deg, product_dtype=None):
    """tb, tau_total (b, E, C) and trans_level (b, E, C, L) of the fast
    operator with weights w (72, C) on level columns x (b, L) in their
    dtype; the product in `product_dtype` (theirs when None)."""
    like = x["t"]
    f = torch.as_tensor(np.asarray(freqs_ghz, np.float64),
                        device=like.device).to(like.dtype)
    feats = features(x["p"], x["t"], x["rho"], x["lwc"])       # (b, K, 72)
    pd = product_dtype or like.dtype
    wt = torch.as_tensor(np.asarray(w, np.float64), device=like.device)
    alpha = torch.clamp_min(feats.to(pd) @ wt.to(pd), 0.0).to(like.dtype)
    el = torch.as_tensor(np.asarray(elevations_deg, np.float64),
                         device=like.device).to(like.dtype)
    cos_el = torch.cos(torch.deg2rad(el))
    n = refractive_index(x["p"], x["t"], rho_to_e(x["rho"], x["t"]))
    ds = chord_lengths(x["z"][None], n[None], cos_el[:, None])  # (E, b, K)
    dtau = alpha.permute(2, 0, 1)[None] * ds[:, None]           # (E,C,b,K)
    tb, tau, trans = downwelling_from_dtau(dtau, x["t"], f[None, :, None])
    return (tb.permute(2, 0, 1), tau.permute(2, 0, 1),
            trans.permute(2, 0, 1, 3))
