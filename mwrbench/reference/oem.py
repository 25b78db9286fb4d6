"""The optimal-estimation (1D-Var) retrieval, plain, in the dtype it is
given: Rodgers (2000) Levenberg-Marquardt in measurement space, with the
state x = [T (L), ln(rho + rho_floor) (L)] (Hewison 2007).  From x_0 = xa
and g = 0 for every profile, `n_iter` steps, each to the trial state

    xa + d g / (1 + g)
       + Sa' K^T (K Sa' K^T + Se)^-1 (y - F(x_k) + K d / (1 + g)),

d = x_k - xa, Sa' = Sa / (1 + g), which at g = 0 is the Gauss-Newton
update xa + Sa K^T (K Sa K^T + Se)^-1 (y - F(x_k) + K (x_k - xa)).  The
trial state is taken where the cost J = (y - F)^T Se^-1 (y - F) +
d^T Sa^-1 d rises by no more than 5 % of its current value, and g is
divided by 10; elsewhere the state is kept and g becomes max(10 g, 100).
Last the degrees of freedom for signal tr(Sa K^T (K Sa K^T + Se)^-1 K) at
the last state.

  F    `fast.forward`, the frozen fast operator (features, product clamped
       at zero, refraction, chords, the RTE on layer-mean extinction);
  K    dF/dx by reverse-mode autograd through that forward's arithmetic,
       in the [T, ln rho] state: each (elevation, channel) row takes its
       own copy of the states as the leaf and computes its own TB (the
       features, its channel's product, its elevation's chords, the RTE),
       so one backward pass of the summed TBs gives every row of K, as
       `forward.kmatrix` does for the LBL;
  Sa   exponential correlation over levels, sigma^2 exp(-|i - j| / l), one
       block for T and one for ln rho, none between them;
  Se   obs_error^2 I.

The linear systems are solved by a Cholesky factorisation and two
triangular substitutions written out column by column in plain torch, so
that they run in any dtype (LAPACK and cuSOLVER have none below float32).
F and K are computed in `dtype`, the linear algebra and the cost in
`solve_dtype` (by default `dtype`).  TF32 is off for every product.

Departures from the port's formulation (`models/retrieval.py`): K comes
from autograd, not from the port's closed form; the factorisation and
substitutions are this module's loops, not `torch.linalg.cholesky_ex` and
`solve_triangular`; the prior term of the cost is ||L^-1 d||^2 by a
substitution through the Cholesky factor L of Sa, where the port uses the
tridiagonal inverse of the exponential correlation; K is computed in blocks
of profiles, which changes nothing since the profiles do not interact.  The
arithmetic of each step is otherwise the port's: xa from
ln(max(rho_prior, 0) + floor), rho returned as max(exp(x) - floor, 0).

Imports nothing of the port: `guard.py` checks it.
"""

import numpy as np
import torch

from . import fast
from .physics import (chord_lengths, downwelling_from_dtau, refractive_index,
                      rho_to_e)


def prior_covariance(n_levels: int, sigma_t: float, sigma_lnrho: float,
                     corr_len: float, dtype, device) -> torch.Tensor:
    """Sa (2L, 2L): the T block and the ln rho block, each sigma^2
    exp(-|i - j| / corr_len), computed in float64 and given in `dtype`."""
    i = torch.arange(n_levels, dtype=torch.float64, device=device)
    c = torch.exp(-torch.abs(i[:, None] - i[None, :]) / corr_len)
    sa = torch.zeros((2 * n_levels, 2 * n_levels), dtype=torch.float64,
                     device=device)
    sa[:n_levels, :n_levels] = sigma_t ** 2 * c
    sa[n_levels:, n_levels:] = sigma_lnrho ** 2 * c
    return sa.to(dtype)


def cholesky(a):
    """The lower factor of symmetric positive definite (b, m, m) `a`,
    column by column."""
    m = a.shape[-1]
    low = torch.zeros_like(a)
    for j in range(m):
        row = low[:, j, :j]
        d = torch.sqrt(a[:, j, j] - (row * row).sum(-1))
        low[:, j, j] = d
        low[:, j + 1:, j] = (a[:, j + 1:, j] - (low[:, j + 1:, :j]
                                                * row[:, None]).sum(-1)
                             ) / d[:, None]
    return low


def forward_substitute(rhs, low):
    """L^-1 rhs for rhs (b, m, k)."""
    y = torch.zeros_like(rhs)
    for i in range(low.shape[-1]):
        y[:, i] = (rhs[:, i] - (low[:, i, :i, None] * y[:, :i]).sum(1)
                   ) / low[:, i, i, None]
    return y


def cholesky_solve(rhs, low):
    """(L L^T)^-1 rhs for rhs (b, m, k): forward, then back substitution."""
    m = low.shape[-1]
    y = forward_substitute(rhs, low)
    x = torch.zeros_like(rhs)
    for i in range(m - 1, -1, -1):
        x[:, i] = (y[:, i] - (low[:, i + 1:, i, None] * x[:, i + 1:]).sum(1)
                   ) / low[:, i, i, None]
    return x


def _state_profile(x, cols: dict, floor: float) -> dict:
    n_lev = x.shape[-1] // 2
    return dict(cols, t=x[..., :n_lev], rho=torch.exp(x[..., n_lev:]) - floor)


def rows_forward(w, x_rows, cols: dict, freqs_ghz, elevations_deg, floor):
    """TB (E, C, b) of each (elevation, channel) row from its own copy of
    the states, x_rows (E, C, b, 2L): `fast.forward`'s arithmetic with the
    product taken for the row's channel and the chords for its
    elevation."""
    like = x_rows
    x = {k: v.expand(*like.shape[:3], v.shape[-1])
         for k, v in _state_profile(x_rows, cols, floor).items()}
    f = torch.as_tensor(np.asarray(freqs_ghz, np.float64),
                        device=like.device).to(like.dtype)
    wt = torch.as_tensor(np.asarray(w, np.float64),
                         device=like.device).to(like.dtype)
    feats = fast.features(x["p"], x["t"], x["rho"], x["lwc"])  # (E,C,b,K,72)
    alpha = torch.clamp_min(torch.einsum("ecbkj,jc->ecbk", feats, wt), 0.0)
    el = torch.as_tensor(np.asarray(elevations_deg, np.float64),
                         device=like.device).to(like.dtype)
    cos_el = torch.cos(torch.deg2rad(el))
    n = refractive_index(x["p"], x["t"], rho_to_e(x["rho"], x["t"]))
    ds = chord_lengths(x["z"], n, cos_el[:, None, None])       # (E,C,b,K)
    return downwelling_from_dtau(alpha * ds, x["t"], f[None, :, None])[0]


def jacobian(w, x, cols: dict, freqs_ghz, elevations_deg, floor):
    """K (b, E x C, 2L) at the states x (b, 2L), by one backward pass."""
    n_el, n_ch = len(elevations_deg), len(freqs_ghz)
    with torch.enable_grad():
        leaf = x.detach().expand(n_el, n_ch, *x.shape).clone()
        leaf.requires_grad_(True)
        tb = rows_forward(w, leaf, cols, freqs_ghz, elevations_deg, floor)
        (grad,) = torch.autograd.grad(tb.sum(), leaf)
    return grad.permute(2, 0, 1, 3).reshape(x.shape[0], n_el * n_ch, -1)


def _retrieve_one(w, cols, y, t_prior, rho_prior, freqs, elevations, oem,
                  block):
    """The retrieval of the profiles whose fixed columns are `cols`: F and
    K in their dtype; y, the priors, the linear algebra and the cost in
    `solve_dtype`, the dtype of y."""
    dtype, solve_dtype = cols["z"].dtype, y.dtype
    n_b, n_lev = cols["z"].shape
    floor = oem["rho_floor"]

    def forward(x):
        tb = fast.forward(w, _state_profile(x.to(dtype), cols, floor), freqs,
                          elevations)[0]
        return tb.reshape(x.shape[0], -1).to(solve_dtype)       # (b, m)

    def jac(x):
        x = x.to(dtype)
        return torch.cat([jacobian(w, x[s:s + block],
                                   {k: v[s:s + block] for k, v in
                                    cols.items()}, freqs, elevations, floor)
                          for s in range(0, n_b, block)]).to(solve_dtype)

    xa = torch.cat([t_prior, torch.log(torch.clamp_min(rho_prior, 0.0)
                                       + floor)], dim=1)
    sa = prior_covariance(n_lev, oem["sigma_t_k"], oem["sigma_lnrho"],
                          oem["corr_length_levels"], solve_dtype, y.device)
    sa_low = cholesky(sa[None])
    m = y.shape[1]
    se = oem["obs_error_k"] ** 2 * torch.eye(m, dtype=solve_dtype,
                                             device=y.device)

    def cost(x, f):
        d = forward_substitute((x - xa).T[None], sa_low)[0]     # (2L, b)
        return (((y - f) ** 2).sum(1) / oem["obs_error_k"] ** 2
                + (d * d).sum(0))

    x = xa
    f, k = forward(x), jac(x)
    j = cost(x, f)
    g = torch.zeros(n_b, dtype=solve_dtype, device=y.device)
    for _ in range(oem["n_iter"]):
        s = 1.0 / (1.0 + g)
        sa_kt = sa @ k.transpose(1, 2)                          # (b, 2L, m)
        low = cholesky(s[:, None, None] * (k @ sa_kt) + se)
        d = x - xa
        rhs = y - f + s[:, None] * (k @ d[:, :, None])[:, :, 0]
        trial = (xa + (g * s)[:, None] * d + s[:, None]
                 * (sa_kt @ cholesky_solve(rhs[:, :, None], low))[:, :, 0])
        f_t, k_t = forward(trial), jac(trial)
        j_t = cost(trial, f_t)
        take = j_t <= 1.05 * j
        x = torch.where(take[:, None], trial, x)
        f = torch.where(take[:, None], f_t, f)
        k = torch.where(take[:, None, None], k_t, k)
        j = torch.where(take, j_t, j)
        g = torch.where(take, g / 10.0, torch.clamp_min(10.0 * g, 100.0))
    sa_kt = sa @ k.transpose(1, 2)
    low = cholesky(k @ sa_kt + se)
    dofs = torch.sum(sa_kt * cholesky_solve(k, low).transpose(1, 2),
                     dim=(1, 2))
    return {"t": x[:, :n_lev],
            "rho": torch.clamp_min(torch.exp(x[:, n_lev:]) - floor, 0.0),
            "tb_fit": f.reshape(n_b, len(elevations), -1), "dofs": dofs}


def retrieve(w, profiles: dict, tb_obs, t_prior, rho_prior, freqs_ghz,
             elevations_deg, oem: dict, dtype=torch.float64, device="cpu",
             block: int = 64, solve_dtype=None) -> dict:
    """t, rho (B, L), tb_fit (B, E, C) and dofs (B,), float64 tensors on
    `device`, of the retrieval with F and K computed in `dtype` and the
    linear algebra and the cost in `solve_dtype` (`dtype` where None).

    w (72, C) the fast operator's weights; `profiles` the (B, L) numpy
    columns z, p and lwc (held fixed); tb_obs (B, E, C); t_prior, rho_prior
    (B, L); `oem` the configuration's n_iter, obs_error_k, sigma_t_k,
    sigma_lnrho, corr_length_levels and rho_floor.  K is computed `block`
    profiles at a time."""
    solve_dtype = solve_dtype or dtype

    def col(a, to=dtype):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=device).to(to)

    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cols = {k: col(profiles[k]) for k in ("z", "p", "lwc")}
        out = _retrieve_one(
            w, cols, col(tb_obs, solve_dtype).reshape(len(t_prior), -1),
            col(t_prior, solve_dtype), col(rho_prior, solve_dtype),
            freqs_ghz, elevations_deg, oem, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    return {k: v.double() for k, v in out.items()}
