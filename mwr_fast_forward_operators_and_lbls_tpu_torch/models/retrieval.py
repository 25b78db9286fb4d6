"""Optimal-estimation (1D-Var) retrieval on the fast operator's K-matrix.

Torch counterpart of the JAX package's `models/retrieval.py`: Gauss-Newton
optimal estimation (Rodgers 2000) inverting observed multi-elevation TBs for
(T, rho) profiles.

State vector: x = [T (L), ln(rho + floor) (L)] on the fixed level grid;
humidity in log space keeps it positive without a clamp that would zero
K-matrix columns.  Each iteration is the measurement-space update, which
never inverts the prior:

    x_{k+1} = xa + Sa K^T (K Sa K^T + Se)^-1 (y - F(x_k) + K (x_k - xa))

with F the fast operator (`fast.fast_forward_batch`: through kernel K2 on
CUDA float32 tensors) and K = dF/dx its closed-form K-matrix
(`jacobians.kmatrix_fast_adjoint_batch`).  The (m x m) system is symmetric
positive definite by construction and is solved by a float32 Cholesky
factorisation, batched over the profiles; the iterations are a Python loop.
"""

import dataclasses

import numpy as np
import torch

from ..ops.tensors import input_device
from . import fast as fast_mod
from . import jacobians


@dataclasses.dataclass(frozen=True)
class OEMConfig:
    """Static retrieval configuration."""

    elevations_deg: tuple = (90.0, 30.0, 19.2, 14.4, 11.4, 8.4, 6.6, 5.4,
                             4.8, 4.2)
    freqs_ghz: tuple = fast_mod.FastConfig().freqs_ghz
    n_iter: int = 5
    obs_error_k: float = 0.5        # HATPRO radiometric noise [K]
    sigma_t_k: float = 3.0          # prior T std [K]
    sigma_lnrho: float = 0.4        # prior ln(vapor-density) std [~40 %]
    corr_length_levels: float = 8.0  # prior vertical correlation [levels]
    rho_floor: float = 1e-3         # [g/m^3] log-space lower anchor


def _prior_covariance(n_levels: int, sigma: float, corr_len: float,
                      device=None):
    """Exponential-correlation prior block (L, L), float32."""
    i = torch.arange(n_levels, dtype=torch.float32, device=device)
    c = torch.exp(-torch.abs(i[:, None] - i[None, :]) / corr_len)
    return (sigma * sigma) * c


def retrieve_batch(params: dict, tb_obs, z_m, p_hpa, t_prior, rho_prior,
                   config: OEMConfig = OEMConfig(), lwc_gm3=None):
    """Gauss-Newton OEM retrieval of (T, rho) from observed TBs, for a batch.

    Args:
      params: fast-operator coefficients (`fast.fit_closed_form`, `distill`).
      tb_obs: (B, E, C) observed brightness temperatures [K].
      z_m, p_hpa: (B, L) level grids (pressure is taken as known).
      t_prior, rho_prior: (B, L) prior and first-guess profiles.
      lwc_gm3: optional (B, L) cloud liquid, held fixed.
    The work is float32 on the device of `z_m` (`input_device`): a tensor
    stays where it lies (a CPU tensor asks for the CPU), a numpy array goes
    to the CUDA card and raises RuntimeError where there is none; the other
    inputs are moved there.

    Returns t, rho (B, L), tb_fit (B, E, C), cost (B, n_iter), the mean
    squared residual [K^2] before each step, and dofs (B,), the degrees of
    freedom for signal tr(Sa K^T S^-1 K) at the solution.
    """
    f32 = torch.float32
    dev = input_device(z_m)
    z, p, t0, rho0 = (torch.as_tensor(v).to(device=dev, dtype=f32)
                      for v in (z_m, p_hpa, t_prior, rho_prior))
    lwc = (torch.zeros_like(z) if lwc_gm3 is None
           else torch.as_tensor(lwc_gm3).to(device=dev, dtype=f32))
    fcfg = fast_mod.FastConfig(freqs_ghz=config.freqs_ghz,
                               elevations_deg=config.elevations_deg,
                               outputs=("tb",))
    n_b, lev = z.shape
    y = torch.as_tensor(tb_obs).to(device=dev, dtype=f32).reshape(n_b, -1)
    m = y.shape[1]

    xa = torch.cat([t0, torch.log(torch.clamp_min(rho0, 0.0)
                                  + config.rho_floor)], dim=1)  # (B, 2L)
    sa = torch.zeros((2 * lev, 2 * lev), dtype=f32, device=dev)
    sa[:lev, :lev] = _prior_covariance(lev, config.sigma_t_k,
                                       config.corr_length_levels, dev)
    sa[lev:, lev:] = _prior_covariance(lev, config.sigma_lnrho,
                                       config.corr_length_levels, dev)
    se = torch.diag(torch.full((m,), config.obs_error_k ** 2, dtype=f32,
                               device=dev))

    def forward_and_jacobian(x):
        """F(x) (B, m) and K (B, m, 2L) in [T, ln rho] at the state x."""
        t = x[:, :lev]
        expx = torch.exp(x[:, lev:])                 # = rho + rho_floor
        prof = {"z": z, "p": p, "t": t, "rho": expx - config.rho_floor,
                "lwc": lwc}
        f = fast_mod.fast_forward_batch(params, prof, fcfg)["tb"]
        ks = jacobians.kmatrix_fast_adjoint_batch(params, prof, fcfg,
                                                  wrt=("t", "rho"))
        k_t = ks["t"].reshape(n_b, m, lev)
        # chain rule into log space: d rho / d x_lnrho = exp(x)
        k_lnrho = ks["rho"].reshape(n_b, m, lev) * expx[:, None, :]
        return f.reshape(n_b, m), torch.cat([k_t, k_lnrho], dim=2)

    def m_form_factor(k):
        """Sa K^T (B, 2L, m) and the Cholesky factor of K Sa K^T + Se."""
        sa_kt = torch.matmul(sa, k.transpose(1, 2))
        return sa_kt, torch.linalg.cholesky(torch.matmul(k, sa_kt) + se)

    x, costs = xa, []
    for _ in range(config.n_iter):
        f, k = forward_and_jacobian(x)
        sa_kt, chol = m_form_factor(k)
        rhs = y - f + torch.matmul(k, (x - xa)[:, :, None])[:, :, 0]
        u = torch.cholesky_solve(rhs[:, :, None], chol)          # (B, m, 1)
        x = xa + torch.matmul(sa_kt, u)[:, :, 0]
        costs.append(torch.mean((y - f) ** 2, dim=1))

    f, k = forward_and_jacobian(x)
    # averaging kernel A = Sa K^T (K Sa K^T + Se)^-1 K; dofs = tr(A)
    sa_kt, chol = m_form_factor(k)
    u = torch.cholesky_solve(k, chol)                            # (B, m, 2L)
    dofs = torch.sum(sa_kt * u.transpose(1, 2), dim=(1, 2))
    return {
        "t": x[:, :lev],
        "rho": torch.clamp_min(torch.exp(x[:, lev:]) - config.rho_floor, 0.0),
        "tb_fit": f.reshape(n_b, len(config.elevations_deg), -1),
        "cost": (torch.stack(costs, dim=1) if costs
                 else torch.zeros((n_b, 0), dtype=f32, device=dev)),
        "dofs": dofs,
    }


def retrieve(params: dict, tb_obs, z_m, p_hpa, t_prior, rho_prior,
             config: OEMConfig = OEMConfig(), lwc_gm3=None):
    """`retrieve_batch` for one profile: tb_obs (E, C), the others (L,).
    Returns t, rho (L,), tb_fit (E, C), cost (n_iter,) and dofs ()."""
    def lead(a):
        # a leading axis of one; what is no tensor stays none, so that
        # `retrieve_batch` resolves the device from what the caller gave
        if a is None or torch.is_tensor(a):
            return None if a is None else a[None]
        return np.asarray(a)[None]

    out = retrieve_batch(params, lead(tb_obs), lead(z_m), lead(p_hpa),
                         lead(t_prior), lead(rho_prior), config,
                         lead(lwc_gm3))
    return {k: v[0] for k, v in out.items()}
