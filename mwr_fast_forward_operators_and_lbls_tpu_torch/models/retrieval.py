"""Optimal-estimation (1D-Var) retrieval on the fast operator's K-matrix.

Torch counterpart of the JAX package's `models/retrieval.py`: optimal
estimation (Rodgers 2000) inverting observed multi-elevation TBs for
(T, rho) profiles.

State vector: x = [T (L), ln(rho + floor) (L)] on the fixed level grid;
humidity in log space keeps it positive without a clamp that would zero
K-matrix columns.  Each step is the Levenberg-Marquardt step (Rodgers 2000,
ch. 5) in measurement space, which never inverts the prior: with
Sa' = Sa / (1 + g) and d = x_k - xa, the trial state is

    xa + d g / (1 + g)
       + Sa' K^T (K Sa' K^T + Se)^-1 (y - F(x_k) + K d / (1 + g))

with F the fast operator (`fast.fast_forward_batch`: through kernel K2 where
it launches, `ops.cuda.launches`) and K = dF/dx its closed-form K-matrix
(`jacobians.kmatrix_fast_adjoint_batch`).  At g = 0 it is, term for term,
the JAX package's Gauss-Newton update,

    x_{k+1} = xa + Sa K^T (K Sa K^T + Se)^-1 (y - F(x_k) + K (x_k - xa)).

Each profile starts at g = 0 and takes its trial state where the cost
J = (y - F)^T Se^-1 (y - F) + d^T Sa^-1 d rises by no more than 5 % of its
current value, dividing g by 10; elsewhere it keeps its state and g becomes
max(10 g, 100).  A profile whose steps all pass is thus retrieved by plain
Gauss-Newton, as in the JAX package, and one that Gauss-Newton would send
away from the solution (a far prior) is held back.  The 5 % keeps the
choice away from the steps near the solution, whose J moves by less than
the float32 operator's rounding moves it: a choice taken there by rounding
would part a float32 retrieval from a float64 one by a whole step.  The
forward, K and the cost are evaluated once a step, at the trial state; the
(m x m) system is symmetric positive definite by construction and is solved
by a Cholesky factorisation and two triangular solves, batched over the
profiles; a profile whose system is not positive definite gets a NaN trial
state, which is not taken.  The iterations are a Python loop.

F and K are computed in the working dtype: float64 where `z_m` is a float64
tensor (the plain path, on the CPU) and float32 otherwise.  The state, the
products, the factorisation, the solves and the cost are float64 whatever
the working dtype: the system's condition number reaches 1e5 and more, which
leaves a float32 solve two digits, and those digits decide whether a far
profile's step is taken.  The outputs are given in the working dtype.

Under a profiler the call records the spans `oem.retrieve_batch` and, inside
it, `oem.prior`, `oem.forward` (the fast operator's `fast.*`), `oem.jacobian`
(its K's `fastk.*`) and `oem.accept` at the prior, then per step
`oem.solve`, `oem.forward`, `oem.jacobian` and `oem.accept`, and last
`oem.dofs` (`ops/spans.py`).
"""

import dataclasses
import math

import numpy as np
import torch

from ..ops.spans import span
from ..ops.tensors import input_device
from . import fast as fast_mod
from . import jacobians

# Levenberg-Marquardt: a trial state is taken where its cost rises by no
# more than COST_RISE_TAKEN of the current cost, and g is then divided by
# DAMPING_DOWN; elsewhere g becomes at least DAMPING_AFTER_RISE
COST_RISE_TAKEN = 0.05
DAMPING_AFTER_RISE = 100.0
DAMPING_DOWN = 10.0


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
    """Exponential-correlation prior block (L, L), float64."""
    i = torch.arange(n_levels, dtype=torch.float64, device=device)
    c = torch.exp(-torch.abs(i[:, None] - i[None, :]) / corr_len)
    return (sigma * sigma) * c


def _prior_cost(d, sigma: float, corr_len: float):
    """d^T C^-1 d for each row of d (B, L), C = sigma^2 exp(-|i - j| /
    corr_len) the prior block: the correlation is that of a first-order
    autoregressive chain, whose inverse is tridiagonal, so the form is the
    first level's square plus the squares of the innovations
    d_i - r d_{i-1}, r = exp(-1 / corr_len), over their variance 1 - r^2."""
    r = math.exp(-1.0 / corr_len)
    w = d[:, 1:] - r * d[:, :-1]
    return (d[:, 0] ** 2 + torch.sum(w * w, dim=1) / (1.0 - r * r)) / (
        sigma * sigma)


def _cholesky_solve(b, chol):
    """(L L^T)^-1 b for the lower factors `chol` (B, m, m) and b (B, m, k),
    by two triangular solves: cuBLAS on the card.  The batched
    `torch.cholesky_solve` takes MAGMA there, whose cudaMalloc and cudaFree
    of workspace on every call stall the card for 0.2-0.7 s now and then."""
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(1, 2), y, upper=True)


def retrieve_batch(params: dict, tb_obs, z_m, p_hpa, t_prior, rho_prior,
                   config: OEMConfig = OEMConfig(), lwc_gm3=None):
    """OEM retrieval of (T, rho) from observed TBs, for a batch.

    Args:
      params: fast-operator coefficients (`fast.fit_closed_form`, `distill`).
      tb_obs: (B, E, C) observed brightness temperatures [K].
      z_m, p_hpa: (B, L) level grids (pressure is taken as known).
      t_prior, rho_prior: (B, L) prior and first-guess profiles.
      lwc_gm3: optional (B, L) cloud liquid, held fixed.
    The work is on the device of `z_m` (`input_device`): a tensor stays
    where it lies (a CPU tensor asks for the CPU), a numpy array goes to the
    CUDA card and raises RuntimeError where there is none; the other inputs
    are moved there.  It is float64 where `z_m` is a float64 tensor and
    float32 otherwise; the kernels take float32 alone
    (`ops.cuda.launches`), so float64 runs on the CPU.

    Returns t, rho (B, L), tb_fit (B, E, C), cost (B, n_iter), the mean
    squared residual [K^2] before each step, and dofs (B,), the degrees of
    freedom for signal tr(Sa K^T S^-1 K) at the solution.
    """
    with span("oem.retrieve_batch"):
        return _retrieve_batch(params, tb_obs, z_m, p_hpa, t_prior,
                               rho_prior, config, lwc_gm3)


def _retrieve_batch(params, tb_obs, z_m, p_hpa, t_prior, rho_prior, config,
                    lwc_gm3):
    wd = (torch.float64 if torch.is_tensor(z_m)
          and z_m.dtype == torch.float64 else torch.float32)
    f64 = torch.float64
    dev = input_device(z_m)
    corr = config.corr_length_levels
    with span("oem.prior"):
        z, p, t0, rho0 = (torch.as_tensor(v).to(device=dev, dtype=wd)
                          for v in (z_m, p_hpa, t_prior, rho_prior))
        lwc = (torch.zeros_like(z) if lwc_gm3 is None
               else torch.as_tensor(lwc_gm3).to(device=dev, dtype=wd))
        fcfg = fast_mod.FastConfig(freqs_ghz=config.freqs_ghz,
                                   elevations_deg=config.elevations_deg,
                                   dtype=str(wd).removeprefix("torch."),
                                   outputs=("tb",))
        n_b, lev = z.shape
        y = torch.as_tensor(tb_obs).to(device=dev, dtype=f64).reshape(n_b,
                                                                      -1)
        m = y.shape[1]

        xa = torch.cat([t0, torch.log(torch.clamp_min(rho0, 0.0)
                                      + config.rho_floor)],
                       dim=1).to(f64)                               # (B, 2L)
        sa = torch.zeros((2 * lev, 2 * lev), dtype=f64, device=dev)
        sa[:lev, :lev] = _prior_covariance(lev, config.sigma_t_k, corr, dev)
        sa[lev:, lev:] = _prior_covariance(lev, config.sigma_lnrho, corr,
                                           dev)
        se = torch.diag(torch.full((m,), config.obs_error_k ** 2, dtype=f64,
                                   device=dev))

    def forward_and_jacobian(x):
        """F(x) (B, m) and K (B, m, 2L) in [T, ln rho] at the state x,
        computed in the working dtype and given in float64."""
        with span("oem.forward"):
            x = x.to(wd)
            t = x[:, :lev]
            expx = torch.exp(x[:, lev:])             # = rho + rho_floor
            prof = {"z": z, "p": p, "t": t, "rho": expx - config.rho_floor,
                    "lwc": lwc}
            f = fast_mod.fast_forward_batch(params, prof, fcfg)["tb"]
        with span("oem.jacobian"):
            ks = jacobians.kmatrix_fast_adjoint_batch(params, prof, fcfg,
                                                      wrt=("t", "rho"))
            k_t = ks["t"].reshape(n_b, m, lev)
            # chain rule into log space: d rho / d x_lnrho = exp(x)
            k_lnrho = ks["rho"].reshape(n_b, m, lev) * expx[:, None, :]
            return (f.reshape(n_b, m).to(f64),
                    torch.cat([k_t, k_lnrho], dim=2).to(f64))

    def cost(x, f):
        """The OEM cost of the states x (B, 2L) whose TBs are f (B, m)."""
        d = x - xa
        return (torch.sum((y - f) ** 2, dim=1) / config.obs_error_k ** 2
                + _prior_cost(d[:, :lev], config.sigma_t_k, corr)
                + _prior_cost(d[:, lev:], config.sigma_lnrho, corr))

    def factor(k_sa_kt):
        """The Cholesky factor of K Sa' K^T + Se; a profile whose system is
        not positive definite gets NaN, and the batch goes on with no sync
        with the host."""
        chol, info = torch.linalg.cholesky_ex(k_sa_kt + se)
        return torch.where((info == 0)[:, None, None], chol, torch.nan)

    x = xa
    f, k = forward_and_jacobian(x)
    with span("oem.accept"):
        j = cost(x, f)
        g = torch.zeros((n_b,), dtype=f64, device=dev)
    costs = []
    for _ in range(config.n_iter):
        with span("oem.solve"):
            costs.append(torch.mean((y - f) ** 2, dim=1))
            s = 1.0 / (1.0 + g)                       # Sa' = s Sa
            sa_kt = torch.matmul(sa, k.transpose(1, 2))           # (B, 2L, m)
            chol = factor(s[:, None, None] * torch.matmul(k, sa_kt))
            d = x - xa
            rhs = y - f + s[:, None] * torch.matmul(k, d[:, :, None])[:, :, 0]
            u = _cholesky_solve(rhs[:, :, None], chol)           # (B, m, 1)
            trial = (xa + (g * s)[:, None] * d
                     + s[:, None] * torch.matmul(sa_kt, u)[:, :, 0])
        f_t, k_t = forward_and_jacobian(trial)
        with span("oem.accept"):
            j_t = cost(trial, f_t)
            take = j_t <= (1.0 + COST_RISE_TAKEN) * j  # a NaN cost is not
            x = torch.where(take[:, None], trial, x)
            f = torch.where(take[:, None], f_t, f)
            k = torch.where(take[:, None, None], k_t, k)
            j = torch.where(take, j_t, j)
            g = torch.where(take, g / DAMPING_DOWN,
                            torch.clamp_min(10.0 * g, DAMPING_AFTER_RISE))

    with span("oem.dofs"):
        # averaging kernel A = Sa K^T (K Sa K^T + Se)^-1 K; dofs = tr(A)
        sa_kt = torch.matmul(sa, k.transpose(1, 2))
        chol = factor(torch.matmul(k, sa_kt))
        u = _cholesky_solve(k, chol)                             # (B, m, 2L)
        dofs = torch.sum(sa_kt * u.transpose(1, 2), dim=(1, 2))
    out = {
        "t": x[:, :lev],
        "rho": torch.clamp_min(torch.exp(x[:, lev:]) - config.rho_floor, 0.0),
        "tb_fit": f.reshape(n_b, len(config.elevations_deg), -1),
        "cost": (torch.stack(costs, dim=1) if costs
                 else torch.zeros((n_b, 0), dtype=f64, device=dev)),
        "dofs": dofs,
    }
    return {k: v.to(wd) for k, v in out.items()}


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
