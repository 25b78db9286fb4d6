"""The needed work of one call of `retrieval.retrieve_batch`, from the cell's
sizes: B profiles, a state of n = 2L (T and ln rho on L levels), m = E x C
observations, n_iter Levenberg-Marquardt steps and the final DFS.

  linalg  the products as the update writes them, with Sa's two L x L
          blocks (T and ln rho, nothing between them) taken as they are,
          each multiply-add one FMA, in float64 at 33.5e12 FMA/s, the
          float64 tensor cores' 67 TFLOP/s (the figure of float32 outside
          them): per factorisation (n_iter + 1) Sa K^T
          (2 L^2 m = n^2 m / 2) and K (Sa K^T) (m^2 n), the Cholesky
          (m^3 / 6); per step K (x - xa) (m n), the two triangular solves of
          one right-hand side (m^2) and Sa K^T u (n m); last the solves of K
          (m^2 n) and the trace of Sa K^T . (S^-1 K)^T (n m).  The damping's
          scalings, the cost and the choice of state are elementwise and
          counted as nothing.  No bytes.
  k2mid   K2 with `alpha_is_mid` (`counts.k2_roofline`), one a pass: the
          fast forward's RTE, n_iter + 1 launches.
  fastk   the fast K's least bytes, one a pass: z, p, t, rho, lwc (B, L)
          and the weights (72, C) read, K_t and K_rho (B, E, C, L) written,
          float32.
"""

from . import counts

N_FEATURES = 72


def linalg_fma(batch: int, n_state: int, m: int, n_iter: int) -> float:
    """FMAs of the products, factorisations and solves of a call."""
    n, per = n_state, n_iter + 1
    factor = n * n * m / 2.0 + m * m * n + m ** 3 / 6.0
    step = m * n + m * m + n * m
    final = m * m * n + n * m
    return float(batch) * (per * factor + n_iter * step + final)


def oem_call(workload: dict, config: dict) -> dict:
    """{"linalg": [..], "k2mid": [one per pass], "fastk": [one per pass]}
    of `Roofline`s."""
    b, n_lev, n_iter = workload["batch"], config["n_levels"], config["n_iter"]
    n_ch, n_el = len(config["channels_ghz"]), len(config["elevations_deg"])
    passes = n_iter + 1
    fma = linalg_fma(b, 2 * n_lev, n_el * n_ch, n_iter)
    k_bytes = 4.0 * (5 * b * n_lev + N_FEATURES * n_ch
                     + 2 * b * n_el * n_ch * n_lev)
    return {"linalg": [counts.Roofline(fma, 0.0, 0.0, 0.0)],
            "k2mid": [counts.k2_roofline(b, n_lev, n_ch, n_el,
                                         alpha_is_mid=True)] * passes,
            "fastk": [counts.Roofline(0.0, 0.0, 0.0, k_bytes)] * passes}
