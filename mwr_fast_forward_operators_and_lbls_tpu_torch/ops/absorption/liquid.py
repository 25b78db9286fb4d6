"""Cloud liquid-water absorption (Rayleigh regime), in torch.

Liebe-Hufford-Manabe (1991) double-Debye dielectric model with explicit
real/imaginary arithmetic, as in the JAX package's `ops/absorption/liquid.py`.
"""

import torch

from ..tensors import promote


def liquid_absorption(f_ghz, t_k, lwc_gm3):
    """Cloud liquid absorption [Np/km] at f [GHz], T [K], LWC [g/m^3]."""
    f, t, w = promote(f_ghz, t_k, lwc_gm3)

    theta1 = 1.0 - 300.0 / t
    eps0 = 77.66 - 103.3 * theta1
    eps1 = 0.0671 * eps0
    eps2 = 3.52
    fp = 20.1 * torch.exp(7.88 * theta1)  # primary relaxation frequency [GHz]
    fs = 39.8 * fp                        # secondary relaxation frequency

    u = f / fp
    v = f / fs
    re = eps2 + (eps0 - eps1) / (1.0 + u * u) + (eps1 - eps2) / (1.0 + v * v)
    im = -(eps0 - eps1) * u / (1.0 + u * u) - (eps1 - eps2) * v / (1.0 + v * v)

    # Im[(eps-1)/(eps+2)] = 3*im / ((re+2)^2 + im^2)
    aimag = 3.0 * im / ((re + 2.0) ** 2 + im * im)
    return -0.06286 * aimag * f * w
