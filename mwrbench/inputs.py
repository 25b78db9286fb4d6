"""The benchmark's seeded inputs, made on the host with numpy.

`profiles` is the port's `models/lbl.py::demo_profile` arithmetic (a
standard-atmosphere temperature with a random walk, an exponential
pressure, a noisy relative humidity, a cloud layer), vectorised over one
generator, with what an archive varies from profile to profile drawn per
profile: the surface temperature (+-15 K), the surface pressure (+-2 %),
the humidity's offset (+-15 % RH), and a cloud (half of the profiles) of
random base, depth and liquid water content.  Every seed gives the same
shapes; only the values differ.

`srf_weights` is the port's `bench.py::srf_weights`: a Gaussian per HATPRO
channel with its nominal bandwidth as the standard deviation.
"""

import numpy as np

from .reference import hatpro

TOP_M = 25_000.0


def generator(seed: int, stream: int) -> np.random.Generator:
    """One generator per (seed, stream): any whole seed, negative or beyond
    64 bits included."""
    return np.random.default_rng([seed % 2**64, stream])


def profiles(seed: int, n: int, n_levels: int, stream: int = 0) -> dict:
    """`n` profiles of `n_levels` levels ground -> top: z [m], p [hPa],
    t [K], rho [g/m^3], lwc [g/m^3], each a float32 (n, L) array."""
    rng = generator(seed, stream)
    z = np.linspace(0.0, TOP_M, n_levels)[None, :]
    t_sfc = 288.0 + rng.uniform(-15.0, 15.0, (n, 1))
    t = (t_sfc - 6.5e-3 * np.minimum(z, 11_000.0)
         - 0.0005e-3 * np.maximum(z - 11_000.0, 0))
    t = t + rng.normal(0, 0.5, (n, n_levels)).cumsum(axis=1) * 0.05
    p = 1013.0 * (1.0 + rng.uniform(-0.02, 0.02, (n, 1))) * np.exp(-z / 7800.0)
    rh = np.clip(75.0 + rng.uniform(-15.0, 15.0, (n, 1)) - z / 1000.0 * 2.0
                 + rng.normal(0, 3.0, (n, n_levels)), 2.0, 98.0)
    e = rh / 100.0 * 6.1078 * np.exp(17.08085 * (t - 273.15)
                                     / (234.175 + (t - 273.15)))
    rho = 216.679 * e / t
    base = rng.uniform(500.0, 3000.0, (n, 1))
    depth = rng.uniform(200.0, 1000.0, (n, 1))
    water = rng.uniform(0.05, 0.5, (n, 1)) * (rng.random((n, 1)) < 0.5)
    lwc = np.where((z > base) & (z < base + depth), water, 0.0)
    z = np.broadcast_to(z, (n, n_levels))
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in dict(z=z, p=p, t=t, rho=rho, lwc=lwc).items()}


def srf_weights(f_ghz) -> np.ndarray:
    """(14, F) float32: a Gaussian per HATPRO channel, its nominal bandwidth
    as the standard deviation."""
    f = np.asarray(f_ghz)
    w = np.zeros((hatpro.N_CHANNELS, f.size), np.float32)
    for c, (fc, bw) in enumerate(zip(hatpro.HATPRO_FREQS_GHZ,
                                     hatpro.nominal_bandwidth_ghz())):
        w[c] = np.exp(-0.5 * ((f - fc) / max(bw, 1e-3)) ** 2)
    return w
