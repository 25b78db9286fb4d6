"""The frozen needed-work counts equal the port's `parallel/profiling.py`
counts with `as_coded=False`.

The port's file may change with its kernels; where it does, this test
names the count that moved, and the frozen copy stays as it is.
"""

import dataclasses

import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import profiling
from mwrbench.rooflines import counts

GRID = np.linspace(20.0, 64.0, 8192).astype(np.float32)
HATPRO = counts._HATPRO

CASES = [
    ("k1_roofline", (1024 * 180, HATPRO, "R24"), {}),
    ("k1_roofline", (256 * 180, HATPRO, "R98"), {}),
    ("k1_roofline", (2000 * 180, HATPRO, "R17"), {}),
    ("k1_roofline", (2000 * 180, HATPRO, "R20"), {}),
    ("k1_roofline", (1000, HATPRO[:7], "R24"), {"with_o3": True}),
    ("k4_roofline", (256 * 180, HATPRO, "R24"), {}),
    ("k4_roofline", (64 * 180, HATPRO, "R98"), {}),
    ("k6_roofline", (32 * 180, GRID, "R24"), {}),
    ("k6_roofline", (32 * 180, GRID[:1000], "R20"), {}),
    ("k2_roofline", (1024, 180, 14, 10), {}),
    ("k2_roofline", (32, 180, 8192, 1), {"given_paths": True}),
    ("k2_roofline", (256, 180, 14, 10), {"alpha_is_mid": True,
                                         "want_trans_level": True,
                                         "planck_series_fraction": 0.5,
                                         "small_dtau_fraction": 0.7}),
    ("k5_roofline", (256,), {"which": "t"}),
    ("k5_roofline", (256,), {"which": "rho_lwc"}),
    ("k5_roofline", (64, 90, 7, 3), {"which": "lwc",
                                     "series_fraction": 0.4}),
    ("lbl_roofline", (1024,), {}),
    ("lbl_roofline", (256, 180, 7, 2), {}),
    ("spectral_roofline", (32 * 180, 8192), {}),
    ("spectral_roofline", (32 * 180, 3000), {"f_range": (50.0, 60.0)}),
]


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_counts_equal_the_ports_needed_counts(name, args, kwargs):
    frozen = getattr(counts, name)(*args, **kwargs)
    port = getattr(profiling, name)(*args, as_coded=False, **kwargs)
    assert dataclasses.astuple(frozen) == dataclasses.astuple(port)


def test_peaks_equal_the_ports():
    assert counts.DEFAULT_PEAKS == profiling.DEFAULT_PEAKS


def test_bound_is_the_largest_resource_time():
    r = counts.lbl_roofline(1024)
    times = r.times_s()
    assert r.time_bound_s() == max(times.values())
    assert r.bound_by() in times
