"""The seeded generators repeat for a seed and differ between seeds."""

import numpy as np
import pytest

from mwr_fast_forward_operators_and_lbls_tpu_torch import bench
from mwrbench import inputs


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 3 * 2**62, -5])
def test_profiles_repeat_for_a_seed(seed):
    a = inputs.profiles(seed, 16, 180)
    b = inputs.profiles(seed, 16, 180)
    assert a.keys() == {"z", "p", "t", "rho", "lwc"}
    for k in a:
        assert a[k].shape == (16, 180) and a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_profiles_differ_between_seeds_and_streams():
    a = inputs.profiles(2**31, 8, 180)
    b = inputs.profiles(2**31 + 1, 8, 180)
    c = inputs.profiles(2**31, 8, 180, stream=1)
    assert not np.array_equal(a["t"], b["t"])
    assert not np.array_equal(a["t"], c["t"])
    np.testing.assert_array_equal(a["z"], b["z"])


def test_profiles_are_physical():
    p = inputs.profiles(11, 512, 180)
    assert np.all(np.diff(p["z"], axis=1) > 0)
    assert np.all(np.diff(p["p"], axis=1) < 0)
    assert 150.0 < p["t"].min() and p["t"].max() < 320.0
    assert np.all(p["rho"] > 0) and np.all(p["lwc"] >= 0)
    cloudy = (p["lwc"] > 0).any(axis=1).mean()
    assert 0.3 < cloudy < 0.7


def test_srf_weights_equal_the_ports():
    f = np.linspace(20.0, 64.0, 5000).astype(np.float32)
    np.testing.assert_array_equal(inputs.srf_weights(f),
                                  bench.srf_weights(f))
