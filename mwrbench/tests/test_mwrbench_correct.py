"""What decides `correct`, at sizes a CPU test run can hold: a whole run of
each cell (all but the look for a card) is correct with the program as it
is, and not correct with its timed path broken underneath or with the
control in the program's place.

The faults a cell of this benchmark can have: half of the batch left out
(the program computes the first half of the profiles, or of the stage's
times, and leaves the rest at zero) and an answer altered where it is
produced (one TB, or one entry of each output, moved by ten times the
cell's widest limit).  The control is the plain
reference computed in bfloat16, the precision below the configurations'
float32 (`control.py`, which on the card gives each limit's upper reading).
"""

import numpy as np
import pytest
import torch

from mwrbench import control, manifest, run

CPU = torch.device("cpu")
SMALL = {
    "hatpro_archive_b4096": {"batch": 6, "pool": 2, "n_levels": 40},
    "spectral_channel_design": {"batch": 4, "pool": 2, "n_levels": 40,
                                "n_freqs": 800, "freq_chunk": 256,
                                "samples": 2},
    "hatpro_kmatrix_b256": {"batch": 2, "pool": 2, "n_levels": 30},
    "campaign_stage_4rel": {"n_time": 6, "n_levels": 30, "invalid": 0.25,
                            "batch_size": 4},
}
CELLS = sorted(SMALL)


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _limits(cell):
    return manifest.read_json(manifest.workload_path(cell))["limits"]


def _each(out, fn):
    return {k: fn(v) for k, v in out.items()} if isinstance(out, dict) \
        else fn(out)


def _copy(v):
    return v.clone() if torch.is_tensor(v) else np.array(v, copy=True)


def half_batch(out):
    def cut(v):
        v = _copy(v)
        v[v.shape[0] // 2:] = 0.0
        return v
    return _each(out, cut)


def altered(cell):
    """One finite entry of each output moved by ten times the cell's
    widest limit, times the output's largest magnitude for a dict of
    outputs (the K-matrices, the stage's variables)."""
    def alter(out):
        def bump(v):
            v = _copy(v)
            flat = v.reshape(-1)
            finite = np.flatnonzero(np.isfinite(np.asarray(flat)))
            at = int(finite[len(finite) // 3])
            limit = max(_limits(cell).values())
            scale = (float(np.nanmax(np.abs(np.asarray(flat))))
                     if isinstance(out, dict) else 1.0)
            flat[at] += 10.0 * limit * scale
            return v
        return _each(out, bump)
    return alter


def _run(bench, cell, fault=None):
    wrap = None if fault is None else (lambda call: lambda i: fault(call(i)))
    return run.measure(cell, 20261017, 0.3, False, CPU, bench,
                       overrides=SMALL[cell], wrap=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(bench, cell):
    result = _run(bench, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(bench, cell):
    assert not _run(bench, cell, half_batch)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_is_not_correct(bench, cell):
    result = _run(bench, cell, altered(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    numbers = control.control_numbers(cell, 7, torch.bfloat16, CPU,
                                      SMALL[cell])
    limits = _limits(cell)
    assert numbers.keys() == limits.keys()
    assert any(numbers[k] > limits[k] for k in limits), numbers
