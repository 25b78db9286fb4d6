"""The retrieval cell `hatpro_oem_b1024`: its entries load, a whole run at
a small size on the CPU is correct and reads its per-layer metrics, a fault
or the control is not correct, its reference imports nothing of the port
and agrees with the fast operator it differentiates, and its work count is
the one its docstring states."""

import ast

import numpy as np
import pytest
import torch

from mwrbench import control, guard, manifest, run
from mwrbench.reference import fast as ref_fast
from mwrbench.reference import oem as ref_oem
from mwrbench.rooflines import counts
from mwrbench.rooflines import oem as oem_counts

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "hatpro_oem_b1024"
SMALL = {"batch": 3, "pool": 2, "n_levels": 40,
         "elevations_deg": [90.0, 19.2, 4.2], "n_iter": 2,
         "fast_fit_profiles": 24, "samples": 2, "trace_calls": 2}
NEW_METRICS = ("oem.launches_per_call", "oem.glue_idle_ms_per_call",
               "oem.jacobian_idle_ms_per_call",
               "oem.jacobian_launches_per_call", "device.idle_pct.oem",
               "k2mid_roofline", "oem.step_mfu",
               "oem.forward_idle_ms_per_call")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _limits():
    return manifest.read_json(manifest.workload_path(CELL))["limits"]


def test_the_manifest_holds_the_cell_and_its_metrics(bench):
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == "hatpro_g5_oem_l180"
    (config,) = [c for c in bench["configs"]
                 if c["name"] == cell["config"]]
    assert config["reduced"] == []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert [m for m in e2e if manifest.reports(e2e[m], CELL)] == [
        "profiles_per_s", "call_ms_p95", "setup_s"]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "profiles_per_s"
    assert [n for n, m in per_layer.items()
            if manifest.reports(m, CELL)] == list(NEW_METRICS)


def test_the_configuration_is_the_retrieval_the_cli_runs():
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
        retrieval)
    config = manifest.read_json(manifest.config_path("hatpro_g5_oem_l180"))
    default = retrieval.OEMConfig()
    for key in ("n_iter", "obs_error_k", "sigma_t_k", "sigma_lnrho",
                "corr_length_levels", "rho_floor"):
        assert config[key] == getattr(default, key), key
    assert tuple(config["channels_ghz"]) == default.freqs_ghz
    assert tuple(config["elevations_deg"]) == default.elevations_deg
    assert config["n_state"] == 2 * config["n_levels"] == 360
    assert config["n_obs"] == len(default.freqs_ghz) * len(
        default.elevations_deg) == 140
    assert config["dtype"] == "float32" and config["tf32"] is False


def _run(bench, trace=False, wrap=None):
    return run.measure(CELL, 2**31 + 77, 0.3, trace, CPU, bench,
                       overrides=SMALL, wrap=wrap)


def test_the_program_is_correct(bench):
    result = _run(bench)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    limits = _limits()
    assert result["checks"].keys() == limits.keys()
    for name, c in result["checks"].items():
        assert np.isfinite(c["value"]) and c["value"] <= limits[name], name
    assert set(result["metrics"]) == {"profiles_per_s", "call_ms_p95",
                                      "setup_s"}


def test_a_traced_run_reads_the_metrics_it_can_on_the_cpu(bench):
    """No device operation runs on the CPU: the readers of device time give
    none (and raise nothing); the spans' idle time and the step's share
    are read."""
    metrics = _run(bench, trace=True)["metrics"]
    assert set(metrics) <= set(NEW_METRICS)
    for name in ("oem.glue_idle_ms_per_call", "oem.jacobian_idle_ms_per_call",
                 "oem.forward_idle_ms_per_call", "oem.step_mfu"):
        assert np.isfinite(metrics[name]["value"]), name
    assert "k2mid_roofline" not in metrics


def _first_profile_moved(out):
    out = dict(out)
    out["t"] = out["t"].clone()
    out["t"][0, 0] += 10.0 * _limits()["t_max_abs_k"]
    return out


def _half_batch(out):
    return {k: torch.where(torch.arange(len(v)).reshape(
        -1, *[1] * (v.dim() - 1)) < len(v) // 2, v, 0.0)
        for k, v in out.items()}


def _a_diverged_profile(out):
    return {k: v.clone().index_fill_(0, torch.tensor([1]), float("nan"))
            for k, v in out.items()}


@pytest.mark.parametrize("fault", (_first_profile_moved, _half_batch,
                                   _a_diverged_profile))
def test_a_fault_is_not_correct(bench, fault):
    result = _run(bench, wrap=lambda call: lambda i: fault(call(i)))
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct():
    numbers = control.control_numbers(CELL, 7, torch.bfloat16, CPU, SMALL)
    limits = _limits()
    assert numbers.keys() == limits.keys()
    assert any(not numbers[k] <= limits[k] for k in limits), numbers


def test_the_reference_imports_nothing_of_the_port():
    assert guard.reference_imports_program() == []
    tree = ast.parse((manifest.HERE / "reference" / "oem.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"numpy", "torch", "", "physics"}


def test_the_rows_forward_is_the_fast_forward():
    """The per-row arithmetic K differentiates gives `fast.forward`'s TBs."""
    from mwrbench import inputs
    prof = inputs.profiles(5, 3, 40)
    freqs = (22.24, 31.4, 54.94, 58.0)
    els = (90.0, 30.0, 4.2)
    w = np.random.default_rng(2).normal(0.0, 1e-2, (72, 4))
    x = {k: torch.from_numpy(v).double() for k, v in prof.items()}
    want = ref_fast.forward(w, x, freqs, els)[0].permute(1, 2, 0)
    state = torch.cat([x["t"], torch.log(x["rho"] + 1e-3)], dim=1)
    rows = state.expand(len(els), len(freqs), *state.shape)
    cols = {k: x[k] for k in ("z", "p", "lwc")}
    got = ref_oem.rows_forward(w, rows, cols, freqs, els, 1e-3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_the_linear_algebra_is_counted_as_stated():
    """Per profile, n = 2, m = 1, one step: the factorisation's n^2 m / 2
    (Sa's two blocks) + m^2 n + m^3 / 6 twice, the step's m n + m^2 + n m
    once, the final solves' m^2 n and the trace's n m."""
    got = oem_counts.linalg_fma(1, 2, 1, 1)
    assert got == pytest.approx(2 * (2 + 2 + 1 / 6) + (2 + 1 + 2) + 2 + 2)
    assert oem_counts.linalg_fma(7, 2, 1, 1) == pytest.approx(7 * got)
    config = manifest.read_json(manifest.config_path("hatpro_g5_oem_l180"))
    spec = manifest.read_json(manifest.workload_path(CELL))
    call = oem_counts.oem_call(spec, config)
    n, m, b = 360, 140, 1024
    (linalg,) = call["linalg"]
    assert linalg.fma_ops == pytest.approx(
        b * (6 * (n * n * m / 2 + m * m * n + m ** 3 / 6)
             + 5 * (2 * m * n + m * m) + m * m * n + n * m))
    assert 1.05e11 < linalg.fma_ops < 1.15e11
    assert call["k2mid"] == [counts.k2_roofline(b, 180, 14, 10,
                                                alpha_is_mid=True)] * 6
    assert [r.hbm_bytes for r in call["fastk"]] == [
        4.0 * (5 * b * 180 + 72 * 14 + 2 * b * m * 180)] * 6
