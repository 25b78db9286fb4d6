"""The MP-3000A archive cell `mp3000a_archive_b4096`: its entries load and
differ from the HATPRO archive cell's in the channels alone, a whole run at a
small size on the CPU is correct and the bfloat16 control is not, each of
the archive cell's per-layer readers gives a number on a synthetic trace of
the 22-channel bodies and none without one, and K1's need at 22 channels
counts the line state once a point."""

import json
import types

import numpy as np
import pytest
import torch

from mwrbench import control, manifest, run, traceread
from mwrbench.rooflines import bounds

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "mp3000a_archive_b4096"
CONFIG = "mp3000a_l180"
SMALL = {"batch": 3, "pool": 2, "n_levels": 40,
         "elevations_deg": [90.0, 19.2, 4.2], "samples": 2, "trace_calls": 2}
# the HATPRO archive cell's readers, which read the cell as they read it
METRICS = ("lbl.launches_per_call", "lbl.step_mfu", "k1_roofline",
           "k2_roofline", "device.idle_pct.lbl", "lbl.glue_idle_ms_per_call",
           "lbl.wrapper_idle_ms_per_call")
CHANNELS = (22.234, 22.5, 23.034, 23.834, 25.0, 26.234, 28.0, 30.0,
            51.248, 51.76, 52.28, 52.804, 53.336, 53.848, 54.4, 54.94,
            55.5, 56.02, 56.66, 57.288, 57.964, 58.8)


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_the_manifest_holds_the_cell_and_its_metrics(bench):
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == CONFIG
    (config,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert config["reduced"] == []
    assert config["source"].startswith("Radiometrics MP-3000A 22-ch")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert [m for m in e2e if manifest.reports(e2e[m], CELL)] == [
        "spectra_per_s", "call_ms_p95", "setup_s"]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert per_layer[name]["workloads"] == ["hatpro_archive_b4096", CELL]
        assert per_layer[name]["moves"] == "spectra_per_s"
    assert [n for n, m in per_layer.items()
            if manifest.reports(m, CELL)] == list(METRICS)
    assert all(manifest.reader_path("metrics", n).exists() for n in METRICS)


def test_the_cell_is_the_archive_cell_at_other_channels():
    """The traffic and every size but the channels are the HATPRO archive
    cell's."""
    mine = manifest.read_json(manifest.workload_path(CELL))
    theirs = manifest.read_json(manifest.workload_path("hatpro_archive_b4096"))
    assert {k: v for k, v in mine.items() if k != "config"} == \
        {k: v for k, v in theirs.items() if k != "config"}
    config = manifest.read_json(manifest.config_path(CONFIG))
    hatpro = manifest.read_json(manifest.config_path("hatpro_g5_l180"))
    assert tuple(config["channels_ghz"]) == CHANNELS
    for key in ("elevations_deg", "n_levels", "top_m", "absorption_models",
                "include_liquid", "dtype", "tf32", "kmatrix_wrt",
                "kmatrix_geometry_dtype", "lbl_tb_limit_k"):
        assert config[key] == hatpro[key], key
    assert set(config["assumed"]) == {"profiles", "bandwidths", "scan"}


def _run(bench, trace=False, wrap=None):
    return run.measure(CELL, 2**31 + 2503, 0.3, trace, CPU, bench,
                       overrides=SMALL, wrap=wrap)


def test_the_program_is_correct(bench):
    result = _run(bench)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"tb_max_abs_k"}
    assert set(result["metrics"]) == {"spectra_per_s", "call_ms_p95",
                                      "setup_s"}


def test_a_moved_tb_is_not_correct(bench):
    def moved(call):
        def f(i):
            out = call(i).clone()
            out[0, -1, -1] += 0.1
            return out
        return f
    assert not _run(bench, wrap=moved)["correct"]


def test_the_control_is_not_correct():
    numbers = control.control_numbers(CELL, 7, torch.bfloat16, CPU, SMALL)
    limit = manifest.read_json(manifest.workload_path(CELL))["limits"]
    assert numbers["tb_max_abs_k"] > limit["tb_max_abs_k"]


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """Two calls of 1000 us.  Each: K1 from 100 to 700, K2 from 720 to
    900, one launch each, and a copy of 100 us; idle 0-100
    under cuda.absorption_lb, 700-720 under cuda.forward_lb, 900-1000 under
    lbl.output_layout.  The first call's last gap and the second's first
    are one gap, which goes to the harness by its middle."""
    ua, rt, k = "user_annotation", "cuda_runtime", "kernel"
    events = []
    for c in range(2):
        t0, corr = 1000 * c, 10 * c
        events += [
            _x(ua, "mwrbench.call", t0, 1000),
            _x(ua, "lbl.forward_batch", t0 + 1, 998),
            _x(ua, "lbl.layout", t0 + 1, 8),
            _x(ua, "cuda.absorption_lb", t0 + 10, 85),
            _x(rt, "cudaLaunchKernel", t0 + 20, 5, corr + 1),
            _x(rt, "cudaMemcpyAsync", t0 + 30, 5, corr + 2),
            _x(ua, "cuda.forward_lb", t0 + 690, 40),
            _x(rt, "cudaLaunchKernel", t0 + 700, 5, corr + 3),
            _x(ua, "lbl.output_layout", t0 + 900, 90),
            _x(k, "void (anonymous namespace)::absorption_points_kernel<22>"
               "(float const*)", t0 + 100, 500, corr + 1),
            _x("gpu_memcpy", "Memcpy DtoD", t0 + 600, 100, corr + 2),
            _x(k, "void (anonymous namespace)::downwelling_staged_kernel"
               "<true>(float const*)", t0 + 720, 180, corr + 3)]
    return events


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "OUT_DIR", tmp_path)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    spec, config = run.cell_spec(CELL)
    return types.SimpleNamespace(workload=spec, config=config,
                                 trace=traceread.read(path),
                                 untraced_call_s=1e-3)


def test_each_reader_reads_the_synthetic_trace(ctx):
    got = {n: run.reader("metrics", n)(ctx) for n in METRICS}
    need = bounds.lbl_call(ctx.workload, ctx.config)
    k1 = need["k1"][0].time_bound_s()
    k2 = need["k2"][0].time_bound_s()
    assert got["k1_roofline"] == pytest.approx(100 * 2 * k1 / 1e-3)
    assert got["k2_roofline"] == pytest.approx(100 * 2 * k2 / 0.36e-3)
    assert got["lbl.launches_per_call"] == 3
    assert got["lbl.step_mfu"] == pytest.approx(
        100 * (need["k1"][0] + need["k2"][0]).time_bound_s() / 1e-3)
    assert got["device.idle_pct.lbl"] == pytest.approx(22.0)
    # the second call's last gap, under lbl.output_layout, over two calls
    assert got["lbl.glue_idle_ms_per_call"] == pytest.approx(100 * 1e-3 / 2)
    assert got["lbl.wrapper_idle_ms_per_call"] == pytest.approx(
        (100 + 20 + 20) * 1e-3 / 2)
    # at the cell's sizes the shares of the card stay below 100 %
    for name in ("k1_roofline", "k2_roofline", "lbl.step_mfu"):
        assert 0 < got[name] < 100, name


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_gives_none_without_a_trace(name):
    spec, config = run.cell_spec(CELL)
    assert run.reader("metrics", name)(types.SimpleNamespace(
        workload=spec, config=config, trace=None)) is None


def _k1(freqs):
    spec, config = run.cell_spec(CELL)
    return bounds.lbl_call(spec, dict(config, channels_ghz=list(freqs)))["k1"][0]


def test_k1s_need_counts_the_line_state_once_a_point():
    """The need of 22 channels holds the line state once, where two halves
    of 11 hold it twice: the state's exponentials are all of K1's (per
    point, whatever the channels), its divides come out of the sum of the
    halves once, as for HATPRO's two bands, and its fp32 work is some 5 %
    of the need."""
    whole, low, high = _k1(CHANNELS), _k1(CHANNELS[:11]), _k1(CHANNELS[11:])
    hatpro = manifest.read_json(
        manifest.config_path("hatpro_g5_l180"))["channels_ghz"]
    h_whole, h_k, h_v = _k1(hatpro), _k1(hatpro[:7]), _k1(hatpro[7:])
    assert whole.exp_ops == low.exp_ops == high.exp_ops == h_whole.exp_ops
    state_div = low.div_ops + high.div_ops - whole.div_ops
    assert state_div > 0
    assert state_div == h_k.div_ops + h_v.div_ops - h_whole.div_ops
    state_fma = low.fma_ops + high.fma_ops - whole.fma_ops
    assert 0.03 < state_fma / whole.fma_ops < 0.08
    # per channel K1 needs about 0.27e9 FMA at B=4096 x 180, so 22
    # channels need about 1.5 times HATPRO's 14
    assert 1.4 < whole.fma_ops / h_whole.fma_ops < 1.6
    assert np.isclose(whole.hbm_bytes - h_whole.hbm_bytes,
                      4.0 * (4096 * 180 + 1) * 8)
