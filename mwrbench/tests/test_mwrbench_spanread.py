"""The idle time of a traced slice put down to the program's spans
(`spanread.py`), on a small synthetic Chrome trace."""

import json
import types

import pytest

from mwrbench import guard, manifest, run, spanread, traceread

NEW = {
    "lbl.glue_idle_ms_per_call": "hatpro_archive_b4096",
    "lbl.wrapper_idle_ms_per_call": "hatpro_archive_b4096",
    "kmatrix.glue_idle_ms_per_call": "hatpro_kmatrix_b256",
    "kmatrix.geometry_idle_ms_per_call": "hatpro_kmatrix_b256",
    "kmatrix.geometry_launches_per_call": "hatpro_kmatrix_b256",
    "kmatrix.wrapper_idle_ms_per_call": "hatpro_kmatrix_b256",
    "spectral.glue_idle_ms_per_call": "spectral_channel_design",
    "spectral.wrapper_idle_ms_per_call": "spectral_channel_design",
}


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(with_spans=True):
    """Two calls of 100 us; busy 15-25, 38-70 and 95-100 in the first,
    153-155 and 170-240 in the second.  Idle, each gap by its middle: 0-15
    (under lbl.layout, aten::mul innermost), 25-38 (cuda.absorption_lb),
    70-95 (lbl.output_layout, aten::permute innermost), 100-153 (the
    harness, between the calls), 155-170 (kmatrix.slant_geometry) and
    240-250 (the harness: the call after its entry)."""
    ua, op, rt, k = "user_annotation", "cpu_op", "cuda_runtime", "kernel"
    events = [
        _x(ua, "mwrbench.call", 0, 100),
        _x(ua, "mwrbench.call", 150, 100),
        _x(op, "aten::mul", 2, 26),
        _x(rt, "cudaLaunchKernel", 12, 2, 10),
        _x(rt, "cudaLaunchKernel", 35, 2, 11),
        _x(rt, "cudaLaunchKernel", 44, 2, 12),
        _x(op, "aten::permute", 81, 13),
        _x(rt, "cudaLaunchKernel", 90, 2, 13),
        _x(rt, "cudaDeviceSynchronize", 95, 5),
        _x(rt, "cudaLaunchKernel", 151, 1, 19),
        _x(rt, "cudaLaunchKernel", 160, 2, 20),
        # the harness's copy of a kept output, after the calls
        _x(rt, "cudaMemcpyAsync", 260, 2, 30),
        _x(k, "vectorized_elementwise_kernel", 15, 10, 10),
        _x(k, "absorption_points_kernel<14>", 38, 22, 11),
        _x(k, "vectorized_elementwise_kernel", 60, 10, 12),
        _x(k, "vectorized_elementwise_kernel", 95, 5, 13),
        _x(k, "vectorized_elementwise_kernel", 153, 2, 19),
        _x(k, "kmatrix_kernel<true>", 170, 70, 20),
        _x("gpu_memcpy", "Memcpy DtoD", 262, 18, 30),
    ]
    if with_spans:
        events += [
            _x(ua, "lbl.forward_batch", 1, 94),
            _x(ua, "lbl.layout", 1, 27),
            _x(ua, "cuda.absorption_lb", 28, 12),
            _x(ua, "lbl.refractive_index", 40, 10),
            _x(ua, "lbl.output_layout", 80, 15),
            _x(ua, "kmatrix.kmatrix_batch_fast", 151, 89),
            _x(ua, "kmatrix.slant_geometry", 155, 10),
            # the same span on the device's timeline is not the host's
            _x("gpu_user_annotation", "lbl.layout", 200, 50),
        ]
    return events


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """Writes a trace where the run writes it; returns a reader's ctx."""
    monkeypatch.setattr(run, "OUT_DIR", tmp_path)

    def write(with_spans=True):
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": _events(with_spans)}))
        return types.SimpleNamespace(trace=traceread.read(path), path=path)
    return write


def _read(ctx):
    return spanread.read(ctx.path, spanread.program_span_names())


def test_gaps_go_to_the_innermost_program_span(traced):
    ctx = traced()
    s = _read(ctx)
    # traceread names these gaps by the aten ops
    assert ctx.trace.gaps["aten::mul"] == pytest.approx(15e-6)
    assert ctx.trace.gaps["aten::permute"] == pytest.approx(25e-6)
    assert s.idle_s == pytest.approx({
        "lbl.layout": 15e-6, "cuda.absorption_lb": 13e-6,
        "lbl.output_layout": 25e-6, "kmatrix.slant_geometry": 15e-6,
        spanread.HARNESS: 63e-6})
    assert s.calls == 2
    assert s.names == {"lbl.forward_batch", "lbl.layout",
                       "cuda.absorption_lb", "lbl.refractive_index",
                       "lbl.output_layout", "kmatrix.kmatrix_batch_fast",
                       "kmatrix.slant_geometry"}


def test_launches_are_put_down_through_correlation(traced):
    s = _read(traced())
    # K1 runs while the host is past its wrapper, and the elementwise
    # kernel after lbl.refractive_index ended: each goes to its launch's
    # span; the harness's copy after the calls is not the calls'
    assert s.launches == {"lbl.layout": 1, "cuda.absorption_lb": 1,
                          "lbl.refractive_index": 1, "lbl.output_layout": 1,
                          "kmatrix.kmatrix_batch_fast": 1,
                          "kmatrix.slant_geometry": 1}


def test_glue_wrapper_and_harness_add_up_to_the_idle_time(traced):
    ctx = traced()
    glue, wrapper, harness = _read(ctx).split()
    assert (glue, wrapper, harness) == pytest.approx((55e-6, 13e-6, 63e-6))
    idle = ctx.trace.window_s - ctx.trace.busy_s
    assert abs(glue + wrapper + harness - idle) < 1e-9 * idle


def test_the_readers_put_harness_time_in_no_metric(traced):
    ctx = traced()
    got = {name: run.reader("metrics", name)(ctx) for name in NEW}
    assert got["lbl.glue_idle_ms_per_call"] == pytest.approx(40e-3 / 2)
    assert got["lbl.wrapper_idle_ms_per_call"] == pytest.approx(13e-3 / 2)
    assert got["kmatrix.glue_idle_ms_per_call"] == pytest.approx(15e-3 / 2)
    assert got["kmatrix.geometry_idle_ms_per_call"] == pytest.approx(
        15e-3 / 2)
    assert got["kmatrix.geometry_launches_per_call"] == 0.5
    assert got["kmatrix.wrapper_idle_ms_per_call"] == got[
        "lbl.wrapper_idle_ms_per_call"]
    # no spectral span ran in this slice
    assert got["spectral.glue_idle_ms_per_call"] is None
    # glue and wrapper: all of the idle time but the harness's 63 us
    per_call = (got["lbl.glue_idle_ms_per_call"]
                + got["kmatrix.glue_idle_ms_per_call"]
                + got["lbl.wrapper_idle_ms_per_call"])
    idle_ms = 1e3 * (ctx.trace.window_s - ctx.trace.busy_s) / 2
    assert per_call == pytest.approx(idle_ms - 63e-3 / 2)


@pytest.mark.parametrize("name", sorted(NEW))
def test_every_reader_gives_none_without_a_trace(name):
    assert run.reader("metrics", name)(
        types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_every_reader_gives_none_without_program_spans(traced, name):
    """A version of the program that records no span: the metric is left
    out of the result line, and nothing raises."""
    assert run.reader("metrics", name)(traced(with_spans=False)) is None


def test_a_port_without_spans_gives_none(traced, monkeypatch):
    ctx = traced()
    monkeypatch.setattr(guard, "PORT", "no_such_port_package")
    assert spanread.program_span_names() is None
    assert run.reader("metrics", "lbl.glue_idle_ms_per_call")(ctx) is None


def test_the_manifest_takes_the_new_entries():
    bench = manifest.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    moves = {"hatpro_archive_b4096": "spectra_per_s",
             "hatpro_kmatrix_b256": "profiles_per_s",
             "spectral_channel_design": "freq_points_per_s"}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["workloads"] == [cell]
        assert m["source"] == "device_trace"
        assert m["moves"] == moves[cell]
    assert bench["per_layer"][-len(NEW):] == [entries[n] for n in NEW]
