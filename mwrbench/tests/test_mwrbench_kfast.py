"""The fast-K kernel's share of its roofline, `kfast_roofline`: its entry in
the manifest, None on a trace without the kernel (the parent's path, or any
trace of the plain fast K), and the share on a synthetic trace that holds
it, against the fast K's least bytes in `rooflines/oem.py`."""

import json
import types

from mwrbench import manifest, run, traceread
from mwrbench.rooflines import oem

CELL = "hatpro_oem_b1024"
NAME = "kfast_roofline"


def _trace(tmp_path, kernel: str):
    """Two traced calls of 1 ms, each with one launch of `kernel` of 200 us
    and one of a cuBLAS product of 300 us."""
    events = []
    for i in range(2):
        t0 = 1000 * i
        events += [
            {"ph": "X", "cat": "user_annotation", "name": "mwrbench.call",
             "ts": t0, "dur": 1000},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t0 + 10, "dur": 5, "args": {"correlation": 10 * i + 1}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t0 + 20, "dur": 5, "args": {"correlation": 10 * i + 2}},
            {"ph": "X", "cat": "kernel", "ts": t0 + 30, "dur": 200,
             "name": f"void (anonymous namespace)::{kernel}<true, true>"
                     f"(float const*, float*)",
             "args": {"correlation": 10 * i + 1}},
            {"ph": "X", "cat": "kernel", "ts": t0 + 300, "dur": 300,
             "name": "sm90_xmma_gemm_f64f64_f64f64_f64_nt_n",
             "args": {"correlation": 10 * i + 2}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return traceread.read(path)


def _ctx(trace):
    spec, config = run.cell_spec(CELL)
    return types.SimpleNamespace(workload=spec, config=config, trace=trace)


def test_the_manifest_appends_the_metric_last():
    bench = manifest.load()
    assert bench["per_layer"][-1] == {
        "name": NAME, "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "ops.cuda",
        "moves": "profiles_per_s", "workloads": [CELL]}
    assert manifest.reader_path("metrics", NAME).exists()


def test_it_reads_none_without_the_kernel(tmp_path):
    read = run.reader("metrics", NAME)
    assert read(_ctx(None)) is None
    assert read(_ctx(_trace(tmp_path, "elementwise_kernel"))) is None


def test_it_reads_the_share_of_the_fast_k_bytes(tmp_path):
    trace = _trace(tmp_path, "fastk_adjoint_kernel")
    ctx = _ctx(trace)
    share = run.reader("metrics", NAME)(ctx)
    passes = oem.oem_call(ctx.workload, ctx.config)["fastk"]
    assert len(passes) == ctx.config["n_iter"] + 1
    bound = sum(r.time_bound_s() for r in passes) * trace.calls
    assert abs(share - 100.0 * bound / 400e-6) < 1e-9
    # the least bytes: z, p, t, rho, lwc and the weights read, K_t and
    # K_rho written, float32, about 210 MB a pass at the cell's size
    b, lev = ctx.workload["batch"], ctx.config["n_levels"]
    n_ch = len(ctx.config["channels_ghz"])
    n_el = len(ctx.config["elevations_deg"])
    assert passes[0].hbm_bytes == 4.0 * (5 * b * lev + 72 * n_ch
                                     + 2 * b * n_el * n_ch * lev)
