"""The traced slice read from a Chrome trace: the calls' own device
operations, the busy seconds, the idle gaps by host op, the shares."""

import json
import types

from mwrbench import traceread
from mwrbench.rooflines import counts


def _trace(tmp_path):
    X = "X"
    events = [
        # two calls of 100 us each
        {"ph": X, "cat": "user_annotation", "name": "mwrbench.call",
         "ts": 0, "dur": 100},
        {"ph": X, "cat": "user_annotation", "name": "mwrbench.call",
         "ts": 200, "dur": 100},
        {"ph": X, "cat": "cpu_op", "name": "aten::mul", "ts": 120,
         "dur": 40},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 5, "args": {"correlation": 1}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 210, "dur": 5, "args": {"correlation": 2}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 310, "dur": 5, "args": {"correlation": 3}},
        {"ph": X, "cat": "kernel", "ts": 20, "dur": 40,
         "name": "void (anonymous namespace)::absorption_points_kernel<14>"
                 "(float const*, float*)", "args": {"correlation": 1}},
        {"ph": X, "cat": "kernel", "ts": 220, "dur": 40,
         "name": "void absorption_points_kernel<14>(float const*)",
         "args": {"correlation": 2}},
        # the harness's copy of a kept output, launched outside any call
        {"ph": X, "cat": "gpu_memcpy", "name": "Memcpy DtoD",
         "ts": 320, "dur": 30, "args": {"correlation": 3}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return traceread.read(path)


def test_read_keeps_the_calls_own_operations(tmp_path):
    t = _trace(tmp_path)
    assert t.calls == 2
    assert len(t.ops) == 2
    assert abs(t.busy_s - 80e-6) < 1e-12
    assert abs(t.window_s - 300e-6) < 1e-12
    assert abs(sum(t.gaps.values()) - 220e-6) < 1e-12
    assert t.gaps["aten::mul"] > 0
    assert t.op_seconds(("absorption_points_kernel",))[1] == 2


def test_breakdown_and_shares(tmp_path):
    t = _trace(tmp_path)
    b = traceread.breakdown(t)
    assert b["device_ops"][0][0] == "absorption_points_kernel<14>"
    r = counts.k1_roofline(1000)
    ctx = types.SimpleNamespace(trace=t, untraced_call_s=1e-3)
    share = traceread.roofline_pct(ctx, ("absorption_points_kernel",), [r])
    assert abs(share - 100.0 * r.time_bound_s() * 2 / 80e-6) < 1e-9
    assert traceread.roofline_pct(ctx, ("nothing_kernel",), [r]) is None
    assert abs(traceread.idle_pct(ctx) - 100.0 * (1 - 80 / 300)) < 1e-9
    assert traceread.launches_per_call(ctx) == 1.0
    assert abs(traceread.step_mfu_pct(ctx, [r, r])
               - 100.0 * (r + r).time_bound_s() / 1e-3) < 1e-9
