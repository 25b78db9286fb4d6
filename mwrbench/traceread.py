"""The traced slice of a window, read from `torch.profiler`'s Chrome trace.

`read` turns the exported trace into a `Trace`: every device operation
(kernel, copy, set) of the slice with its seconds, the union of their
intervals (the busy seconds), the slice's length, and the idle gaps named
by the innermost host operation that was running in each.  The per-layer
readers under `metrics/` take their numbers from it.
"""

import bisect
import dataclasses
import heapq
import json
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
CALL_SPAN = "mwrbench.call"


@dataclasses.dataclass
class Trace:
    ops: list          # (name, seconds) of each device operation
    busy_s: float      # the union of the device operations' intervals
    window_s: float    # from the first call's start to the last one's end
    calls: int         # calls in the slice
    gaps: dict         # {host op: idle seconds}

    def op_seconds(self, symbols) -> tuple:
        """(seconds, launches) of the device operations whose name holds
        one of `symbols`."""
        hits = [s for n, s in self.ops if any(y in n for y in symbols)]
        return sum(hits), len(hits)


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list, at most
    100 letters."""
    name = name.strip().removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    return name.replace("(anonymous namespace)::", "").strip()[:100]


def _gap_names(gaps, host):
    """The innermost host event covering the middle of each gap."""
    host = sorted(host)                     # (start, end, name)
    active, names, k = [], [], 0
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(active, (host[k][1], host[k][0], host[k][2]))
            k += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        names.append(max(active, key=lambda e: e[1])[2] if active
                     else "host, outside any op")
    return names


def _inside(t, spans, starts) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= spans[k][1]


def read(path) -> Trace:
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events)
    dev, host, spans, launches = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        corr = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((lo, hi, e["name"], corr))
        elif cat in HOST_CATS:
            host.append((lo, hi, e["name"]))
            if e["name"] == CALL_SPAN:
                spans.append((lo, hi))
            if corr is not None:
                launches.append((lo, corr))
    if not spans:
        raise RuntimeError("the trace holds no call")
    w_lo = min(s[0] for s in spans)
    w_hi = max(s[1] for s in spans)
    # the calls' own operations, by the launch on the host clock that each
    # correlates with: the harness copies the outputs it keeps after a call
    # has synchronised, outside its span
    spans.sort()
    starts = [s[0] for s in spans]
    ours = {c for t, c in launches if _inside(t, spans, starts)}
    dev = sorted(d[:3] for d in dev
                 if (d[3] in ours if d[3] is not None
                     else _inside(0.5 * (d[0] + d[1]), spans, starts)))
    busy, gaps, cursor = 0.0, [], w_lo
    for lo, hi, _ in dev:
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi <= cursor:
            continue
        if lo > cursor:
            gaps.append((cursor, lo))
        busy += hi - max(lo, cursor)
        cursor = hi
    if w_hi > cursor:
        gaps.append((cursor, w_hi))
    named = defaultdict(float)
    for (lo, hi), name in zip(gaps, _gap_names(gaps, host)):
        named[name] += (hi - lo) * 1e-6
    return Trace(ops=[(n, (hi - lo) * 1e-6) for lo, hi, n in dev],
                 busy_s=busy * 1e-6, window_s=(w_hi - w_lo) * 1e-6,
                 calls=len(spans), gaps=dict(named))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    time by the host op that was running, each summed by name."""
    by_op = defaultdict(float)
    for name, s in trace.ops:
        by_op[short_name(name)] += s

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(trace.gaps)}


def roofline_pct(ctx, symbols, rooflines) -> float | None:
    """A kernel's share of its roofline [%]: the least time of `rooflines`
    (one per launch of one call) times the traced calls, over the device
    seconds of the operations named by `symbols`; None where the trace
    holds none of them."""
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.op_seconds(symbols)
    if not launches:
        return None
    bound = sum(r.time_bound_s() for r in rooflines) * ctx.trace.calls
    return 100.0 * bound / seconds


def step_mfu_pct(ctx, rooflines) -> float | None:
    """The whole call's share of the card's peaks [%]: the least time of
    the call's kernels by need, summed as one Roofline, over the time per
    call of the traced run's calls outside the profiled slice."""
    if ctx.trace is None or not ctx.untraced_call_s > 0:
        return None
    total = rooflines[0]
    for r in rooflines[1:]:
        total = total + r
    return 100.0 * total.time_bound_s() / ctx.untraced_call_s


def idle_pct(ctx) -> float | None:
    """The share of the traced slice in which no operation ran on the
    device [%]."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def launches_per_call(ctx) -> float | None:
    """Device operations (kernels, copies, sets) per call of the slice."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.trace.calls
