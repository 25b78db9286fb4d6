"""The traced slice's idle device time, put down to the program's spans.

The port records host spans at its layer boundaries (`ops/spans.py` of the
port: `lbl.*`, `kmatrix.*`, `spectral.*` and `stage.*` in the entry points,
`cuda.*` in the kernel wrappers) as `user_annotation` events on the clock of
the device trace.  `read` takes the Chrome trace that a `--trace 1` run has
just written (`run.OUT_DIR / "trace.json"`) and rebuilds what
`traceread.read` builds from it: the calls' own device operations, by the
same launch-correlation rule, and the idle gaps between them over the
slice.  Then:

  * each gap goes to the innermost program span that covers its middle (a
    `user_annotation` named in the port's `SPAN_NAMES`), and to the harness
    where none does;
  * each device operation goes to the innermost program span that covers
    its launch on the host clock.

The idle time thus splits whole into glue (an entry point's own spans),
wrapper (the `cuda.*` spans) and harness, and the three add up to
traceread's `window_s - busy_s`.  Where the program has no spans (a version
without `ops/spans.py`, or none in the slice) the readers give None.
"""

import dataclasses
import importlib
import json
from collections import defaultdict

from . import guard, run, traceread

HARNESS = "host, outside any op"         # traceread's name for no cover
WRAPPER = "cuda."


@dataclasses.dataclass
class Spans:
    calls: int         # calls in the slice
    names: set         # the program spans that ran in the slice
    idle_s: dict       # {innermost program span or HARNESS: idle seconds}
    launches: dict     # {innermost program span or HARNESS: device ops}

    def idle_under(self, prefix: str) -> float:
        """Idle seconds whose innermost program span starts with
        `prefix` (a layer's "lbl." or one span's whole name)."""
        return sum(v for k, v in self.idle_s.items() if k.startswith(prefix))

    def launched_under(self, prefix: str) -> int:
        """Device operations launched with such a span innermost."""
        return sum(v for k, v in self.launches.items()
                   if k.startswith(prefix))

    def split(self) -> tuple:
        """(glue, wrapper, harness) idle seconds."""
        harness = self.idle_s.get(HARNESS, 0.0)
        wrapper = self.idle_under(WRAPPER)
        return (sum(self.idle_s.values()) - harness - wrapper, wrapper,
                harness)


def program_span_names():
    """The port's SPAN_NAMES, or None where the port has no spans."""
    try:
        return importlib.import_module(f"{guard.PORT}.ops.spans").SPAN_NAMES
    except ImportError:
        return None


def read(path, names) -> Spans:
    """The slice of the Chrome trace at `path`, its idle gaps and device
    operations given to the innermost span named in `names`."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events)
    dev, calls, launches, program = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        corr = e.get("args", {}).get("correlation")
        if cat in traceread.DEVICE_CATS:
            dev.append((lo, hi, corr))
        elif cat in traceread.HOST_CATS:
            if e["name"] == traceread.CALL_SPAN:
                calls.append((lo, hi))
            if corr is not None:
                launches.append((lo, corr))
            if cat == "user_annotation" and e["name"] in names:
                program.append((lo, hi, e["name"]))
    if not calls:
        raise RuntimeError("the trace holds no call")
    # traceread.read's slice, operations and gaps, step for step
    w_lo = min(s[0] for s in calls)
    w_hi = max(s[1] for s in calls)
    calls.sort()
    starts = [s[0] for s in calls]
    ours = {c for t, c in launches if traceread._inside(t, calls, starts)}
    launched_at = {}
    for t, c in launches:
        launched_at.setdefault(c, t)
    dev = sorted(d for d in dev
                 if (d[2] in ours if d[2] is not None
                     else traceread._inside(0.5 * (d[0] + d[1]), calls,
                                            starts)))
    gaps, cursor = [], w_lo
    for lo, hi, _ in dev:
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi <= cursor:
            continue
        if lo > cursor:
            gaps.append((cursor, lo))
        cursor = hi
    if w_hi > cursor:
        gaps.append((cursor, w_hi))

    idle = defaultdict(float)
    for (lo, hi), name in zip(gaps, traceread._gap_names(gaps, program)):
        idle[name] += (hi - lo) * 1e-6
    # an operation's launch, as a gap of no length at the launch's time
    at = sorted(launched_at.get(c, lo) if c is not None else lo
                for lo, _, c in dev)
    launched = defaultdict(int)
    for name in traceread._gap_names([(t, t) for t in at], program):
        launched[name] += 1
    seen = {n for lo, hi, n in program if hi >= w_lo and lo <= w_hi}
    return Spans(calls=len(calls), names=seen, idle_s=dict(idle),
                 launches=dict(launched))


_CACHE = {}


def of(ctx):
    """The `Spans` of the trace the run has just written, or None without
    a trace or without program spans in it."""
    if ctx.trace is None:
        return None
    names = program_span_names()
    if names is None:
        return None
    path = run.OUT_DIR / "trace.json"
    stat = path.stat()
    key = (str(path), stat.st_mtime_ns, stat.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = read(path, names)
    spans = _CACHE[key]
    return spans if spans.names else None


def idle_ms_per_call(ctx, prefix: str):
    """Idle device milliseconds per call of the slice under the program
    spans whose names start with `prefix`; None where none ran."""
    spans = of(ctx)
    if spans is None or not any(n.startswith(prefix) for n in spans.names):
        return None
    return 1e3 * spans.idle_under(prefix) / spans.calls


def launches_per_call(ctx, prefix: str):
    """Device operations per call launched with a program span whose name
    starts with `prefix` innermost; None where none ran."""
    spans = of(ctx)
    if spans is None or not any(n.startswith(prefix) for n in spans.names):
        return None
    return spans.launched_under(prefix) / spans.calls
