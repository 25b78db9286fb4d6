"""Profiling and roofline accounting for the port's kernels on an NVIDIA GPU.

Three things live here:

  * timing: `device_time` (CUDA events around back-to-back launches) and
    `trace` (a `torch.profiler` Chrome trace);
  * the card's primitive rates: `measure_peaks` runs the chain kernel K7
    (`ops/cuda/chain.py`) for fmaf, the IEEE divide and expf, and a
    device-to-device copy for the memory rate; `DEFAULT_PEAKS` holds the
    published figures;
  * the least time the card could take for each kernel: `k1_roofline` ...
    `k7_roofline` count the multiplies and adds, divides, transcendentals
    and bytes one call of the function needs, as a `Roofline`.
    `lbl_roofline` and `spectral_roofline` sum them for the two forward
    paths.

What is counted.  The bound is one of the function, not of the body under
`csrc/` that computes it today.  The formulas are those of the bodies, but
each quantity is charged once, on the indices it depends on: the Planck
radiance per (channel, level, profile) and the chord per (elevation, layer,
profile), although K3's one-thread-per-column body recomputes the radiance
in every (elevation, frequency, profile) thread; a line's
width and strength once per point (K1 and K6 do so); what depends on the
line table alone (1 / f_line, 1 / f_line^2) once per call and line; what
depends on the frequency grid alone (f - f_line, (f / f_line)^2, the
continuum's frequency factor) once per call, although every thread of K1
and K6 forms f - f_line again.

The line shapes are charged in the cheapest form known that holds the
accuracy.  On floats (K1, K6) a line's two halves a / A + b / B are the one
rational (k2 + q k3) / (q^2 + k1) in q = d1 d2 + w^2 (K6's main pass,
`csrc/absorption_spectral.cu`, has the algebra; K1's body is the same): the coefficients once per
(point, line), and d1 d2 of an H2O line, which has no pressure shift, on
the grid alone.  Two O2 lines share one divide, (n_a D_b + n_b D_a) /
(D_a D_b): the denominators are sums of squares under 1e13, so the product
stays in range; no more lines are merged than that (each merge squares the
range), and H2O lines, whose cutoff tests differ from line to line, are not
paired.  The strengths carry 1 / f_line^2 and the sums are multiplied by
f^2 once per (point, frequency).  All powers of a point have the one base
300 / T, so a^x is charged as exp2(x log2 a): one logarithm per point and
one exponential per power, as K1 takes them (the multiply is left out, which
keeps the fp32 count where it was); K4 and K6 call powf, a logarithm and an
exponential each time.  A qSD node's c_r, its weight times c_r
and c_r^2 are charged once per (point, line, node).  On K4's dual numbers
the merged forms cost more than they save, so there the halves stay apart
and the count is that of the formulas as written.  Where u = x / T < 0.25
the Planck radiance x / expm1(u) of a level may be taken as its series
T (1 - u / 2 + u^2 / 12 - u^4 / 720), exact in float32 there: no
exponential and one divide less for about ten more instructions of the fp32
pipe.  Neither form is the cheaper in every resource, so the function is
charged the lesser of the two in each: `k2_roofline` charges the share
`planck_series_fraction` of the (channel, level, profile)
(`planck_series_share` finds what share of a run's data has u < 0.25: all
of it for a microwave channel at atmospheric temperatures) the series' one
divide and no exponential, and none of its fp32 instructions, which the
closed form does without.  The fp32 count is so the same at every share,
and the bound of a function that the fp32 pipe bounds, as it does K2 at the
published peaks, does not move with it.  A transmittance is charged one
exponential per (elevation, channel, layer, profile).

With `as_coded=True` every function returns instead what its body under
`csrc/` executes, recomputation included: the arithmetic a kernel of that
design would pay if it hid all latency.  No function's count is above its
body's in any resource.

Counting convention.  `fma_ops` is a lower bound on the instructions of the
fp32 pipe: one instruction does at most one multiply and one add, so M
multiplies, A adds and C compares, selects, min/max or negations need at
least max(M, A) + C of them, whatever the compiler contracts into fmaf.
`div_ops` counts fp32 divides and square roots, `exp_ops` calls of expf,
expm1f and log1pf as one each and powf as two (a logarithm and an
exponential): each needs at least that many results of the
special-function unit.  sqrtf, expm1f and powf run slower than the divide
and expf that `measure_peaks` times, so pricing them at those rates keeps
the result a lower bound.  The instructions hidden inside a divide or a
transcendental (Newton steps, range reduction) are not in `fma_ops`; the
rates that `measure_peaks` finds for div and exp include them.  `hbm_bytes`
reads each input once and writes each output once.
"""

import contextlib
import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from ..constants import HK_GHZ, H2O_MODELS, O2_MODELS, hatpro, o3_lines
from ..ops.cuda import adjoint as adjoint_mod
from ..ops.cuda import chain as chain_mod

# Published peaks of one H100 SXM (NVIDIA's data sheet), per second.
#   fma: 67 TFLOP/s of fp32 outside the tensor cores, an FMA counted once:
#        132 SMs x 128 lanes x 1.98 GHz = 33.5e12.
#   hbm: 3.35 TB/s.
#   div, exp: the data sheet gives none.  Each SM has 16 special-function
#        lanes (4 per scheduler), one result per lane and clock: 132 x 16 x
#        1.98 GHz = 4.19e12 results/s.  An IEEE fp32 divide needs one
#        reciprocal from that unit (plus two Newton steps and a range check
#        on the fp32 pipe), an accurate expf one exp2 (plus its range
#        reduction), so neither can go faster than this; `measure_peaks`
#        says how much slower the whole sequences run.
DEFAULT_PEAKS = {"fma": 33.5e12, "div": 4.19e12, "exp": 4.19e12,
                 "hbm": 3.35e12}

# The element count of one chain launch: 512 x 32 rows of 512, 8.4 M (the
# JAX package's microbenchmark uses the same).
CHAIN_ELEMENTS = 512 * 32 * 512
COPY_BYTES = 2 ** 30


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def _first_device(tree):
    if torch.is_tensor(tree):
        return tree.device
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        for item in tree:
            dev = _first_device(item)
            if dev is not None:
                return dev
    return None


def device_time(fn, args=(), iters: int = 20, trials: int = 3,
                device=None) -> float:
    """Seconds per call of `fn(*args)`: the median over `trials` of the time
    of `iters` back-to-back calls, after one warm-up call.

    On a CUDA device the calls are bracketed by CUDA events on the current
    stream, so the host's enqueue time is not in the result unless the
    device waits for the host.  On the CPU the clock is
    `time.perf_counter`.  The device is `device`, or that of the first
    tensor in `args`, or the CPU.
    """
    dev = torch.device(device) if device is not None else _first_device(args)
    on_card = dev is not None and dev.type == "cuda"
    fn(*args)
    times = []
    if on_card:
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(trials):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3 / iters)
    else:
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            times.append((time.perf_counter() - t0) / iters)
    return max(statistics.median(times), 1e-12)


@contextlib.contextmanager
def trace(log_dir: str = "mwr_torch_trace"):
    """Capture a `torch.profiler` trace of the block (CPU activity, and CUDA
    activity where there is a card) and write it to `log_dir/trace.json` in
    Chrome's format.  Yields the profiler, whose `key_averages()` sums the
    device time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def chain_rate(op: str, device, k=None, n: int = CHAIN_ELEMENTS,
               threads: int = 256, iters: int = 12, trials: int = 3) -> float:
    """Applications of the primitive `op` per second on `device`, from the
    time of one K7 launch over `n` elements: 8 n k applications."""
    k = chain_mod.default_k(op) if k is None else k
    x = torch.full((n,), 0.25, dtype=torch.float32, device=device)
    seconds = device_time(
        lambda: chain_mod.chain(x, op, k, threads), (),
        iters=iters, trials=trials, device=device)
    return chain_mod.N_CHAINS * k * n / seconds


def copy_rate(device, n_bytes: int = COPY_BYTES, iters: int = 10,
              trials: int = 3) -> float:
    """Bytes per second of a device-to-device copy of `n_bytes`: each byte
    is read once and written once, so the copy moves 2 n_bytes."""
    src = torch.empty(n_bytes // 4, dtype=torch.float32,
                      device=device).normal_()
    dst = torch.empty_like(src)
    seconds = device_time(lambda: dst.copy_(src), (), iters=iters,
                          trials=trials, device=device)
    return 2.0 * src.numel() * 4 / seconds


def measure_peaks(device=None) -> dict:
    """The rates of THIS card: {"fma", "div", "exp"} in applications per
    second from three K7 launches of 8.4 M elements (fmaf, one add and one
    IEEE divide, one multiply and one accurate expf), and "hbm" in bytes
    per second from a device-to-device copy of 1 GiB.

    Raises RuntimeError without a CUDA device: there are no defaults here
    (`DEFAULT_PEAKS` holds the published figures).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_peaks needs a CUDA device, got {dev} "
                           f"(DEFAULT_PEAKS holds the published figures)")
    peaks = {op: chain_rate(op, dev) for op in ("fma", "div", "exp")}
    peaks["hbm"] = copy_rate(dev)
    return peaks


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Roofline:
    """What one call of a kernel needs: fp32-pipe instructions, divides,
    transcendentals (the module docstring has the convention) and bytes of
    device memory."""

    fma_ops: float
    div_ops: float
    exp_ops: float
    hbm_bytes: float

    def times_s(self, peaks=None) -> dict:
        """The least time [s] each resource needs: fma, div, exp, bytes."""
        p = peaks or DEFAULT_PEAKS
        return {"fma": self.fma_ops / p["fma"], "div": self.div_ops / p["div"],
                "exp": self.exp_ops / p["exp"],
                "bytes": self.hbm_bytes / p["hbm"]}

    def time_bound_s(self, peaks=None) -> float:
        """Lower bound on the kernel's time: the largest of `times_s`."""
        return max(self.times_s(peaks).values())

    def bound_by(self, peaks=None) -> str:
        """Which of fma, div, exp, bytes gives `time_bound_s`."""
        times = self.times_s(peaks)
        return max(times, key=times.get)

    def __add__(self, other):
        return Roofline(*(a + b for a, b in zip(dataclasses.astuple(self),
                                                dataclasses.astuple(other))))


def pipeline_model_time(roofline: Roofline, peaks=None) -> float:
    """Additive dispatch-time model [s]: fmaf, the divide sequence and the
    expf sequence share the schedulers' dispatch slots, so their times add;
    the memory system runs beside them.  With measured peaks this is an
    estimate of a kernel that hides all latency, not a bound."""
    t = roofline.times_s(peaks)
    return max(t["fma"] + t["div"] + t["exp"], t["bytes"])


class _Ops:
    """A tally of multiplies, adds, other fp32-pipe instructions, divides
    and transcendentals."""

    FIELDS = ("mul", "add", "other", "div", "exp")

    def __init__(self, mul=0.0, add=0.0, other=0.0, div=0.0, exp=0.0):
        self.mul, self.add, self.other = mul, add, other
        self.div, self.exp = div, exp

    def add_scaled(self, ops: "_Ops", times: float):
        for f in self.FIELDS:
            setattr(self, f, getattr(self, f) + times * getattr(ops, f))

    def roofline(self, hbm_bytes: float) -> Roofline:
        return Roofline(float(max(self.mul, self.add) + self.other),
                        float(self.div), float(self.exp), float(hbm_bytes))


def _tally(listing: str, cost: dict) -> _Ops:
    """Sum the cost of a listing such as "vmul*2 vadd fdiv"."""
    total = _Ops()
    for item in listing.split():
        kind, _, times = item.partition("*")
        total.add_scaled(cost[kind], float(times or 1))
    return total


def _charge(body: dict, cost: dict, times: dict) -> _Ops:
    """Sum `times[name]` x the listing `body[name]` over the names given."""
    total = _Ops()
    for name, n in times.items():
        total.add_scaled(_tally(body[name], cost), n)
    return total


# ---- K4's absorption body (csrc/absorption_tangents.cu) and the function's
# ---- counts; K1's and K6's bodies are below
#
# Each operation of the body by kind.  f* are operations on plain floats
# (the same in every mode); v* are operations on the body's value type V:
# float for K1 and K6, the dual number {v, d/dT, d/drho} for K4, whose
# operators (absorption.cuh, `struct Dual`) cost what _DUAL says.
#   (K6 shares the function's count on floats, `_ABSORPTION_NEEDED_FLOAT`.)
#   vmul V*V, vmuls V*float, vadd V+-V, vadds V+-float, rsub float-V,
#   vneg -V, vdiv V/V, vdivs V/float, sdivv float/V, vexp exp_, vpow pow_,
#   vmax0 max0, vsel a select between two V, cmp a compare.
_FLOAT = {
    "fmul": _Ops(mul=1), "fadd": _Ops(add=1), "fdiv": _Ops(div=1),
    "fexp": _Ops(exp=1), "fpow": _Ops(exp=2), "cmp": _Ops(other=1),
    "vmul": _Ops(mul=1), "vmuls": _Ops(mul=1), "vadd": _Ops(add=1),
    "vadds": _Ops(add=1), "rsub": _Ops(add=1), "vneg": _Ops(other=1),
    "vdiv": _Ops(div=1), "vdivs": _Ops(div=1), "sdivv": _Ops(div=1),
    "vexp": _Ops(exp=1), "vpow": _Ops(exp=2), "vmax0": _Ops(other=1),
    "vsel": _Ops(other=1),
}
# one power of a point's shared base, given its logarithm (K1's body)
_FLOAT["fpw"] = _Ops(exp=1, mul=1)
_DUAL = dict(
    _FLOAT,
    vmul=_Ops(mul=5, add=2), vmuls=_Ops(mul=3), vadd=_Ops(add=3),
    rsub=_Ops(add=1, other=2), vneg=_Ops(other=3),
    vdiv=_Ops(div=1, mul=5, add=2), vdivs=_Ops(div=2, mul=2),
    sdivv=_Ops(div=1, mul=5), vexp=_Ops(exp=1, mul=2),
    vpow=_Ops(exp=2, div=1, mul=3), vmax0=_Ops(other=4),
    vsel=_Ops(other=3))

# What the function is charged: a power is one exponential, the point's one
# logarithm is charged apart ("point_log").
_FLOAT_NEEDED = dict(_FLOAT, fpow=_Ops(exp=1), vpow=_Ops(exp=1))
_DUAL_NEEDED = dict(_DUAL, fpow=_Ops(exp=1),
                    vpow=_Ops(exp=1, div=1, mul=3))

_QSD_NODE = "vmuls vadd vmul vadds vmuls vdiv vadd "
_POINT = ("sdivv vadds vmul vdivs rsub vpow fmul vmuls*2 "
          "vpow*2 vmuls*2 vmul*2 vadd vmul "
          "vpow vmul vmuls vmul vadd vmuls vmul vmuls cmp fmul vmuls vsel "
          "vmul*2 vmuls vmul vpow "
          "rsub vmuls rsub vmuls vmuls vexp vmuls vmuls vadd vadds")
_FDEP = "fdiv fmul fadd fdiv fadd cmp"
# What the body of K4 executes (K1's own body on floats is `_K1_CODED`): one
# thread per point evaluates all channels, its "tile", every Lorentzian half
# with a divide of its own.
_ABSORPTION_CODED = {
    # once per (point, tile): ti, th1, pvap, pda, ti25, cut2, h2o_scale,
    # con_b; the O2 block's b, den, pe2, dfnr, ybase; ti3; the dry
    # continuum's n2_b, n2_t; the liquid term's theta1, eps0, eps1, fp, fs
    # and the two differences of eps hoisted out of the channel loop
    "point": _POINT,
    # once per (point, tile, H2O line): tix, tixs, width, wsq, s, base, the
    # two tests of `sd`, c0, inv_fl
    "h2o_line": ("vpow*2 vmuls vmul vmuls vmul vadd vmul "
                 "rsub vmuls vexp vmuls vmul vadds vdiv cmp*2 vmuls vadd "
                 "fdiv"),
    # more per (point, tile, qSD line): gamma2
    "h2o_sd_line": "vmuls vmul vmuls vmul vadd",
    # per (point, frequency, H2O line), always: df1, df2, the two cutoff
    # tests, r, r*r, s*res*(r*r) and the sum
    "h2o_pair": "fadd*2 cmp*2 fmul*2 vmul vmuls vadd",
    # per (point, frequency, line) inside the cutoff: a Lorentzian half
    # minus `base`, added to res (the near and the mirror half cost the same)
    "h2o_half": "fmul vadds vdiv vadd*2",
    # the near half of a qSD line: ci2, 16 quadrature nodes, the update
    "h2o_sd_half": "fmul vadd*2 " + _QSD_NODE * 16,
    # once per (point, tile, O2 line): df, dfsq, y, strength, dfg, dnu,
    # inv_f0
    "o2_line": ("vmuls vmul vmuls vadds vmul vmuls vexp vmuls "
                "vmuls vadds vmul vadds vmul vmuls vadds vmul fdiv"),
    # per (point, frequency, O2 line): d1, d2, sf1, sf2, r, r*r, the sum
    "o2_pair": ("fadd rsub fadd vadds vmul vadd vmul vadd vdiv "
                "vmul vadd vmul vadd vdiv fmul*2 vadd vmul vmuls vadd"),
    # per (point, frequency): the tail of the channel loop
    "channel": ("fmul vmul vmuls*2 vadd "                      # h2o
                "fmul*2 vmuls vmul vadds vmul vdiv "           # nonres
                "vadd vmuls vmul*2 vmax0 "                     # o2
                "vmuls*3 vmul "                                # n2
                "sdivv*2 vmul vadds vmul vadds "               # u, v
                "vdiv*2 vadds vadd "                           # re
                "vneg vmul vdiv vmul vdiv vadd "               # im
                "vmuls vadds vmul*2 vadd vdiv "                # aimag
                "vmuls*3 vadd*3"),                             # liq, alpha
    # more per (point, frequency) for the 2017 dry continuum's fdep
    "channel_fdep": _FDEP,
    # O3 (K1 only, floats): per point, per line, per (frequency, line),
    # per frequency
    "o3_point": "fmul*3 fdiv",
    "o3_line": "fpow fmul*2 fmul fadd fmul fexp fmul*2 fdiv",
    "o3_pair": "fadd*2 fmul*2 fadd*2 fdiv*2 fadd fmul*4 fadd fmul fadd",
    "o3_channel": "fmul fadd",
}
# What the function needs with the halves of a line kept apart, as K4's dual
# numbers take it (the module docstring has the rules): the entries that
# change, and those charged once per call on the frequency grid.
_ABSORPTION_NEEDED = dict(
    _ABSORPTION_CODED,
    # once per point; beside the body's: 1 / fp, dfnr^2, n2_b n2_t and
    # o2_scale pda ti3, which the body forms per channel
    point=_POINT + " sdivv vmul*2 vmuls",
    # 1 / f_line hangs on the table alone: once per call and line, not per
    # point as the body forms it
    h2o_line=_ABSORPTION_CODED["h2o_line"].removesuffix(" fdiv"),
    o2_line=_ABSORPTION_CODED["o2_line"].removesuffix(" fdiv"),
    o3_line=_ABSORPTION_CODED["o3_line"].removesuffix(" fdiv"),
    line_grid="fdiv",
    # log2(300 / T), once per point, for all its powers
    point_log="fexp",
    # per (frequency, H2O line) on the grid alone: df1, df2, the cutoff
    # tests, (f / fl)^2; per half inside the cutoff: df^2
    h2o_grid="fadd*2 cmp*2 fmul*2", h2o_grid_half="fmul",
    # per (point, frequency, H2O line): s res (f / fl)^2 and the sum
    h2o_pair="vmul vmuls vadd",
    # one half inside the cutoff: df^2 + wsq, the divide, minus base
    h2o_half="vadds vdiv vadd",
    h2o_sd_half="vadd*2 " + _QSD_NODE * 16,
    # per (frequency, O2 line) on the grid alone: f -+ f0, (f / f0)^2
    o2_grid="fadd*2 fmul*2",
    # per (point, frequency, O2 line), the halves divided apart: d1, d2;
    # the numerators dfg +- d y; the denominators d^2 + dfsq; two divides;
    # times the strength and (f / f0)^2; the sum
    o2_pair_apart=("rsub vadds vmul*2 vadd*2 vmul*2 vadd*2 vdiv*2 vadd "
                   "vmul vmuls vadd"),
    # per frequency on the grid alone: fc^2 and its products with the
    # table's constants
    channel_grid="fmul*4",
    # per (point, frequency): the water continuum; the non-resonant O2 term
    # and the clamp; N2; u = fc / fp and v = u / 39.8, 1 / (1 + u^2),
    # 1 / (1 + v^2), re and im from the same two reciprocals; aimag; the
    # liquid term and the sum
    channel=("vmul vmuls vadd "
             "vmuls vadds vmul vdiv vadd vmul vmax0 "
             "vmuls "
             "vmuls*2 vmul*2 vadds*2 sdivv*2 vmul*2 vadd*2 vmul*2 vadd vneg "
             "vadds vmul*2 vadd vdiv vmuls "
             "vmuls*2 vadd*3"),
    # per (frequency, O3 line) on the grid alone; per (point, frequency,
    # line): A, B, A + B, width (A + B), A B, one divide, s res r^2, the sum
    o3_grid="fadd*2 fmul*4",
    o3_pair="fadd*3 fmul*2 fdiv fmul*2 fadd",
)
# The same on floats, with each line as one rational in q (the module
# docstring has the rules): the entries that differ from the above.
_QSD_NODE_SETUP = "vmuls vadd vmuls vmul vmul "    # c_r, its weight, c_r^2
_ABSORPTION_NEEDED_FLOAT = dict(
    _ABSORPTION_NEEDED,
    # more per (point, H2O line): the strength with the density scale and
    # 1 / fl^2, times the width and times the base; k1, k2, k3; the running
    # sum of the bases
    h2o_line=_ABSORPTION_NEEDED["h2o_line"] + " vmul vmuls vmul*4 vmuls vadd",
    h2o_sd_line=_ABSORPTION_CODED["h2o_sd_line"] + " " + _QSD_NODE_SETUP * 16,
    # per (frequency, H2O line) on the grid alone: d1, d2, the cutoff tests,
    # d1 d2; per half inside the cutoff: d^2
    h2o_grid="fadd*2 cmp*2 fmul", h2o_grid_half="fmul",
    # both halves inside the cutoff: q, the numerator, the denominator, the
    # divide, the sum
    h2o_both="vadds vmul vadd vmul vadd vdiv vadd",
    # one half: d^2 + wsq, the divide, the sum
    h2o_half="vadds vdiv vadd",
    # the near half of a qSD line, per node: c_r^2 + d1^2, the divide, the sum
    h2o_sd_half="vadds vdiv vadd " * 16,
    # more per (point, O2 line): c = 2 (f0 + dnu), the strength over f0^2,
    # its products with dfg and with y c, k1, k2, k3
    o2_line=(_ABSORPTION_NEEDED["o2_line"]
             + " vadds vmuls*2 vmul*7 vadd*2 vmuls"),
    # 1 / f_line^2 per line of the table
    line_grid="fmul fdiv",
    # per (frequency, O2 line) on the grid alone: f - f0
    o2_grid="fadd",
    # per (point, frequency, O2 line): d1, d2, q, the numerator, the
    # denominator
    o2_rational="rsub vadd vmul vadd vmul vadd vmul vadd",
    # per (point, frequency, two O2 lines): n_a D_b + n_b D_a, D_a D_b, the
    # divide, the sum; the odd line out: the divide and the sum
    o2_two="vmul*2 vadd vmul vdiv vadd", o2_one="vdiv vadd",
    # more per (point, frequency): the bases' sum off the H2O lines, the O2
    # lines' sum times f^2
    channel=_ABSORPTION_NEEDED["channel"] + " vadd vmul",
)

# What K6's two passes execute (csrc/absorption_spectral.cu), on floats.
_K6_TILE = 8    # frequencies per register tile (kFT)
_K6_CODED = {
    # state pass, once per point: ti, th1, pvap, pda, ti25, cut2, h2o_scale;
    # con_b; b, den, pe2, dfnr, ybase; the nine scalars
    "point": ("fdiv fadd fmul fdiv fadd fpow fmul fmul*2 "
              "fpow*2 fmul*4 fadd "
              "fpow fmul*4 fadd fmul fmul fmul*2 cmp "
              "fadd fmul fadd fmul fmul fdiv fmul fmul*4 fmul*3 fpow "
              "fmul fexp fmul fdiv fadd*2 fmul"),
    # state pass, per (point, H2O line): tix, tixs, width, wsq, s, base, sn,
    # sw, sb
    "h2o_line": ("fpow*2 fmul*4 fadd fmul fadd fmul fexp fmul*2 fadd fdiv "
                 "fmul*3 fdiv fmul*2"),
    # more per (point, H2O line) of a qSD release: gamma2, c0
    "h2o_sd_line": "fmul*4 fadd fmul fadd",
    # state pass, per (point, O2 line): df, sn, dfg, dnu, c2, dfsq, dfg_s,
    # yc, k2, k3
    "o2_line": ("fmul fmul fexp fmul*2 fdiv fmul fadd fmul fadd fmul "
                "fmul fadd fmul fadd fmul fmul fmul fmul fadd fmul*3 "
                "fmul*4 fadd fmul fadd"),
    # state pass, per frequency: the dry continuum's factor
    "freq": _FDEP,
    # main pass, per (point, tile): the tile's lowest and highest frequency
    "tile": f"cmp*{2 * _K6_TILE}",
    # per (point, tile, H2O line): the four cutoff tests of the tile's ends
    "tile_h2o_line": "fadd*4 cmp*4",
    # per (point, tile, H2O line merged below): c^2, k1, k2, k3, and 2 sb
    # into the tile's sum
    "tile_h2o_both": "fmul*6 fadd",
    # per (point, frequency, H2O line) with both halves inside the cutoff
    # for the whole tile: d1, d2, q, the numerator, the denominator, the
    # reciprocal and its product, the sum
    "h2o_both": "fadd*2 fmul fadd fmul fadd fmul fadd fdiv fmul fadd",
    # per (point, frequency, H2O line) otherwise: d1, d2, d1^2, the tests
    "h2o_apart": "fadd*2 fmul cmp*2",
    # a near half inside the cutoff (not qSD), a far half inside it
    "h2o_near": "fadd fdiv fmul fadd*2",
    "h2o_far": "fmul fadd fdiv fmul fadd*2",
    # per (point, tile, qSD line, node): cr, crw, cr^2; per (point,
    # frequency, qSD line inside the cutoff, node): one rational
    "tile_sd_node": "fmul fadd fmul*3",
    "h2o_sd_node": "fadd fdiv fmul fadd",
    # per (point, frequency, qSD line inside the cutoff): minus sb
    "h2o_sd_near": "fadd",
    # per (point, tile, O2 line): k1 = dfsq c2^2
    "tile_o2_line": "fmul*2",
    # per (point, frequency, O2 line): d1 = (f - f0) - dnu, d2 = d1 + c2,
    # q = d1 d2 + dfsq, k2 + q k3, q^2 + k1
    "o2_rational": "fadd*3 fmul fadd fmul fadd fmul fadd",
    # per (point, frequency, two O2 lines): n_a D_b + n_b D_a, D_a D_b, the
    # reciprocal and its product, the sum; the odd line out: the same alone
    "o2_two": "fmul*2 fadd fmul fdiv fmul fadd",
    "o2_one": "fdiv fmul fadd",
    # per (point, frequency): f^2; the water term; the non-resonant O2 term
    # and the clamp; N2; u, v, the two reciprocals, re, im, aimag; the sum
    "channel": ("fmul fadd*2 fmul "
                "fmul fadd fdiv fmul fadd fmul cmp "
                "fmul*2 "
                "fmul*2 fmul fadd fdiv fmul fadd fdiv fmul*2 fadd*2 "
                "fmul*4 fadd vneg fmul fadd fmul*2 fadd fdiv "
                "fmul*2 fadd*3"),
}


def _k6_coded_ops(n_points, freqs, model, n_h2o_lines=None,
                  n_o2_lines=None) -> _Ops:
    """Operations of K6's two passes over `n_points` points and the grid
    `freqs`, taken in tiles of 8 consecutive frequencies as the kernel
    takes them: a non-qSD H2O line is merged where the whole tile lies
    inside the cutoff on both sides, and two O2 lines share a reciprocal."""
    h2o, o2 = H2O_MODELS[model], O2_MODELS[model]
    f = np.asarray(freqs, np.float64).reshape(-1)
    fl = np.asarray(h2o.fl, np.float64)[:n_h2o_lines]
    sd = ((np.asarray(h2o.w2) != 0) | (np.asarray(h2o.ws2) != 0))[:fl.size]
    n_o2 = np.asarray(o2.f)[:n_o2_lines].size
    nf, tiles = f.size, -(-f.size // _K6_TILE)
    near = np.abs(f[:, None] - fl[None, :]) < h2o.cutoff_ghz     # (F, lines)
    far = np.abs(f[:, None] + fl[None, :]) < h2o.cutoff_ghz
    tile_of = np.arange(nf) // _K6_TILE
    whole = np.ones((tiles, fl.size), bool)       # tiles wholly inside both
    np.logical_and.at(whole, tile_of, near & far)
    merged = whole[tile_of] & ~sd[None, :]                       # (F, lines)
    nodes = 16
    per_point = {
        "point": 1, "h2o_line": fl.size,
        "h2o_sd_line": fl.size * bool(h2o.has_sd), "o2_line": n_o2,
        "tile": tiles, "tile_h2o_line": tiles * fl.size,
        "tile_o2_line": tiles * n_o2,
        "tile_h2o_both": (whole & ~sd[None, :]).sum(),
        "h2o_both": merged.sum(), "h2o_apart": (~merged).sum(),
        "h2o_near": (near & ~merged & ~sd[None, :]).sum(),
        "h2o_far": (far & ~merged).sum(),
        "tile_sd_node": tiles * int(sd.sum()) * nodes,
        "h2o_sd_node": near[:, sd].sum() * nodes,
        "h2o_sd_near": near[:, sd].sum(),
        "o2_rational": nf * n_o2, "o2_two": nf * (n_o2 // 2),
        "o2_one": nf * (n_o2 % 2), "channel": nf}
    total = _charge(_K6_CODED, _FLOAT, {"freq": nf})
    total.add_scaled(_charge(_K6_CODED, _FLOAT, per_point), n_points)
    return total


# What K1's body executes (csrc/absorption.cu), on floats: a thread per
# point forms each line's state and spends it on all channels at once.  The
# arithmetic is K6's, so most entries are K6's; those that differ:
_K1_THREADS = 128   # points per block (kPointThreads)
_K1_CODED = dict(
    _K6_CODED,
    # per block: the table's 1 / f_line^2 per line, the dry continuum's
    # factor per channel
    block_line="fmul fdiv", block_channel=_FDEP,
    # per point: K6's list with each power as exp2f(x log2 ti), and the
    # logarithm
    point=_K6_CODED["point"].replace("fpow", "fpw") + " fexp",
    # per (point, channel): the span of the channels, for the cutoff tests
    span="cmp*2",
    # per (point, H2O line): tix, tixs, width, wsq, s, base, sn (1 / fl^2 is
    # the block's), sw, sb, the two tests of `sd`, the four of the span
    h2o_line=("fpw*2 fmul*4 fadd fmul fadd fmul fexp fmul*2 fadd fdiv "
              "fmul*4 cmp*2 fadd*4 cmp*4"),
    # per (point, H2O line merged for all channels): c^2, k1, k2, k3, 2 sb
    h2o_line_both=_K6_CODED["tile_h2o_both"],
    # per (point, qSD line): gamma2, c0, and per node cr, crw, cr^2
    h2o_sd_line="fmul*4 fadd fmul fadd " + (_K6_CODED["tile_sd_node"] + " ") * 16,
    # per (point, O2 line): df, sn (1 / f0^2 is the block's), dfg, dnu, c2,
    # dfsq, dfg_s, yc, k1, k2, k3
    o2_line=("fmul fmul fexp fmul*2 fmul fadd fmul fadd fmul "
             "fmul fadd fmul fadd fmul fmul fmul fadd fmul*3 "
             "fmul*2 fmul*3 fadd fmul fadd"),
    # O3: the density scale per point; per (point, line) width, wsq, s, sw,
    # c^2, k1, k2, k3; per (point, channel, line) the merged rational
    o3_point="fmul*3 fdiv",
    o3_line="fpw fmul*2 fmul fadd fmul fexp fmul*2 fmul*3 fmul*2 fmul*3",
    o3_pair=_K6_CODED["h2o_both"],
)


def _k1_coded_ops(n_points, freqs, model, with_o3=False, n_h2o_lines=None,
                  n_o2_lines=None) -> _Ops:
    """Operations of K1's body over `n_points` points at the channels
    `freqs`: a non-qSD H2O line is merged where every channel lies inside
    the cutoff on both sides, and two O2 lines share a reciprocal."""
    h2o, o2 = H2O_MODELS[model], O2_MODELS[model]
    f = np.asarray(freqs, np.float64).reshape(-1)
    fl = np.asarray(h2o.fl, np.float64)[:n_h2o_lines]
    sd = ((np.asarray(h2o.w2) != 0) | (np.asarray(h2o.ws2) != 0))[:fl.size]
    n_o2 = np.asarray(o2.f)[:n_o2_lines].size
    n_o3 = o3_lines.O3_FL.size if with_o3 else 0
    nf = f.size
    near = np.abs(f[:, None] - fl[None, :]) < h2o.cutoff_ghz     # (F, lines)
    far = np.abs(f[:, None] + fl[None, :]) < h2o.cutoff_ghz
    merged = (near & far).all(axis=0) & ~sd                      # (lines,)
    apart = ~merged
    per_point = {
        "point": 1, "span": nf, "h2o_line": fl.size,
        "h2o_line_both": merged.sum(), "h2o_sd_line": int(sd.sum()),
        "o2_line": n_o2, "h2o_both": nf * merged.sum(),
        "h2o_apart": nf * apart.sum(),
        "h2o_near": near[:, apart & ~sd].sum(),
        "h2o_far": far[:, apart].sum(),
        "h2o_sd_node": near[:, sd].sum() * 16,
        "h2o_sd_near": near[:, sd].sum(),
        "o2_rational": nf * n_o2, "o2_two": nf * (n_o2 // 2),
        "o2_one": nf * (n_o2 % 2), "channel": nf,
        "o3_point": with_o3, "o3_line": n_o3, "o3_pair": nf * n_o3,
        "block_line": (fl.size + n_o2 + n_o3) / _K1_THREADS,
        "block_channel": nf / _K1_THREADS}
    total = _Ops()
    total.add_scaled(_charge(_K1_CODED, _FLOAT, per_point), n_points)
    return total


def _absorption_ops(n_points, freqs, model, cost, with_o3=False,
                    n_h2o_lines=None, n_o2_lines=None,
                    as_coded=False) -> _Ops:
    """Operations of the absorption function over `n_points` points and the
    frequencies `freqs`, on floats or (`cost` = _DUAL) on K4's dual numbers
    (as coded: of K4's body, which sets a point and its lines up once for
    all channels and divides every Lorentzian half apart; K1's own body is
    counted by `_k1_coded_ops`).  The Clough-cutoff
    branches are counted for these frequencies:
    a Lorentzian half is evaluated where |f -+ f_line| lies under the
    release's cutoff."""
    h2o, o2 = H2O_MODELS[model], O2_MODELS[model]
    f = np.asarray(freqs, np.float64).reshape(-1)
    fl = np.asarray(h2o.fl, np.float64)[:n_h2o_lines]
    sd = ((np.asarray(h2o.w2) != 0) | (np.asarray(h2o.ws2) != 0))[:fl.size]
    n_o2 = np.asarray(o2.f)[:n_o2_lines].size
    n_o3 = o3_lines.O3_FL.size if with_o3 else 0
    near = np.abs(f[:, None] - fl[None, :]) < h2o.cutoff_ghz     # (F, lines)
    far = np.abs(f[:, None] + fl[None, :]) < h2o.cutoff_ghz
    nf, n_sd = f.size, int(sd.sum())
    fdep = model not in ("R98", "R03")      # the 1998 continuum has none
    per_point = {"h2o_sd_half": near[:, sd].sum(), "channel": nf,
                 "o3_pair": nf * n_o3, "o3_channel": nf * with_o3}
    halves = near[:, ~sd].sum() + far.sum()
    if as_coded:
        body, per_call = _ABSORPTION_CODED, {}
        per_point.update(h2o_pair=nf * fl.size, h2o_half=halves,
                         o2_pair=nf * n_o2, channel_fdep=nf * fdep)
    else:
        dual = cost is _DUAL
        cost = _DUAL_NEEDED if dual else _FLOAT_NEEDED
        per_point["point_log"] = 1
        per_call = {"line_grid": fl.size + n_o2 + n_o3,
                    "h2o_grid": nf * fl.size,
                    "h2o_grid_half": near.sum() + far.sum(),
                    "o2_grid": nf * n_o2, "o3_grid": nf * n_o3,
                    "channel_grid": nf, "channel_fdep": nf * fdep}
        if dual:
            body = _ABSORPTION_NEEDED
            per_point.update(h2o_pair=nf * fl.size, h2o_half=halves,
                             o2_pair_apart=nf * n_o2)
        else:
            body = _ABSORPTION_NEEDED_FLOAT
            both = (near & far & ~sd).sum()
            per_point.update(h2o_both=both, h2o_half=halves - 2 * both,
                             o2_rational=nf * n_o2,
                             o2_two=nf * (n_o2 // 2), o2_one=nf * (n_o2 % 2))
    per_point.update(point=1, h2o_line=fl.size, h2o_sd_line=n_sd,
                     o2_line=n_o2, o3_point=with_o3, o3_line=n_o3)
    total = _charge(body, cost, per_call)
    total.add_scaled(_charge(body, cost, per_point), n_points)
    return total


def _table_bytes(model, with_o3, n_h2o_lines=None, n_o2_lines=None) -> int:
    """Bytes of the packed line table (ops/cuda/absorption.py)."""
    n_h2o = np.asarray(H2O_MODELS[model].fl)[:n_h2o_lines].size
    n_o2 = np.asarray(O2_MODELS[model].f)[:n_o2_lines].size
    n_o3 = o3_lines.O3_FL.size if with_o3 else 0
    return 4 * (16 + 9 * n_h2o + 10 * n_o2 + 5 * n_o3 + 32)


_HATPRO = tuple(hatpro.HATPRO_FREQS_GHZ.tolist())


def k1_roofline(n_points: int, freqs=_HATPRO, model: str = "R24",
                with_o3: bool = False, n_h2o_lines=None, n_o2_lines=None,
                as_coded: bool = False) -> Roofline:
    """K1, `absorption_lb`: alpha (F, n_points) at the channels `freqs`
    (at most 16).  Reads p, T, rho, LWC (and O3), the table and the
    channels; writes alpha."""
    f = np.asarray(freqs, np.float64).reshape(-1)
    ops = (_k1_coded_ops(n_points, f, model, with_o3, n_h2o_lines,
                         n_o2_lines) if as_coded else
           _absorption_ops(n_points, f, model, _FLOAT, with_o3,
                           n_h2o_lines, n_o2_lines))
    n_in = 5 if with_o3 else 4
    return ops.roofline(4.0 * n_points * (n_in + f.size) + 4 * f.size
                        + _table_bytes(model, with_o3, n_h2o_lines,
                                       n_o2_lines))


def k4_roofline(n_points: int, freqs=_HATPRO, model: str = "R24",
                n_h2o_lines=None, n_o2_lines=None,
                as_coded: bool = False) -> Roofline:
    """K4, `absorption_tangents_lb`: alpha, dalpha/dT and dalpha/drho
    (F, n_points): K1's formulas carried on dual numbers (no O3)."""
    f = np.asarray(freqs, np.float64).reshape(-1)
    ops = _absorption_ops(n_points, f, model, _DUAL, False,
                          n_h2o_lines, n_o2_lines, as_coded)
    return ops.roofline(4.0 * n_points * (4 + 3 * f.size) + 4 * f.size
                        + _table_bytes(model, False, n_h2o_lines, n_o2_lines))


def k6_roofline(n_points: int, freqs, model: str = "R24", n_h2o_lines=None,
                n_o2_lines=None, as_coded: bool = False) -> Roofline:
    """K6, `absorption_spectral`: alpha (F, n_points) on the runtime grid
    `freqs`.  The Clough branches are counted for this grid.  As coded:
    the state pass once per point and the main pass in tiles of 8
    frequencies (`_k6_coded_ops`); the state's round trip through L2 is
    not in the bytes."""
    f = np.asarray(freqs, np.float64).reshape(-1)
    ops = (_k6_coded_ops(n_points, f, model, n_h2o_lines, n_o2_lines)
           if as_coded else
           _absorption_ops(n_points, f, model, _FLOAT, False,
                           n_h2o_lines, n_o2_lines))
    return ops.roofline(4.0 * n_points * (4 + f.size) + 4 * f.size
                        + _table_bytes(model, False, n_h2o_lines, n_o2_lines))


# ---- K2, K3: the downwelling RTE (csrc/rte.cu) ---------------------------

_PLANCK = "fdiv*2 fexp"                  # x / expm1f(x / t)
# the same while u = x / t < 0.25 (K3's staged body takes it so):
# t (1 - u / 2 + u^2 / 12 - u^4 / 720), u from one reciprocal
_PLANCK_SERIES = "fdiv fmul cmp fmul*2 fadd fmul fadd fmul fadd fmul"
# the chord of one layer: two sqrtf count as divides
_CHORD = ("fadd fadd fmul fdiv fadd*2 fmul cmp fdiv "
          "fadd*2 fmul cmp fdiv fadd*2 fmul fadd cmp fdiv fmul")
_RTE_TAIL = "fmul fadd fdiv*2 fexp fadd cmp fdiv fdiv*2 fexp"   # tb, t_mr
# What the bodies execute.  K3's other body: one thread per (elevation,
# frequency, profile) walks the layers.
_RTE_CODED = {
    # per thread: x; planck of level 0 and of the cosmic background; the
    # tail (tb, tau, t_mr)
    "thread": f"fmul {_PLANCK} {_PLANCK} {_RTE_TAIL}",
    # per (thread, layer): d, ctau, expf, planck of the top, the
    # small-opacity test, the emission sum
    "layer": f"fmul fadd fexp {_PLANCK} cmp fmul*2 fadd*3",
    # per (thread, layer) on level alpha: the layer mean
    "layer_mean": "fadd fmul",
    # per (thread, layer) below an opacity of 0.03 (the series), and above
    "layer_small": "fmul*7 fadd*4",
    "layer_large": "fadd*2 fdiv",
    # The staged body (K2 always; K3 without trans_level on a batch that is
    # a multiple of 4).  Per thread: x; planck of the cosmic background; the
    # tail
    "staged_thread": f"fmul {_PLANCK} {_RTE_TAIL}",
    # per (thread, layer): d, ctau, expf, the small-opacity test, the
    # emission sum
    "staged_layer": "fmul fadd fexp cmp fmul*2 fadd*3",
    # per (thread, level): planck, by its series or with expm1f
    "staged_level_series": _PLANCK_SERIES,
    "staged_level": _PLANCK,
    # K2's staged body, per block of up to 16 channels: the Snell invariant
    # per (elevation, profile), the chord per (elevation, layer, profile)
    "staged_path": "fadd fmul*2",
    "staged_chord": _CHORD,
    # and per (thread, layer) both forms of the emission factors, the
    # quotient by a reciprocal, and the two selects, in place of the branch
    "staged_layer_select": "fmul*8 fadd*6 fdiv cmp*2",
}
_K2_BLOCK_CHANNELS = 16     # two a warp, kChordWarps = 8, csrc/rte.cu
# What the function needs: each quantity on the indices it depends on.
_RTE_NEEDED = dict(
    _RTE_CODED,
    freq=f"fmul {_PLANCK}",        # per channel: x, the cosmic background
    level=_PLANCK,                 # per (channel, level, profile)
    # the same where x / t < 0.25: the series' one divide, no exponential,
    # and as few fp32 instructions as the closed form (none)
    level_series="fdiv",
    level_step="fadd",             # per (channel, layer, profile): dB
    path="fadd fmul*2",            # per (elevation, profile)
    chord=_CHORD,                  # per (elevation, layer, profile)
    # per (elevation, channel, layer, profile): d, ctau, expf, the test,
    # the emission sum
    layer="fmul fadd fexp cmp fmul*2 fadd*2",
    thread=_RTE_TAIL,              # per (elevation, channel, profile)
)


def k2_roofline(batch: int, n_levels: int = 180, n_channels: int = 14,
                n_elevations: int = 10, alpha_is_mid: bool = False,
                given_paths: bool = False, want_trans_level: bool = False,
                small_dtau_fraction: float = 1.0,
                planck_series_fraction: float = 0.0,
                as_coded: bool = False) -> Roofline:
    """K2, `forward_lb`, and with `given_paths` K3, `downwelling_lb`: tb,
    tau_total, t_mr (E, F, B) from alpha (F, L or L-1, B).

    `small_dtau_fraction` is the share of (elevation, channel, layer,
    profile) opacities under 0.03, which take the series branch: it
    depends on the data (1.0 for a thin atmosphere); `small_dtau_share`
    computes it from a run's inputs.  `planck_series_fraction` is the share
    of (channel, level, profile) with x / T < 0.25, whose Planck radiance
    needs no exponential and one divide less (`planck_series_share`); the
    function's fp32 count does not depend on it.  As coded, K2 and, on a
    batch that is a multiple of 4 without trans_level, K3 are the staged
    body, which takes that share of the levels by the series and, for K2,
    forms each chord once per block of up to 16 channels (in float64,
    counted here as the same operations) and computes both forms of a
    layer's emission factors, whatever its opacity; K3's other body takes
    no level by the series.
    """
    threads = float(batch) * n_channels * n_elevations
    layers = threads * (n_levels - 1)
    times = {"thread": threads, "layer": layers,
             "layer_small": layers * small_dtau_fraction,
             "layer_large": layers * (1.0 - small_dtau_fraction)}
    if as_coded and not (given_paths
                         and (want_trans_level or batch % 4 != 0)):
        # the staged body (csrc/rte.cu::staged_takes); blocks of 32 profiles
        body = _RTE_CODED
        levels = threads * n_levels
        blocks = (0 if given_paths else
                  float(batch) * n_elevations
                  * -(-n_channels // _K2_BLOCK_CHANNELS))
        times = {"staged_thread": threads, "staged_layer": layers,
                 "staged_path": blocks,
                 "staged_chord": blocks * (n_levels - 1),
                 "staged_level_series": levels * planck_series_fraction,
                 "staged_level": levels * (1.0 - planck_series_fraction),
                 "layer_mean": layers * (not alpha_is_mid),
                 "layer_small": times["layer_small"] * given_paths,
                 "layer_large": times["layer_large"] * given_paths,
                 "staged_layer_select": layers * (not given_paths)}
    elif as_coded:
        body = _RTE_CODED
        times.update(layer_mean=layers * (not alpha_is_mid))
    else:
        body = _RTE_NEEDED
        fields = float(batch) * n_channels          # (channel, profile)
        paths = float(batch) * n_elevations * (not given_paths)
        levels = fields * n_levels
        times.update(freq=n_channels,
                     level=levels * (1.0 - planck_series_fraction),
                     level_series=levels * planck_series_fraction,
                     level_step=fields * (n_levels - 1),
                     layer_mean=fields * (n_levels - 1) * (not alpha_is_mid),
                     path=paths, chord=paths * (n_levels - 1))
    ops = _charge(body, _FLOAT, times)
    l_in = n_levels - 1 if alpha_is_mid else n_levels
    hbm = 4.0 * (n_channels * l_in * batch + n_channels
                 + 3 * threads
                 + (threads * n_levels if want_trans_level else 0))
    if given_paths:       # ds (E, L-1, B) and T (L, B)
        hbm += 4.0 * batch * (n_elevations * (n_levels - 1) + n_levels)
    else:                 # z, n, T (L, B) and cos(elevation)
        hbm += 4.0 * (3 * n_levels * batch + n_elevations)
    return ops.roofline(hbm)


def small_dtau_share(dtau, threshold: float = 0.03) -> float:
    """The share of layer opacities `dtau` (any shape) under `threshold`."""
    return float((dtau < threshold).double().mean())


def planck_series_share(freqs_ghz, t) -> float:
    """The share of (channel, level, profile) with u = (h f / k) / T under
    0.25, where the Planck radiance is its four-term series: frequencies
    (F,) [GHz] against temperatures `t` of any shape [K]."""
    f = torch.as_tensor(freqs_ghz, dtype=t.dtype, device=t.device)
    u = HK_GHZ * f.reshape((-1,) + (1,) * t.ndim) / t
    return float((u < 0.25).double().mean())


# ---- K5: the adjoint with the assembly (csrc/adjoint.cu) ------------------

_SERIES = "fmul*9 fadd*9"                # one 10-term Horner series
_PLANCK_DT = "fdiv fexp fmul fadd fmul fmul fdiv"
_GEO = "fmul*2 fmul*2 fadd fmul fadd fmul fadd"
# What the body executes: a block per (elevation, channel, 32 profiles); each
# of its C warps walks one chunk of the layers up twice, then down, and the
# warps combine their sums in shared memory after each walk.
_ADJOINT_CODED = {
    # per (chunk, column): x; planck of the chunk's bottom level; ctt;
    # dtb_dr; planck of its top level; that level's absorption share plus
    # the carry of the chunk above
    "chunk": f"fmul {_PLANCK} {_PLANCK} fexp fmul "
             f"fadd fdiv fexp fmul fadd fmul*3 fdiv {_PLANCK} fadd",
    "chunk_planck": f"{_PLANCK_DT} fadd",
    "chunk_geo": "fadd",
    # per (chunk, column, chunk read back): the column's opacity and radiance
    "combine": "fadd*2",
    # per (column, pair of chunks j above c): the suffix entering chunk c
    "combine_suffix": "fadd",
    # per (column, chunk): warp 0's Snell sum
    "combine_geo": "fadd",
    # per column: level 0
    "thread": "fmul",
    "thread_planck": "fadd",
    "thread_geo": "fmul fadd fmul fadd",
    "thread_two": "fmul",
    # walk 1, per layer: d and the chunk's opacity
    "opacity": "fadd fmul*2 fadd",
    # walk 2, per layer: d, t_below, ctau, planck, the series test, g_top,
    # g_bot (an expm1f), the emission sum
    "forward": f"fadd fmul*2 fexp fadd {_PLANCK} cmp fmul fexp fadd "
               "fmul*3 fadd*2",
    "forward_series": _SERIES,
    "forward_closed": "fexp fadd fmul fadd fmul fdiv",
    # walk 3, per layer: amid, d, planck, the two tests, g_top, g_bot, w,
    # the suffix sum, half, the level's share and its product with the
    # tangent
    "backward": f"fadd fmul fmul {_PLANCK} cmp*2 fmul fexp fadd "
                "fmul*3 fadd*3 fmul*3 fadd*2 fmul*3 fadd fmul",
    "backward_series": f"{_SERIES} {_SERIES}",
    "backward_closed": "fexp fadd fmul fadd fmul fdiv fadd",
    "backward_planck": f"{_PLANCK_DT} fmul*3 fadd*2 fmul*3",
    "backward_geo": _GEO,
    "backward_two": "fmul",
}
# What the function needs.  One exponential per layer: expm1(-d) gives the
# layer's emission factors and, times the transmittance below, the next
# transmittance; the emission factors and the Planck radiances are formed
# once, not in both walks.
_ADJOINT_NEEDED = {
    "freq": f"fmul {_PLANCK}",     # per channel: x, the cosmic background
    # per (channel, level, profile): planck and the layer-mean absorption;
    # for t, dB/dT from the same x / T and expm1
    "level": f"{_PLANCK} fadd fmul",
    "level_planck": "fmul fadd fmul*2 fdiv",

    # per (elevation, channel, profile): ctt, dtb_dr, level 0 of K
    "thread": "fmul fadd fdiv fexp fmul fadd fmul*3 fdiv fmul",
    "thread_planck": "fadd",
    "thread_geo": "fmul fadd fmul fadd",
    "thread_two": "fmul",
    # per (elevation, channel, layer, profile): d, expm1(-d), the next
    # transmittance, the two tests, g_top, g_bot; the layer's emission into
    # the radiance and the suffix sum; W; the level's share and its product
    # with the tangent
    "layer": ("fmul fexp fadd fmul cmp*2 fmul fadd "
              "fmul*3 fadd*3 fmul*3 fadd*3 fmul*2 fadd fmul"),
    "layer_series": f"{_SERIES} {_SERIES}",
    "layer_closed": "fadd fmul fadd fmul fdiv fadd",
    "layer_planck": "fmul*3 fadd*2 fmul*3",
    "layer_geo": _GEO,
    "layer_two": "fmul",
}
_K5_MODES = {"lwc": (False, False, False), "rho": (False, True, False),
             "t": (True, True, False), "rho_lwc": (False, True, True)}


def k5_roofline(batch: int, n_levels: int = 180, n_channels: int = 14,
                n_elevations: int = 10, which: str = "t",
                series_fraction: float = 1.0,
                as_coded: bool = False) -> Roofline:
    """K5, `kmatrix_assembled_lb` for `which` in {"t", "rho", "lwc"} and
    `kmatrix_assembled_rho_lwc_lb` for "rho_lwc": K (E, F, L, B) per
    variable.  `series_fraction` is the share of layer opacities under 0.5,
    which take the emission-factor series (`small_dtau_share(dtau, 0.5)`).
    The kernel's re-read of the transmittances it parks in its own output
    is not in the bytes.  With `as_coded` the walk is split into
    min(`adjoint.CHUNK_WARPS`, L - 1) chunks, as the kernel splits it."""
    planck, geo, two = _K5_MODES[which]
    threads = float(batch) * n_channels * n_elevations
    layers = threads * (n_levels - 1)
    times = {"thread": threads, "thread_planck": threads * planck,
             "thread_geo": threads * geo, "thread_two": threads * two}
    if as_coded:
        body = _ADJOINT_CODED
        n_chunks = min(adjoint_mod.CHUNK_WARPS, n_levels - 1)
        chunks = threads * n_chunks
        times.update(chunk=chunks, chunk_planck=chunks * planck,
                     chunk_geo=chunks * geo, combine=chunks * n_chunks,
                     combine_suffix=threads * n_chunks * (n_chunks - 1) / 2,
                     combine_geo=chunks * geo, opacity=layers)
        for walk in ("forward", "backward"):
            times.update({walk: layers,
                          f"{walk}_series": layers * series_fraction,
                          f"{walk}_closed": layers * (1.0 - series_fraction)})
        times.update(backward_planck=layers * planck,
                     backward_geo=layers * geo, backward_two=layers * two)
    else:
        body = _ADJOINT_NEEDED
        levels = float(batch) * n_channels * n_levels
        times.update(freq=n_channels, level=levels,
                     level_planck=levels * planck, layer=layers,
                     layer_series=layers * series_fraction,
                     layer_closed=layers * (1.0 - series_fraction),
                     layer_planck=layers * planck, layer_geo=layers * geo,
                     layer_two=layers * two)
    ops = _charge(body, _FLOAT, times)
    fields = n_channels * n_levels * batch            # alpha, da (F, L, B)
    paths = n_elevations * (n_levels - 1) * batch     # ds, dnl, dk
    hbm = 4.0 * (fields * (3 if two else 2) + paths * (3 if geo else 1)
                 + n_levels * batch * (2 if geo else 1)
                 + (n_elevations * batch if geo else 0) + n_channels
                 + threads * n_levels * (2 if two else 1))
    return ops.roofline(hbm)


# ---- K7 and the sums -------------------------------------------------------

def k7_roofline(n_elements: int = CHAIN_ELEMENTS, op: str = "fma",
                k=None) -> Roofline:
    """K7, `chain`: 8 k applications of the primitive per element, plus the
    scaling and the sum of the 8 chains; 4 bytes in and 4 out.  The chain
    is the function here, so there is nothing to count apart from it."""
    k = chain_mod.default_k(op) if k is None else k
    steps = float(chain_mod.N_CHAINS) * k * n_elements
    per_step = {"fma": "fmul fadd", "div": "fadd fdiv", "exp": "fmul fexp",
                "div_fast": "fadd fdiv", "exp_fast": "fmul fexp"}
    if op not in per_step:
        raise ValueError(f"unknown primitive {op!r}")
    ops = _charge({"ends": "fmul*8 fadd*7", "step": per_step[op]}, _FLOAT,
                  {"ends": n_elements, "step": steps})
    return ops.roofline(8.0 * n_elements)


def lbl_roofline(batch: int, n_levels: int = 180, n_channels: int = 14,
                 n_elevations: int = 10, n_h2o_lines: int = 15,
                 n_o2_lines: int = 49, as_coded: bool = False) -> Roofline:
    """The LBL forward (`forward_batch`, R24, tb only): K1 on batch x
    n_levels points at the first `n_channels` HATPRO channels, then K2."""
    return (k1_roofline(batch * n_levels, _HATPRO[:n_channels], "R24",
                        n_h2o_lines=n_h2o_lines, n_o2_lines=n_o2_lines,
                        as_coded=as_coded)
            + k2_roofline(batch, n_levels, n_channels, n_elevations,
                          as_coded=as_coded))


def spectral_roofline(n_points: int, n_freqs: int, n_h2o_lines: int = 15,
                      n_o2_lines: int = 49, model: str = "R24",
                      f_range=None, n_levels: int = 180,
                      n_elevations: int = 1,
                      as_coded: bool = False) -> Roofline:
    """One chunk of the spectral forward: K6 on `n_points` = batch x
    n_levels points and `n_freqs` frequencies spread evenly over `f_range`
    (20-64 GHz when None), then K3 on the given paths."""
    lo, hi = (20.0, 64.0) if f_range is None else f_range
    freqs = np.linspace(lo, hi, n_freqs)
    return (k6_roofline(n_points, freqs, model, n_h2o_lines, n_o2_lines,
                        as_coded)
            + k2_roofline(n_points // n_levels, n_levels, n_freqs,
                          n_elevations, given_paths=True, as_coded=as_coded))
