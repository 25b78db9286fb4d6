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
keeps the fp32 count where it was); K6 calls powf, a logarithm and an
exponential each time.  A qSD node's c_r, its weight times c_r
and c_r^2 are charged once per (point, line, node).  K4 carries the partials
in T and rho through the same rationals, each with its tangents from the
line's one divide (`_K4_NEEDED`); two O2 lines per divide save a divide for
more fp32 instructions there, so it is charged the lesser of the two forms
in each resource, as Planck below.  Where u = x / T < 0.25
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
from ..ops.cuda import absorption as absorption_mod
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
    device time by kernel.

    This is the way to trace any call of the port: inside the block the
    entry points and kernel wrappers record their spans (`ops/spans.py`,
    `SPAN_NAMES`) as `user_annotation` events on the trace's clock, so each
    device gap lies under the host span that was running."""
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


# ---- the absorption function on floats (K1, K6) -----------------------------
#
# Each operation by kind.  f* are operations on the table's and the grid's
# numbers, v* the same operations on values that hang on the point (the
# listings of the function name them apart); on floats each costs one.
#   vmul V*V, vmuls V*float, vadd V+-V, vadds V+-float, rsub float-V,
#   vneg -V, vdiv V/V, vdivs V/float, sdivv float/V, vexp exp, vpow a power,
#   vmax0 max(V, 0), vsel a select, cmp a compare.
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
# What the function is charged: a power is one exponential, the point's one
# logarithm is charged apart ("point_log").
_FLOAT_NEEDED = dict(_FLOAT, fpow=_Ops(exp=1), vpow=_Ops(exp=1))

_FDEP = "fdiv fmul fadd fdiv fadd cmp"
# What the function needs on floats, each line as one rational in q (the
# module docstring has the rules), per point unless said otherwise.
_ABSORPTION_NEEDED_FLOAT = {
    # ti, th1, pvap, pda, ti25, cut2, the H2O scale, con_b; the O2 block's
    # b, den, pe2, dfnr, ybase; ti3; N2's n2_b, n2_t; the liquid term's
    # theta1, eps0, eps1, fp, fs and the two differences of eps; 1 / fp,
    # dfnr^2, n2_b n2_t and o2_scale pda ti3
    "point": ("sdivv vadds vmul vdivs rsub vpow fmul vmuls*2 "
              "vpow*2 vmuls*2 vmul*2 vadd vmul "
              "vpow vmul vmuls vmul vadd vmuls vmul vmuls cmp fmul vmuls vsel "
              "vmul*2 vmuls vmul vpow "
              "rsub vmuls rsub vmuls vmuls vexp vmuls vmuls vadd vadds "
              "sdivv vmul*2 vmuls"),
    # log2(300 / T), once per point, for all its powers
    "point_log": "fexp",
    # per H2O line: tix, tixs, width, wsq, s, base, the two tests of `sd`;
    # the strength with the density scale and 1 / fl^2, times the width and
    # times the base; k1, k2, k3; the running sum of the bases
    "h2o_line": ("vpow*2 vmuls vmul vmuls vmul vadd vmul rsub vmuls vexp "
                 "vmuls vmul vadds vdiv cmp*2 vmuls vadd "
                 "vmul vmuls vmul*4 vmuls vadd"),
    # more per qSD line: gamma2, and per node c_r, its weight, c_r^2
    "h2o_sd_line": ("vmuls vmul vmuls vmul vadd "
                    + "vmuls vadd vmuls vmul vmul " * 16),
    # per O2 line: df, dfsq, y, strength, dfg, dnu; c = 2 (f0 + dnu), the
    # strength over f0^2, its products with dfg and with y c, k1, k2, k3
    "o2_line": ("vmuls vmul vmuls vadds vmul vmuls vexp vmuls "
                "vmuls vadds vmul vadds vmul vmuls vadds vmul "
                "vadds vmuls*2 vmul*7 vadd*2 vmuls"),
    # per (frequency, H2O line) on the grid alone: d1, d2, the cutoff tests,
    # d1 d2; per half inside the cutoff: d^2
    "h2o_grid": "fadd*2 cmp*2 fmul", "h2o_grid_half": "fmul",
    # both halves inside the cutoff: q, the numerator, the denominator, the
    # divide, the sum
    "h2o_both": "vadds vmul vadd vmul vadd vdiv vadd",
    # one half: d^2 + wsq, the divide, the sum
    "h2o_half": "vadds vdiv vadd",
    # the near half of a qSD line, per node: c_r^2 + d1^2, the divide, the sum
    "h2o_sd_half": "vadds vdiv vadd " * 16,
    # 1 / f_line^2 per line of the table
    "line_grid": "fmul fdiv",
    # per (frequency, O2 line) on the grid alone: f - f0
    "o2_grid": "fadd",
    # per (point, frequency, O2 line): d1, d2, q, the numerator, the
    # denominator
    "o2_rational": "rsub vadd vmul vadd vmul vadd vmul vadd",
    # per (point, frequency, two O2 lines): n_a D_b + n_b D_a, D_a D_b, the
    # divide, the sum; the odd line out: the divide and the sum
    "o2_two": "vmul*2 vadd vmul vdiv vadd", "o2_one": "vdiv vadd",
    # per frequency on the grid alone: fc^2 and its products with the
    # table's constants
    "channel_grid": "fmul*4",
    # more per frequency for the 2017 dry continuum's fdep
    "channel_fdep": _FDEP,
    # per (point, frequency): the water continuum; the non-resonant O2 term
    # and the clamp; N2; u = fc / fp and v = u / 39.8, 1 / (1 + u^2),
    # 1 / (1 + v^2), re and im from the same two reciprocals; aimag; the
    # liquid term and the sum; the bases' sum off the H2O lines, the O2
    # lines' sum times f^2
    "channel": ("vmul vmuls vadd "
                "vmuls vadds vmul vdiv vadd vmul vmax0 "
                "vmuls "
                "vmuls*2 vmul*2 vadds*2 sdivv*2 vmul*2 vadd*2 vmul*2 vadd vneg "
                "vadds vmul*2 vadd vdiv vmuls "
                "vmuls*2 vadd*3 vadd vmul"),
    # O3: per point, per line; per (frequency, O3 line) on the grid alone;
    # per (point, frequency, line): A, B, A + B, width (A + B), A B, one
    # divide, s res r^2, the sum; per (point, frequency)
    "o3_point": "fmul*3 fdiv",
    "o3_line": "fpow fmul*2 fmul fadd fmul fexp fmul*2",
    "o3_grid": "fadd*2 fmul*4",
    "o3_pair": "fadd*3 fmul*2 fdiv fmul*2 fadd",
    "o3_channel": "fmul fadd",
}

def _lines(model, freqs, n_h2o_lines=None, n_o2_lines=None):
    """The release's H2O line centres, which of them are qSD, the O2 line
    count, and (F, lines) masks of the Lorentzian halves inside the Clough
    cutoff at the frequencies `freqs` (|f -+ f_line| under the cutoff)."""
    h2o, o2 = H2O_MODELS[model], O2_MODELS[model]
    f = np.asarray(freqs, np.float64).reshape(-1)
    fl = np.asarray(h2o.fl, np.float64)[:n_h2o_lines]
    sd = ((np.asarray(h2o.w2) != 0) | (np.asarray(h2o.ws2) != 0))[:fl.size]
    n_o2 = np.asarray(o2.f)[:n_o2_lines].size
    near = np.abs(f[:, None] - fl[None, :]) < h2o.cutoff_ghz
    far = np.abs(f[:, None] + fl[None, :]) < h2o.cutoff_ghz
    return fl, sd, n_o2, near, far


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
    fl, sd, n_o2, near, far = _lines(model, freqs, n_h2o_lines, n_o2_lines)
    nf = near.shape[0]
    tiles = -(-nf // _K6_TILE)
    tile_of = np.arange(nf) // _K6_TILE
    whole = np.ones((tiles, fl.size), bool)       # tiles wholly inside both
    np.logical_and.at(whole, tile_of, near & far)
    merged = whole[tile_of] & ~sd[None, :]                       # (F, lines)
    nodes = 16
    per_point = {
        "point": 1, "h2o_line": fl.size,
        "h2o_sd_line": fl.size * bool(H2O_MODELS[model].has_sd),
        "o2_line": n_o2,
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
    fl, sd, n_o2, near, far = _lines(model, freqs, n_h2o_lines, n_o2_lines)
    n_o3 = o3_lines.O3_FL.size if with_o3 else 0
    nf = near.shape[0]
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


def _absorption_ops(n_points, freqs, model, with_o3=False, n_h2o_lines=None,
                    n_o2_lines=None) -> _Ops:
    """Operations the absorption function needs on floats over `n_points`
    points and the frequencies `freqs` (K1's and K6's bound; their bodies
    are counted by `_k1_coded_ops` and `_k6_coded_ops`).  The Clough-cutoff
    branches are counted for these frequencies."""
    fl, sd, n_o2, near, far = _lines(model, freqs, n_h2o_lines, n_o2_lines)
    n_o3 = o3_lines.O3_FL.size if with_o3 else 0
    nf = near.shape[0]
    fdep = model not in ("R98", "R03")      # the 1998 continuum has none
    both = (near & far & ~sd).sum()
    per_point = {"point": 1, "point_log": 1, "h2o_line": fl.size,
                 "h2o_sd_line": int(sd.sum()), "o2_line": n_o2,
                 "h2o_both": both,
                 "h2o_half": near[:, ~sd].sum() + far.sum() - 2 * both,
                 "h2o_sd_half": near[:, sd].sum(), "o2_rational": nf * n_o2,
                 "o2_two": nf * (n_o2 // 2), "o2_one": nf * (n_o2 % 2),
                 "channel": nf, "o3_point": with_o3, "o3_line": n_o3,
                 "o3_pair": nf * n_o3, "o3_channel": nf * with_o3}
    per_call = {"line_grid": fl.size + n_o2 + n_o3, "h2o_grid": nf * fl.size,
                "h2o_grid_half": near.sum() + far.sum(), "o2_grid": nf * n_o2,
                "o3_grid": nf * n_o3, "channel_grid": nf,
                "channel_fdep": nf * fdep}
    body, cost = _ABSORPTION_NEEDED_FLOAT, _FLOAT_NEEDED
    total = _charge(body, cost, per_call)
    total.add_scaled(_charge(body, cost, per_point), n_points)
    return total


# ---- K4: absorption with its partials in T and rho -----------------------
#
# The value and both tangents of each quantity, counted on floats: what hangs
# on T alone carries one tangent, a quantity linear in a line's width the
# width's tangents by one derivative (csrc/absorption_tangents.cu has the
# algebra).
_POW = "fmul fexp fmul*2"         # ti^x from log2 ti, and its tangent
_DMUL = "fmul*5 fadd*2"           # the product of two (v, d/dT, d/drho)
_ADD_LINE = "fmul*5 fadd*5"       # sn (res, res_w w') into a channel's sum
# What K4's body executes (csrc/absorption_tangents.cu): a thread per
# (point, group of channels) forms the state of every line for its group
# and spends it on the group's channels, one reciprocal per line shape.
_K4_CODED = {
    # per block, per line and per channel of its group: an H2O record's
    # s1 / fl^2, c^2 and the tests that pick its form; an O2 record's
    # s300 / f0^2, w300^2, 2 f0; 1 / f^2, the dry continuum's factor, the
    # group's span
    "block_h2o_line": "fmul*3 fdiv fadd*4 cmp*8",
    "block_o2_line": "fmul*3 fdiv",
    "block_channel": f"fmul fdiv {_FDEP} cmp*2",
    # per (point, group): ti, -1 / T, dti/dT, th1, log2 ti, pvap, pda
    "point": "fdiv fmul*2 fadd fexp fmul fdiv fmul*2 fadd",
    # the O2 block's b, den, pe2, ybase
    "o2_point": f"{_POW} fmul*4 fadd fmul*6 fadd*3 fmul*4 fadd fmul*5 "
                "fmul*3 cmp*3",
    # per (point, group, O2 line): df, dfsq, the strength, y, gfac, dfg,
    # dnu, c, dfg_s, s y, y c, c^2, k1, k2, k3, the tangents of q and of
    # the numerator's constant term, 2 q'
    "o2_line": (f"fmul*3 fmul*3 fmul*4 fexp fmul*6 fadd*2 fmul*6 fadd*3 "
                f"{_DMUL} fmul*6 fadd*2 fmul*3 fadd fmul*4 fadd fmul*4 fadd "
                f"{_DMUL} fmul*5 {_DMUL} {_DMUL} {_DMUL} fmul*3 fadd*3 "
                f"fmul*3 fadd*3 fmul*4 fadd*4 fmul*2"),
    # per (point, group, channel, O2 line): d1, d1 + c, q, the numerator,
    # the denominator, its reciprocal, the value, the two tangents
    "o2_rational": ("fadd*3 fmul fadd fmul fadd fmul fadd fdiv fmul fadd "
                    "fmul*8 fadd*8"),
    # per (point, group): dfnr, 1 / ti, k_nr, dfnr^2, ti^3, o2s; N2's power
    # and pda^2, n2k; the water continuum's two powers and con_b; the
    # liquid term's theta1, eps0, eps1, 1 / fp, e01, e12, -0.06286 LWC
    "tail": (f"fmul*3 fdiv fmul*7 fadd fmul*5 fmul*5 fmul*7 fadd {_POW} "
             f"fmul*5 fmul*7 fadd {_POW} {_POW} fmul*12 fadd*5 {_DMUL} "
             "fadd fmul fadd fmul fmul*2 fmul fexp fmul fdiv fmul*2 fadd*3 "
             "fmul"),
    # per (point, group, channel): f^2, the non-resonant term, the O2 term
    # and its clamp, N2, u, v, 1 / (1 + u^2), 1 / (1 + v^2) and their
    # tangents, re, im, aimag, the liquid term, the continuum, the sum
    "tail_channel": ("fmul fadd fdiv fmul fmul*4 fadd*5 "
                     f"{_DMUL} cmp*4 fmul*3 fadd*3 fmul*4 "
                     "fmul fadd fdiv fmul fadd fdiv fmul*8 "
                     "fmul*2 fadd*2 fmul*4 fadd*3 fmul*2 fmul*2 fadd "
                     "fmul*8 fadd*5 fadd fmul*2 fadd fmul fdiv "
                     "fmul*5 fadd*2 fdiv fmul*2 fmul*2 fadd*6"),
    # per (point, group): cut^2, the H2O density scale, ti^2.5
    "h2o_point": f"fmul*3 {_POW}",
    # per (point, group, H2O line): tix, tixs, the width, w^2, the strength
    # and its tangent, sn, Clough's base and its derivative, sn w', the test
    "h2o_line": (f"{_POW} {_POW} fmul*4 fmul*8 fadd*5 fmul fadd fmul fexp "
                 "fmul*2 fmul*3 fadd fmul*3 fadd fdiv fmul fmul*2 fadd "
                 "fmul*2 cmp"),
    # per (point, group, merged H2O line): c^2 w^2, 4 w^2, 2 w, the bases'
    # sum
    "h2o_merged_line": f"fmul*3 fmul*2 {_ADD_LINE}",
    # per (point, group, channel, merged H2O line): d1, d2, q, c^2 + 2 q, the
    # denominator, its reciprocal, the value, its derivative in w, the sum
    "h2o_merged": ("fadd*2 fmul fadd fmul fadd fmul fadd fdiv fmul*2 "
                   f"fmul fadd fmul fadd fmul {_ADD_LINE}"),
    # per (point, group, channel, H2O line apart): d1, d2, the two tests,
    # the sum; per half inside the cutoff: d^2 + w^2, its reciprocal, the
    # shape minus the base, its derivative minus the base's (the near half
    # also adds to the far one's)
    "h2o_apart": f"fadd*2 cmp*2 {_ADD_LINE}",
    "h2o_far": "fmul fadd fdiv fmul fadd fmul*2 fadd fadd",
    "h2o_near": "fmul fadd fdiv fmul fadd*2 fmul*2 fadd fadd*2",
    # per (point, group, qSD line): gamma2 and c0; per (point, group,
    # channel, qSD line with its near half inside the cutoff): d1^2, the
    # value and the tangents from P and Q, the sum; per node: c_r, its
    # square plus d1^2, the reciprocal, the value, T', the three sums
    "h2o_sd_line": "fmul*4 fmul*8 fadd*5 fmul*3 fadd*3",
    "h2o_sd_near": "fmul fadd fmul*3 fadd*2 fmul*3 fadd*2 fmul*5 fadd*5",
    "h2o_sd_node": "fmul fadd fmul fadd fdiv fmul fmul*2 fadd fmul fmul fadd "
                   "fadd fmul fadd",
    # per (point, channel) stored: f^2 (the sum - the merged bases)
    "store": "fmul fadd*3 fmul*3",
}
# What the function needs with both tangents: each quantity once, on the
# indices it depends on, in the cheapest form known (the body's, without
# the state repeated per group): what depends on the table or the grid
# alone once per call, a line's state once per point.  An O2 line is K1's
# one rational on the body's dual algebra; two O2 lines may share a
# reciprocal, which saves a divide for 11 more instructions of the fp32
# pipe, so the function is charged the lesser in each resource, as for
# Planck: the single line's fp32 count and one divide per two lines.
_K4_NEEDED = {
    "point": " ".join(_K4_CODED[k] for k in ("point", "o2_point", "tail",
                                             "h2o_point")),
    "o2_line": _K4_CODED["o2_line"],
    "h2o_line": _K4_CODED["h2o_line"],
    "h2o_merged_line": _K4_CODED["h2o_merged_line"],
    # gamma2 and c0, and per node c_r and its square
    "h2o_sd_line": _K4_CODED["h2o_sd_line"],
    "h2o_sd_line_node": "fmul fadd fmul",
    # per line of the table: the strength over f_line^2 and c^2 (H2O),
    # w300^2 and 2 f0 (O2)
    "line_h2o": "fmul fdiv fmul*2", "line_o2": "fmul*3 fdiv",
    # on the grid alone: per (frequency, H2O line) d1, d2, the tests and
    # d1 d2, per half inside the cutoff d^2; per (frequency, O2 line)
    # f - f0; per frequency f^2, 1 / f^2 and the dry continuum's factor
    "h2o_grid": "fadd*2 cmp*2 fmul", "h2o_grid_half": "fmul",
    "o2_grid": "fadd", "channel_grid": f"fmul*2 fdiv {_FDEP}",
    # per (point, frequency, merged H2O line): q, c^2 + 2 q, the
    # denominator, its reciprocal, the value and its derivative, the sum
    "h2o_merged": ("fadd fmul fadd fmul fadd fdiv fmul*2 fmul fadd fmul "
                   f"fadd fmul {_ADD_LINE}"),
    # per (point, frequency, H2O line apart): the sum; per half inside the
    # cutoff: d^2 + w^2, the reciprocal, the shape minus the base, its
    # derivative minus the base's
    "h2o_apart": _ADD_LINE,
    "h2o_half": "fadd fdiv fmul fadd fmul*2 fadd fadd",
    # per (point, frequency, qSD near half inside the cutoff): the value and
    # the tangents, the sum; per node: the denominator, the reciprocal, the
    # value, T', the three sums
    "h2o_sd_near": "fadd fmul*3 fadd*2 fmul*3 fadd*2 fmul*5 fadd*5",
    "h2o_sd_node": "fadd fdiv fmul fmul*2 fadd fmul fmul fadd fadd fmul fadd",
    # per (point, frequency, O2 line): d1, d1 + c, q, the numerator, the
    # denominator, the value, the two tangents, without the divide; one
    # divide per (point, frequency, two O2 lines) and for the odd line out
    "o2_rational": "fadd*2 fmul fadd fmul fadd fmul fadd fmul fadd "
                   "fmul*8 fadd*8",
    "o2_two": "fdiv", "o2_one": "fdiv",
    "tail_channel": _K4_CODED["tail_channel"],
    "store": "fadd*3 fmul*3",
}
_K4_THREADS = absorption_mod.TANGENT_THREADS


def _k4_ops(n_points, freqs, model, n_h2o_lines=None, n_o2_lines=None,
            as_coded=False) -> _Ops:
    """Operations of K4 over `n_points` points at the channels `freqs`: of
    the function, or (`as_coded`) of the body, which takes the channels in
    groups (`tangent_groups`), the last filled up with its last channel, and
    forms every line's state per group; an H2O line is merged where all the
    group's channels lie inside the cutoff on both sides."""
    fl, sd, n_o2, near, far = _lines(model, freqs, n_h2o_lines, n_o2_lines)
    nf = near.shape[0]
    n_sd = int(sd.sum())
    if not as_coded:
        merged = near & far & ~sd
        apart = ~merged
        per_point = {"point": 1, "o2_line": n_o2, "h2o_line": fl.size,
                     "h2o_merged_line": merged.any(axis=0).sum(),
                     "h2o_sd_line": n_sd, "h2o_sd_line_node": 16 * n_sd,
                     "h2o_merged": merged.sum(), "h2o_apart": apart.sum(),
                     "h2o_half": (near & apart & ~sd).sum()
                     + (far & apart).sum(),
                     "h2o_sd_near": near[:, sd].sum(),
                     "h2o_sd_node": 16 * near[:, sd].sum(),
                     "o2_rational": nf * n_o2, "o2_two": nf * (n_o2 // 2),
                     "o2_one": nf * (n_o2 % 2), "tail_channel": nf,
                     "store": nf}
        per_call = {"line_h2o": fl.size, "line_o2": n_o2,
                    "h2o_grid": nf * fl.size,
                    "h2o_grid_half": near.sum() + far.sum(),
                    "o2_grid": nf * n_o2, "channel_grid": nf}
        total = _charge(_K4_NEEDED, _FLOAT, per_call)
        total.add_scaled(_charge(_K4_NEEDED, _FLOAT, per_point), n_points)
        return total
    groups, per = absorption_mod.tangent_groups(nf)
    per_point = dict.fromkeys(_K4_CODED, 0)
    for s0 in range(0, groups * per, per):
        slots = np.minimum(np.arange(s0, s0 + per), nf - 1)
        g_near, g_far = near[slots], far[slots]
        merged = (g_near & g_far).all(axis=0) & ~sd             # (lines,)
        apart = ~merged
        counts = {
            "block_h2o_line": fl.size / _K4_THREADS,
            "block_o2_line": n_o2 / _K4_THREADS,
            "block_channel": per / _K4_THREADS,
            "point": 1, "o2_point": 1, "tail": 1, "h2o_point": 1,
            "o2_line": n_o2, "o2_rational": per * n_o2,
            "tail_channel": per, "h2o_line": fl.size,
            "h2o_merged_line": merged.sum(),
            "h2o_merged": per * merged.sum(), "h2o_apart": per * apart.sum(),
            "h2o_far": g_far[:, apart].sum(),
            "h2o_near": g_near[:, apart & ~sd].sum(),
            "h2o_sd_line": n_sd, "h2o_sd_near": g_near[:, sd].sum(),
            "h2o_sd_node": 16 * g_near[:, sd].sum(),
            "store": min(per, nf - s0)}
        for k, v in counts.items():
            per_point[k] += v
    total = _Ops()
    total.add_scaled(_charge(_K4_CODED, _FLOAT, per_point), n_points)
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
    (at most 32).  Reads p, T, rho, LWC (and O3), the table and the
    channels; writes alpha."""
    f = np.asarray(freqs, np.float64).reshape(-1)
    ops = (_k1_coded_ops(n_points, f, model, with_o3, n_h2o_lines,
                         n_o2_lines) if as_coded else
           _absorption_ops(n_points, f, model, with_o3, n_h2o_lines,
                           n_o2_lines))
    n_in = 5 if with_o3 else 4
    return ops.roofline(4.0 * n_points * (n_in + f.size) + 4 * f.size
                        + _table_bytes(model, with_o3, n_h2o_lines,
                                       n_o2_lines))


def k4_roofline(n_points: int, freqs=_HATPRO, model: str = "R24",
                n_h2o_lines=None, n_o2_lines=None,
                as_coded: bool = False) -> Roofline:
    """K4, `absorption_tangents_lb`: alpha, dalpha/dT and dalpha/drho
    (F, n_points), no O3.  Reads p, T, rho, LWC, the table and the
    channels; writes the three outputs."""
    f = np.asarray(freqs, np.float64).reshape(-1)
    ops = _k4_ops(n_points, f, model, n_h2o_lines, n_o2_lines, as_coded)
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
           _absorption_ops(n_points, f, model, False, n_h2o_lines,
                           n_o2_lines))
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
