// K6: monochromatic absorption alpha (F, N) [Np/km] over a runtime frequency
// grid of any length, for the N points of flattened (level x profile)
// arrays.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/spectral_kernel.py
//   ::absorption_spectral (body _build_kernel), reached on the spectral
//   forward (models/spectral.py::_forward_chunk).
// The function is that of ops/absorption/{h2o,o2,n2,liquid}.py, including
// the 1998 dry continuum for R98 *and* R03 (n2.py), which the packed table's
// header carries; the TPU kernel gives it to R98 only.  No O3, as on the TPU.
//
// What bounds it on Hopper: arithmetic.  Each (point, frequency) sums 15 H2O
// and 49 O2 lines (R24) against 4 bytes of output: a 5760-point x
// 8192-frequency chunk writes 189 MB (56 us at 3.35 TB/s) and evaluates
// 3.0e9 line shapes.  Each needs one result of the special-function unit
// (16 lanes per SM) and about ten instructions of the fp32 pipe.
//
// What the design does about it:
//  * Two passes.  `line_state_kernel` computes once per call, one thread per
//    (point, line), what depends on the point alone, with the powf, expf and
//    divides that takes: per H2O line the squared width and the strength
//    (with the density scale and 1 / f_line^2 folded in) times the width and
//    times the Clough base; per O2 line the pressure shift, the squared
//    width and the strength times the two numerator coefficients; nine
//    scalars of the continua, the non-resonant O2 term, N2 and the Debye
//    liquid term.  It writes them as (slot, N) rows, some 300 floats a point
//    (7 MB for 5760 points: it stays in L2), and the dry continuum's
//    frequency factor per frequency.  ops/cuda/spectral.py::line_state is
//    the same in plain torch.
//  * `spectral_kernel` is the main pass.  A block owns 32 points (one lane
//    each) and keeps their state in shared memory, 38 KB for R24, so four
//    blocks, 32 warps, stay resident per SM.  Its eight warps walk the
//    block's share of the frequency tiles, eight frequencies per tile in
//    registers: every state value read from shared memory serves eight
//    frequencies, every store is one coalesced 128-byte row, and the
//    Clough-cutoff tests, which depend on (line, frequency), are the same
//    for a whole warp.  The eight independent rationals of one line give the
//    instruction-level parallelism that hides the special-function unit's
//    latency.
//  * One rational per line.  With d1 = (f - f0) -
//    dnu the distance to the line centre, d2 = d1 + c that to its mirror
//    image (c = 2 (f0 + dnu)), A = d1^2 + w^2 and B = d2^2 + w^2, an O2
//    line's two halves n1 / A + n2 / B are the one rational (n1 B + n2 A) /
//    (A B).  In q = d1 d2 + w^2 that is (k2 + q k3) / (q^2 + w^2 c^2):
//    A + B = c^2 + 2 q, A B = q^2 + w^2 c^2, and n1 B + n2 A = dfg (A + B) +
//    y c (q - 2 w^2), so k2 and k3 are per-point state.  Three adds for d1
//    and d2 and four FMAs: q, the denominator (a sum of squares: it cannot
//    cancel), the numerator, the sum.  An H2O line inside the cutoff on
//    both sides is the same with n1 = n2 = sw.  q is formed from the
//    difference d1, never as f^2 - (c / 2)^2 + w^2: f^2 is 3600, where
//    float32 resolves 2.4e-4, and q falls to 1e-3 at the line centres
//    aloft; even rounding f0 + dnu once before the subtraction costs 6e-6
//    of alpha at 25 hPa.  q^2 stays under 1e13.
//  * The reciprocal occupies a sub-partition's special-function unit for
//    eight cycles a warp, as long as the seven fp32 instructions of one O2
//    line take to dispatch, so neither runs full beside the other.  Two O2
//    lines therefore share one reciprocal, (n_a D_b + n_b D_a) / (D_a D_b):
//    17 instructions in place of 16, half the reciprocals.
//  * The line loops divide by the special-function unit's approximate
//    reciprocal (1 ulp) and a multiply, by intrinsic.  (__fdividef is not
//    that: it adds a range test and two scalings per call, a quarter of the
//    O2 loop's instructions.)  The IEEE divide and the reciprocal with one
//    Newton step were timed on the same body and were slower at the same
//    error.  The state pass and the tail keep IEEE arithmetic, and no build
//    flag changes any other kernel.
//  * What depends on the frequency alone is applied once: the sums are
//    multiplied by f^2 after the loops, and the liquid term takes
//    1 / (1 + u^2) and 1 / (1 + v^2) once each, four divides a (point,
//    frequency) with the non-resonant term and the dielectric ratio.
//  * The grid is (point groups, frequency shares); each block takes as many
//    tiles as leaves some ten waves of blocks, so the state is re-read from
//    L2 a few dozen times per call, not once per tile.  Any F and N: the
//    last tile and the last group are masked at the store.

#include "absorption.cuh"

namespace {

constexpr int kFT = 8;        // frequencies per register tile
constexpr int kWarps = 8;     // warps per block
constexpr int kPoints = 32;   // points per block: one lane each
constexpr int kStateThreads = 128;
// blocks a launch aims for: 132 SMs x 4 resident blocks x 10 waves
constexpr int kTargetBlocks = 132 * 4 * 10;

// Rows of the per-point state; keep in step with STATE_SCALARS and the
// layout comment in ops/cuda/spectral.py.
enum Scalar {
  kConB = 0, kKnr, kDfnr2, kO2s, kN2k, kInvFp, kE01, kE12, kWk, kNumScalars,
};
constexpr int kO2Slots = 5;   // dnu, c2, dfsq, k2, k3

struct SpecLayout {
  int n_h2o, n_o2;       // lines
  int h2o, o2, gl;       // offsets of the packed table
  int h2o_slots;         // 3, or 6 for a release with qSD lines
  __host__ __device__ int o2_row() const {
    return kNumScalars + h2o_slots * n_h2o;
  }
  __host__ __device__ int n_state() const {
    return o2_row() + kO2Slots * n_o2;
  }
  // block-uniform constants kept behind the state in shared memory:
  // fl and the qSD flag per H2O line, f0 per O2 line, 16 nodes, 16 weights
  __host__ __device__ int n_const() const {
    return 2 * n_h2o + n_o2 + 2 * kGlNodes;
  }
};

// ---- pass 1: the per-point state -----------------------------------------

// Block (x, y): 128 points x, and y names what the block computes for them:
// H2O line y, O2 line y - n_h2o, or (the last y) the nine scalars and, for
// the first F threads of the grid's x axis, the dry continuum's frequency
// factor.  One thread per (point, line) keeps the pass short: a thread per
// point would walk 64 lines of powf and expf alone, 1.4 warps per SM.
__global__ void line_state_kernel(const float* __restrict__ p,
                                  const float* __restrict__ t,
                                  const float* __restrict__ rho,
                                  const float* __restrict__ lwc,
                                  const float* __restrict__ freqs,
                                  const float* __restrict__ tab,
                                  SpecLayout lay, int n, int nf,
                                  float* __restrict__ state,
                                  float* __restrict__ fdep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nh = lay.n_h2o, no = lay.n_o2;
  const int what = blockIdx.y;
  if (what == nh + no && i < nf) {
    const float r = freqs[i] / 450.0f;
    fdep[i] = tab[kN2Fdep] != 0.0f ? 0.5f + 0.5f / (1.0f + r * r) : 1.0f;
  }
  if (i >= n) return;
  float* st = state + i;
  const size_t row = (size_t)n;

  const float pp = p[i], tt = t[i], rr = rho[i];
  const float ti = 300.0f / tt;
  const float th1 = ti - 1.0f;
  const float pvap = rr * tt / 217.0f;
  const float pda = pp - pvap;

  if (what < nh) {
    const int l = what;
    const float* col = tab + lay.h2o + l;
    const float fl = col[0 * nh], s1 = col[1 * nh], b2 = col[2 * nh];
    const float w3 = col[3 * nh], x = col[4 * nh], ws = col[5 * nh];
    const float xs = col[6 * nh], w2 = col[7 * nh], ws2 = col[8 * nh];
    const float cut = tab[kCutoff];
    const float tix = powf(ti, x);
    const float tixs = powf(ti, xs);
    const float width = w3 * pda * tix + ws * pvap * tixs;
    const float wsq = width * width;
    const float s = s1 * powf(ti, 2.5f) * expf(b2 * (1.0f - ti));
    const float base = width / (cut * cut + wsq);
    const float h2o_scale = 0.3183e-4f * (3.344e16f * rr);
    const float sn = s * h2o_scale * (1.0f / (fl * fl));
    float* out = st + (size_t)(kNumScalars + lay.h2o_slots * l) * row;
    out[0 * row] = wsq;
    out[1 * row] = sn * width;
    out[2 * row] = sn * base;
    if (lay.h2o_slots == 6) {
      const float gamma2 = w2 * pda * tix + ws2 * pvap * tixs;
      out[3 * row] = sn;
      out[4 * row] = width - 1.5f * gamma2;
      out[5 * row] = gamma2;
    }
    return;
  }

  const float b = powf(ti, tab[kO2X]);
  const float den = 0.001f * (pda * b + tab[kH2oFactor] * pvap * ti);
  if (what < nh + no) {
    const int l = what - nh;
    const float* col = tab + lay.o2 + l;
    const float f0 = col[0 * no], s300 = col[1 * no], be = col[2 * no];
    const float w300 = col[3 * no], y0 = col[4 * no], y1 = col[5 * no];
    const float g0 = col[6 * no], g1 = col[7 * no];
    const float dnu0 = col[8 * no], dnu1 = col[9 * no];
    const float pe2 = den * den;
    const float ybase = tab[kMixingBasisP] != 0.0f ? 0.001f * pp * b : den;
    const float df = w300 * den;
    const float sn = (s300 * expf(-be * th1)) * (1.0f / (f0 * f0));
    // First-order tables carry g = dnu = 0, which makes these exactly 1 and 0.
    const float dfg = df * (1.0f + pe2 * (g0 + g1 * th1));
    const float dnu = pe2 * (dnu0 + dnu1 * th1);
    float* out = st + (size_t)(lay.o2_row() + kO2Slots * l) * row;
    // the merged numerator n1 B + n2 A = k2 + q k3 (see the note above)
    const float c2 = 2.0f * (f0 + dnu);
    const float dfsq = df * df;
    const float dfg_s = sn * dfg;
    const float yc = (sn * (ybase * (y0 + y1 * th1))) * c2;
    out[0 * row] = dnu;
    out[1 * row] = c2;
    out[2 * row] = dfsq;
    out[3 * row] = dfg_s * (c2 * c2) - 2.0f * dfsq * yc;
    out[4 * row] = 2.0f * dfg_s + yc;
    return;
  }

  const float dfnr = tab[kWb300] * den;
  const float theta1 = 1.0f - ti;
  const float eps0 = 77.66f - 103.3f * theta1;
  const float eps1 = 0.0671f * eps0;
  st[kConB * row] = (tab[kCf] * powf(ti, tab[kXcf]) * pda
                     + tab[kCs] * powf(ti, tab[kXcs]) * pvap) * pvap;
  st[kKnr * row] = tab[kNonres] * dfnr / ti;
  st[kDfnr2 * row] = dfnr * dfnr;
  st[kO2s * row] = tab[kO2Scale] * pda * (ti * ti * ti);
  st[kN2k * row] = tab[kN2Coef] * pda * pda * powf(ti, tab[kN2Exp]);
  st[kInvFp * row] = 1.0f / (20.1f * expf(7.88f * theta1));
  st[kE01 * row] = eps0 - eps1;
  st[kE12 * row] = eps1 - 3.52f;
  st[kWk * row] = -0.06286f * lwc[i];
}

// ---- pass 2: the lines ----------------------------------------------------

__global__ void __launch_bounds__(kWarps * 32, 4)
spectral_kernel(const float* __restrict__ state,
                const float* __restrict__ freqs,
                const float* __restrict__ fdep,
                const float* __restrict__ tab, SpecLayout lay, int n, int nf,
                int tiles_per_block, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nh = lay.n_h2o, no = lay.n_o2;
  const int n_state = lay.n_state();

  // this block's 32 points: their state rows, one lane per point (lanes past
  // the last point repeat it and store nothing)
  const int i = blockIdx.x * kPoints + lane;
  const int i_load = i < n ? i : n - 1;
  for (int k = warp; k < n_state; k += kWarps)
    smem[k * kPoints + lane] = state[(size_t)k * n + i_load];
  float* c_fl = smem + n_state * kPoints;
  float* c_sd = c_fl + nh;
  float* c_f0 = c_sd + nh;
  float* c_glx = c_f0 + no;
  float* c_glw = c_glx + kGlNodes;
  for (int l = threadIdx.x; l < nh; l += blockDim.x) {
    c_fl[l] = tab[lay.h2o + l];
    c_sd[l] = (tab[lay.h2o + 7 * nh + l] != 0.0f
               || tab[lay.h2o + 8 * nh + l] != 0.0f) ? 1.0f : 0.0f;
  }
  for (int l = threadIdx.x; l < no; l += blockDim.x)
    c_f0[l] = tab[lay.o2 + l];
  for (int k = threadIdx.x; k < 2 * kGlNodes; k += blockDim.x)
    c_glx[k] = tab[lay.gl + k];
  __syncthreads();

  const float* st = smem + lane;
  const float cut = tab[kCutoff];
  const int n_tiles = (nf + kFT - 1) / kFT;
  const int tile_end = min(n_tiles, (blockIdx.y + 1) * tiles_per_block);

  for (int tile = blockIdx.y * tiles_per_block + warp; tile < tile_end;
       tile += kWarps) {
    const int row0 = tile * kFT;
    float f[kFT], acc_h2o[kFT], acc_o2[kFT];
    float f_lo = 3.0e38f, f_hi = -3.0e38f;
#pragma unroll
    for (int c = 0; c < kFT; ++c) {
      f[c] = freqs[min(row0 + c, nf - 1)];
      f_lo = fminf(f_lo, f[c]);
      f_hi = fmaxf(f_hi, f[c]);
      acc_h2o[c] = 0.0f;
      acc_o2[c] = 0.0f;
    }

    // ---- H2O lines: VVW with the Clough cutoff, qSD near half where set --
    float two_base = 0.0f;   // 2 sb summed over the lines merged below
    for (int l = 0; l < nh; ++l) {
      const float fl = c_fl[l];
      const bool sd = c_sd[l] != 0.0f;
      const float* s = st + (kNumScalars + lay.h2o_slots * l) * kPoints;
      const float wsq = s[0 * kPoints], sw = s[1 * kPoints];
      const float sb = s[2 * kPoints];
      // |f -+ fl| is convex in f: the tile's ends decide for all of it
      const bool all_both = fabsf(f_lo - fl) < cut && fabsf(f_hi - fl) < cut
                            && fabsf(f_lo + fl) < cut
                            && fabsf(f_hi + fl) < cut;
      if (all_both && !sd) {
        // sw (A + B) / (A B) in q = d1 d2 + wsq, with c = 2 fl
        const float csq = 4.0f * fl * fl;
        const float k1 = wsq * csq, k2 = sw * csq, k3 = 2.0f * sw;
#pragma unroll
        for (int c = 0; c < kFT; ++c) {
          const float q = fmaf(f[c] - fl, f[c] + fl, wsq);
          acc_h2o[c] += ratio(fmaf(q, k3, k2), fmaf(q, q, k1));
        }
        two_base += 2.0f * sb;
        continue;
      }
      // the halves apart, each under its own cutoff test
      float ci2[kFT];
      bool near_in[kFT];
#pragma unroll
      for (int c = 0; c < kFT; ++c) {
        const float d1 = f[c] - fl, d2 = f[c] + fl;
        ci2[c] = d1 * d1;
        near_in[c] = fabsf(d1) < cut;
        if (near_in[c]) acc_h2o[c] -= sb;
        if (fabsf(d2) < cut)
          acc_h2o[c] += ratio(sw, fmaf(d2, d2, wsq)) - sb;
      }
      if (sd) {
        const float sn = s[3 * kPoints], c0 = s[4 * kPoints];
        const float gamma2 = s[5 * kPoints];
        for (int k = 0; k < kGlNodes; ++k) {
          const float cr = fmaf(gamma2, c_glx[k], c0);
          const float crw = sn * c_glw[k] * cr;
          const float cr2 = cr * cr;
#pragma unroll
          for (int c = 0; c < kFT; ++c)
            if (near_in[c]) acc_h2o[c] += ratio(crw, cr2 + ci2[c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kFT; ++c)
          if (near_in[c]) acc_h2o[c] += ratio(sw, ci2[c] + wsq);
      }
    }

    // ---- O2 lines with first- or second-order mixing: one rational each --
    // two lines as one rational, n_a / D_a + n_b / D_b =
    // (n_a D_b + n_b D_a) / (D_a D_b): three more multiplies for one
    // reciprocal less.  D is a sum of squares, at most 1e13 here, so the
    // product stays in range.  An odd line out goes alone.
    int l = 0;
    for (; l + 1 < no; l += 2) {
      const float f0a = c_f0[l], f0b = c_f0[l + 1];
      const float* s = st + (lay.o2_row() + kO2Slots * l) * kPoints;
      const float* s2 = s + kO2Slots * kPoints;
      const float dnua = s[0 * kPoints], c2a = s[1 * kPoints];
      const float dfsqa = s[2 * kPoints], k2a = s[3 * kPoints];
      const float k3a = s[4 * kPoints];
      const float dnub = s2[0 * kPoints], c2b = s2[1 * kPoints];
      const float dfsqb = s2[2 * kPoints], k2b = s2[3 * kPoints];
      const float k3b = s2[4 * kPoints];
      const float k1a = dfsqa * (c2a * c2a), k1b = dfsqb * (c2b * c2b);
#pragma unroll
      for (int c = 0; c < kFT; ++c) {
        // from the difference d1, never expanded in f (see the note above)
        const float d1a = (f[c] - f0a) - dnua;
        const float d1b = (f[c] - f0b) - dnub;
        const float qa = fmaf(d1a, d1a + c2a, dfsqa);
        const float qb = fmaf(d1b, d1b + c2b, dfsqb);
        const float na = fmaf(qa, k3a, k2a), da = fmaf(qa, qa, k1a);
        const float nb = fmaf(qb, k3b, k2b), db = fmaf(qb, qb, k1b);
        acc_o2[c] += ratio(fmaf(na, db, nb * da), da * db);
      }
    }
    for (; l < no; ++l) {
      const float f0 = c_f0[l];
      const float* s = st + (lay.o2_row() + kO2Slots * l) * kPoints;
      const float dnu = s[0 * kPoints], c2 = s[1 * kPoints];
      const float dfsq = s[2 * kPoints], k2 = s[3 * kPoints];
      const float k3 = s[4 * kPoints];
      const float k1 = dfsq * (c2 * c2);
#pragma unroll
      for (int c = 0; c < kFT; ++c) {
        const float d1 = (f[c] - f0) - dnu;
        const float q = fmaf(d1, d1 + c2, dfsq);
        acc_o2[c] += ratio(fmaf(q, k3, k2), fmaf(q, q, k1));
      }
    }

    // ---- continua, cloud liquid, the sum ----------------------------------
    const float con_b = st[kConB * kPoints], k_nr = st[kKnr * kPoints];
    const float dfnr2 = st[kDfnr2 * kPoints], o2s = st[kO2s * kPoints];
    const float n2k = st[kN2k * kPoints], inv_fp = st[kInvFp * kPoints];
    const float e01 = st[kE01 * kPoints], e12 = st[kE12 * kPoints];
    const float wk = st[kWk * kPoints];
#pragma unroll
    for (int c = 0; c < kFT; ++c) {
      if (row0 + c >= nf) break;
      const float fc = f[c];
      const float f2 = fc * fc;
      const float h2o = f2 * ((acc_h2o[c] - two_base) + con_b);
      const float nonres = k_nr * f2 / (f2 + dfnr2);
      const float o2 = fmaxf(o2s * fmaf(f2, acc_o2[c], nonres), 0.0f);
      const float n2 = n2k * (fdep[row0 + c] * f2);
      const float u = fc * inv_fp;
      const float v = u * (1.0f / 39.8f);
      const float ru = 1.0f / fmaf(u, u, 1.0f);
      const float rv = 1.0f / fmaf(v, v, 1.0f);
      const float re = 3.52f + e01 * ru + e12 * rv;
      const float im = -(e01 * (u * ru) + e12 * (v * rv));
      const float aimag = 3.0f * im / ((re + 2.0f) * (re + 2.0f) + im * im);
      const float alpha = h2o + o2 + n2 + wk * (aimag * fc);
      if (i < n) out[(size_t)(row0 + c) * n + i] = alpha;
    }
  }
}

size_t lines_shared_bytes(SpecLayout lay) {
  return sizeof(float) * ((size_t)lay.n_state() * kPoints + lay.n_const());
}

// Let the main pass take `smem` bytes of shared memory a block where that is
// more than the 48 KB a kernel gets unasked.
cudaError_t allow_lines_shared(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(spectral_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int launch_lines(const float* state, const float* freqs, const float* fdep,
                 const float* tab, SpecLayout lay, int n, int nf, float* out,
                 cudaStream_t stream) {
  const int groups = (n + kPoints - 1) / kPoints;
  const int n_tiles = (nf + kFT - 1) / kFT;
  const long long want =
      ((long long)groups * n_tiles + kTargetBlocks - 1) / kTargetBlocks;
  const int tiles_per_block = (int)((want + kWarps - 1) / kWarps) * kWarps;
  const int shares = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  if (shares > 65535) return cudaErrorInvalidValue;
  const size_t smem = lines_shared_bytes(lay);
  const cudaError_t err = allow_lines_shared(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spectral_kernel<<<dim3(groups, shares), kWarps * 32, smem, stream>>>(
      state, freqs, fdep, tab, lay, n, nf, tiles_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

int lines_resident_warps(SpecLayout lay) {
  const size_t smem = lines_shared_bytes(lay);
  int blocks = 0;
  cudaError_t err = allow_lines_shared(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, spectral_kernel, kWarps * 32, smem);
  return err == cudaSuccess ? blocks * kWarps : -static_cast<int>(err);
}

}  // namespace

// alpha (F, N) at the F frequencies `freqs` for the N points of p, t, rho,
// lwc, all float32 on the device; the table carries no O3 lines.  `scratch`
// holds n_state x N + F floats (n_state = 9 + h2o_slots x n_h2o + 5 x n_o2):
// the state pass fills it, the main pass reads it.  `lines` = 0 runs the
// state pass alone.
// Returns the CUDA error of the first launch that failed (0 when all were
// accepted).
extern "C" int mwr_absorption_spectral(const float* p, const float* t,
                                       const float* rho, const float* lwc,
                                       const float* freqs, int nf,
                                       const float* tables, int n_h2o,
                                       int n_o2, int h2o_off, int o2_off,
                                       int gl_off, int h2o_slots, int n,
                                       int lines, float* scratch, float* out,
                                       void* stream) {
  if (nf < 1 || n < 1 || (h2o_slots != 3 && h2o_slots != 6))
    return cudaErrorInvalidValue;
  const SpecLayout lay{n_h2o, n_o2, h2o_off, o2_off, gl_off, h2o_slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* state = scratch;
  float* fdep = scratch + (size_t)lay.n_state() * n;
  const int most = n > nf ? n : nf;
  line_state_kernel<<<dim3((most + kStateThreads - 1) / kStateThreads,
                           n_h2o + n_o2 + 1),
                      kStateThreads, 0, s>>>(p, t, rho, lwc, freqs, tables,
                                             lay, n, nf, state, fdep);
  const int err = static_cast<int>(cudaGetLastError());
  if (err || !lines) return err;
  return launch_lines(state, freqs, fdep, tables, lay, n, nf, out, s);
}

// Warps of the main pass resident per SM for a release's state (what the
// occupancy calculator says for its registers and shared memory), or minus
// the CUDA error.
extern "C" int mwr_absorption_spectral_resident_warps(int n_h2o, int n_o2,
                                                      int h2o_slots) {
  return lines_resident_warps(SpecLayout{n_h2o, n_o2, 0, 0, 0, h2o_slots});
}
