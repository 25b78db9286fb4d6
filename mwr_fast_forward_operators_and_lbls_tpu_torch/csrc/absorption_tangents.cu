// K4: total clear/cloudy-sky absorption alpha [Np/km] at a set of channels
// with its elementwise partials dalpha/dT and dalpha/drho, in one
// dual-number pass over the points of a flattened (level x profile) array.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/absorption_kernel.py
//   ::total_absorption_fused_tangents (the body _build_kernel on dual
//   numbers `_D`), reached on the K-matrix path.
// The arithmetic follows the plain formulas of ops/absorption/{h2o,o2,n2,
// liquid}.py term for term, including the 1998 dry continuum for R98 and
// R03 and the clamp of the O2 term at zero; there is no O3 term, as on the
// TPU.
//
// What bounds it on Hopper: arithmetic, and the fp32 divides above all.  Each
// point reads 16 bytes and, at 14 channels, evaluates about
// 14 x (2 x 15 H2O + 2 x 49 O2) Lorentzian rationals plus some 200
// transcendentals; there is nothing to stream.  A dual number carries three
// floats through every operation: one divide and a few more FMAs per
// rational, and 3x the per-channel register sums.
//
// What the design does about it:
//  * One thread per point; channels are the inner loop, unrolled over the
//    template parameter F, with the per-channel sums in registers.  Each
//    line's width, strength and mixing coefficients are computed once per
//    point and shared by all channels.
//  * The body is written on the value type V = Dual {value, d/dT, d/drho}.
//    pvap = rho T / 217 depends on both, so the tangents flow through
//    widths, strengths, continua, the O2 density term, N2 and the Debye
//    liquid term.  A Dual divide costs one reciprocal for value and both
//    tangents.
//  * The line tables are a runtime argument, copied into shared memory by
//    each block (about 3 KB), so one binary serves all nine releases.
//  * The Clough cutoff is a run-time test per (line, channel); the channel
//    frequency is the same for the whole grid, so the branch never diverges.
//  * Every Lorentzian is evaluated exactly with IEEE fp32 division: the TPU
//    kernel's far-wing series, bf16 fold matrix and divide-merge trees exist
//    for the TPU's vector unit and are not carried over, and on dual numbers
//    the merged rationals of K1 and K6 cost more than they save.
//  * 128-thread blocks: the large register file per thread leaves few blocks
//    per SM, and small blocks spread the grid over more SMs.
//
// The packed line table's layout is in absorption.cuh.  K1 (absorption.cu)
// and K6 (absorption_spectral.cu) compute the same function on floats with
// bodies of their own.

#include "absorption.cuh"

namespace {

// ---- dual numbers: a value and its partials in T and rho -----------------

struct Dual {
  float v, dt, dr;
  __device__ __forceinline__ Dual(float v_ = 0.0f, float dt_ = 0.0f,
                                  float dr_ = 0.0f)
      : v(v_), dt(dt_), dr(dr_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.dt + b.dt, a.dr + b.dr};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
  return {a.v + b, a.dt, a.dr};
}
__device__ __forceinline__ Dual operator+(float a, Dual b) { return b + a; }
__device__ __forceinline__ Dual operator-(Dual a) {
  return {-a.v, -a.dt, -a.dr};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.dt - b.dt, a.dr - b.dr};
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
  return {a.v - b, a.dt, a.dr};
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
  return {a - b.v, -b.dt, -b.dr};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.dt * b.v + a.v * b.dt, a.dr * b.v + a.v * b.dr};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
  return {a.v * b, a.dt * b, a.dr * b};
}
__device__ __forceinline__ Dual operator*(float a, Dual b) { return b * a; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float inv = 1.0f / b.v;
  const float v = a.v * inv;
  return {v, (a.dt - v * b.dt) * inv, (a.dr - v * b.dr) * inv};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
  const float inv = 1.0f / b;
  return {a.v / b, a.dt * inv, a.dr * inv};
}
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float inv = 1.0f / b.v;
  const float v = a * inv;
  return {v, -v * b.dt * inv, -v * b.dr * inv};
}
__device__ __forceinline__ Dual& operator+=(Dual& a, Dual b) {
  a = a + b;
  return a;
}

__device__ __forceinline__ Dual exp_(Dual a) {
  const float e = expf(a.v);
  return {e, e * a.dt, e * a.dr};
}
// a^x for a > 0 and a constant exponent x
__device__ __forceinline__ Dual pow_(Dual a, float x) {
  const float v = powf(a.v, x);
  const float k = x * v / a.v;
  return {v, k * a.dt, k * a.dr};
}
// max(a, 0); the tangents are gated where the value is not positive
__device__ __forceinline__ Dual max0(Dual a) {
  return a.v > 0.0f ? a : Dual(0.0f);
}

__device__ __forceinline__ void store(Dual a, size_t j, float* out,
                                      float* out_dt, float* out_dr) {
  out[j] = a.v;
  out_dt[j] = a.dt;
  out_dr[j] = a.dr;
}

// ---- the body of K4 --------------------------------------------------------

template <int F>
__global__ void absorption_tangents_kernel(const float* __restrict__ p,
                                           const float* __restrict__ t,
                                           const float* __restrict__ rho,
                                           const float* __restrict__ lwc,
                                           const float* __restrict__ freqs,
                                           const float* __restrict__ tables,
                                           int table_size, Layout lay, int n,
                                           float* __restrict__ out,
                                           float* __restrict__ out_dt,
                                           float* __restrict__ out_dr) {
  using V = Dual;
  extern __shared__ float tab[];
  for (int j = threadIdx.x; j < table_size; j += blockDim.x) tab[j] = tables[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // every thread evaluates the same channels, so the Clough branch below
  // stays warp-uniform
  float f[F];
#pragma unroll
  for (int c = 0; c < F; ++c) f[c] = freqs[c];

  const float pp = p[i];
  const float ww = lwc[i];
  const V tt = Dual(t[i], 1.0f, 0.0f);
  const V rr = Dual(rho[i], 0.0f, 1.0f);

  const V ti = 300.0f / tt;
  const V th1 = ti - 1.0f;
  const V pvap = rr * tt / 217.0f;  // vapor partial pressure [hPa]
  const V pda = pp - pvap;          // dry-air partial pressure [hPa]
  const V ti25 = pow_(ti, 2.5f);

  // ---- H2O lines: VVW with the Clough cutoff, qSD near term where set ----
  const float cut = tab[kCutoff];
  const float cut2 = cut * cut;
  const float* gl_x = tab + lay.gl;
  const float* gl_w = tab + lay.gl + kGlNodes;
  V acc_h2o[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc_h2o[c] = 0.0f;

  const int nh = lay.n_h2o;
  for (int l = 0; l < nh; ++l) {
    const float* col = tab + lay.h2o + l;
    const float fl = col[0 * nh], s1 = col[1 * nh], b2 = col[2 * nh];
    const float w3 = col[3 * nh], x = col[4 * nh], ws = col[5 * nh];
    const float xs = col[6 * nh], w2 = col[7 * nh], ws2 = col[8 * nh];
    const V tix = pow_(ti, x);
    const V tixs = pow_(ti, xs);
    const V width = w3 * pda * tix + ws * pvap * tixs;
    const V wsq = width * width;
    const V s = s1 * ti25 * exp_(b2 * (1.0f - ti));
    const V base = width / (cut2 + wsq);
    const bool sd = (w2 != 0.0f) || (ws2 != 0.0f);
    const V gamma2 = sd ? w2 * pda * tix + ws2 * pvap * tixs : V(0.0f);
    const V c0 = width - 1.5f * gamma2;
    const float inv_fl = 1.0f / fl;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float df1 = f[c] - fl;
      const float df2 = f[c] + fl;
      V res = 0.0f;
      if (fabsf(df1) < cut) {
        V near1;
        if (sd) {
          near1 = 0.0f;
          const float ci2 = df1 * df1;
          for (int k = 0; k < kGlNodes; ++k) {
            const V cr = c0 + gamma2 * gl_x[k];
            near1 += gl_w[k] * cr / (cr * cr + ci2);
          }
        } else {
          near1 = width / (df1 * df1 + wsq);
        }
        res += near1 - base;
      }
      if (fabsf(df2) < cut) res += width / (df2 * df2 + wsq) - base;
      const float r = f[c] * inv_fl;
      acc_h2o[c] += s * res * (r * r);
    }
  }
  const V h2o_scale = 0.3183e-4f * (3.344e16f * rr);
  const V con_b = (tab[kCf] * pow_(ti, tab[kXcf]) * pda
                   + tab[kCs] * pow_(ti, tab[kXcs]) * pvap) * pvap;

  // ---- O2 lines with first- or second-order mixing ----
  const V b = pow_(ti, tab[kO2X]);
  const V den = 0.001f * (pda * b + tab[kH2oFactor] * pvap * ti);
  const V pe2 = den * den;
  const V dfnr = tab[kWb300] * den;
  const V ybase = tab[kMixingBasisP] != 0.0f ? 0.001f * pp * b : den;
  V acc_o2[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc_o2[c] = 0.0f;

  const int no = lay.n_o2;
  for (int l = 0; l < no; ++l) {
    const float* col = tab + lay.o2 + l;
    const float f0 = col[0 * no], s300 = col[1 * no], be = col[2 * no];
    const float w300 = col[3 * no], y0 = col[4 * no], y1 = col[5 * no];
    const float g0 = col[6 * no], g1 = col[7 * no];
    const float dnu0 = col[8 * no], dnu1 = col[9 * no];
    const V df = w300 * den;
    const V dfsq = df * df;
    const V y = ybase * (y0 + y1 * th1);
    const V strength = s300 * exp_(-be * th1);
    // First-order tables carry g = dnu = 0, which makes these exactly 1 and 0.
    const V dfg = df * (1.0f + pe2 * (g0 + g1 * th1));
    const V dnu = pe2 * (dnu0 + dnu1 * th1);
    const float inv_f0 = 1.0f / f0;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      // the pressure shift moves the centre of both halves
      const V d1 = f[c] - f0 - dnu;
      const V d2 = f[c] + f0 + dnu;
      const V sf1 = (dfg + d1 * y) / (d1 * d1 + dfsq);
      const V sf2 = (dfg - d2 * y) / (d2 * d2 + dfsq);
      const float r = f[c] * inv_f0;
      acc_o2[c] += strength * (sf1 + sf2) * (r * r);
    }
  }
  const float o2_scale_p = tab[kO2Scale];
  const V ti3 = ti * ti * ti;

  // ---- dry continuum and cloud liquid terms shared by all channels ----
  const V n2_b = tab[kN2Coef] * pda * pda;
  const V n2_t = pow_(ti, tab[kN2Exp]);
  const bool n2_fdep = tab[kN2Fdep] != 0.0f;
  const V theta1 = 1.0f - ti;
  const V eps0 = 77.66f - 103.3f * theta1;
  const V eps1 = 0.0671f * eps0;
  const float eps2 = 3.52f;
  const V fp = 20.1f * exp_(7.88f * theta1);
  const V fs = 39.8f * fp;

#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float fc = f[c];
    const V h2o = h2o_scale * acc_h2o[c] + con_b * fc * fc;

    const V nonres = tab[kNonres] * fc * fc * dfnr
                     / (ti * (fc * fc + dfnr * dfnr));
    const V o2 = max0(o2_scale_p * (nonres + acc_o2[c]) * pda * ti3);

    const float fdep = n2_fdep ? 0.5f + 0.5f / (1.0f + (fc / 450.0f) * (fc / 450.0f))
                               : 1.0f;
    const V n2 = n2_b * fdep * fc * fc * n2_t;

    const V u = fc / fp;
    const V v = fc / fs;
    const V re = eps2 + (eps0 - eps1) / (1.0f + u * u)
                 + (eps1 - eps2) / (1.0f + v * v);
    const V im = -(eps0 - eps1) * u / (1.0f + u * u)
                 - (eps1 - eps2) * v / (1.0f + v * v);
    const V aimag = 3.0f * im / ((re + 2.0f) * (re + 2.0f) + im * im);
    const V liq = -0.06286f * aimag * fc * ww;

    store(h2o + o2 + n2 + liq, (size_t)c * n + i, out, out_dt, out_dr);
  }
}

template <int F>
void launch(const float* p, const float* t, const float* rho, const float* lwc,
            const float* freqs, const float* tables, int table_size,
            Layout lay, int n, float* out, float* out_dt, float* out_dr,
            cudaStream_t stream) {
  constexpr int kThreads = 128;
  absorption_tangents_kernel<F><<<(n + kThreads - 1) / kThreads, kThreads,
                                  table_size * sizeof(float), stream>>>(
      p, t, rho, lwc, freqs, tables, table_size, lay, n, out, out_dt, out_dr);
}

// Launch the body for the nf channels of `freqs`.
inline int dispatch(int nf, const float* p, const float* t, const float* rho,
                    const float* lwc, const float* freqs,
                    const float* tables, int table_size, Layout lay, int n,
                    float* out, float* out_dt, float* out_dr, void* stream) {
  if (nf < 1 || nf > kMaxChannels || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
#define MWR_CASE(F_)                                                       \
  case F_:                                                                 \
    launch<F_>(p, t, rho, lwc, freqs, tables, table_size, lay, n, out,     \
               out_dt, out_dr, s);                                         \
    break;
    MWR_CASE(1) MWR_CASE(2) MWR_CASE(3) MWR_CASE(4) MWR_CASE(5) MWR_CASE(6)
    MWR_CASE(7) MWR_CASE(8) MWR_CASE(9) MWR_CASE(10) MWR_CASE(11)
    MWR_CASE(12) MWR_CASE(13) MWR_CASE(14) MWR_CASE(15) MWR_CASE(16)
#undef MWR_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alpha, dalpha/dT and dalpha/drho, each (F, N), for the N points of p, t,
// rho, lwc, all float32 on the device; the table carries no O3 lines.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mwr_absorption_tangents_lb(
    const float* p, const float* t, const float* rho, const float* lwc,
    const float* freqs, int nf, const float* tables, int table_size,
    int n_h2o, int n_o2, int h2o_off, int o2_off, int gl_off, int n,
    float* out, float* out_dt, float* out_dr, void* stream) {
  const Layout lay{n_h2o, n_o2, 0, h2o_off, o2_off, gl_off, gl_off};
  return dispatch(nf, p, t, rho, lwc, freqs, tables, table_size, lay, n, out,
                  out_dt, out_dr, stream);
}
