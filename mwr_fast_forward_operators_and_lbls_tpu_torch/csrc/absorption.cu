// Total clear/cloudy-sky absorption alpha [Np/km] at a set of channels, for
// every point of a flattened (level x profile) array.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/absorption_kernel.py
//   ::total_absorption_fused (body _build_kernel), reached on the LBL path
//   through absorption_lb_fused.
// The arithmetic follows the plain formulas of ops/absorption/{h2o,o2,n2,
// liquid,o3}.py term for term, including the 1998 dry continuum for R98 and
// R03 and the clamp of the O2 term at zero.
//
// What bounds it on Hopper: arithmetic, and the fp32 divides above all.  Each
// point reads 16-20 bytes and, at 14 channels, evaluates about
// 14 x (2 x 15 H2O + 2 x 49 O2) Lorentzian rationals plus some 200
// transcendentals; there is nothing to stream.
//
// What the design does about it:
//  * One thread per point; channels are the inner loop, unrolled over the
//    template parameter F, with the per-channel sums in registers.  Each
//    line's width, strength and mixing coefficients are computed once per
//    point and shared by all channels.
//  * The line tables are a runtime argument, copied into shared memory by
//    each block (about 3 KB), so one binary serves all nine releases and O3.
//  * The Clough cutoff is a run-time test per (line, channel); the channel
//    frequency is the same for the whole grid, so the branch never diverges.
//  * Every Lorentzian is evaluated exactly with IEEE fp32 division: the TPU
//    kernel's far-wing series, bf16 fold matrix and divide-merge trees exist
//    for the TPU's vector unit and are not carried over.
//
// Table layout (written by ops/cuda/absorption.py::line_tables): a header of
// scalars, then per-line columns (each `n_lines` floats long) for H2O, O2 and
// O3, then the 16 Gauss-Laguerre nodes and 16 weights of the qSD shape.

#include <cuda_runtime.h>

namespace {

// Header slots; keep in step with HEADER_FIELDS in ops/cuda/absorption.py.
enum Header {
  kCutoff = 0, kCf, kXcf, kCs, kXcs,
  kO2X, kWb300, kH2oFactor, kNonres, kO2Scale, kMixingBasisP,
  kN2Coef, kN2Exp, kN2Fdep,
};

constexpr int kMaxChannels = 16;
constexpr int kGlNodes = 16;

struct Layout {
  int n_h2o, n_o2, n_o3;
  int h2o, o2, o3, gl;
};

template <int F>
__global__ void absorption_kernel(const float* __restrict__ p,
                                  const float* __restrict__ t,
                                  const float* __restrict__ rho,
                                  const float* __restrict__ lwc,
                                  const float* __restrict__ o3,
                                  const float* __restrict__ freqs,
                                  const float* __restrict__ tables,
                                  int table_size, Layout lay, int n,
                                  float* __restrict__ out) {
  extern __shared__ float tab[];
  for (int j = threadIdx.x; j < table_size; j += blockDim.x) tab[j] = tables[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float f[F];
#pragma unroll
  for (int c = 0; c < F; ++c) f[c] = freqs[c];

  const float pp = p[i];
  const float tt = t[i];
  const float rr = rho[i];
  const float ww = lwc[i];

  const float ti = 300.0f / tt;
  const float th1 = ti - 1.0f;
  const float pvap = rr * tt / 217.0f;  // vapor partial pressure [hPa]
  const float pda = pp - pvap;          // dry-air partial pressure [hPa]
  const float ti25 = powf(ti, 2.5f);

  // ---- H2O lines: VVW with the Clough cutoff, qSD near term where set ----
  const float cut = tab[kCutoff];
  const float cut2 = cut * cut;
  const float* gl_x = tab + lay.gl;
  const float* gl_w = tab + lay.gl + kGlNodes;
  float acc_h2o[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc_h2o[c] = 0.0f;

  const int nh = lay.n_h2o;
  for (int l = 0; l < nh; ++l) {
    const float* col = tab + lay.h2o + l;
    const float fl = col[0 * nh], s1 = col[1 * nh], b2 = col[2 * nh];
    const float w3 = col[3 * nh], x = col[4 * nh], ws = col[5 * nh];
    const float xs = col[6 * nh], w2 = col[7 * nh], ws2 = col[8 * nh];
    const float tix = powf(ti, x);
    const float tixs = powf(ti, xs);
    const float width = w3 * pda * tix + ws * pvap * tixs;
    const float wsq = width * width;
    const float s = s1 * ti25 * expf(b2 * (1.0f - ti));
    const float base = width / (cut2 + wsq);
    const bool sd = (w2 != 0.0f) || (ws2 != 0.0f);
    const float gamma2 = sd ? w2 * pda * tix + ws2 * pvap * tixs : 0.0f;
    const float c0 = width - 1.5f * gamma2;
    const float inv_fl = 1.0f / fl;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float df1 = f[c] - fl;
      const float df2 = f[c] + fl;
      float res = 0.0f;
      if (fabsf(df1) < cut) {
        float near1;
        if (sd) {
          near1 = 0.0f;
          const float ci2 = df1 * df1;
          for (int k = 0; k < kGlNodes; ++k) {
            const float cr = c0 + gamma2 * gl_x[k];
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
  const float h2o_scale = 0.3183e-4f * (3.344e16f * rr);
  const float con_b = (tab[kCf] * powf(ti, tab[kXcf]) * pda
                       + tab[kCs] * powf(ti, tab[kXcs]) * pvap) * pvap;

  // ---- O2 lines with first- or second-order mixing ----
  const float b = powf(ti, tab[kO2X]);
  const float den = 0.001f * (pda * b + tab[kH2oFactor] * pvap * ti);
  const float pe2 = den * den;
  const float dfnr = tab[kWb300] * den;
  const float ybase = tab[kMixingBasisP] != 0.0f ? 0.001f * pp * b : den;
  float acc_o2[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc_o2[c] = 0.0f;

  const int no = lay.n_o2;
  for (int l = 0; l < no; ++l) {
    const float* col = tab + lay.o2 + l;
    const float f0 = col[0 * no], s300 = col[1 * no], be = col[2 * no];
    const float w300 = col[3 * no], y0 = col[4 * no], y1 = col[5 * no];
    const float g0 = col[6 * no], g1 = col[7 * no];
    const float dnu0 = col[8 * no], dnu1 = col[9 * no];
    const float df = w300 * den;
    const float dfsq = df * df;
    const float y = ybase * (y0 + y1 * th1);
    const float strength = s300 * expf(-be * th1);
    // First-order tables carry g = dnu = 0, which makes these exactly 1 and 0.
    const float dfg = df * (1.0f + pe2 * (g0 + g1 * th1));
    const float dnu = pe2 * (dnu0 + dnu1 * th1);
    const float inv_f0 = 1.0f / f0;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      // the pressure shift moves the centre of both halves
      const float d1 = f[c] - f0 - dnu;
      const float d2 = f[c] + f0 + dnu;
      const float sf1 = (dfg + d1 * y) / (d1 * d1 + dfsq);
      const float sf2 = (dfg - d2 * y) / (d2 * d2 + dfsq);
      const float r = f[c] * inv_f0;
      acc_o2[c] += strength * (sf1 + sf2) * (r * r);
    }
  }
  const float o2_scale_p = tab[kO2Scale];
  const float ti3 = ti * ti * ti;

  // ---- O3 lines (optional) ----
  float acc_o3[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc_o3[c] = 0.0f;
  float o3_scale = 0.0f;
  if (o3 != nullptr) {
    o3_scale = 0.3183e-4f * (7.2429e12f * pp * o3[i] / tt);
    const int nz = lay.n_o3;
    for (int l = 0; l < nz; ++l) {
      const float* col = tab + lay.o3 + l;
      const float fl = col[0 * nz], s1 = col[1 * nz], b2 = col[2 * nz];
      const float w3 = col[3 * nz], x = col[4 * nz];
      const float width = w3 * pp * powf(ti, x);
      const float wsq = width * width;
      const float s = s1 * ti25 * expf(b2 * (1.0f - ti));
      const float inv_fl = 1.0f / fl;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        const float df1 = f[c] - fl;
        const float df2 = f[c] + fl;
        const float res = width / (df1 * df1 + wsq) + width / (df2 * df2 + wsq);
        const float r = f[c] * inv_fl;
        acc_o3[c] += s * res * (r * r);
      }
    }
  }

  // ---- dry continuum and cloud liquid terms shared by all channels ----
  const float n2_b = tab[kN2Coef] * pda * pda;
  const float n2_t = powf(ti, tab[kN2Exp]);
  const bool n2_fdep = tab[kN2Fdep] != 0.0f;
  const float theta1 = 1.0f - ti;
  const float eps0 = 77.66f - 103.3f * theta1;
  const float eps1 = 0.0671f * eps0;
  const float eps2 = 3.52f;
  const float fp = 20.1f * expf(7.88f * theta1);
  const float fs = 39.8f * fp;

#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float fc = f[c];
    const float h2o = h2o_scale * acc_h2o[c] + con_b * fc * fc;

    const float nonres = tab[kNonres] * fc * fc * dfnr
                         / (ti * (fc * fc + dfnr * dfnr));
    const float o2 = fmaxf(
        o2_scale_p * (nonres + acc_o2[c]) * pda * ti3, 0.0f);

    const float fdep = n2_fdep ? 0.5f + 0.5f / (1.0f + (fc / 450.0f) * (fc / 450.0f))
                               : 1.0f;
    const float n2 = n2_b * fdep * fc * fc * n2_t;

    const float u = fc / fp;
    const float v = fc / fs;
    const float re = eps2 + (eps0 - eps1) / (1.0f + u * u)
                     + (eps1 - eps2) / (1.0f + v * v);
    const float im = -(eps0 - eps1) * u / (1.0f + u * u)
                     - (eps1 - eps2) * v / (1.0f + v * v);
    const float aimag = 3.0f * im / ((re + 2.0f) * (re + 2.0f) + im * im);
    const float liq = -0.06286f * aimag * fc * ww;

    float alpha = h2o + o2 + n2 + liq;
    if (o3 != nullptr) alpha += o3_scale * acc_o3[c];
    out[(size_t)c * n + i] = alpha;
  }
}

template <int F>
void launch(const float* p, const float* t, const float* rho, const float* lwc,
            const float* o3, const float* freqs, const float* tables,
            int table_size, Layout lay, int n, float* out,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  absorption_kernel<F><<<blocks, kThreads, table_size * sizeof(float),
                         stream>>>(p, t, rho, lwc, o3, freqs, tables,
                                   table_size, lay, n, out);
}

}  // namespace

// alpha (F, N) for the N points of p, t, rho, lwc (and o3 unless null), all
// float32 on the device.  Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int mwr_absorption_lb(const float* p, const float* t,
                                 const float* rho, const float* lwc,
                                 const float* o3, const float* freqs, int nf,
                                 const float* tables, int table_size,
                                 int n_h2o, int n_o2, int n_o3, int h2o_off,
                                 int o2_off, int o3_off, int gl_off, int n,
                                 float* out, void* stream) {
  if (nf < 1 || nf > kMaxChannels || n < 1) return cudaErrorInvalidValue;
  const Layout lay{n_h2o, n_o2, n_o3, h2o_off, o2_off, o3_off, gl_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
#define MWR_CASE(F_)                                                        \
  case F_:                                                                  \
    launch<F_>(p, t, rho, lwc, o3, freqs, tables, table_size, lay, n, out, \
               s);                                                          \
    break;
    MWR_CASE(1) MWR_CASE(2) MWR_CASE(3) MWR_CASE(4) MWR_CASE(5) MWR_CASE(6)
    MWR_CASE(7) MWR_CASE(8) MWR_CASE(9) MWR_CASE(10) MWR_CASE(11)
    MWR_CASE(12) MWR_CASE(13) MWR_CASE(14) MWR_CASE(15) MWR_CASE(16)
#undef MWR_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
