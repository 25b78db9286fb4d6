// The body of K1 (absorption.cu, whose notes describe it), in a header of
// its own: absorption.cu instantiates it at 1 to 16 channels, and
// absorption_f17_24.cu and absorption_f25_32.cu at 17 to 32, each file in
// an nvcc process of its own, so the wider bodies build beside the rest.

#pragma once

#include "absorption.cuh"

namespace {

constexpr int kPointThreads = 128;
constexpr int kPointBlocks = 6;     // resident blocks per SM aimed for
// the same for the bodies past 16 channels, at up to 96 registers
constexpr int kWideBlocks = 5;

// The channel frequencies [GHz], passed by value.
struct Channels {
  float f[kMaxChannels];
};

// Floats of shared memory behind the packed table: 1 / f_line^2 per line of
// H2O, O2 and O3, and the dry continuum's factor per channel.
__host__ __device__ inline int extra_floats(Layout lay) {
  return lay.n_h2o + lay.n_o2 + lay.n_o3 + kMaxChannels;
}

// ti^x from l2 = log2(ti): all the powers of a point have the one base
// ti = 300 / T in [0.9, 1.7], so one logarithm serves them.  The rounding of
// l2 and of the product x l2 moves the result by 1.2e-7 |x l2| ln 2, under
// 5e-7 for the largest exponent here (7.5, the self continuum's), beside
// exp2f's own 2 ulp: what powf allows itself (4 ulp).
__device__ __forceinline__ float pow_ti(float l2, float x) {
  return exp2f(x * l2);
}

// What K6's state pass keeps of one O2 line (absorption_spectral.cu,
// `line_state_kernel`), in the same arithmetic, plus k1 = w^2 c^2.
struct O2Line {
  float f0, dnu, c2, dfsq, k1, k2, k3;
};

__device__ __forceinline__ O2Line o2_line(const float* col, int no,
                                          float inv_f0sq, float th1,
                                          float den, float pe2, float ybase) {
  const float f0 = col[0 * no], s300 = col[1 * no], be = col[2 * no];
  const float w300 = col[3 * no], y0 = col[4 * no], y1 = col[5 * no];
  const float g0 = col[6 * no], g1 = col[7 * no];
  const float dnu0 = col[8 * no], dnu1 = col[9 * no];
  const float df = w300 * den;
  const float sn = (s300 * expf(-be * th1)) * inv_f0sq;
  // First-order tables carry g = dnu = 0, which makes these exactly 1 and 0.
  const float dfg = df * (1.0f + pe2 * (g0 + g1 * th1));
  const float dnu = pe2 * (dnu0 + dnu1 * th1);
  // the merged numerator n1 B + n2 A = k2 + q k3
  const float c2 = 2.0f * (f0 + dnu);
  const float dfsq = df * df;
  const float dfg_s = sn * dfg;
  const float yc = (sn * (ybase * (y0 + y1 * th1))) * c2;
  return {f0, dnu, c2, dfsq, dfsq * (c2 * c2),
          dfg_s * (c2 * c2) - 2.0f * dfsq * yc, 2.0f * dfg_s + yc};
}

template <int F>
__global__ void __launch_bounds__(kPointThreads,
                                  F <= 16 ? kPointBlocks : kWideBlocks)
absorption_points_kernel(const float* __restrict__ p,
                         const float* __restrict__ t,
                         const float* __restrict__ rho,
                         const float* __restrict__ lwc,
                         const float* __restrict__ o3, const Channels ch,
                         const float* __restrict__ tables, int table_size,
                         Layout lay, int n, float* __restrict__ out) {
  extern __shared__ float tab[];
  const int nh = lay.n_h2o, no = lay.n_o2, nz = lay.n_o3;
  float* inv_h2o = tab + table_size;      // 1 / fl^2 per H2O line
  float* inv_o2 = inv_h2o + nh;           // 1 / f0^2 per O2 line
  float* inv_o3 = inv_o2 + no;            // 1 / fl^2 per O3 line
  float* fdep = inv_o3 + nz;              // per channel
  for (int j = threadIdx.x; j < table_size; j += blockDim.x)
    tab[j] = tables[j];
  for (int l = threadIdx.x; l < nh + no + nz; l += blockDim.x) {
    const float fl = l < nh ? tables[lay.h2o + l]
                     : l < nh + no ? tables[lay.o2 + (l - nh)]
                                   : tables[lay.o3 + (l - nh - no)];
    inv_h2o[l] = 1.0f / (fl * fl);
  }
  if (threadIdx.x < F) {
    const float r = ch.f[threadIdx.x] / 450.0f;
    fdep[threadIdx.x] =
        tables[kN2Fdep] != 0.0f ? 0.5f + 0.5f / (1.0f + r * r) : 1.0f;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // the channels' span decides the cutoff tests of a line for all of them:
  // |f -+ fl| is convex in f
  float f_lo = ch.f[0], f_hi = ch.f[0];
#pragma unroll
  for (int c = 1; c < F; ++c) {
    f_lo = fminf(f_lo, ch.f[c]);
    f_hi = fmaxf(f_hi, ch.f[c]);
  }

  const float pp = p[i], tt = t[i], rr = rho[i];
  const float ti = 300.0f / tt;
  const float th1 = ti - 1.0f;
  const float pvap = rr * tt / 217.0f;   // vapor partial pressure [hPa]
  const float pda = pp - pvap;           // dry-air partial pressure [hPa]
  const float l2 = log2f(ti);
  const float ti25 = pow_ti(l2, 2.5f);

  // acc_x: the H2O and O3 lines; acc_o2: the O2 lines.  Both lack f^2.
  float acc_x[F], acc_o2[F];
#pragma unroll
  for (int c = 0; c < F; ++c) {
    acc_x[c] = 0.0f;
    acc_o2[c] = 0.0f;
  }

  // ---- H2O lines: VVW with the Clough cutoff, qSD near half where set ----
  const float cut = tab[kCutoff];
  const float cut2 = cut * cut;
  const float h2o_scale = 0.3183e-4f * (3.344e16f * rr);
  const float* gl_x = tab + lay.gl;
  const float* gl_w = gl_x + kGlNodes;
  float two_base = 0.0f;   // 2 sb summed over the lines merged below
  for (int l = 0; l < nh; ++l) {
    const float* col = tab + lay.h2o + l;
    const float fl = col[0 * nh], s1 = col[1 * nh], b2 = col[2 * nh];
    const float w3 = col[3 * nh], x = col[4 * nh], ws = col[5 * nh];
    const float xs = col[6 * nh], w2 = col[7 * nh], ws2 = col[8 * nh];
    const float tix = pow_ti(l2, x);
    const float tixs = pow_ti(l2, xs);
    const float width = w3 * pda * tix + ws * pvap * tixs;
    const float wsq = width * width;
    const float s = s1 * ti25 * expf(b2 * (1.0f - ti));
    const float base = width / (cut2 + wsq);
    const float sn = s * h2o_scale * inv_h2o[l];
    const float sw = sn * width, sb = sn * base;
    const bool sd = (w2 != 0.0f) || (ws2 != 0.0f);
    const bool all_both = fabsf(f_lo - fl) < cut && fabsf(f_hi - fl) < cut
                          && fabsf(f_lo + fl) < cut && fabsf(f_hi + fl) < cut;
    if (all_both && !sd) {
      // sw (A + B) / (A B) in q = d1 d2 + wsq, with c = 2 fl
      const float csq = 4.0f * fl * fl;
      const float k1 = wsq * csq, k2 = sw * csq, k3 = 2.0f * sw;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        const float q = fmaf(ch.f[c] - fl, ch.f[c] + fl, wsq);
        acc_x[c] += ratio(fmaf(q, k3, k2), fmaf(q, q, k1));
      }
      two_base += 2.0f * sb;
      continue;
    }
    // the halves apart, each under its own cutoff test
    float ci2[F];
    bool near_in[F];
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float d1 = ch.f[c] - fl, d2 = ch.f[c] + fl;
      ci2[c] = d1 * d1;
      near_in[c] = fabsf(d1) < cut;
      if (near_in[c]) acc_x[c] -= sb;
      if (fabsf(d2) < cut) acc_x[c] += ratio(sw, fmaf(d2, d2, wsq)) - sb;
    }
    if (sd) {
      const float gamma2 = w2 * pda * tix + ws2 * pvap * tixs;
      const float c0 = width - 1.5f * gamma2;
      for (int k = 0; k < kGlNodes; ++k) {
        const float cr = fmaf(gamma2, gl_x[k], c0);
        const float crw = sn * gl_w[k] * cr;
        const float cr2 = cr * cr;
#pragma unroll
        for (int c = 0; c < F; ++c)
          if (near_in[c]) acc_x[c] += ratio(crw, cr2 + ci2[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < F; ++c)
        if (near_in[c]) acc_x[c] += ratio(sw, ci2[c] + wsq);
    }
  }

  // ---- O3 lines (optional): no cutoff, one merged rational each ----------
  if (o3 != nullptr) {
    const float o3_scale = 0.3183e-4f * (7.2429e12f * pp * o3[i] / tt);
    for (int l = 0; l < nz; ++l) {
      const float* col = tab + lay.o3 + l;
      const float fl = col[0 * nz], s1 = col[1 * nz], b2 = col[2 * nz];
      const float w3 = col[3 * nz], x = col[4 * nz];
      const float width = w3 * pp * pow_ti(l2, x);
      const float wsq = width * width;
      const float s = s1 * ti25 * expf(b2 * (1.0f - ti));
      const float sw = (s * o3_scale * inv_o3[l]) * width;
      const float csq = 4.0f * fl * fl;
      const float k1 = wsq * csq, k2 = sw * csq, k3 = 2.0f * sw;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        const float q = fmaf(ch.f[c] - fl, ch.f[c] + fl, wsq);
        acc_x[c] += ratio(fmaf(q, k3, k2), fmaf(q, q, k1));
      }
    }
  }

  // ---- O2 lines with first- or second-order mixing -----------------------
  // two lines as one rational, n_a / D_a + n_b / D_b =
  // (n_a D_b + n_b D_a) / (D_a D_b).  D is a sum of squares, at most 1e13
  // here, so the product stays in range.  An odd line out goes alone.
  const float b = pow_ti(l2, tab[kO2X]);
  const float den = 0.001f * (pda * b + tab[kH2oFactor] * pvap * ti);
  const float pe2 = den * den;
  const float ybase = tab[kMixingBasisP] != 0.0f ? 0.001f * pp * b : den;
  int l = 0;
  for (; l + 1 < no; l += 2) {
    const O2Line a =
        o2_line(tab + lay.o2 + l, no, inv_o2[l], th1, den, pe2, ybase);
    const O2Line bb = o2_line(tab + lay.o2 + l + 1, no, inv_o2[l + 1], th1,
                              den, pe2, ybase);
#pragma unroll
    for (int c = 0; c < F; ++c) {
      // from the difference d1, never expanded in f
      const float d1a = (ch.f[c] - a.f0) - a.dnu;
      const float d1b = (ch.f[c] - bb.f0) - bb.dnu;
      const float qa = fmaf(d1a, d1a + a.c2, a.dfsq);
      const float qb = fmaf(d1b, d1b + bb.c2, bb.dfsq);
      const float na = fmaf(qa, a.k3, a.k2), da = fmaf(qa, qa, a.k1);
      const float nb = fmaf(qb, bb.k3, bb.k2), db = fmaf(qb, qb, bb.k1);
      acc_o2[c] += ratio(fmaf(na, db, nb * da), da * db);
    }
  }
  for (; l < no; ++l) {
    const O2Line a =
        o2_line(tab + lay.o2 + l, no, inv_o2[l], th1, den, pe2, ybase);
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float d1 = (ch.f[c] - a.f0) - a.dnu;
      const float q = fmaf(d1, d1 + a.c2, a.dfsq);
      acc_o2[c] += ratio(fmaf(q, a.k3, a.k2), fmaf(q, q, a.k1));
    }
  }

  // ---- continua, cloud liquid, the sum (IEEE arithmetic) -----------------
  const float dfnr = tab[kWb300] * den;
  const float theta1 = 1.0f - ti;
  const float eps0 = 77.66f - 103.3f * theta1;
  const float eps1 = 0.0671f * eps0;
  const float con_b = (tab[kCf] * pow_ti(l2, tab[kXcf]) * pda
                       + tab[kCs] * pow_ti(l2, tab[kXcs]) * pvap) * pvap;
  const float k_nr = tab[kNonres] * dfnr / ti;
  const float dfnr2 = dfnr * dfnr;
  const float o2s = tab[kO2Scale] * pda * (ti * ti * ti);
  const float n2k = tab[kN2Coef] * pda * pda * pow_ti(l2, tab[kN2Exp]);
  const float inv_fp = 1.0f / (20.1f * expf(7.88f * theta1));
  const float e01 = eps0 - eps1, e12 = eps1 - 3.52f;
  const float wk = -0.06286f * lwc[i];
#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float fc = ch.f[c];
    const float f2 = fc * fc;
    const float h2o = f2 * ((acc_x[c] - two_base) + con_b);
    const float nonres = k_nr * f2 / (f2 + dfnr2);
    const float o2 = fmaxf(o2s * fmaf(f2, acc_o2[c], nonres), 0.0f);
    const float n2 = n2k * (fdep[c] * f2);
    const float u = fc * inv_fp;
    const float v = u * (1.0f / 39.8f);
    const float ru = 1.0f / fmaf(u, u, 1.0f);
    const float rv = 1.0f / fmaf(v, v, 1.0f);
    const float re = 3.52f + e01 * ru + e12 * rv;
    const float im = -(e01 * (u * ru) + e12 * (v * rv));
    const float aimag = 3.0f * im / ((re + 2.0f) * (re + 2.0f) + im * im);
    out[(size_t)c * n + i] = h2o + o2 + n2 + wk * (aimag * fc);
  }
}

using PointsKernel = void (*)(const float*, const float*, const float*,
                              const float*, const float*, Channels,
                              const float*, int, Layout, int, float*);

}  // namespace

// The instantiation for nf channels in 17..24 and in 25..32, or null, each
// from its own file; absorption.cu casts it back to PointsKernel.
void* absorption_points_f17_24(int nf);
void* absorption_points_f25_32(int nf);

// A case of a switch over nf: the instantiation of F_ channels, untyped.
#define MWR_K1_CASE(F_) \
  case F_:              \
    return reinterpret_cast<void*>(absorption_points_kernel<F_>);
