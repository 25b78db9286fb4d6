// The downwelling RTE's derivative helpers and a warp's walk of one column,
// shared by the kernels that differentiate the RTE: K5 (csrc/adjoint.cu)
// takes the Planck and emission helpers; FK (csrc/fastk.cu) and K2v
// (csrc/rte_vjp.cu) take those, the chord and both walks.
//
// With E_k = g_bot B_k + g_top B_{k+1} the emission of layer k reaching its
// bottom, T_k the transmittance from the ground to the bottom of layer k,
// S_k = sum_{j>k} E_j T_j and ctt = B(T_cosmic) Ttot, the radiance at the
// ground is R = sum_k E_k T_k + ctt, and its derivative in the opacity d_k of
// layer k is
//   W_k = dR/dd_k = E'_k T_k - S_k - ctt.
//
// A walk is one warp's: the lanes run along the layers in chunks of 32,
// lane j of chunk i on layer 32 i + j.  Walk 1, up: a shuffle-up scan of the
// chunk's opacities plus the opacity carried from the chunks below gives
// T_k, parked in the warp's own row of shared memory; each lane sums its
// layers' E_k T_k, one tree sum gives the radiance.  Walk 2, down from the
// top chunk: a shuffle-down scan of E_k T_k plus the sum carried from the
// chunks above gives S_k directly, a sum of positive terms from the column
// top (the plain version's atm - cumsum cancels there in float32), then
// W_k.  A chain is 2 x ceil((L-1)/32) chunk steps of a 5-step scan.

#pragma once

#include <cuda_runtime.h>

namespace mwr_rte {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// Below this opacity the emission factors take their Taylor series.
constexpr float kSeriesDtau = 0.5f;

__device__ __forceinline__ float planck(float x, float t) {
  return x / expm1f(x / t);
}

// d planck / dT = u^2 e^u / expm1(u)^2, u = x / T
__device__ __forceinline__ float planck_dt(float x, float t) {
  const float u = x / t;
  const float em = expm1f(u);
  return u * u * (em + 1.0f) / (em * em);
}

// d inverse_planck / dB = x^2 / (B (B + x) log1p(x / B)^2)
__device__ __forceinline__ float inverse_planck_db(float x, float b) {
  const float lg = log1pf(x / b);
  return x * x / (b * (b + x) * lg * lg);
}

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// Linear-in-tau emission weights of a layer of opacity d and, when asked,
// their derivatives in d (ops/rte.py::_emission_factors and
// _emission_factor_derivs):
//   g_top = (1 - (1+d) e^-d) / d,  g_bot = 1 - e^-d - g_top,
//   dg_bot/dd = g_top / d,         dg_top/dd = e^-d - g_top / d.
// The plain version switches from a 3-term series to the closed form at
// d = 0.03, where 1 - (1+d) e^-d keeps only ~1e-4 of its relative precision
// in fp32.  In k_t the Planck term can nearly cancel the absorption term,
// which turned that into 5e-3 errors against float64; so here the series of
// g_top/d = sum_n (-1)^n (n-1)/n! d^(n-2) and of dg_top/dd =
// sum_n (-1)^n (n-1)^2/n! d^(n-2), n = 2..11, run up to d = 0.5 (truncation
// below 1e-9 relative), and the closed form above it loses at most ~1e-6.
struct Emission {
  float g_bot, g_top, dg_bot, dg_top;
};

template <bool kDerivs>
__device__ __forceinline__ Emission emission(float d) {
  Emission g;
  float g_top_over_d;
  float em = 0.0f;
  if (d < kSeriesDtau) {
    g_top_over_d =
        0.5f - d * (1.0f / 3.0f - d * (1.0f / 8.0f - d * (1.0f / 30.0f
        - d * (1.0f / 144.0f - d * (1.0f / 840.0f - d * (1.0f / 5760.0f
        - d * (1.0f / 45360.0f - d * (1.0f / 403200.0f
        - d * (1.0f / 3991680.0f)))))))));
  } else {
    em = expf(-d);
    g_top_over_d = (1.0f - (1.0f + d) * em) / (d * d);
  }
  g.g_top = d * g_top_over_d;
  g.g_bot = -expm1f(-d) - g.g_top;
  if (kDerivs) {
    g.dg_bot = g_top_over_d;
    g.dg_top = d < kSeriesDtau
        ? 0.5f - d * (2.0f / 3.0f - d * (3.0f / 8.0f - d * (2.0f / 15.0f
          - d * (5.0f / 144.0f - d * (1.0f / 140.0f - d * (7.0f / 5760.0f
          - d * (1.0f / 5670.0f - d * (1.0f / 44800.0f
          - d * (1.0f / 399168.0f)))))))))
        : em - g_top_over_d;
  }
  return g;
}

// The sum of v over the warp, as lane 0 holds it after a shuffle-down tree.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// A layer's chord ds [km] and its sensitivities d(ds)/d(n_layer) and
// d(ds)/d(k) [km/m] for the Snell invariant k = n_0 r_0 cos(el) [m], from
// the levels' heights z [m] and the layer's 1 / n_layer:
// ops/geometry.py::chord_lengths and ::chord_sensitivities, with r_k,
// r - r_k, r + r_k and their product in float64 (r = R_E + z in float32 is
// quantized to half a metre, 3e-5 of the 17 km r - r_k comes to at 4.2
// degrees); the rest, free of cancellation, in float32.  A caller that
// reads ds alone leaves the rest to the compiler to drop.
struct Chord {
  float ds, dnl, dk;
};

__device__ __forceinline__ Chord chord(float z_bot, float z_top,
                                       double inv_n_layer, double snell,
                                       double earth_radius) {
  const double r_bot = earth_radius + z_bot, r_top = earth_radius + z_top;
  const double rk = snell * inv_n_layer;
  const float seg_top =
      sqrtf(clamp_min((float)((r_top - rk) * (r_top + rk)), 0.0f));
  const float seg_bot =
      sqrtf(clamp_min((float)((r_bot - rk) * (r_bot + rk)), 0.0f));
  const float span = (z_top - z_bot) * (float)(r_top + r_bot);
  const float denom = seg_top + seg_bot;
  const float denom_c = clamp_min(denom, 1.0f);
  const float inv_top =
      seg_top > 0.0f ? 1.0f / clamp_min(seg_top, 1e-30f) : 0.0f;
  const float inv_bot =
      seg_bot > 0.0f ? 1.0f / clamp_min(seg_bot, 1e-30f) : 0.0f;
  const float rkf = (float)rk, inl = (float)inv_n_layer;
  const float dds_drk =
      denom > 1.0f ? span / (denom_c * denom_c) * rkf * (inv_top + inv_bot)
                   : 0.0f;
  return {span / denom_c * 1e-3f, dds_drk * (-rkf * inl) * 1e-3f,
          dds_drk * inl * 1e-3f};
}

// Walk 1 of one warp's column of K layers, up.  `opacity(k)` gives layer
// k's opacity d_k (and may park what walk 2 reads again); T_k goes to
// tr[k]; b holds the Planck radiance of the K + 1 levels.  Returns the
// radiance sum_k E_k T_k in every lane and the column's opacity in `tau`.
template <typename Opacity>
__device__ __forceinline__ float walk_up(int K, int lane, const float* b,
                                         float* tr, float& tau,
                                         Opacity&& opacity) {
  const int n_chunks = (K + kLanes - 1) / kLanes;
  float carry = 0.0f;     // the opacity of the chunks below
  float radiance = 0.0f;  // this lane's layers' E_k T_k
  for (int i = 0; i < n_chunks; ++i) {
    const int k = i * kLanes + lane;
    const bool on = k < K;
    const float d = on ? opacity(k) : 0.0f;
    float incl = d;
    for (int off = 1; off < kLanes; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (on) {
      const float t_below = expf(-(carry + excl));
      tr[k] = t_below;
      const Emission g = emission<false>(d);
      radiance += (g.g_bot * b[k] + g.g_top * b[k + 1]) * t_below;
    }
    carry += __shfl_sync(kFull, incl, kLanes - 1);
  }
  tau = carry;
  return __shfl_sync(kFull, warp_sum(radiance), 0);
}

// What walk 2 hands a layer: its opacity d, T_k, the emission factors with
// their derivatives and W_k (zero past the last layer).
struct Down {
  float d, t_below, w_k;
  Emission g;
};

// Walk 2 of the same column, down from the top chunk, with the T_k that
// walk 1 parked in tr and ctt = B(T_cosmic) Ttot.  Every lane calls
// `layer(k, on, down)` once a chunk, `on` false past the last layer, so the
// callee may shuffle across the warp; layer k's T_k has been read before,
// so the callee may overwrite tr[k].
template <typename Opacity, typename Layer>
__device__ __forceinline__ void walk_down(int K, int lane, const float* b,
                                          const float* tr, float ctt,
                                          Opacity&& opacity, Layer&& layer) {
  const int n_chunks = (K + kLanes - 1) / kLanes;
  float carry_s = 0.0f;  // S entering the chunk from above
  for (int i = n_chunks - 1; i >= 0; --i) {
    const int k = i * kLanes + lane;
    const bool on = k < K;
    float et = 0.0f, ep = 0.0f;
    Down dn = {0.0f, 0.0f, 0.0f, {0.0f, 0.0f, 0.0f, 0.0f}};
    if (on) {
      dn.d = opacity(k);
      dn.t_below = tr[k];
      dn.g = emission<true>(dn.d);
      et = (dn.g.g_bot * b[k] + dn.g.g_top * b[k + 1]) * dn.t_below;
      ep = (dn.g.dg_bot * b[k] + dn.g.dg_top * b[k + 1]) * dn.t_below;
    }
    float rincl = et;
    for (int off = 1; off < kLanes; off <<= 1) {
      const float y = __shfl_down_sync(kFull, rincl, off);
      if (lane + off < kLanes) rincl += y;
    }
    float rexcl = __shfl_down_sync(kFull, rincl, 1);
    if (lane == kLanes - 1) rexcl = 0.0f;
    dn.w_k = ep - (carry_s + rexcl) - ctt;
    carry_s += __shfl_sync(kFull, rincl, 0);
    layer(k, on, dn);
  }
}

}  // namespace mwr_rte
