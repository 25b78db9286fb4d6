// K-matrix rows of the downwelling RTE: the closed-form adjoint dTB/dalpha
// times an absorption tangent field, plus the Planck and refraction-geometry
// direct terms, assembled into K (E, F, L, B) for one or two variables.
//
// Replaces the TPU kernels
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/adjoint_kernel.py
//   ::kmatrix_assembled_lb (which = t, rho, lwc) and
//   ::kmatrix_assembled_rho_lwc_lb (k_rho and k_lwc from one shared core),
//   both with the body _build_kernel.
// The physics is that of ops/rte.py::downwelling_tb_adjoint followed by the
// assembly of models/jacobians.py::kmatrix_batch_fast: with E_k = g_bot B_k +
// g_top B_{k+1}, T_k the transmittance from the ground to the bottom of
// layer k, S_k = sum_{j>k} E_j T_j and C = B(T_cosmic) Ttot,
//   W_k   = E'_k T_k - S_k - C,
//   K[l]  = dtb/dR [ (W ds)/2 of layers l-1, l ] * dalpha[l]
//         + dtb/dR (g_bot_l T_l B'_l + g_top_{l-1} T_{l-1} B'_l)    (t only)
//         + 0.5 (A_{l-1} + A_l) dn[l],  A_k = dtb/dR W_k alpha_mid_k dds_dnl_k
//         + [l = 0] s * r0cos * dn[0],  s = sum_k dtb/dR W_k alpha_mid_k dds_dk_k
// (the geometry terms for t and rho only).
//
// What bounds it on Hopper: latency.  Each thread walks 2 (L-1) layers in
// sequence, with about four transcendentals per layer; at the HATPRO K-matrix
// shape (E=10, F=14, B=256) that is 35,840 threads, some 8 warps per SM, so
// the dependent chains and the L2 round trips are not hidden.  The output,
// 4 E F L B bytes per variable (25.8 MB at that shape), is the only large
// stream.
//
// What the design does about it:
//  * One thread per (elevation, channel, profile), profile fastest, as in
//    csrc/rte.cu: every load of alpha/da[f, l, b], ds/dds[e, k, b] and
//    T/dn[l, b], and every store of K[e, f, l, b], is coalesced.
//  * A forward walk accumulates the cumulative opacity as a running fp32 sum
//    (the TPU's triangular-matrix prefix scan is not needed), the
//    atmospheric radiance and the column transmittance, hence dtb/dR.
//  * A backward walk from the column top accumulates the strict suffix sum
//    S_k directly.  S_k = atm - prefix_k cancels catastrophically near the
//    top, where S_k is small; the direct sum of the positive E_j T_j keeps
//    its error relative.
//  * The walk down needs T_k = exp(-tau below layer k); the forward walk
//    writes it into the thread's own output column K[e, f, k, b], which the
//    backward walk reads at layer k before it writes level k+1.  The output
//    doubles as the scratch, so the kernel needs no memory of its own and no
//    cancelling reconstruction of tau from the top.
//  * Each level gets its share of the two layers around it through a
//    one-layer carry, so every level of K is stored once; level 0, the last
//    written, also takes the rank-one Snell-invariant column.
//  * The variable is a template parameter (Planck term, geometry term, a
//    second output for k_lwc), so one body serves t, rho, lwc and rho+lwc.

#include <cuda_runtime.h>

namespace {

// Below this opacity the emission factors take their Taylor series (see
// `emission`).
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

template <bool kPlanck, bool kGeo, bool kTwo>
__global__ void kmatrix_kernel(
    const float* __restrict__ freqs, const float* __restrict__ alpha,
    const float* __restrict__ da, const float* __restrict__ da2,
    const float* __restrict__ ds, const float* __restrict__ t,
    const float* __restrict__ dnl, const float* __restrict__ dk,
    const float* __restrict__ dn, const float* __restrict__ r0cos, int E,
    int F, int L, int B, float hk_ghz, float t_cosmic, float* out,
    float* __restrict__ out2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)E * F * B) return;
  const int b = (int)(idx % B);
  const int ef = (int)(idx / B);
  const int f = ef % F;
  const int e = ef / F;
  const int K = L - 1;

  const float x = hk_ghz * freqs[f];
  const float* a = alpha + (size_t)f * L * B + b;
  const float* tan1 = da + (size_t)f * L * B + b;
  const float* tan2 = kTwo ? da2 + (size_t)f * L * B + b : nullptr;
  const float* dsr = ds + (size_t)e * K * B + b;
  const float* tl = t + b;
  float* o = out + (size_t)ef * L * B + b;
  float* o2 = kTwo ? out2 + (size_t)ef * L * B + b : nullptr;

  // ---- forward walk: tau, radiance, column transmittance ----
  float ctau = 0.0f;
  float atm = 0.0f;
  float a_bot = a[0];
  float b_bot = planck(x, tl[0]);
  for (int k = 0; k < K; ++k) {
    const size_t top = (size_t)(k + 1) * B;
    const float a_top = a[top];
    const float d = 0.5f * (a_bot + a_top) * dsr[(size_t)k * B];
    const float t_below = expf(-ctau);
    o[(size_t)k * B] = t_below;  // scratch, read back by the walk down
    ctau += d;
    const float b_top = planck(x, tl[top]);
    const Emission g = emission<false>(d);
    atm += (g.g_bot * b_bot + g.g_top * b_top) * t_below;
    a_bot = a_top;
    b_bot = b_top;
  }
  const float ctt = planck(x, t_cosmic) * expf(-ctau);
  const float dtb_dr = inverse_planck_db(x, atm + ctt);

  // ---- backward walk: suffix sum, W, and K level by level ----
  float suffix = 0.0f;       // S_k = sum_{j>k} E_j T_j
  float carry_alpha = 0.0f;  // (W ds)/2 of layer k+1, for level k+1
  float carry_planck = 0.0f;
  float carry_geo = 0.0f;
  float s_k = 0.0f;          // Snell-invariant sum over all layers
  float a_top = a[(size_t)K * B];
  float b_top = planck(x, tl[(size_t)K * B]);
  float bp_top = kPlanck ? planck_dt(x, tl[(size_t)K * B]) : 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    const size_t bot = (size_t)k * B;
    const size_t top = bot + B;
    const float a_bot_k = a[bot];
    const float amid = 0.5f * (a_bot_k + a_top);
    const float dsk = dsr[bot];
    const float d = amid * dsk;
    const float t_below = o[bot];
    const float b_bot_k = planck(x, tl[bot]);
    const Emission g = emission<true>(d);

    const float w = (g.dg_bot * b_bot_k + g.dg_top * b_top) * t_below
                    - suffix - ctt;
    suffix += (g.g_bot * b_bot_k + g.g_top * b_top) * t_below;
    const float half = 0.5f * dtb_dr * w * dsk;

    // level k+1 is complete: layer k adds its top share to the carry from
    // layer k+1
    const float lev_alpha = carry_alpha + half;
    float k_top = lev_alpha * tan1[top];
    carry_alpha = half;
    float bp_bot = 0.0f;
    if (kPlanck) {
      bp_bot = planck_dt(x, tl[bot]);
      k_top += carry_planck + dtb_dr * g.g_top * t_below * bp_top;
      carry_planck = dtb_dr * g.g_bot * t_below * bp_bot;
    }
    if (kGeo) {
      const float g_ds = dtb_dr * w * amid;
      const float half_geo = 0.5f * g_ds * dnl[(size_t)e * K * B + bot + b];
      k_top += (carry_geo + half_geo) * dn[top + b];
      carry_geo = half_geo;
      s_k += g_ds * dk[(size_t)e * K * B + bot + b];
    }
    o[top] = k_top;
    if (kTwo) o2[top] = lev_alpha * tan2[top];

    a_top = a_bot_k;
    b_top = b_bot_k;
    bp_top = bp_bot;
  }

  // level 0: the bottom share of layer 0, and the rank-one column
  float k0 = carry_alpha * tan1[0];
  if (kPlanck) k0 += carry_planck;
  if (kGeo) k0 += (carry_geo + s_k * r0cos[(size_t)e * B + b]) * dn[b];
  o[0] = k0;
  if (kTwo) o2[0] = carry_alpha * tan2[0];
}

}  // namespace

// Assembled K (E, F, L, B) of one variable, or of two sharing one adjoint
// core, all float32 on the device.  mode: 0 lwc (absorption tangent only),
// 1 rho (+ geometry), 2 t (+ Planck + geometry), 3 rho and lwc (out = k_rho,
// out2 = k_lwc from da2).  dnl, dk, dn and r0cos may be null in mode 0, da2
// and out2 outside mode 3.  Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int mwr_kmatrix_lb(int mode, const float* freqs,
                              const float* alpha, const float* da,
                              const float* da2, const float* ds,
                              const float* t, const float* dnl,
                              const float* dk, const float* dn,
                              const float* r0cos, int E, int F, int L, int B,
                              float hk_ghz, float t_cosmic, float* out,
                              float* out2, void* stream) {
  if (E < 1 || F < 1 || L < 2 || B < 1 || mode < 0 || mode > 3)
    return cudaErrorInvalidValue;
  constexpr int kThreads = 128;
  const long long n = (long long)E * F * B;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MWR_ARGS                                                           \
  freqs, alpha, da, da2, ds, t, dnl, dk, dn, r0cos, E, F, L, B, hk_ghz,    \
      t_cosmic, out, out2
  switch (mode) {
    case 0:
      kmatrix_kernel<false, false, false><<<blocks, kThreads, 0, s>>>(MWR_ARGS);
      break;
    case 1:
      kmatrix_kernel<false, true, false><<<blocks, kThreads, 0, s>>>(MWR_ARGS);
      break;
    case 2:
      kmatrix_kernel<true, true, false><<<blocks, kThreads, 0, s>>>(MWR_ARGS);
      break;
    case 3:
      kmatrix_kernel<false, true, true><<<blocks, kThreads, 0, s>>>(MWR_ARGS);
      break;
  }
#undef MWR_ARGS
  return static_cast<int>(cudaGetLastError());
}
