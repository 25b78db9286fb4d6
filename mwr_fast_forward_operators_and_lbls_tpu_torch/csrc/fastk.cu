// The fast operator's closed-form K: the adjoint of the downwelling RTE on
// layer-mean extinction and its assembly into K_t and K_rho (B, E, C, L).
//
// Replaces no TPU kernel: the JAX package leaves
// models/jacobians.py::kmatrix_fast_adjoint_single to XLA.  Added because
// its plain torch version (ops/cuda/fastk.py::fastk_adjoint_reference, the
// body of ops/rte.py::downwelling_tb_adjoint_mid and of the assembly) is
// 179 operations, 94 of which write a full (B, E, C, L-1) float32 tensor or
// larger, and the retrieval calls it once a Gauss-Newton step.  The physics, with E_k = g_bot B_k + g_top
// B_{k+1}, T_k the transmittance from the ground to the bottom of layer k,
// S_k = sum_{j>k} E_j T_j and C = B(T_cosmic) Ttot:
//   W_k      = E'_k T_k - S_k - C,
//   g_mid_k  = dtb/dR W_k ds_k,        g_ds_k = dtb/dR W_k alpha_mid_k,
//   K_x[l]   = 0.5 (g_mid_{l-1} dx_{l-1} + g_mid_l dx_l)   (dx = d_tm, d_rm)
//            + dtb/dR (g_top_{l-1} T_{l-1} + g_bot_l T_l) B'_l  (t only)
//            + 0.5 (g_ds_{l-1} dnl_{l-1} + g_ds_l dnl_l) dn_x[l]
//            + [l = 0] sum_k g_ds_k dk_k * r0cos * dn_x[0],
// where dtb/dR is the inverse Planck's slope at the column's radiance.
//
// What bounds it on Hopper: bytes.  Its need is the two float32 K outputs,
// 4 B E C L bytes each (103 MB at the retrieval's B=1024, E=10, C=14,
// L=180), against inputs of a few MB.  Each (profile, elevation, channel)
// column is also a chain: a prefix sum up the L-1 layers (the opacity) and a
// suffix sum down (S_k), with an expf and a divide or a series a layer and
// walk.
//
// What the design does about it:
//  * One block per (profile, channel), one warp per elevation (E <= 32).
//    The block computes B(t_l), B'(t_l), alpha_mid, the partials and dn of
//    its (b, c) once into shared memory; the E warps share them.  Blocks of
//    one profile are neighbours in the grid, so the profile's (B, L-1, C)
//    inputs, read with a stride of C, come from L2.
//  * In a warp the lanes run along the layers in chunks of 32, lane j of
//    chunk i on layer 32 i + j.  Walk 1, up: a shuffle-up scan of the
//    chunk's opacities plus the opacity carried from the chunks below gives
//    T_k, parked in shared memory; each lane sums its layers' E_k T_k, one
//    tree sum gives the radiance.  Walk 2, down from the top chunk: a
//    shuffle-down scan of E_k T_k plus the sum carried from the chunks above
//    gives S_k directly, a sum of positive terms from the column top (the
//    plain version's atm - cumsum cancels there in float32), then W_k and
//    the layer's terms.  Lane j stores level 32 i + j + 1 from its layer's
//    top terms and the bottom terms of the layer above (lane j + 1's, or for
//    lane 31 those carried down from the chunk above), so every store of a
//    K row is 32 consecutive floats, and each level is written once.  Lane 0
//    stores level 0 last, with the rank-one sum.
//  * A chain is 2 x ceil((L-1)/32) chunk steps of a 5-step scan; at the
//    retrieval's shape 14,336 blocks of 10 warps keep the card's SMs full
//    while the stores drain.
//  * The emission factors take K5's 10-term series below d = 0.5
//    (csrc/adjoint.cu::emission), not the plain float32 version's 3-term
//    series below 0.03: in this walk mirrored in plain torch
//    (ops/cuda/_mirrors.py::fastk_warp_walk), on 16 demo profiles of 180
//    levels, the 3-term series left 2.7e-4 of a row's largest |K_t|
//    between float32 and float64, the 10-term series 1.1e-6.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// a warp per elevation, at most 32 in a block of 1024 threads
constexpr int kMaxWarps = 32;
// the most shared memory a block may ask for on Hopper
constexpr int kMaxSharedBytes = 232448;
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

// Linear-in-tau emission weights of a layer of opacity d and, when asked,
// their derivatives in d, as csrc/adjoint.cu::emission forms them:
//   g_top = (1 - (1+d) e^-d) / d,  g_bot = 1 - e^-d - g_top,
//   dg_bot/dd = g_top / d,         dg_top/dd = e^-d - g_top / d,
// with the series of g_top/d = sum_n (-1)^n (n-1)/n! d^(n-2) and of
// dg_top/dd = sum_n (-1)^n (n-1)^2/n! d^(n-2), n = 2..11, below d = 0.5.
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

// Shared memory of a block, in floats: B, B', dn_t, dn_rho at the L
// levels; alpha_mid, d_tm, d_rm of the L-1 layers; T_k of each elevation.
__host__ __device__ __forceinline__ long long shared_floats(int E, int L) {
  return 4LL * L + (3LL + E) * (L - 1);
}

template <bool kT, bool kRho>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
fastk_adjoint_kernel(
    const float* __restrict__ freqs, const float* __restrict__ alpha_mid,
    const float* __restrict__ d_tm, const float* __restrict__ d_rm,
    const float* __restrict__ ds, const float* __restrict__ dnl,
    const float* __restrict__ dk, const float* __restrict__ t, int t_row,
    const float* __restrict__ dn_t, const float* __restrict__ dn_rho,
    const float* __restrict__ r0cos, int E, int C, int L, float hk_ghz,
    float t_cosmic, float* __restrict__ k_t, float* __restrict__ k_rho) {
  extern __shared__ float sh[];
  const int K = L - 1;
  float* s_b = sh;
  float* s_bp = s_b + L;
  float* s_dnt = s_bp + L;
  float* s_dnr = s_dnt + L;
  float* s_am = s_dnr + L;
  float* s_dtm = s_am + K;
  float* s_drm = s_dtm + K;

  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const float x = hk_ghz * freqs[c];

  // ---- the (profile, channel)'s levels and layers, shared by the warps --
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float tl = t[(size_t)b * t_row + l];
    s_b[l] = planck(x, tl);
    if (kT) {
      s_bp[l] = planck_dt(x, tl);
      s_dnt[l] = dn_t[(size_t)b * L + l];
    }
    if (kRho) s_dnr[l] = dn_rho[(size_t)b * L + l];
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const size_t at = ((size_t)b * K + k) * C + c;
    s_am[k] = alpha_mid[at];
    if (kT) s_dtm[k] = d_tm[at];
    if (kRho) s_drm[k] = d_rm[at];
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int e = threadIdx.x / kLanes;
  const size_t be = (size_t)b * E + e;
  const float* dsr = ds + be * K;
  const float* dnlr = dnl + be * K;
  const float* dkr = dk + be * K;
  float* tr = s_drm + K + (size_t)e * K;  // T_k, walk 1 -> walk 2
  const size_t row = (be * C + c) * L;
  const int n_chunks = (K + kLanes - 1) / kLanes;

  // ---- walk 1, up: T_k and the radiance ----
  float carry = 0.0f;     // the opacity of the chunks below
  float radiance = 0.0f;  // this lane's layers' E_k T_k
  for (int i = 0; i < n_chunks; ++i) {
    const int k = i * kLanes + lane;
    const bool on = k < K;
    const float d = on ? s_am[k] * dsr[k] : 0.0f;
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
      radiance += (g.g_bot * s_b[k] + g.g_top * s_b[k + 1]) * t_below;
    }
    carry += __shfl_sync(kFull, incl, kLanes - 1);
  }
  const float atm = __shfl_sync(kFull, warp_sum(radiance), 0);
  const float ctt = planck(x, t_cosmic) * expf(-carry);
  const float dtb_dr = inverse_planck_db(x, atm + ctt);

  // ---- walk 2, down: S_k, W_k and K level by level ----
  float carry_s = 0.0f;  // S entering the chunk from above
  // the bottom terms of the lowest layer of the chunk above
  float up_t = 0.0f, up_r = 0.0f, up_g = 0.0f, up_p = 0.0f;
  float snell = 0.0f;    // this lane's layers' g_ds dk
  for (int i = n_chunks - 1; i >= 0; --i) {
    const int k = i * kLanes + lane;
    const bool on = k < K;
    float et = 0.0f, ep = 0.0f, t_below = 0.0f, d = 0.0f, dsk = 0.0f;
    Emission g = {0.0f, 0.0f, 0.0f, 0.0f};
    if (on) {
      dsk = dsr[k];
      d = s_am[k] * dsk;
      t_below = tr[k];
      g = emission<true>(d);
      et = (g.g_bot * s_b[k] + g.g_top * s_b[k + 1]) * t_below;
      ep = (g.dg_bot * s_b[k] + g.dg_top * s_b[k + 1]) * t_below;
    }
    float rincl = et;
    for (int off = 1; off < kLanes; off <<= 1) {
      const float y = __shfl_down_sync(kFull, rincl, off);
      if (lane + off < kLanes) rincl += y;
    }
    float rexcl = __shfl_down_sync(kFull, rincl, 1);
    if (lane == kLanes - 1) rexcl = 0.0f;
    const float w = ep - (carry_s + rexcl) - ctt;
    carry_s += __shfl_sync(kFull, rincl, 0);

    // the layer's bottom terms (level k) and top terms (level k + 1)
    float own_t = 0.0f, own_r = 0.0f, own_g = 0.0f, own_p = 0.0f;
    float top_p = 0.0f;
    if (on) {
      const float g_mid = dtb_dr * w * dsk;
      const float g_ds = dtb_dr * w * s_am[k];
      own_g = 0.5f * g_ds * dnlr[k];
      snell += g_ds * dkr[k];
      if (kT) {
        own_t = 0.5f * g_mid * s_dtm[k];
        own_p = dtb_dr * g.g_bot * t_below;
        top_p = dtb_dr * g.g_top * t_below;
      }
      if (kRho) own_r = 0.5f * g_mid * s_drm[k];
    }
    // every lane takes part in each shuffle; lane 31 then takes the carry
    const bool last = lane == kLanes - 1;
    const float n_g = __shfl_down_sync(kFull, own_g, 1);
    const float n_t = __shfl_down_sync(kFull, own_t, 1);
    const float n_r = __shfl_down_sync(kFull, own_r, 1);
    const float n_p = __shfl_down_sync(kFull, own_p, 1);
    const float a_g = last ? up_g : n_g;
    const float a_t = last ? up_t : n_t;
    const float a_r = last ? up_r : n_r;
    const float a_p = last ? up_p : n_p;
    if (on) {
      const float geo = own_g + a_g;
      if (kT) {
        float kk = own_t + a_t;
        kk = kk + (top_p + a_p) * s_bp[k + 1];
        k_t[row + k + 1] = kk + geo * s_dnt[k + 1];
      }
      if (kRho) k_rho[row + k + 1] = (own_r + a_r) + geo * s_dnr[k + 1];
    }
    up_g = __shfl_sync(kFull, own_g, 0);
    up_t = __shfl_sync(kFull, own_t, 0);
    up_r = __shfl_sync(kFull, own_r, 0);
    up_p = __shfl_sync(kFull, own_p, 0);
  }
  const float s = warp_sum(snell);
  if (lane == 0) {
    const float geo = up_g + s * r0cos[be];
    if (kT) k_t[row] = (up_t + geo * s_dnt[0]) + up_p * s_bp[0];
    if (kRho) k_rho[row] = up_r + geo * s_dnr[0];
  }
}

template <bool kT, bool kRho>
int launch(int B, int E, int C, int L, size_t bytes, cudaStream_t s,
           const float* freqs, const float* alpha_mid, const float* d_tm,
           const float* d_rm, const float* ds, const float* dnl,
           const float* dk, const float* t, int t_row, const float* dn_t,
           const float* dn_rho, const float* r0cos, float hk_ghz,
           float t_cosmic, float* k_t, float* k_rho) {
  const auto kernel = fastk_adjoint_kernel<kT, kRho>;
  if (bytes > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  kernel<<<B * C, E * kLanes, bytes, s>>>(
      freqs, alpha_mid, d_tm, d_rm, ds, dnl, dk, t, t_row, dn_t, dn_rho,
      r0cos, E, C, L, hk_ghz, t_cosmic, k_t, k_rho);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K_t and K_rho (B, E, C, L) of the fast operator, float32 on the device,
// from alpha_mid, d_tm, d_rm (B, L-1, C), ds, dds_dnl, dds_dk (B, E, L-1),
// t (B, L) with rows t_row floats apart, dn_t, dn_rho (B, L), r0cos (B, E)
// and the C channel frequencies.  A null k_t (k_rho) leaves out its rows,
// and then d_tm and dn_t (d_rm and dn_rho) may be null.  Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int mwr_fastk_adjoint(const float* freqs, const float* alpha_mid,
                                 const float* d_tm, const float* d_rm,
                                 const float* ds, const float* dds_dnl,
                                 const float* dds_dk, const float* t,
                                 int t_row, const float* dn_t,
                                 const float* dn_rho, const float* r0cos,
                                 int B, int E, int C, int L, float hk_ghz,
                                 float t_cosmic, float* k_t, float* k_rho,
                                 void* stream) {
  const long long floats = shared_floats(E, L);
  if (B < 1 || E < 1 || E > kMaxWarps || C < 1 || L < 2 || t_row < L ||
      (long long)B * C > 0x7fffffffLL || (!k_t && !k_rho) ||
      floats * 4 > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const size_t bytes = (size_t)floats * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MWR_ARGS                                                            \
  B, E, C, L, bytes, s, freqs, alpha_mid, d_tm, d_rm, ds, dds_dnl, dds_dk, \
      t, t_row, dn_t, dn_rho, r0cos, hk_ghz, t_cosmic, k_t, k_rho
  if (k_t && k_rho) return launch<true, true>(MWR_ARGS);
  if (k_t) return launch<true, false>(MWR_ARGS);
  return launch<false, true>(MWR_ARGS);
#undef MWR_ARGS
}
