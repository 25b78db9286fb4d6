// The fast operator's closed-form K from the profiles: the layer-mean
// extinction and its partials, the slant geometry, the adjoint of the
// downwelling RTE on layer-mean extinction and its assembly into K_t and
// K_rho (B, E, C, L), in one launch.
//
// Replaces no TPU kernel: the JAX package leaves
// models/jacobians.py::kmatrix_fast_adjoint_single to XLA.  Added because
// its plain torch version is a prologue (models/jacobians.py::fast_k_inputs,
// some 180 operations, three of them (B, L-1, 72) feature expansions) and
// the adjoint (ops/cuda/fastk.py::fastk_adjoint_reference, 179 operations,
// 94 of which write a full (B, E, C, L-1) float32 tensor or larger), and
// the retrieval calls it once a Gauss-Newton step.  The physics, with
// E_k = g_bot B_k + g_top B_{k+1}, T_k the transmittance from the ground to
// the bottom of layer k, S_k = sum_{j>k} E_j T_j and C = B(T_cosmic) Ttot:
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
// L=180), against inputs of under 4 MB: the profiles z, p, T, rho, LWC
// (B, L) and the weights (72, C).  Each (profile, elevation, channel)
// column is also a chain: a prefix sum up the L-1 layers (the opacity) and a
// suffix sum down (S_k), with an expf and a divide or a series a layer and
// walk.
//
// What the design does about it:
//  * One block per (profile, channel), one warp per elevation (E <= 32).
//    The block's preamble computes what the E warps share, into shared
//    memory: for each level (a thread each) e = rho Rv T, the refractive
//    index n (float64, from the float32 refractivity), B(T), B'(T) and
//    dn/dT, dn/drho through e (ops/thermo.py::rho_to_e,
//    ops/geometry.py::refractive_index, ::refractive_index_partials, chained
//    as fast_k_inputs chains them); for each layer (a thread each) the
//    scaled layer means (models/fast.py::_scaled_means), the two hats of
//    log p that can be non-zero (::_hats), the 18 monomials and their theta
//    and r partials (::_base_features, ::_base_feature_partials), dotted
//    with the two hats' 36 weights of column c (the other 36 of the 72
//    features are zero) as polynomials in theta, in float64 (`extinction`
//    says why), which gives alpha_mid, d_tm and d_rm, gated by the clamp at
//    zero (::extinction_partials).  Column c of w sits in shared memory.
//    The preamble repeats per channel what does not depend on it (the
//    levels, the layer means): some 100 float64 operations a layer beside
//    the walk's expf, divides and 2 E stores.
//  * Each warp forms its own chords and their sensitivities from z and the
//    block's n (ops/geometry.py::chord_lengths' cancellation-safe form, dz
//    from z, and the clamps and zero-gates of ::chord_sensitivities): the
//    Snell invariant, r - r_k and r + r_k and their product in float64,
//    since r = R_E + z in float32 is quantized to half a metre, 3e-5 of the
//    17 km r - r_k comes to at 4.2 degrees; the rest, free of cancellation,
//    in float32.  Walk 1 forms each chunk's chords as it needs them and
//    parks them in shared memory for walk 2 (forming them again there took
//    0.05 ms more a launch at the retrieval's shape, 0.608 against 0.558 ms
//    in a CUDA graph on an H100 SXM at 700 W).
//  * In a warp the lanes run along the layers in chunks of 32, lane j of
//    chunk i on layer 32 i + j, in the two walks of csrc/rte_walk.cuh
//    (shared with K2v): walk 1 up gives T_k and the radiance, walk 2 down
//    S_k as a sum of positive terms from the column top, then W_k and the
//    layer's terms.  Lane j stores level 32 i + j + 1 from its layer's
//    top terms and the bottom terms of the layer above (lane j + 1's, or for
//    lane 31 those carried down from the chunk above), so every store of a
//    K row is 32 consecutive floats, and each level is written once.  Lane 0
//    stores level 0 last, with the rank-one sum.
//  * A chain is 2 x ceil((L-1)/32) chunk steps of a 5-step scan; at the
//    retrieval's shape 14,336 blocks of 10 warps keep the card's SMs full
//    while the stores drain.
//  * The emission factors take K5's 10-term series below d = 0.5
//    (csrc/rte_walk.cuh::emission, shared with K5 and K2v), not the plain float32 version's 3-term
//    series below 0.03: in this walk mirrored in plain torch
//    (ops/cuda/_mirrors.py::fastk_warp_walk), on 16 demo profiles of 180
//    levels, the 3-term series left 2.7e-4 of a row's largest |K_t|
//    between float32 and float64, the 10-term series 1.1e-6.
//
// ops/cuda/_mirrors.py::fastk_preamble is the preamble and the chords in
// plain torch, in this order of operations.

#include <cuda_runtime.h>

#include "rte_walk.cuh"

namespace {

// the Planck and emission helpers, the chord and the walks
using namespace mwr_rte;


// a warp per elevation, at most 32 in a block of 1024 threads
constexpr int kMaxWarps = 32;
// the most shared memory a block may ask for on Hopper
constexpr int kMaxSharedBytes = 232448;
// the regression's monomials and hats of log p (models/fast.py)
constexpr int kMonomials = 18;
constexpr int kHats = 4;
constexpr int kFeatures = kMonomials * kHats;

// The physical constants the plain version takes from the port's
// constants/physics.py and ops/geometry.py, as the wrapper passes them,
// rounded to float32 where the plain float32 version rounds them.
struct Constants {
  float hk_ghz, t_cosmic, rv, k1, k2, k3, k2_minus_k1, two_k3;
  double earth_radius;
};

// torch.clamp(., 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

// Hat j of log p (models/fast.py::_hats): knot[j] its knot, knot[4 + j] and
// knot[8 + j] its lower and upper neighbours.
__device__ __forceinline__ float hat(float lp, const float* knot, int j) {
  const float k = knot[j], lo = knot[kHats + j], hi = knot[2 * kHats + j];
  return lp <= k ? clamp01((lp - lo) / (k - lo))
                 : clamp01((hi - lp) / (hi - k));
}

struct Extinction {
  float alpha, d_t, d_r;
};

// sum_n c[n] theta^n and its theta derivative sum_n n c[n] theta^(n-1),
// n = 0..N-1, by Horner's rule in float64.
template <int N>
__device__ __forceinline__ void poly(const float* c, double th, double& v,
                                     double& dv) {
  v = c[N - 1];
  dv = (N - 1) * (double)c[N - 1];
#pragma unroll
  for (int n = N - 2; n >= 1; --n) {
    v = fma(v, th, (double)c[n]);
    dv = fma(dv, th, n * (double)c[n]);
  }
  v = fma(v, th, (double)c[0]);
}

// The regression's layer-mean extinction of one layer and channel and its
// partials in the layer-mean T and rho (models/fast.py::extinction_partials)
// from the layer means pm [hPa], tm [K], rm [g/m^3], lm [g/m^3], the knots
// and the channel's column w (72,) of the weights, feature b * 18 + j being
// hat b times monomial j.  The monomials are p^2, r p, r^2 and w times
// powers of theta, and p theta^3, so for each of the two hats around log p
// (the others are zero there) each group's weights make a polynomial in
// theta, taken with its derivative by Horner's rule; the theta partial is
// scaled by dtheta/dT and the r partial by dr/drho at the end.  The hats
// are float32, as the plain float32 version forms them; the rest is float64
// and rounded once: the weights' signed terms reach 300 times the
// extinction, so float32 monomials left 1.2e-5 of a field's largest value
// in alpha_mid and 1.3e-3 of a row's largest |K_rho| at 58 GHz
// (ops/cuda/_mirrors.py, 16 demo profiles of 180 levels).
__device__ __forceinline__ Extinction extinction(double pm, double tm,
                                                 double rm, double lm,
                                                 const float* knot,
                                                 const float* w) {
  const float lp = logf(clamp_min((float)pm, 1e-3f));
  // the hats other than i0 and i0 + 1 are zero at lp
  const int i0 = (lp > knot[1]) + (lp > knot[2]);
  const double ps = pm * 1e-3, th = 300.0 / tm, r = rm * 0.1;
  double a = 0.0, at = 0.0, ar = 0.0;
#pragma unroll 1
  for (int q = 0; q < 2; ++q) {
    const float* wq = w + (i0 + q) * kMonomials;
    double o2, d_o2, h2o, d_h2o, self, d_self, liq, d_liq;
    poly<6>(wq, th, o2, d_o2);         // O2 band p^2 theta^0..5
    poly<5>(wq + 6, th, h2o, d_h2o);   // H2O lines r p theta^0..4
    poly<3>(wq + 11, th, self, d_self);  // self continuum r^2 theta^0..2
    poly<3>(wq + 14, th, liq, d_liq);  // liquid w theta^0..2
    const double dry = wq[17] * th * th;  // dry continuum p theta^3
    const double h = hat(lp, knot, i0 + q);
    a = fma(h, ps * ps * o2 + r * ps * h2o + r * r * self + lm * liq
                   + ps * dry * th, a);
    at = fma(h, ps * ps * d_o2 + r * ps * d_h2o + r * r * d_self
                    + lm * d_liq + 3.0 * ps * dry, at);
    ar = fma(h, ps * h2o + 2.0 * r * self, ar);
  }
  const bool live = a > 0.0;
  const double dth_dt = -(th * th) / 300.0;
  return {a < 0.0 ? 0.0f : (float)a, live ? (float)(at * dth_dt) : 0.0f,
          live ? (float)(ar * 0.1) : 0.0f};
}

// Shared memory of a block, in bytes: n at the L levels and 1 / n_layer of
// the L-1 layers (float64); then floats: column c of w, the knots, z, B,
// B', dn_t, dn_rho at the levels, alpha_mid, d_tm, d_rm of the layers, and
// T_k, ds, dds_dnl, dds_dk of each elevation's layers.
__host__ __device__ __forceinline__ long long shared_bytes(int E, int L) {
  const long long K = L - 1;
  return 8LL * (L + K) +
         4LL * (kFeatures + 3 * kHats + 5LL * L + 3 * K + 4LL * E * K);
}

template <bool kT, bool kRho>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
fastk_adjoint_kernel(
    const float* __restrict__ freqs, const float* __restrict__ knots,
    const float* __restrict__ w, int w_row, int w_col,
    const double* __restrict__ cos_el,
    const float* __restrict__ z, const float* __restrict__ p,
    const float* __restrict__ t, int t_row, const float* __restrict__ rho,
    const float* __restrict__ lwc, int E, int C, int L, Constants cst,
    float* __restrict__ k_t, float* __restrict__ k_rho) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = L - 1;
  double* s_n = reinterpret_cast<double*>(smem);
  double* s_inl = s_n + L;
  float* s_w = reinterpret_cast<float*>(s_inl + K);
  float* s_knot = s_w + kFeatures;
  float* s_z = s_knot + 3 * kHats;
  float* s_b = s_z + L;
  float* s_bp = s_b + L;
  float* s_dnt = s_bp + L;
  float* s_dnr = s_dnt + L;
  float* s_am = s_dnr + L;
  float* s_dtm = s_am + K;
  float* s_drm = s_dtm + K;
  float* s_walk = s_drm + K;  // per elevation: T_k, then ds, dnl, dk

  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const float x = cst.hk_ghz * freqs[c];
  const size_t row0 = (size_t)b * L;
  const float* tb = t + (size_t)b * t_row;

  // ---- the preamble: the (profile, channel)'s levels and layers --------
  for (int f = threadIdx.x; f < kFeatures; f += blockDim.x)
    s_w[f] = w[(size_t)f * w_row + (size_t)c * w_col];
  for (int j = threadIdx.x; j < 3 * kHats; j += blockDim.x)
    s_knot[j] = knots[j];
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float tl = tb[l], pl = p[row0 + l], rl = rho[row0 + l];
    const float e = rl * tl * cst.rv / 1e5f;
    const float refractivity = cst.k1 * (pl - e) / tl + cst.k2 * e / tl +
                               cst.k3 * e / (tl * tl);
    s_n[l] = 1.0 + 1e-6 * (double)refractivity;
    s_z[l] = z[row0 + l];
    s_b[l] = planck(x, tl);
    const float inv_t = 1.0f / tl;
    const float dn_de = 1e-6f * (cst.k2_minus_k1 + cst.k3 * inv_t) * inv_t;
    if (kT) {
      s_bp[l] = planck_dt(x, tl);
      const float dn_dt = -1e-6f *
                          (cst.k1 * (pl - e) + cst.k2 * e +
                           cst.two_k3 * e * inv_t) *
                          inv_t * inv_t;
      s_dnt[l] = dn_dt + dn_de * (rl * cst.rv / 1e5f);
    }
    if (kRho) s_dnr[l] = dn_de * (tl * cst.rv / 1e5f);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_inl[k] = 1.0 / (0.5 * (s_n[k] + s_n[k + 1]));
    const size_t at = row0 + k;
    const Extinction ex = extinction(
        0.5 * ((double)p[at] + p[at + 1]), 0.5 * ((double)tb[k] + tb[k + 1]),
        0.5 * ((double)rho[at] + rho[at + 1]),
        0.5 * ((double)lwc[at] + lwc[at + 1]), s_knot, s_w);
    s_am[k] = ex.alpha;
    if (kT) s_dtm[k] = ex.d_t;
    if (kRho) s_drm[k] = ex.d_r;
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int e = threadIdx.x / kLanes;
  const size_t be = (size_t)b * E + e;
  float* tr = s_walk + (size_t)e * 4 * K;  // T_k
  float* c_ds = tr + K;
  float* c_dnl = c_ds + K;
  float* c_dk = c_dnl + K;
  const double r0 = cst.earth_radius + (double)s_z[0];
  const double snell = s_n[0] * r0 * cos_el[e];
  const float r0cos = (float)(r0 * cos_el[e]);
  const size_t row = (be * C + c) * L;

  // ---- walk 1, up: the chords, T_k and the radiance ----
  float tau;
  const float atm = walk_up(K, lane, s_b, tr, tau, [&](int k) {
    const Chord ch = chord(s_z[k], s_z[k + 1], s_inl[k], snell,
                           cst.earth_radius);
    c_ds[k] = ch.ds;
    c_dnl[k] = ch.dnl;
    c_dk[k] = ch.dk;
    return s_am[k] * ch.ds;
  });
  const float ctt = planck(x, cst.t_cosmic) * expf(-tau);
  const float dtb_dr = inverse_planck_db(x, atm + ctt);

  // ---- walk 2, down: S_k, W_k and K level by level ----
  // the bottom terms of the lowest layer of the chunk above
  float up_t = 0.0f, up_r = 0.0f, up_g = 0.0f, up_p = 0.0f;
  float snell_sum = 0.0f;  // this lane's layers' g_ds dk
  walk_down(K, lane, s_b, tr, ctt, [&](int k) { return s_am[k] * c_ds[k]; },
            [&](int k, bool on, const Down& dn) {
    // the layer's bottom terms (level k) and top terms (level k + 1)
    float own_t = 0.0f, own_r = 0.0f, own_g = 0.0f, own_p = 0.0f;
    float top_p = 0.0f;
    if (on) {
      const float g_mid = dtb_dr * dn.w_k * c_ds[k];
      const float g_ds = dtb_dr * dn.w_k * s_am[k];
      own_g = 0.5f * g_ds * c_dnl[k];
      snell_sum += g_ds * c_dk[k];
      if (kT) {
        own_t = 0.5f * g_mid * s_dtm[k];
        own_p = dtb_dr * dn.g.g_bot * dn.t_below;
        top_p = dtb_dr * dn.g.g_top * dn.t_below;
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
  });
  const float s = warp_sum(snell_sum);
  if (lane == 0) {
    const float geo = up_g + s * r0cos;
    if (kT) k_t[row] = (up_t + geo * s_dnt[0]) + up_p * s_bp[0];
    if (kRho) k_rho[row] = up_r + geo * s_dnr[0];
  }
}

struct Inputs {
  const float *freqs, *knots, *w;
  int w_row, w_col;
  const double* cos_el;
  const float *z, *p, *t;
  int t_row;
  const float *rho, *lwc;
};

template <bool kT, bool kRho>
int launch(int B, int E, int C, int L, size_t bytes, cudaStream_t s,
           const Inputs& in, const Constants& cst, float* k_t,
           float* k_rho) {
  const auto kernel = fastk_adjoint_kernel<kT, kRho>;
  if (bytes > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  kernel<<<B * C, E * kLanes, bytes, s>>>(
      in.freqs, in.knots, in.w, in.w_row, in.w_col, in.cos_el, in.z, in.p,
      in.t, in.t_row, in.rho, in.lwc, E, C, L, cst, k_t, k_rho);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K_t and K_rho (B, E, C, L) of the fast operator, float32 on the device,
// from the profiles z [m], p [hPa], rho [g/m^3], lwc [g/m^3] (B, L) and
// t [K] (B, L) with rows t_row floats apart, the weights w (72, C) with
// rows w_row and columns w_col floats apart, the knots of the hats of log p
// (4 knots, their 4 lower and 4 upper neighbours), cos(elevation) (E,) in
// float64 and the C channel frequencies [GHz].  hk_ghz, t_cosmic, rv and earth_radius are
// constants/physics.py's HK_GHZ, T_COSMIC, RV and EARTH_RADIUS, k1..k3
// ops/geometry.py's Rueeger coefficients.  A null k_t (k_rho) leaves out its
// rows.  Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mwr_fastk_adjoint(const float* freqs, const float* knots,
                                 const float* w, int w_row, int w_col,
                                 const double* cos_el,
                                 const float* z, const float* p,
                                 const float* t, int t_row,
                                 const float* rho, const float* lwc, int B,
                                 int E, int C, int L, float hk_ghz,
                                 float t_cosmic, double rv,
                                 double earth_radius, double k1, double k2,
                                 double k3, float* k_t, float* k_rho,
                                 void* stream) {
  if (B < 1 || E < 1 || E > kMaxWarps || C < 1 || L < 2 || t_row < L ||
      (long long)B * C > 0x7fffffffLL || (!k_t && !k_rho) ||
      w_row < 0 || w_col < 0 || shared_bytes(E, L) > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const size_t bytes = (size_t)shared_bytes(E, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in{freqs, knots, w, w_row, w_col, cos_el,
                  z,     p,     t, t_row, rho,   lwc};
  const Constants cst{hk_ghz,          t_cosmic,         (float)rv,
                      (float)k1,       (float)k2,        (float)k3,
                      (float)(k2 - k1), (float)(2.0 * k3), earth_radius};
  if (k_t && k_rho)
    return launch<true, true>(B, E, C, L, bytes, s, in, cst, k_t, k_rho);
  if (k_t) return launch<true, false>(B, E, C, L, bytes, s, in, cst, k_t,
                                      k_rho);
  return launch<false, true>(B, E, C, L, bytes, s, in, cst, k_t, k_rho);
}
