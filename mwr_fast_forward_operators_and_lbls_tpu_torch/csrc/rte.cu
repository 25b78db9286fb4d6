// The multi-elevation downwelling RTE over level absorption (F, L, B) ->
// brightness temperature, total opacity and mean radiating temperature
// (E, F, B), and optionally the ground-to-level transmittance (E, F, L, B),
// in two modes of one kernel body:
//  * K2, refraction-bent slant paths and the RTE fused: the chords come from
//    heights and refractive indices (L, B).  Replaces the TPU kernel
//      mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/rte_kernel.py
//      ::forward_lb_fused (body _build_geo_kernel); the physics is that of
//    ops/geometry.py::slant_path_lengths_lb followed by
//    ops/rte.py::downwelling_tb_lb_multi (or ..._from_alpha_mid).
//  * K3, the RTE on given slant paths ds (E, L-1, B) [km].  Replaces
//      rte_kernel.py::downwelling_lb_fused (body _build_kernel); the physics
//    is that of ops/rte.py::downwelling_tb_lb_multi (or ..._from_alpha_mid).
// Both: trapezoidal layer opacities, linear-in-tau source with the 3-term
// series below an opacity of 0.03, cosmic background, Planck inversion.
//
// What bounds it on Hopper: one expf per (layer, elevation, channel,
// profile) for the cumulative transmittance, plus the Planck expm1f per
// level, and, when it is asked for, the 4 x E x F x L x B byte write of
// trans_level (103 MB at the HATPRO scan shape).  K2's inputs are small and
// are re-read from L2 by the E x F threads of each profile; K3 on the
// spectral path streams alpha once (189 MB for an 8192-frequency chunk of
// 32 x 180 levels).
//
// What the design does about it:
//  * One thread per (elevation, channel, profile), profile fastest, so every
//    load of alpha[f, l, b], ds[e, l, b] and z/n/T[l, b] and every store is
//    coalesced.  That is E x F x B = 143,360 threads at the HATPRO scan
//    shape and 262,144 for a spectral chunk; B need not be a multiple of
//    anything.
//  * Each thread walks the layers in order and keeps the cumulative opacity
//    as a running fp32 sum; this replaces the TPU's triangular-matrix scan.
//  * The layer's own transmittance comes from two consecutive cumulative
//    ones (trans_below - e^-ctau), so a layer costs one expf.
//  * K2 recomputes the chord per channel: two sqrtf and a divide per layer
//    beside the exponentials already paid, with no shared state between
//    threads.  K3 reads ds[e, l, b] in its place; the mode is a template
//    parameter, so neither pays for the other's branch.
//  * Planck and its inverse use expm1f and log1pf.

#include <cuda_runtime.h>

namespace {

constexpr float kSmallDtau = 0.03f;  // fp32 series threshold of ops/rte.py

__device__ __forceinline__ float planck(float x, float t) {
  return x / expm1f(x / t);
}

__device__ __forceinline__ float inverse_planck(float x, float b) {
  return x / log1pf(x / b);
}

// kGivenPaths false: K2, chords from z, nr and cos_el (ds unused);
// kGivenPaths true: K3, chords read from ds (z, nr and cos_el unused).
template <bool kGivenPaths>
__global__ void downwelling_kernel(const float* __restrict__ cos_el,
                                   const float* __restrict__ freqs,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ z,
                                   const float* __restrict__ nr,
                                   const float* __restrict__ ds,
                                   const float* __restrict__ t, int E, int F,
                                   int L, int B, int alpha_is_mid,
                                   float hk_ghz, float t_cosmic,
                                   float earth_radius,
                                   float* __restrict__ tb,
                                   float* __restrict__ tau,
                                   float* __restrict__ tmr,
                                   float* __restrict__ trans) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)E * F * B) return;
  const int b = (int)(idx % B);
  const int ef = (int)(idx / B);
  const int f = ef % F;
  const int e = ef / F;

  const float x = hk_ghz * freqs[f];
  const int l_in = alpha_is_mid ? L - 1 : L;
  const float* a = alpha + (size_t)f * l_in * B + b;
  float* trow = trans ? trans + (size_t)ef * L * B + b : nullptr;

  // K2's chord state; K3 reads its chords from this elevation's ds rows
  float z_bot = 0.0f, r_bot = 0.0f, n_bot = 0.0f, k = 0.0f;
  const float* ds_row = nullptr;
  if constexpr (kGivenPaths) {
    ds_row = ds + (size_t)e * (L - 1) * B + b;
  } else {
    z_bot = z[b];
    r_bot = earth_radius + z_bot;
    n_bot = nr[b];
    k = n_bot * r_bot * cos_el[e];  // Snell invariant [m]
  }
  float b_bot = planck(x, t[b]);
  float a_bot = alpha_is_mid ? 0.0f : a[0];

  float ctau = 0.0f;
  float trans_below = 1.0f;
  float atm = 0.0f;
  if (trow) trow[0] = 1.0f;

  for (int l = 0; l < L - 1; ++l) {
    const size_t top = (size_t)(l + 1) * B + b;
    float ds_l;
    if constexpr (kGivenPaths) {
      ds_l = ds_row[(size_t)l * B];
    } else {
      const float z_top = z[top];
      const float n_top = nr[top];
      const float r_top = earth_radius + z_top;

      const float rk = k / (0.5f * (n_bot + n_top));
      const float seg_top = sqrtf(fmaxf((r_top - rk) * (r_top + rk), 0.0f));
      const float seg_bot = sqrtf(fmaxf((r_bot - rk) * (r_bot + rk), 0.0f));
      // dz from z: the Earth radius would quantize it in fp32
      ds_l = (z_top - z_bot) * (r_top + r_bot)
             / fmaxf(seg_top + seg_bot, 1.0f) * 1e-3f;
      z_bot = z_top;
      r_bot = r_top;
      n_bot = n_top;
    }

    float a_mid;
    if (alpha_is_mid) {
      a_mid = a[(size_t)l * B];
    } else {
      const float a_top = a[top - b];
      a_mid = 0.5f * (a_bot + a_top);
      a_bot = a_top;
    }
    const float d = a_mid * ds_l;
    ctau += d;
    const float e_ctau = expf(-ctau);
    const float b_top = planck(x, t[top]);

    // emission reaching the layer bottom, times the transmittance below it:
    // delta = trans_below (1 - e^-d), gtop_tb = trans_below g_top
    float delta, gtop_tb;
    if (d < kSmallDtau) {
      const float tbd = trans_below * d;
      delta = tbd * (1.0f - d * (0.5f - d * (1.0f / 6.0f)));
      gtop_tb = tbd * (0.5f - d * (1.0f / 3.0f - d * 0.125f));
    } else {
      delta = trans_below - e_ctau;
      gtop_tb = delta / d - e_ctau;
    }
    atm += b_bot * delta + (b_top - b_bot) * gtop_tb;
    if (trow) trow[top - b] = e_ctau;

    trans_below = e_ctau;
    b_bot = b_top;
  }

  const float cosmic0 = planck(x, t_cosmic);
  tb[idx] = inverse_planck(x, atm + cosmic0 * trans_below);
  tau[idx] = ctau;
  tmr[idx] = inverse_planck(x, atm / fmaxf(1.0f - trans_below, 1e-10f));
}

constexpr int kThreads = 256;

template <bool kGivenPaths>
int launch(const float* cos_el, const float* freqs, const float* alpha,
           const float* z, const float* nr, const float* ds, const float* t,
           int E, int F, int L, int B, int alpha_is_mid, float hk_ghz,
           float t_cosmic, float earth_radius, float* tb, float* tau,
           float* tmr, float* trans, void* stream) {
  if (E < 1 || F < 1 || L < 2 || B < 1) return cudaErrorInvalidValue;
  const long long n = (long long)E * F * B;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  downwelling_kernel<kGivenPaths>
      <<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          cos_el, freqs, alpha, z, nr, ds, t, E, F, L, B, alpha_is_mid,
          hk_ghz, t_cosmic, earth_radius, tb, tau, tmr, trans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: tb, tau, tmr (E, F, B) and, unless trans is null, trans (E, F, L, B)
// from cos(elevation) (E,), frequencies (F,), alpha (F, L, B) -- or
// (F, L-1, B) layer means when alpha_is_mid -- and z, n, T (L, B), all
// float32 on the device.  Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int mwr_forward_lb(const float* cos_el, const float* freqs,
                              const float* alpha, const float* z,
                              const float* nr, const float* t, int E, int F,
                              int L, int B, int alpha_is_mid, float hk_ghz,
                              float t_cosmic, float earth_radius, float* tb,
                              float* tau, float* tmr, float* trans,
                              void* stream) {
  return launch<false>(cos_el, freqs, alpha, z, nr, nullptr, t, E, F, L, B,
                       alpha_is_mid, hk_ghz, t_cosmic, earth_radius, tb, tau,
                       tmr, trans, stream);
}

// K3: the same outputs from frequencies (F,), alpha (F, L, B) or
// (F, L-1, B), slant paths ds (E, L-1, B) [km] and T (L, B), all float32 on
// the device.  Returns the CUDA error of the launch.
extern "C" int mwr_downwelling_lb(const float* freqs, const float* alpha,
                                  const float* ds, const float* t, int E,
                                  int F, int L, int B, int alpha_is_mid,
                                  float hk_ghz, float t_cosmic, float* tb,
                                  float* tau, float* tmr, float* trans,
                                  void* stream) {
  return launch<true>(nullptr, freqs, alpha, nullptr, nullptr, ds, t, E, F, L,
                      B, alpha_is_mid, hk_ghz, t_cosmic, 0.0f, tb, tau, tmr,
                      trans, stream);
}
