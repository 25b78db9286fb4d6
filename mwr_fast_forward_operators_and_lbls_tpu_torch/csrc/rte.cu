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
//  * K3 has a second body, `downwelling_staged_kernel`, for the shapes of
//    the spectral path (no trans_level, B a multiple of 4, rows of alpha
//    aligned to 16 bytes, L up to about 650).  The body above keeps one
//    4-byte load of alpha in flight per thread and waits for it in every
//    layer: 8 KB in flight per SM, where 3.35 TB/s at 0.6-0.8 us of latency
//    wants 20 KB or more.  The staged body gives each warp one (elevation,
//    frequency) and 32 profiles, and streams that warp's (L, 32) slab of
//    alpha through its own ring of four 4-layer stages in shared memory with
//    16-byte cp.async copies, three stages (1.5 KB a warp, 48 KB an SM) in
//    flight while it computes on the fourth; a warp waits on its own copy
//    groups and __syncwarp only.  T and ds (L, 32) are loaded to shared
//    memory once per block of 16 frequencies instead of once per thread and
//    layer; the four layers of a stage are unrolled, their exponentials
//    first, and only the running sum of tau chains them.
//  * With the loads out of the way the staged walk is bound by the
//    instructions it executes, and the level's Planck radiance was 40 of its
//    110 a layer: expm1f and an IEEE divide.  `planck_series` takes
//    x / expm1(u), u = x / T, as T (1 - u / 2 + u^2 / 12 - u^4 / 720), seven
//    instructions with the approximate reciprocal, whose rounding of u
//    moves the radiance by x / 2 times 2^-23 at most.  It holds while
//    u < 0.25 (the next term, u^6 / 30240, is under 1e-8 there; at 300 GHz
//    and 60 K u is 0.24), so a warp takes it when its frequency and the
//    block's lowest T say so for the whole column, and walks with expm1f as
//    before otherwise: the choice is made once, outside the layer loop,
//    which then holds no branch on it.  The rest of the walk is the same.
//    Which body runs is decided in `launch` by `staged_takes`; every other
//    call (trans_level, odd B, very long L, an alpha that does not start on
//    a 16-byte boundary) takes the body above.

#include <cuda_runtime.h>

#include <type_traits>

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

// ---- K3 with alpha staged through shared memory ----------------------------

constexpr int kStagedWarps = 16;   // warps per block: one frequency each
constexpr int kStageRows = 4;      // rows (levels or layers) of alpha a stage
constexpr int kStages = 4;         // stages of a warp's ring
constexpr int kLanes = 32;         // profiles per block: one lane each
constexpr int kStageFloats = kStageRows * kLanes;
constexpr size_t kMaxSharedBytes = 227 * 1024;

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Bytes of shared memory of one block: T (L, 32), ds (L-1, 32) and the
// rings of its warps.
size_t staged_shared_bytes(int L) {
  return sizeof(float) * ((size_t)(2 * L - 1) * kLanes
                          + (size_t)kStagedWarps * kStages * kStageFloats);
}

// Planck radiance of a level in K, x / expm1(u) with u = x / t, by its
// series t (1 - u / 2 + u^2 / 12 - u^4 / 720): for u < 0.25 only (see the
// note at the top).
__device__ __forceinline__ float planck_series(float x, float t) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  const float u = x * r;
  const float u2 = u * u;
  const float g = fmaf(u2, fmaf(u2, -1.0f / 720.0f, 1.0f / 12.0f),
                       fmaf(-0.5f, u, 1.0f));
  return t * g;
}

// What a thread carries up the column.
struct WalkState {
  float b_bot, a_bot, ctau, trans_below, atm;
};

// Layers l0 .. l0 + 4 (kFull) or l0 .. rows of one thread's column, from the
// stage's rows of alpha.  First everything that does not wait for the layer
// below, for all rows at once, so that the exponentials and divides of four
// layers overlap: only the running sum of tau chains them.  Then the
// emission sum, layer by layer.
template <bool kMid, bool kFull, bool kSeries>
__device__ __forceinline__ void walk_stage(WalkState& w, const float* stage,
                                           const float* ds_b,
                                           const float* t_b, int l0,
                                           int rows, float x) {
  float d[kStageRows], e_ctau[kStageRows], b_top[kStageRows];
#pragma unroll
  for (int r = 0; r < kStageRows; ++r) {
    const int l = l0 + r;
    if (!kFull && l >= rows) break;
    const float a = stage[r * kLanes];
    d[r] = (kMid ? a : 0.5f * (w.a_bot + a)) * ds_b[l * kLanes];
    w.a_bot = a;
    w.ctau += d[r];
    e_ctau[r] = expf(-w.ctau);
    const float t_top = t_b[(l + 1) * kLanes];
    b_top[r] = kSeries ? planck_series(x, t_top) : planck(x, t_top);
  }
#pragma unroll
  for (int r = 0; r < kStageRows; ++r) {
    if (!kFull && l0 + r >= rows) break;
    // emission reaching the layer bottom, times the transmittance below it
    float delta, gtop_tb;
    if (d[r] < kSmallDtau) {
      const float tbd = w.trans_below * d[r];
      delta = tbd * (1.0f - d[r] * (0.5f - d[r] * (1.0f / 6.0f)));
      gtop_tb = tbd * (0.5f - d[r] * (1.0f / 3.0f - d[r] * 0.125f));
    } else {
      delta = w.trans_below - e_ctau[r];
      gtop_tb = delta / d[r] - e_ctau[r];
    }
    w.atm += w.b_bot * delta + (b_top[r] - w.b_bot) * gtop_tb;
    w.trans_below = e_ctau[r];
    w.b_bot = b_top[r];
  }
}

// Block (x, y, z): profiles [32 x, 32 x + 32), frequencies [16 y, 16 y + 16),
// elevation z.  kMid: alpha holds L-1 layer means, else L levels.
template <bool kMid>
__global__ void __launch_bounds__(kStagedWarps * 32, 2)
downwelling_staged_kernel(const float* __restrict__ freqs,
                          const float* __restrict__ alpha,
                          const float* __restrict__ ds,
                          const float* __restrict__ t, int F, int L, int B,
                          float hk_ghz, float t_cosmic,
                          float* __restrict__ tb, float* __restrict__ tau,
                          float* __restrict__ tmr) {
  extern __shared__ __align__(16) float shared[];
  float* t_s = shared;                         // (L, 32)
  float* ds_s = t_s + (size_t)L * kLanes;      // (L-1, 32)
  float* rings = ds_s + (size_t)(L - 1) * kLanes;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kLanes;
  const int b = b0 + lane;
  const int f = blockIdx.y * kStagedWarps + warp;
  const int e = blockIdx.z;
  const bool live = f < F;                     // the same for a whole warp
  // The staged rows are the L-1 that close a layer each: the layer means, or
  // the levels from 1 up (level 0 is read from device memory below).
  const int rows = L - 1;
  const int n_chunks = (rows + kStageRows - 1) / kStageRows;
  float* ring = rings + (size_t)warp * kStages * kStageFloats;
  const float* level0 = alpha + (size_t)(live ? f : 0) * (kMid ? L - 1 : L) * B
                        + b0;
  const float* slab = kMid ? level0 : level0 + B;

  // Copy chunk k of this warp's slab into its stage and close the group; an
  // empty group keeps the count of groups in step past the last chunk.
  // A lane copies one of the stage's 32 pieces (4 rows of 8 x 16 bytes); a
  // piece past the last row or the last profile is skipped.
  auto fetch = [&](int k) {
    if (live) {
#pragma unroll
      for (int j = 0; j < kStageFloats / 4 / 32; ++j) {
        const int piece = lane + 32 * j;
        const int r = piece >> 3, col = (piece & 7) * 4;
        const int row = k * kStageRows + r;
        if (row < rows && b0 + col < B)
          cp_async_16(ring + (k % kStages) * kStageFloats + r * kLanes + col,
                      slab + (size_t)row * B + col);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) fetch(k);

  // T and this elevation's ds, once for the block's 16 frequencies, and the
  // block's lowest T (positive floats order as their bits do)
  __shared__ int t_min_bits;
  if (threadIdx.x == 0) t_min_bits = __float_as_int(3.0e38f);
  __syncthreads();
  float t_low = 3.0e38f;
  for (int j = threadIdx.x; j < L * kLanes; j += blockDim.x) {
    const int l = j >> 5, bb = b0 + (j & 31);
    const float t_j = bb < B ? t[(size_t)l * B + bb] : 300.0f;
    t_s[j] = t_j;
    t_low = fminf(t_low, t_j);
    if (l < L - 1)
      ds_s[j] = bb < B ? ds[((size_t)e * (L - 1) + l) * B + bb] : 0.0f;
  }
  // a column with T <= 0 takes no series
  atomicMin(&t_min_bits, t_low > 0.0f ? __float_as_int(t_low) : 0);
  __syncthreads();
  if (!live) return;

  const float x = hk_ghz * freqs[f];
  const float a0 = (kMid || b >= B) ? 0.0f : level0[lane];
  // x / T < 0.25 on every level of the block: the same for a whole warp
  const bool series = x < 0.25f * __int_as_float(t_min_bits);
  WalkState w{series ? planck_series(x, t_s[lane]) : planck(x, t_s[lane]), a0,
              0.0f, 1.0f, 0.0f};
  // The walk, with Planck's series or with expm1f: chosen once, outside the
  // loop, so that the unrolled layers of a stage hold no branch on it.
  auto walk = [&](auto series_tag) {
    constexpr bool kSeries = decltype(series_tag)::value;
    for (int k = 0; k < n_chunks; ++k) {
      fetch(k + kStages - 1);
      cp_async_wait<kStages - 1>();   // this lane's copies of chunk k landed
      __syncwarp();                   // and every other lane's
      const float* stage = ring + (k % kStages) * kStageFloats + lane;
      const int l0 = k * kStageRows;
      if (l0 + kStageRows <= rows)
        walk_stage<kMid, true, kSeries>(w, stage, ds_s + lane, t_s + lane, l0,
                                        rows, x);
      else
        walk_stage<kMid, false, kSeries>(w, stage, ds_s + lane, t_s + lane,
                                         l0, rows, x);
      __syncwarp();   // the stage is free for the copy of chunk k + kStages
    }
  };
  if (series) walk(std::true_type{});
  else walk(std::false_type{});

  if (b >= B) return;
  const size_t idx = ((size_t)e * F + f) * B + b;
  const float cosmic0 = planck(x, t_cosmic);
  tb[idx] = inverse_planck(x, w.atm + cosmic0 * w.trans_below);
  tau[idx] = w.ctau;
  tmr[idx] = inverse_planck(x, w.atm / fmaxf(1.0f - w.trans_below, 1e-10f));
}

// Whether K3's staged body takes this call: decided by the shape and, for
// the 16-byte asynchronous copies, the alignment of alpha's first element (a
// tensor's own storage is aligned; a view that starts inside a row may not
// be, and takes the other body).
bool staged_takes(const float* alpha, int E, int F, int L, int B,
                  const float* trans) {
  return trans == nullptr && B % 4 == 0
         && reinterpret_cast<size_t>(alpha) % 16 == 0
         && staged_shared_bytes(L) <= kMaxSharedBytes && E <= 65535
         && (F + kStagedWarps - 1) / kStagedWarps <= 65535;
}

// Let the staged body take `smem` bytes of shared memory a block on the
// current device.  The attribute is the device's own, so it is set before
// every launch: it costs no more than the launch.  Returns the CUDA error.
template <bool kMid>
cudaError_t allow_staged_shared(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      downwelling_staged_kernel<kMid>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(downwelling_staged_kernel<kMid>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool kMid>
int launch_staged(const float* freqs, const float* alpha, const float* ds,
                  const float* t, int E, int F, int L, int B, float hk_ghz,
                  float t_cosmic, float* tb, float* tau, float* tmr,
                  cudaStream_t stream) {
  const size_t smem = staged_shared_bytes(L);
  const cudaError_t err = allow_staged_shared<kMid>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kLanes - 1) / kLanes,
                  (F + kStagedWarps - 1) / kStagedWarps, E);
  downwelling_staged_kernel<kMid><<<grid, kStagedWarps * 32, smem, stream>>>(
      freqs, alpha, ds, t, F, L, B, hk_ghz, t_cosmic, tb, tau, tmr);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMid>
int staged_resident_warps(int L) {
  const size_t smem = staged_shared_bytes(L);
  int blocks = 0;
  cudaError_t err = allow_staged_shared<kMid>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, downwelling_staged_kernel<kMid>, kStagedWarps * 32, smem);
  return err == cudaSuccess ? blocks * kStagedWarps : -static_cast<int>(err);
}

constexpr int kThreads = 256;

template <bool kGivenPaths>
int launch(const float* cos_el, const float* freqs, const float* alpha,
           const float* z, const float* nr, const float* ds, const float* t,
           int E, int F, int L, int B, int alpha_is_mid, float hk_ghz,
           float t_cosmic, float earth_radius, float* tb, float* tau,
           float* tmr, float* trans, void* stream) {
  if (E < 1 || F < 1 || L < 2 || B < 1) return cudaErrorInvalidValue;
  if constexpr (kGivenPaths) {
    if (staged_takes(alpha, E, F, L, B, trans)) {
      cudaStream_t s = static_cast<cudaStream_t>(stream);
      return alpha_is_mid
                 ? launch_staged<true>(freqs, alpha, ds, t, E, F, L, B, hk_ghz,
                                       t_cosmic, tb, tau, tmr, s)
                 : launch_staged<false>(freqs, alpha, ds, t, E, F, L, B,
                                        hk_ghz, t_cosmic, tb, tau, tmr, s);
    }
  }
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
// the device, through the staged body where `staged_takes` the shape and
// through the body shared with K2 otherwise.  Returns the CUDA error of the
// launch.
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

// Warps of K3's staged body resident per SM at L levels (what the occupancy
// calculator says for its registers and shared memory), or minus the CUDA
// error.
extern "C" int mwr_downwelling_staged_resident_warps(int L, int alpha_is_mid) {
  if (L < 2 || staged_shared_bytes(L) > kMaxSharedBytes)
    return -static_cast<int>(cudaErrorInvalidValue);
  return alpha_is_mid ? staged_resident_warps<true>(L)
                      : staged_resident_warps<false>(L);
}
