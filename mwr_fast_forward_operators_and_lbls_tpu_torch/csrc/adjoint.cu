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
// What bounds it on Hopper: latency.  A column (elevation, channel, profile)
// is a chain of dependent layer steps, each with an expf, an expm1f or two,
// IEEE divides and L2 loads.  One thread per column would be 35,840 threads
// at the HATPRO K-matrix shape (E=10, F=14, B=256, L=180), 8.5 warps an SM,
// each walking 2 x 179 steps; on an H100 SXM (700 W) that took 0.25 ms,
// over 1,000 cycles a step and warp with nothing to hide them.  Split over
// the warps of a block as below, a chain is 3 x 23 steps, and the shape's
// 1,120 blocks run as 2.12 waves of 4 blocks an SM: 0.13 ms.  A step is
// still slow: the time of a lone block, one an SM (chip_smoke.py phase 9,
// PERF.md section 6), shows the loads and the divide chain not hidden.  The
// output, 4 E F L B bytes per variable (25.8 MB at that shape), is the only
// large stream.
//
// What the design does about it: the walk of a column is split over the
// warps of a block, which the algebra allows (a prefix sum, two reductions
// and a suffix sum; the rest is local to a layer or to the two layers
// around a level).
//  * One block per (elevation, channel, 32 profiles); lane = profile, so
//    every load of alpha/da[f, l, b], ds/dds[e, k, b] and T/dn[l, b], and
//    every store of K[e, f, l, b], is a 128-byte row.  Lanes past B take
//    no part but in the barriers.
//  * Warp c of C = min(kChunkWarps, L-1) owns the layers [k0_c, k1_c), an
//    even split; a chain is 3 x 23 layer steps at L=180, and the K-matrix
//    shape launches 1,120 blocks of 8 warps.  Each lane exchanges a few
//    floats with its own lane of the other warps, in shared memory, at
//    three barriers:
//    1. Up, the chunk's opacity alone.  Barrier.  The opacity below the
//       chunk and the column's are sums of the chunks' (in chunk order).
//    2. Up from that opacity, the sequential body's forward walk: it parks
//       T_k = exp(-tau below layer k) in the thread's own output row
//       K[e, f, k, b], which walk 3 reads back (the output doubles as the
//       scratch), and sums the chunk's share of the radiance.  Barrier.
//       The radiance, ctt and dtb/dR; the suffix entering the chunk from
//       above, the shares above it summed from the top down: a sum of
//       positive terms, so its error stays relative near the column top,
//       where atm - prefix would cancel.
//    3. Down from that suffix, the sequential body's backward walk: each
//       level gets its share of the two layers around it through a
//       one-layer carry, and every level strictly inside the chunk is
//       stored.  The chunk's top level k1_c is not: its row still holds the
//       T_{k1_c} parked by the chunk above, which reads it at the end of
//       its own walk.  The chunk leaves that level's shares, its carries at
//       the bottom and its part of the Snell sum in shared memory.
//       Barrier.  Each warp stores its top level from its shares and the
//       carries of the chunk above; warp 0 also stores level 0, with the
//       Snell sum of all chunks.
//    Only the order of the sums differs from one sequential walk.
//  * The variable is a template parameter (Planck term, geometry term, a
//    second output for k_lwc), so one body serves t, rho, lwc and rho+lwc,
//    at every shape.

#include <cuda_runtime.h>

#include "rte_walk.cuh"

namespace {

// The Planck and emission helpers (the 10-term emission series below an
// opacity of 0.5 and why) are csrc/rte_walk.cuh's, shared with FK and K2v.
using mwr_rte::Emission;
using mwr_rte::emission;
using mwr_rte::inverse_planck_db;
using mwr_rte::planck;
using mwr_rte::planck_dt;

constexpr int kLanes = 32;
// Warps of a block, each walking one chunk of the layers.  At the K-matrix
// shape on an H100 SXM, 8 ran faster than 4 (PERF.md section 6).
constexpr int kChunkWarps = 8;
// Blocks an SM should hold: 32 warps, at most 64 registers a thread.
constexpr int kMinBlocks = 32 / kChunkWarps;

// What the warps of a block exchange, per chunk and lane.
struct ChunkShared {
  float opacity[kChunkWarps][kLanes];      // walk 1: the chunk's opacity
  float radiance[kChunkWarps][kLanes];     // walk 2: its share of atm
  float top_alpha[kChunkWarps][kLanes];    // walk 3: the shares of its top
  float top_planck[kChunkWarps][kLanes];   //   level
  float top_geo[kChunkWarps][kLanes];
  float carry_alpha[kChunkWarps][kLanes];  // walk 3: its carries at the
  float carry_planck[kChunkWarps][kLanes]; //   bottom
  float carry_geo[kChunkWarps][kLanes];
  float snell[kChunkWarps][kLanes];        // walk 3: its part of s
};

// Store level `row` (an offset of l * B) of K, and of k_lwc, from the
// level's absorption, Planck and geometry shares.
template <bool kPlanck, bool kGeo, bool kTwo>
__device__ __forceinline__ void store_level(
    float* o, float* o2, const float* tan1, const float* tan2,
    const float* dn_b, size_t row, float lev_alpha, float lev_planck,
    float lev_geo) {
  float k = lev_alpha * tan1[row];
  if (kPlanck) k += lev_planck;
  if (kGeo) k += lev_geo * dn_b[row];
  o[row] = k;
  if (kTwo) o2[row] = lev_alpha * tan2[row];
}

template <bool kPlanck, bool kGeo, bool kTwo>
__global__ void __launch_bounds__(kChunkWarps * kLanes, kMinBlocks)
kmatrix_kernel(
    const float* __restrict__ freqs, const float* __restrict__ alpha,
    const float* __restrict__ da, const float* __restrict__ da2,
    const float* __restrict__ ds, const float* __restrict__ t,
    const float* __restrict__ dnl, const float* __restrict__ dk,
    const float* __restrict__ dn, const float* __restrict__ r0cos, int E,
    int F, int L, int B, float hk_ghz, float t_cosmic, float* out,
    float* __restrict__ out2) {
  __shared__ ChunkShared sh;
  const int lane = threadIdx.x % kLanes;
  const int c = threadIdx.x / kLanes;
  const int n_chunks = blockDim.x / kLanes;
  const int groups = (B + kLanes - 1) / kLanes;
  const int ef = blockIdx.x / groups;
  const int b = (blockIdx.x % groups) * kLanes + lane;
  const bool live = b < B;
  const int f = ef % F;
  const int e = ef / F;
  const int K = L - 1;
  const int k0 = (int)((long long)c * K / n_chunks);
  const int k1 = (int)((long long)(c + 1) * K / n_chunks);

  const int bl = live ? b : 0;
  const float x = hk_ghz * freqs[f];
  const float* a = alpha + (size_t)f * L * B + bl;
  const float* tan1 = da + (size_t)f * L * B + bl;
  const float* tan2 = kTwo ? da2 + (size_t)f * L * B + bl : nullptr;
  const float* dsr = ds + (size_t)e * K * B + bl;
  const float* tl = t + bl;
  const float* dn_b = kGeo ? dn + bl : nullptr;
  float* o = out + (size_t)ef * L * B + bl;
  float* o2 = kTwo ? out2 + (size_t)ef * L * B + bl : nullptr;

  // ---- walk 1: the chunk's opacity ----
  float opacity = 0.0f;
  if (live) {
    float a_bot = a[(size_t)k0 * B];
    for (int k = k0; k < k1; ++k) {
      const float a_top = a[(size_t)(k + 1) * B];
      opacity += 0.5f * (a_bot + a_top) * dsr[(size_t)k * B];
      a_bot = a_top;
    }
  }
  sh.opacity[c][lane] = opacity;
  __syncthreads();
  float ctau = 0.0f;    // the opacity below the chunk
  float total = 0.0f;   // the column's
  for (int j = 0; j < n_chunks; ++j) {
    if (j == c) ctau = total;
    total += sh.opacity[j][lane];
  }

  // ---- walk 2: tau, the parked T, the chunk's radiance ----
  float radiance = 0.0f;
  if (live) {
    float a_bot = a[(size_t)k0 * B];
    float b_bot = planck(x, tl[(size_t)k0 * B]);
    for (int k = k0; k < k1; ++k) {
      const size_t top = (size_t)(k + 1) * B;
      const float a_top = a[top];
      const float d = 0.5f * (a_bot + a_top) * dsr[(size_t)k * B];
      const float t_below = expf(-ctau);
      o[(size_t)k * B] = t_below;  // scratch, read back by walk 3
      ctau += d;
      const float b_top = planck(x, tl[top]);
      const Emission g = emission<false>(d);
      radiance += (g.g_bot * b_bot + g.g_top * b_top) * t_below;
      a_bot = a_top;
      b_bot = b_top;
    }
  }
  sh.radiance[c][lane] = radiance;
  __syncthreads();
  float atm = 0.0f;
  for (int j = 0; j < n_chunks; ++j) atm += sh.radiance[j][lane];
  float suffix = 0.0f;  // S_k = sum_{j>k} E_j T_j, entering from above
  for (int j = n_chunks - 1; j > c; --j) suffix += sh.radiance[j][lane];
  const float ctt = planck(x, t_cosmic) * expf(-total);
  const float dtb_dr = inverse_planck_db(x, atm + ctt);

  // ---- walk 3: suffix sum, W, and K level by level ----
  float carry_alpha = 0.0f;  // (W ds)/2 of layer k+1, for level k+1
  float carry_planck = 0.0f;
  float carry_geo = 0.0f;
  float s_k = 0.0f;          // the chunk's part of the Snell-invariant sum
  float top_alpha = 0.0f, top_planck = 0.0f, top_geo = 0.0f;
  if (live) {
    float a_top = a[(size_t)k1 * B];
    float b_top = planck(x, tl[(size_t)k1 * B]);
    float bp_top = kPlanck ? planck_dt(x, tl[(size_t)k1 * B]) : 0.0f;
    for (int k = k1 - 1; k >= k0; --k) {
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

      // level k+1 is complete: layer k adds its top share to the carry
      // from layer k+1
      const float lev_alpha = carry_alpha + half;
      carry_alpha = half;
      float lev_planck = 0.0f, lev_geo = 0.0f, bp_bot = 0.0f;
      if (kPlanck) {
        bp_bot = planck_dt(x, tl[bot]);
        lev_planck = carry_planck + dtb_dr * g.g_top * t_below * bp_top;
        carry_planck = dtb_dr * g.g_bot * t_below * bp_bot;
      }
      if (kGeo) {
        const float g_ds = dtb_dr * w * amid;
        const float half_geo = 0.5f * g_ds * dnl[(size_t)e * K * B + bot + bl];
        lev_geo = carry_geo + half_geo;
        carry_geo = half_geo;
        s_k += g_ds * dk[(size_t)e * K * B + bot + bl];
      }
      if (k + 1 < k1) {
        store_level<kPlanck, kGeo, kTwo>(o, o2, tan1, tan2, dn_b, top,
                                         lev_alpha, lev_planck, lev_geo);
      } else {  // the chunk's top level: its row is the chunk above's T
        top_alpha = lev_alpha;
        top_planck = lev_planck;
        top_geo = lev_geo;
      }
      a_top = a_bot_k;
      b_top = b_bot_k;
      bp_top = bp_bot;
    }
  }
  sh.carry_alpha[c][lane] = carry_alpha;
  sh.carry_planck[c][lane] = carry_planck;
  sh.carry_geo[c][lane] = carry_geo;
  sh.snell[c][lane] = s_k;
  __syncthreads();
  if (!live) return;

  // the chunk's top level, with the carries of the chunk above
  const bool above = c + 1 < n_chunks;
  store_level<kPlanck, kGeo, kTwo>(
      o, o2, tan1, tan2, dn_b, (size_t)k1 * B,
      (above ? sh.carry_alpha[c + 1][lane] : 0.0f) + top_alpha,
      (above ? sh.carry_planck[c + 1][lane] : 0.0f) + top_planck,
      (above ? sh.carry_geo[c + 1][lane] : 0.0f) + top_geo);
  // level 0: the bottom share of layer 0, and the rank-one column
  if (c == 0) {
    float s = 0.0f;
    for (int j = 0; j < n_chunks; ++j) s += sh.snell[j][lane];
    store_level<kPlanck, kGeo, kTwo>(
        o, o2, tan1, tan2, dn_b, 0, carry_alpha, carry_planck,
        kGeo ? carry_geo + s * r0cos[(size_t)e * B + bl] : 0.0f);
  }
}

// Launch one mode, or (query) ask the occupancy calculator for its resident
// warps per SM: the launch's CUDA error, or the warps, or minus the error of
// the query.
template <bool kPlanck, bool kGeo, bool kTwo>
int kmatrix_instance(int blocks, int warps, bool query, cudaStream_t s,
                     const float* freqs, const float* alpha, const float* da,
                     const float* da2, const float* ds, const float* t,
                     const float* dnl, const float* dk, const float* dn,
                     const float* r0cos, int E, int F, int L, int B,
                     float hk_ghz, float t_cosmic, float* out, float* out2) {
  const auto kernel = kmatrix_kernel<kPlanck, kGeo, kTwo>;
  if (query) {
    int per_sm = 0;
    const cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, warps * kLanes, 0);
    return q == cudaSuccess ? per_sm * warps : -static_cast<int>(q);
  }
  kernel<<<blocks, warps * kLanes, 0, s>>>(freqs, alpha, da, da2, ds, t, dnl,
                                           dk, dn, r0cos, E, F, L, B, hk_ghz,
                                           t_cosmic, out, out2);
  return static_cast<int>(cudaGetLastError());
}

int kmatrix(int mode, bool query, const float* freqs, const float* alpha,
            const float* da, const float* da2, const float* ds,
            const float* t, const float* dnl, const float* dk,
            const float* dn, const float* r0cos, int E, int F, int L, int B,
            float hk_ghz, float t_cosmic, float* out, float* out2,
            cudaStream_t s) {
  const int warps = L - 1 < kChunkWarps ? L - 1 : kChunkWarps;
  const long long blocks =
      (long long)E * F * ((B + kLanes - 1) / kLanes);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
#define MWR_ARGS                                                           \
  (int)blocks, warps, query, s, freqs, alpha, da, da2, ds, t, dnl, dk, dn, \
      r0cos, E, F, L, B, hk_ghz, t_cosmic, out, out2
  switch (mode) {
    case 0: return kmatrix_instance<false, false, false>(MWR_ARGS);
    case 1: return kmatrix_instance<false, true, false>(MWR_ARGS);
    case 2: return kmatrix_instance<true, true, false>(MWR_ARGS);
    default: return kmatrix_instance<false, true, true>(MWR_ARGS);
  }
#undef MWR_ARGS
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
  return kmatrix(mode, false, freqs, alpha, da, da2, ds, t, dnl, dk, dn,
                 r0cos, E, F, L, B, hk_ghz, t_cosmic, out, out2,
                 static_cast<cudaStream_t>(stream));
}

// Warps of K5 resident per SM in `mode` at L levels (what the occupancy
// calculator says for its registers and shared memory), or minus the CUDA
// error when the query fails.
extern "C" int mwr_kmatrix_resident_warps(int mode, int L) {
  if (L < 2 || mode < 0 || mode > 3)
    return -static_cast<int>(cudaErrorInvalidValue);
  return kmatrix(mode, true, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, 1,
                 0.0f, 0.0f, nullptr, nullptr, nullptr);
}
