// The multi-elevation downwelling RTE over level absorption (F, L, B) ->
// brightness temperature, total opacity and mean radiating temperature
// (E, F, B), and optionally the ground-to-level transmittance (E, F, L, B),
// for two kernels:
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
// profile) for the cumulative transmittance and the instructions around it
// (some 65 a layer), plus, when it is asked for, the 4 x E x F x L x B byte
// write of trans_level (103 MB at the HATPRO scan shape).  K2's inputs are
// small (10 MB of alpha at the scan shape, re-read from L2 by each
// elevation); K3 on the spectral path streams alpha once (189 MB for an
// 8192-frequency chunk of 32 x 180 levels).
//
// `downwelling_staged_kernel` is the body of both: every call of K2, and K3's
// calls without trans_level on a batch it can copy in 16-byte pieces.
//  * A block takes P profiles, one elevation and a set of frequencies; a
//    lane is one (frequency, profile) of its warp, which holds 32 / P
//    frequencies.  K3: P = 32 and 16 warps, 16 frequencies a block.  K2:
//    P = 16 and up to 8 warps, so 16 channels a block.  The block loads
//    T (L, P) into shared memory once, and the elevation's slant paths ds
//    (L-1, P) beside it: K3 reads them, K2 computes each chord there from z
//    and n, once per (elevation, layer, profile) and block, which is exactly
//    as often as the function needs it while one block holds all the
//    channels (F <= 16; a one-thread-per-column walk recomputes it F times,
//    two square roots and two divides a layer).  Being off the layer loop,
//    the chord is taken in float64: r - r_k hangs on r = R_E + z, which
//    float32 quantizes to half a metre, 3e-5 of the 17 km it comes to at 4.2
//    degrees (TB there 4.6e-4 K from float64, against 2.2e-3 K with float32
//    chords, for 5 % of the kernel's time).
//  * Each warp streams its (L, 32) slab of alpha (its 32 / P frequencies
//    side by side) through its own ring of
//    four 4-layer stages in shared memory with 16-byte cp.async copies,
//    three stages (1.5 KB a warp) in flight while it computes on the fourth;
//    a warp waits on its own copy groups and __syncwarp only.  One 4-byte
//    load a thread and layer, waited for in every layer, keeps 8 KB in
//    flight per SM, where 3.35 TB/s at 0.6-0.8 us of latency wants 20 KB or
//    more.  The four layers of a stage are unrolled, their exponentials
//    first, and only the running sum of tau chains them.  Where the 16-byte
//    pieces would not be aligned (B not a multiple of 4, or a view of alpha
//    that starts off a 16-byte boundary), K2 copies each piece as four
//    4-byte cp.async: the same stages, the same walk and the same numbers,
//    so what a call returns does not depend on where its alpha lies (0.077
//    against 0.067 ms at the HATPRO scan shape).
//  * Each thread walks the layers in order and keeps the cumulative opacity
//    as a running fp32 sum; this replaces the TPU's triangular-matrix scan.
//    The layer's own transmittance comes from two consecutive cumulative
//    ones (trans_below - e^-ctau), so a layer costs one expf.
//  * With the loads out of the way the walk is bound by the instructions it
//    executes, and the level's Planck radiance by expm1f and an IEEE divide
//    was 40 of 110 a layer.  `planck_series` takes x / expm1(u), u = x / T,
//    as T (1 - u / 2 + u^2 / 12 - u^4 / 720), seven instructions with the
//    approximate reciprocal, whose rounding of u moves the radiance by x / 2
//    times 2^-23 at most.  It holds while u < 0.25 (the next term,
//    u^6 / 30240, is under 1e-8 there; at 300 GHz and 60 K u is 0.24), so a
//    warp takes it when its frequency and the block's lowest T say so for
//    the whole column, and walks with expm1f otherwise: the choice is made
//    once, outside the layer loop, which then holds no branch on it.
//  * K2's grid is small: the HATPRO scan (1024 profiles, 10 elevations, 14
//    channels) is 4,480 warps, 34 an SM, so the block's shape decides how
//    evenly they spread.  Blocks of 32 profiles x 14 channels are 320 on
//    132 SMs, three on some and two on the rest, and the busiest set the
//    time (0.081 ms).  Blocks of 16 profiles x 14 channels (7 warps, 37 KB
//    of shared memory at 180 levels, six an SM: 42 warps at 40 registers)
//    are 640, five on most SMs and four on the rest: 0.070 ms.  trans_level,
//    when asked for, is two coalesced 64-byte rows a warp and layer.  K3
//    keeps 32 profiles, 16 warps and two blocks an SM.
//  * A layer's emission factors have a series below an opacity of 0.03 and
//    a closed form with a quotient above.  K2's columns cross that line
//    inside a warp (a third of the HATPRO scan's layers lie above it), and
//    the branch with its IEEE divide cost more than the walk's other
//    arithmetic: K2 computes both forms, the quotient by the approximate
//    reciprocal (1 ulp of a factor of b_top - b_bot, a few K), and selects
//    (0.110 -> 0.081 ms, the same TBs to four digits).  K3's opacities at
//    zenith lie mostly below 0.03 and its walk keeps the branch, which was
//    the faster there (0.107 against 0.110 ms).
//  * T and ds of a block's whole column live in shared memory, which bounds
//    L: about 1,700 levels for K2 (16 profiles) and 780 for K3 (32).  K2
//    refuses a longer column (the launch returns an error).
//
// `downwelling_kernel` takes K3's other calls (trans_level, an odd B, a view
// of alpha that starts inside a row, more than 780 levels): one thread per
// (elevation, frequency, profile), profile fastest, so every load and store
// is coalesced and B need not be a multiple of anything; Planck takes expm1f.

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

// K3's one-thread-per-column body: the chords are read from ds.
__global__ void downwelling_kernel(const float* __restrict__ freqs,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ ds,
                                   const float* __restrict__ t, int E, int F,
                                   int L, int B, int alpha_is_mid,
                                   float hk_ghz, float t_cosmic,
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
  const float* ds_row = ds + (size_t)e * (L - 1) * B + b;

  float b_bot = planck(x, t[b]);
  float a_bot = alpha_is_mid ? 0.0f : a[0];

  float ctau = 0.0f;
  float trans_below = 1.0f;
  float atm = 0.0f;
  if (trow) trow[0] = 1.0f;

  for (int l = 0; l < L - 1; ++l) {
    const size_t top = (size_t)(l + 1) * B + b;
    const float ds_l = ds_row[(size_t)l * B];

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

// ---- the staged body: alpha through shared memory --------------------------

constexpr int kStagedWarps = 16;   // K3: warps per block, one frequency each
constexpr int kChordWarps = 8;     // K2: at most so many, two channels each
constexpr int kChordProfiles = 16; // K2: profiles per block
constexpr int kStageRows = 4;      // rows (levels or layers) of alpha a stage
constexpr int kStages = 4;         // stages of a warp's ring
constexpr int kLanes = 32;         // floats of a stage's row: one a lane
constexpr int kStageFloats = kStageRows * kLanes;
constexpr size_t kMaxSharedBytes = 227 * 1024;

// Where the staged body takes a block's slant paths from: K3 reads them, K2
// computes the chords, in float64.
enum Paths { kGiven = 0, kChord = 1 };

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Bytes of shared memory of one block of `warps` warps and `profiles`
// profiles: T (L, profiles), ds (L-1, profiles) and the rings of its warps.
size_t staged_shared_bytes(int L, int warps, int profiles) {
  return sizeof(float) * ((size_t)(2 * L - 1) * profiles
                          + (size_t)warps * kStages * kStageFloats);
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

// The chord [km] of the layer between two levels for the Snell invariant
// k = n_0 r_0 cos(elevation) [m], in float64, rounded once; the form is that
// of ops/geometry.py::chord_lengths.
__device__ __forceinline__ float chord_km(float z_bot, float z_top,
                                          float n_bot, float n_top, double k,
                                          double earth_radius) {
  const double r_bot = earth_radius + z_bot, r_top = earth_radius + z_top;
  const double rk = k / (0.5 * ((double)n_bot + (double)n_top));
  const double seg_top = sqrt(fmax((r_top - rk) * (r_top + rk), 0.0));
  const double seg_bot = sqrt(fmax((r_bot - rk) * (r_bot + rk), 0.0));
  return (float)(((double)z_top - (double)z_bot) * (r_top + r_bot)
                 / fmax(seg_top + seg_bot, 1.0) * 1e-3);
}

// What a thread carries up the column.
struct WalkState {
  float b_bot, a_bot, ctau, trans_below, atm;
};

// Layers l0 .. l0 + 4 (kFull) or l0 .. rows of one thread's column, from the
// stage's rows of alpha.  First everything that does not wait for the layer
// below, for all rows at once, so that the exponentials and divides of four
// layers overlap: only the running sum of tau chains them.  Then the
// emission sum, layer by layer: with kSelect both forms of a layer's emission
// factors are computed and one is selected, else a branch takes one.  With
// kTrans the transmittance down to each level goes to `trow` (this thread's column of trans_level, stride B; null
// for a lane past the last profile): a warp stores one 128-byte row a layer.
template <bool kMid, bool kFull, bool kSeries, bool kTrans, bool kSelect,
          int kProfiles>
__device__ __forceinline__ void walk_stage(WalkState& w, const float* stage,
                                           const float* ds_b,
                                           const float* t_b, int l0,
                                           int rows, float x, float* trow,
                                           int B) {
  float d[kStageRows], e_ctau[kStageRows], b_top[kStageRows];
#pragma unroll
  for (int r = 0; r < kStageRows; ++r) {
    const int l = l0 + r;
    if (!kFull && l >= rows) break;
    const float a = stage[r * kLanes];
    d[r] = (kMid ? a : 0.5f * (w.a_bot + a)) * ds_b[l * kProfiles];
    w.a_bot = a;
    w.ctau += d[r];
    e_ctau[r] = expf(-w.ctau);
    if (kTrans && trow) trow[(size_t)(l + 1) * B] = e_ctau[r];
    const float t_top = t_b[(l + 1) * kProfiles];
    b_top[r] = kSeries ? planck_series(x, t_top) : planck(x, t_top);
  }
#pragma unroll
  for (int r = 0; r < kStageRows; ++r) {
    if (!kFull && l0 + r >= rows) break;
    // emission reaching the layer bottom, times the transmittance below it
    float delta, gtop_tb;
    const float tbd = w.trans_below * d[r];
    if (kSelect) {
      // both forms and a select: no branch for the warp to diverge on.  The
      // quotient takes the approximate reciprocal (1 ulp of a factor of
      // b_top - b_bot, a few K); what it gives for d = 0 is not selected.
      const float diff = w.trans_below - e_ctau[r];
      float rd;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rd) : "f"(d[r]));
      const bool small = d[r] < kSmallDtau;
      delta = small ? tbd * (1.0f - d[r] * (0.5f - d[r] * (1.0f / 6.0f)))
                    : diff;
      gtop_tb = small ? tbd * (0.5f - d[r] * (1.0f / 3.0f - d[r] * 0.125f))
                      : fmaf(diff, rd, -e_ctau[r]);
    } else if (d[r] < kSmallDtau) {
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

// The inputs from which the slant paths come: ds (E, L-1, B) for K3; for K2 z
// and nr (L, B), the Earth radius and the cosines of the elevations (E,) in
// double.
struct PathInputs {
  const float* ds;
  const float* z;
  const float* nr;
  const double* cos_el64;
  double earth_radius;
};

// Block (x, y, z) of W warps: kProfiles profiles from kProfiles x on, one
// elevation z, and 32 / kProfiles frequencies a warp: a lane is one
// (frequency, profile) of its warp, the profile fastest, and the block's
// frequencies start at (32 / kProfiles) W y.  kMid: alpha holds L-1 layer
// means, else L levels.  kPaths: the block's slant paths are read (K3) or
// computed from z and nr, once per (layer, profile) of the block (K2).
// kTrans: trans_level is written.  kWide: alpha is copied in 16-byte pieces
// (B a multiple of 4 and alpha on a 16-byte boundary), else each piece as
// four 4-byte copies.  K3 runs 16 warps of 32 profiles and two blocks an SM;
// K2 16 profiles and at most 8 warps (16 channels), six blocks an SM.
template <bool kMid, int kPaths, bool kTrans, bool kWide, int kProfiles>
__global__ void __launch_bounds__(
    (kPaths == kGiven ? kStagedWarps : kChordWarps) * 32,
    kPaths == kGiven ? 2 : 6)
downwelling_staged_kernel(const float* __restrict__ freqs,
                          const float* __restrict__ alpha, PathInputs paths,
                          const float* __restrict__ t, int F, int L, int B,
                          float hk_ghz, float t_cosmic,
                          float* __restrict__ tb, float* __restrict__ tau,
                          float* __restrict__ tmr, float* __restrict__ trans) {
  constexpr int kPerWarp = kLanes / kProfiles;   // frequencies of a warp
  extern __shared__ __align__(16) float shared[];
  float* t_s = shared;                             // (L, kProfiles)
  float* ds_s = t_s + (size_t)L * kProfiles;       // (L-1, kProfiles)
  float* rings = ds_s + (size_t)(L - 1) * kProfiles;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int column = lane % kProfiles;             // the lane's profile
  const int b0 = blockIdx.x * kProfiles;
  const int b = b0 + column;
  // the warp's first frequency, and the lane's own: a lane past the last
  // frequency walks the last one again and stores nothing
  const int f_warp = (blockIdx.y * (blockDim.x >> 5) + warp) * kPerWarp;
  const bool live = f_warp < F;                    // the same for a whole warp
  const bool mine = f_warp + lane / kProfiles < F && b < B;
  const int f = min(f_warp + lane / kProfiles, F - 1);
  const int e = blockIdx.z;
  // The staged rows are the L-1 that close a layer each: the layer means, or
  // the levels from 1 up (level 0 is read from device memory below).
  const int rows = L - 1;
  const int l_in = kMid ? L - 1 : L;
  const int n_chunks = (rows + kStageRows - 1) / kStageRows;
  float* ring = rings + (size_t)warp * kStages * kStageFloats;

  // Copy chunk k of this warp's slabs into its stage and close the group; an
  // empty group keeps the count of groups in step past the last chunk.  A
  // stage's row holds the 32 / kProfiles frequencies of the warp side by
  // side; a lane copies one of the stage's 32 pieces (4 rows of 8 x 16
  // bytes), whole or float by float; what lies past the last row or the
  // last profile is skipped.
  auto fetch = [&](int k) {
    if (live) {
      const int r = lane >> 3, col = (lane & 7) * 4;
      const int row = k * kStageRows + r;
      const int piece_f = min(f_warp + col / kProfiles, F - 1);
      const int piece_b = b0 + col % kProfiles;
      float* dst = ring + (k % kStages) * kStageFloats + r * kLanes + col;
      const float* src =
          alpha + ((size_t)piece_f * l_in + row + (kMid ? 0 : 1)) * B + piece_b;
      if (row < rows) {
        if constexpr (kWide) {
          if (piece_b < B) cp_async_16(dst, src);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (piece_b + i < B) cp_async_4(dst + i, src + i);
        }
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) fetch(k);

  // T and this elevation's ds, once for the block's frequencies, and the
  // block's lowest T (positive floats order as their bits do).  A thread
  // fills one profile's column of both, its lane's: blockDim.x is a multiple
  // of 32, and 32 of kProfiles.
  __shared__ int t_min_bits;
  if (threadIdx.x == 0) t_min_bits = __float_as_int(3.0e38f);
  __syncthreads();
  float t_low = 3.0e38f;
  // the Snell invariant k = n_0 r_0 cos(elevation) [m] of this profile
  double snell = 0.0;
  if (kPaths == kChord && b < B)
    snell = (double)paths.nr[b] * (paths.earth_radius + paths.z[b])
            * paths.cos_el64[e];
  for (int j = threadIdx.x; j < L * kProfiles; j += blockDim.x) {
    const int l = j / kProfiles;
    const size_t at = (size_t)l * B + b;
    const float t_j = b < B ? t[at] : 300.0f;
    t_s[j] = t_j;
    t_low = fminf(t_low, t_j);
    if (l < L - 1) {
      float ds_j = 0.0f;
      if (b < B) {
        if constexpr (kPaths == kGiven)
          ds_j = paths.ds[((size_t)e * (L - 1) + l) * B + b];
        else
          ds_j = chord_km(paths.z[at], paths.z[at + B], paths.nr[at],
                          paths.nr[at + B], snell, paths.earth_radius);
      }
      ds_s[j] = ds_j;
    }
  }
  // a column with T <= 0 takes no series
  atomicMin(&t_min_bits, t_low > 0.0f ? __float_as_int(t_low) : 0);
  __syncthreads();
  if (!live) return;

  const float x = hk_ghz * freqs[f];
  const float a0 = (kMid || b >= B) ? 0.0f : alpha[(size_t)f * l_in * B + b];
  float* trow = nullptr;
  if (kTrans && mine) {
    trow = trans + ((size_t)e * F + f) * L * B + b;
    trow[0] = 1.0f;
  }
  // x / T < 0.25 on every level of the block, for every frequency of the
  // warp: the same for a whole warp
  const bool series =
      __all_sync(0xffffffffu, x < 0.25f * __int_as_float(t_min_bits));
  WalkState w{series ? planck_series(x, t_s[column])
                     : planck(x, t_s[column]),
              a0, 0.0f, 1.0f, 0.0f};
  // The walk, with Planck's series or with expm1f: chosen once, outside the
  // loop, so that the unrolled layers of a stage hold no branch on it.
  auto walk = [&](auto series_tag) {
    constexpr bool kSeries = decltype(series_tag)::value;
    // K2's opacities lie on both sides of 0.03 within a warp; K3's at
    // zenith mostly below, and its walk keeps the branch (measured)
    constexpr bool kSelect = kPaths != kGiven;
    for (int k = 0; k < n_chunks; ++k) {
      fetch(k + kStages - 1);
      cp_async_wait<kStages - 1>();   // this lane's copies of chunk k landed
      __syncwarp();                   // and every other lane's
      const float* stage = ring + (k % kStages) * kStageFloats + lane;
      const int l0 = k * kStageRows;
      if (l0 + kStageRows <= rows)
        walk_stage<kMid, true, kSeries, kTrans, kSelect, kProfiles>(
            w, stage, ds_s + column, t_s + column, l0, rows, x, trow, B);
      else
        walk_stage<kMid, false, kSeries, kTrans, kSelect, kProfiles>(
            w, stage, ds_s + column, t_s + column, l0, rows, x, trow, B);
      __syncwarp();   // the stage is free for the copy of chunk k + kStages
    }
  };
  if (series) walk(std::true_type{});
  else walk(std::false_type{});

  if (!mine) return;
  const size_t idx = ((size_t)e * F + f) * B + b;
  const float cosmic0 = planck(x, t_cosmic);
  tb[idx] = inverse_planck(x, w.atm + cosmic0 * w.trans_below);
  tau[idx] = w.ctau;
  tmr[idx] = inverse_planck(x, w.atm / fmaxf(1.0f - w.trans_below, 1e-10f));
}

// Profiles per block of the staged body: 32 for K3, 16 for K2.
int staged_profiles(int kind) {
  return kind == kGiven ? kLanes : kChordProfiles;
}

// Warps per block of the staged body: 16 for K3; for K2 the F channels
// spread evenly over as few blocks as hold them, two channels a warp and 8
// warps at the most.
int staged_warps(int kind, int F) {
  if (kind == kGiven) return kStagedWarps;
  constexpr int kPerWarp = kLanes / kChordProfiles;
  const int groups = (F + kChordWarps * kPerWarp - 1) / (kChordWarps * kPerWarp);
  const int channels = (F + groups - 1) / groups;
  return (channels + kPerWarp - 1) / kPerWarp;
}

// Whether alpha (rows of B floats) can be copied in 16-byte pieces: a
// tensor's own storage is aligned; a view that starts inside a row may not
// be.
bool wide_copies(const float* alpha, int B) {
  return B % 4 == 0 && reinterpret_cast<size_t>(alpha) % 16 == 0;
}

// Whether the staged body can run a call of this shape at all: its columns
// fit into shared memory and its grid into the launch limits.
bool staged_fits(int kind, int E, int F, int L) {
  const int warps = staged_warps(kind, F);
  const int profiles = staged_profiles(kind);
  const int channels = warps * (kLanes / profiles);
  return staged_shared_bytes(L, warps, profiles) <= kMaxSharedBytes
         && E <= 65535 && (F + channels - 1) / channels <= 65535;
}

// Whether the staged body takes a call, decided by the shape and the
// alignment of alpha's first element.  K2: every call that fits, the others
// are refused.  K3: those that fit and can be copied in 16-byte pieces,
// without trans_level; its other body takes the rest.
bool staged_takes(int kind, const float* alpha, int E, int F, int L, int B,
                  const float* trans) {
  return staged_fits(kind, E, F, L)
         && (kind == kChord || (trans == nullptr && wide_copies(alpha, B)));
}

// Let the staged body take `smem` bytes of shared memory a block on the
// current device.  The attribute is the device's own, so it is set before
// every launch: it costs no more than the launch.  Returns the CUDA error.
template <typename Kernel>
cudaError_t allow_staged_shared(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

struct StagedArgs {
  const float* freqs;
  const float* alpha;
  PathInputs paths;
  const float* t;
  int E, F, L, B;
  float hk_ghz, t_cosmic;
  float *tb, *tau, *tmr, *trans;
};

// Launch one instantiation of the staged body, or (query) ask the occupancy
// calculator for its resident warps per SM: the launch's CUDA error, or the
// warps, or minus the error of the query.
template <bool kMid, int kPaths, bool kTrans, bool kWide>
int staged_instance(const StagedArgs& a, bool query, cudaStream_t stream) {
  constexpr int kProfiles = kPaths == kGiven ? kLanes : kChordProfiles;
  const auto kernel =
      downwelling_staged_kernel<kMid, kPaths, kTrans, kWide, kProfiles>;
  const int warps = staged_warps(kPaths, a.F);
  const int channels = warps * (kLanes / kProfiles);
  const size_t smem = staged_shared_bytes(a.L, warps, kProfiles);
  const cudaError_t err = allow_staged_shared(kernel, smem);
  if (query) {
    int blocks = 0;
    const cudaError_t q =
        err != cudaSuccess ? err
                           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                 &blocks, kernel, warps * 32, smem);
    return q == cudaSuccess ? blocks * warps : -static_cast<int>(q);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + kProfiles - 1) / kProfiles,
                  (a.F + channels - 1) / channels, a.E);
  kernel<<<grid, warps * 32, smem, stream>>>(a.freqs, a.alpha, a.paths, a.t,
                                             a.F, a.L, a.B, a.hk_ghz,
                                             a.t_cosmic, a.tb, a.tau, a.tmr,
                                             a.trans);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (kind, alpha_is_mid, trans_level, 16-byte copies).
int staged(int kind, bool mid, bool trans, bool wide, const StagedArgs& a,
           bool query, cudaStream_t stream) {
#define MWR_STAGED(KIND_, TRANS_, WIDE_)                                   \
  (mid ? staged_instance<true, KIND_, TRANS_, WIDE_>(a, query, stream)     \
       : staged_instance<false, KIND_, TRANS_, WIDE_>(a, query, stream))
  if (kind == kGiven) return MWR_STAGED(kGiven, false, true);
  if (wide)
    return trans ? MWR_STAGED(kChord, true, true)
                 : MWR_STAGED(kChord, false, true);
  return trans ? MWR_STAGED(kChord, true, false)
               : MWR_STAGED(kChord, false, false);
#undef MWR_STAGED
}

constexpr int kThreads = 256;

// kind: kGiven (K3) or kChord (K2).
int launch(int kind, const float* freqs, const float* alpha,
           const PathInputs& paths, const float* t, int E, int F, int L,
           int B, int alpha_is_mid, float hk_ghz, float t_cosmic, float* tb,
           float* tau, float* tmr, float* trans, void* stream) {
  if (E < 1 || F < 1 || L < 2 || B < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged_takes(kind, alpha, E, F, L, B, trans))
    return staged(kind, alpha_is_mid != 0, trans != nullptr,
                  wide_copies(alpha, B),
                  StagedArgs{freqs, alpha, paths, t, E, F, L, B, hk_ghz,
                             t_cosmic, tb, tau, tmr, trans},
                  false, s);
  if (kind != kGiven) return cudaErrorInvalidValue;   // K2 has one body
  const long long n = (long long)E * F * B;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  downwelling_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      freqs, alpha, paths.ds, t, E, F, L, B, alpha_is_mid, hk_ghz, t_cosmic,
      tb, tau, tmr, trans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: tb, tau, tmr (E, F, B) and, unless trans is null, trans (E, F, L, B)
// from cos(elevation) (E,) in float64, frequencies (F,), alpha (F, L, B) --
// or (F, L-1, B) layer means when alpha_is_mid -- and z, n, T (L, B), all
// float32 on the device but for cos_el64.  Returns the CUDA error of the
// launch (0 when it was accepted); a shape for which
// `mwr_forward_lb_copy_bytes` gives 0 is an invalid value.
extern "C" int mwr_forward_lb(const double* cos_el64, const float* freqs,
                              const float* alpha, const float* z,
                              const float* nr, const float* t, int E, int F,
                              int L, int B, int alpha_is_mid, float hk_ghz,
                              float t_cosmic, float earth_radius, float* tb,
                              float* tau, float* tmr, float* trans,
                              void* stream) {
  const PathInputs paths{nullptr, z, nr, cos_el64, earth_radius};
  return launch(kChord, freqs, alpha, paths, t, E, F, L, B, alpha_is_mid,
                hk_ghz, t_cosmic, tb, tau, tmr, trans, stream);
}

// The size of the pieces in which K2 copies this alpha at this shape, 16 or
// 4 bytes, or 0 where it refuses the shape (more levels than its shared
// memory holds): a pure function of the shape and the pointer's alignment.
extern "C" int mwr_forward_lb_copy_bytes(const float* alpha, int E, int F,
                                         int L, int B) {
  if (E < 1 || F < 1 || L < 2 || B < 1 || !staged_fits(kChord, E, F, L))
    return 0;
  return wide_copies(alpha, B) ? 16 : 4;
}

// K3: the same outputs from frequencies (F,), alpha (F, L, B) or
// (F, L-1, B), slant paths ds (E, L-1, B) [km] and T (L, B), all float32 on
// the device, through the staged body where `staged_takes` the call and
// through the one-thread-per-column body otherwise.  Returns the CUDA error
// of the launch.
extern "C" int mwr_downwelling_lb(const float* freqs, const float* alpha,
                                  const float* ds, const float* t, int E,
                                  int F, int L, int B, int alpha_is_mid,
                                  float hk_ghz, float t_cosmic, float* tb,
                                  float* tau, float* tmr, float* trans,
                                  void* stream) {
  const PathInputs paths{ds, nullptr, nullptr, nullptr, 0.0};
  return launch(kGiven, freqs, alpha, paths, t, E, F, L, B, alpha_is_mid,
                hk_ghz, t_cosmic, tb, tau, tmr, trans, stream);
}

// Warps of the staged body resident per SM (what the occupancy calculator
// says for its registers and shared memory) at L levels: K3's with kind 0,
// K2's at F channels with kind 1, with or without trans_level, with 16-byte
// or 4-byte copies.  Minus the CUDA error when the query fails.
extern "C" int mwr_staged_resident_warps(int kind, int F, int L,
                                         int alpha_is_mid, int want_trans,
                                         int wide) {
  if (kind < kGiven || kind > kChord || F < 1 || L < 2
      || (kind == kGiven && (want_trans || !wide))
      || !staged_fits(kind, 1, F, L))
    return -static_cast<int>(cudaErrorInvalidValue);
  StagedArgs a{};
  a.F = F;
  a.L = L;
  return staged(kind, alpha_is_mid != 0, want_trans != 0, wide != 0, a, true,
                nullptr);
}
