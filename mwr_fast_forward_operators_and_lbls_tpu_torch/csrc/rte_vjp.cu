// K2v: the backward of K2 on layer-mean extinction (csrc/rte.cu with
// alpha_is_mid, the fast operator's RTE).  Given the cotangent of tb
// (E, C, B), it returns dL/dalpha_mid (C, L-1, B), summed over the
// elevations:
//   dL/dalpha_mid[c, k, b] = sum_e cot[e, c, b] dtb/dR W_k ds_k,
// with W_k = dR/dd_k of csrc/rte_walk.cuh, ds_k the elevation's chord of
// layer k and dtb/dR the inverse Planck's slope at the column's radiance.
// Replaces no TPU kernel: the JAX package's distillation differentiates
// the fast operator's RTE with jax.grad through XLA (models/fast.py::
// distill_loss); the port's plain version is autograd of
// ops/cuda/rte.py::forward_lb_reference.  The
// distillation's training step (models/fast.py::train_step) reaches it
// through ops/cuda/rte.py's autograd Function around K2.
//
// What bounds it on Hopper: the walks.  Its bytes are alpha_mid read and
// dL/dalpha_mid written, 4 C (L-1) B bytes each (41 MB at the training
// minibatch B=4096, C=14, L=180), z, n, T (L, B) and the cotangent; each
// (profile, elevation, channel) column is a chain up and down its L-1
// layers, with an expf and the emission factors a layer and walk.
//
// What the design does about it: FK's (csrc/fastk.cu) without its
// extinction partials and K assembly.
//  * One block per (profile, channel), one warp per elevation (E <= 32).
//    Blocks run channel by channel, so neighbouring blocks take
//    neighbouring profiles and share the 32-byte sectors of every strided
//    load of alpha_mid, z, n, T and store of the result in L2.  The block
//    puts z, B(T) of the channel at the levels, alpha_mid and 1 / n_layer
//    (float64) of the layers in shared memory.
//  * Each warp forms its chords from z and n as FK does (csrc/rte_walk.cuh::
//    chord: the Snell invariant of K2, n_0 (R_E + z_0) cos(el), then r - r_k
//    and r + r_k in float64), parks them for walk 2, and runs the two walks
//    of csrc/rte_walk.cuh: T_k and the radiance up, S_k and W_k down, with
//    K5's 10-term emission series below d = 0.5.  Walk 2 overwrites each
//    T_k with the layer's term cot dtb/dR W_k ds_k.
//  * After a barrier the block sums each layer's terms over the elevations,
//    in elevation order (no atomics: the result does not depend on the
//    schedule), and stores dL/dalpha_mid[c, :, b].

#include <cuda_runtime.h>

#include "rte_walk.cuh"

namespace {

using namespace mwr_rte;

// a warp per elevation, at most 32 in a block of 1024 threads
constexpr int kMaxWarps = 32;
// the most shared memory a block may ask for on Hopper
constexpr int kMaxSharedBytes = 232448;

// Shared memory of a block, in bytes: 1 / n_layer of the L-1 layers
// (float64); then floats: z and B at the L levels, alpha_mid of the layers,
// and T_k (then the layer's term) and ds of each elevation's layers.
__host__ __device__ __forceinline__ long long shared_bytes(int E, int L) {
  const long long K = L - 1;
  return 8LL * K + 4LL * (2LL * L + K + 2LL * E * K);
}

__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
rte_vjp_kernel(const double* __restrict__ cos_el,
               const float* __restrict__ freqs,
               const float* __restrict__ alpha, const float* __restrict__ z,
               const float* __restrict__ nr, const float* __restrict__ t,
               const float* __restrict__ g_tb, int g_e, int g_c, int g_b,
               int C, int L, int B, float hk_ghz,
               float t_cosmic, double earth_radius,
               float* __restrict__ d_alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = L - 1;
  double* s_inl = reinterpret_cast<double*>(smem);
  float* s_z = reinterpret_cast<float*>(s_inl + K);
  float* s_b = s_z + L;
  float* s_a = s_b + L;
  float* s_walk = s_a + K;  // per elevation: T_k (then the term), ds

  const int c = blockIdx.x / B;
  const int b = blockIdx.x % B;
  const int E = blockDim.x / kLanes;
  const float x = hk_ghz * freqs[c];
  const float* a_col = alpha + (size_t)c * K * B + b;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const size_t at = (size_t)l * B + b;
    s_z[l] = z[at];
    s_b[l] = planck(x, t[at]);
    if (l < K) {
      s_inl[l] = 1.0 / (0.5 * ((double)nr[at] + (double)nr[at + B]));
      s_a[l] = a_col[(size_t)l * B];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int e = threadIdx.x / kLanes;
  float* tr = s_walk + (size_t)e * 2 * K;
  float* c_ds = tr + K;
  const double snell =
      (double)nr[b] * (earth_radius + (double)s_z[0]) * cos_el[e];

  float tau;
  const float atm = walk_up(K, lane, s_b, tr, tau, [&](int k) {
    const float ds =
        chord(s_z[k], s_z[k + 1], s_inl[k], snell, earth_radius).ds;
    c_ds[k] = ds;
    return s_a[k] * ds;
  });
  const float ctt = planck(x, t_cosmic) * expf(-tau);
  // the column's cotangent times dtb/dR
  const float q = g_tb[(long long)e * g_e + (long long)c * g_c +
                       (long long)b * g_b] *
                  inverse_planck_db(x, atm + ctt);
  walk_down(K, lane, s_b, tr, ctt, [&](int k) { return s_a[k] * c_ds[k]; },
            [&](int k, bool on, const Down& dn) {
              if (on) tr[k] = q * dn.w_k * c_ds[k];
            });
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float sum = 0.0f;
    for (int j = 0; j < E; ++j) sum += s_walk[(size_t)j * 2 * K + k];
    d_alpha[((size_t)c * K + k) * B + b] = sum;
  }
}

}  // namespace

// K2v: dL/dalpha_mid (C, L-1, B), float32 on the device, from
// cos(elevation) (E,) in float64, the channel frequencies [GHz] (C,), the
// layer-mean extinction alpha_mid (C, L-1, B) [Np/km], z [m], the
// refractive index n and T [K] (L, B), and the cotangent of tb (E, C, B)
// with strides g_e, g_c, g_b (in floats; autograd hands it as a view of
// the (B, E, C) gradient), all float32 on the device, contiguous but for
// the cotangent, and cos_el in float64.  hk_ghz,
// t_cosmic and earth_radius are constants/physics.py's HK_GHZ, T_COSMIC and
// EARTH_RADIUS.  Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int mwr_forward_lb_vjp(const double* cos_el, const float* freqs,
                                  const float* alpha, const float* z,
                                  const float* nr, const float* t,
                                  const float* g_tb, int g_e, int g_c,
                                  int g_b, int E, int C, int L, int B,
                                  float hk_ghz, float t_cosmic,
                                  double earth_radius, float* d_alpha,
                                  void* stream) {
  if (E < 1 || E > kMaxWarps || C < 1 || L < 2 || B < 1 ||
      (long long)B * C > 0x7fffffffLL || shared_bytes(E, L) > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const size_t bytes = (size_t)shared_bytes(E, L);
  if (bytes > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        rte_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  rte_vjp_kernel<<<B * C, E * kLanes, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      cos_el, freqs, alpha, z, nr, t, g_tb, g_e, g_c, g_b, C, L, B, hk_ghz,
      t_cosmic, earth_radius, d_alpha);
  return static_cast<int>(cudaGetLastError());
}
