// K7: the primitive-rate microbenchmark.  out[i] = sum_{j<8} op^k(x[i] *
// (1 + j 1e-3)) for one of the elementwise primitives
//   fma:  v -> v * 1.0000001 + 1e-9        (one fmaf)
//   div:  v -> 1 / (v + 1.3)               (one add, one IEEE fp32 divide)
//   exp:  v -> exp(v * 1e-6)               (one multiply, one accurate expf)
// and, as extra rows, the approximate forms __fdividef and __expf.
// The wrapper divides the kernel's time by 8 k n to get seconds per
// (element, application), the card's rate for that primitive.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/parallel/profiling.py
//   ::_chain_time (the Pallas body `kernel`), reached through
//   measure_vpu_peaks.
//
// What bounds it on Hopper: by construction the rate at which the SMs
// dispatch the primitive.  Each element reads 4 bytes and writes 4 (67 MB
// for 8.4 M elements, 20 us at 3.35 TB/s) against 8 k applications: 768
// fmaf, or 192 divides or expf of some 8 instructions each.
//
// What the design does about it:
//  * One thread per element; the 8 scaled copies live in 8 registers and
//    nothing is stored between applications.  op and k are template
//    parameters.  The k applications run as a loop unrolled by `kUnroll`
//    steps: 32 for fmaf (256 instructions per trip), 4 for the others.  A
//    fully unrolled divide chain is 48 x 8 inlined sequences with their slow
//    paths, and was bound by instruction fetch on the H100: 2.45e12
//    divides/s at k = 24 and 2.13e12 at k = 48, against 2.80e12 and 2.83e12
//    with 4 steps per trip.
//  * The 8 chains are independent: with 4 warps per scheduler each needs
//    only its own previous result every 32 scheduler slots, far beyond the
//    4-cycle latency of fmaf and the latency of the special-function unit.
//  * x is runtime data and the build has no -use_fast_math, so the compiler
//    can neither fold nor shorten a chain; `/` is the IEEE divide and expf
//    the accurate one, the forms the other kernels of this package use.
//  * `threads` is the block size.  An SM holds at most 32 blocks, so blocks
//    of one warp leave it 32 resident warps of its 64: the rate there against
//    the rate at 256 shows whether a primitive is saturated.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

enum Op { kFma = 0, kDiv = 1, kExp = 2, kDivFast = 3, kExpFast = 4 };

template <int OP>
constexpr int kUnroll = OP == kFma ? 32 : 4;

template <int OP>
__device__ __forceinline__ float apply(float v) {
  static_assert(OP >= kFma && OP <= kExpFast, "unknown primitive");
  if constexpr (OP == kFma) {
    return fmaf(v, 1.0000001f, 1e-9f);
  } else if constexpr (OP == kDiv) {
    return 1.0f / (v + 1.3f);
  } else if constexpr (OP == kExp) {
    return expf(v * 1e-6f);
  } else if constexpr (OP == kDivFast) {
    return __fdividef(1.0f, v + 1.3f);
  } else {
    return __expf(v * 1e-6f);
  }
}

template <int OP, int K>
__global__ void chain_kernel(const float* __restrict__ x,
                             float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) a[j] = xi * (float)(1.0 + j * 1e-3);
  static_assert(K % kUnroll<OP> == 0, "k must be a multiple of the unroll");
#pragma unroll 1
  for (int trip = 0; trip < K / kUnroll<OP>; ++trip) {
#pragma unroll
    for (int s = 0; s < kUnroll<OP>; ++s) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) a[j] = apply<OP>(a[j]);
    }
  }
  float acc = a[0];
#pragma unroll
  for (int j = 1; j < kChains; ++j) acc += a[j];
  out[i] = acc;
}

template <int OP, int K>
void launch(const float* x, float* out, long long n, int threads,
            cudaStream_t stream) {
  const long long blocks = (n + threads - 1) / threads;
  chain_kernel<OP, K><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n);
}

}  // namespace

// out (n,) from x (n,), float32 on the device.  op: 0 fma, 1 div, 2 exp,
// 3 __fdividef, 4 __expf; k, the applications per chain, is one of the
// instantiated lengths (96 or 192 for fma, 24 or 48 for the others).
// threads is the block size (a multiple of 32 up to 1024).  Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int mwr_chain(int op, int k, const float* x, float* out, int n,
                         int threads, void* stream) {
  if (n < 1 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MWR_CHAIN(OP_, K_)                                  \
  if (op == OP_ && k == K_) {                               \
    launch<OP_, K_>(x, out, n, threads, s);                 \
    return static_cast<int>(cudaGetLastError());            \
  }
  MWR_CHAIN(kFma, 96) MWR_CHAIN(kFma, 192)
  MWR_CHAIN(kDiv, 24) MWR_CHAIN(kDiv, 48)
  MWR_CHAIN(kExp, 24) MWR_CHAIN(kExp, 48)
  MWR_CHAIN(kDivFast, 24) MWR_CHAIN(kDivFast, 48)
  MWR_CHAIN(kExpFast, 24) MWR_CHAIN(kExpFast, 48)
#undef MWR_CHAIN
  return cudaErrorInvalidValue;
}
