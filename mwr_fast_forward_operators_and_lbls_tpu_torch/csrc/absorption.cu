// K1: total clear/cloudy-sky absorption alpha (F, N) [Np/km] at up to 32
// fixed channels, for the N points of flattened (level x profile) arrays.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/absorption_kernel.py
//   ::total_absorption_fused (body _build_kernel), reached on the LBL path
//   through absorption_lb_fused.
// The function is that of ops/absorption/{h2o,o2,n2,liquid,o3}.py, including
// the 1998 dry continuum for R98 and R03 and the clamp of the O2 term at
// zero.  K4 (absorption_tangents.cu) computes the same function on dual
// numbers with a body of its own; this file holds the body on floats.
//
// What bounds it on Hopper: arithmetic.  A point reads 16-20 bytes and
// writes 4 F; at 14 channels it evaluates 14 x (15 H2O + 49 O2) line shapes
// and, once, the state of those 64 lines (two powers of 300 / T, an expf and
// a divide per H2O line, an expf per O2 line).  The special-function unit (16 lanes
// per SM) serves one reciprocal per line shape at best, the fp32 pipe some
// eight instructions.
//
// What the design does about it (the arithmetic is K6's,
// absorption_spectral.cu, whose notes have the algebra):
//  * One rational per line.  With d1 the distance to the line centre,
//    d2 = d1 + c that to its mirror image and q = d1 d2 + w^2, a line's two
//    Lorentzian halves are (k2 + q k3) / (q^2 + w^2 c^2): three adds and four
//    FMAs, q always formed from the difference d1.  Two O2 lines share one
//    reciprocal, (n_a D_b + n_b D_a) / (D_a D_b).  The strengths carry
//    1 / f_line^2 and the density scales; the sums are multiplied by f^2
//    once, after the loops.  The line loops divide by the special-function
//    unit's approximate reciprocal (`ratio`, by intrinsic, no build flag);
//    the state and the per-channel tail keep IEEE arithmetic.
//  * The line state never leaves the registers.  K6 writes some 300 floats a
//    point to device memory in a pass of its own, which at K1's 184,320
//    points would be 221 MB written and read again, more than the whole
//    bound.  Here a thread owns a point and walks the lines: it forms the
//    state of one H2O line, or of two O2 lines, and spends it at once on all
//    F channels, whose sums it keeps in registers (2 F of them: the O2 sum
//    is clamped apart).  Nothing is staged in shared memory but the packed
//    table, so no load stands between the state and the F x 17 instructions
//    of a pair of lines, and what the fp32 pipe executes is the function's
//    own count but for the table reads.  (Sharing one point's state between
//    the warps of a block, each taking a few channels, executes the same
//    arithmetic plus ten shared-memory loads per pair of lines and warp,
//    and a block's 38 KB of state would leave 20 warps an SM.)
//  * The channels are a kernel argument by value: f[c] is an operand from
//    the constant bank and costs no register, the loops over c are unrolled
//    (F is the template parameter), and the Clough-cutoff tests, which
//    depend on (line, channel), are the same for every thread of the grid.
//    An H2O line whose two halves lie inside the cutoff for all channels
//    takes the merged form and adds its two bases to one scalar.
//  * A point's 35 powers share the base ti = 300 / T: one log2f per point
//    and one exp2f per power, where powf pays a logarithm in extended
//    precision each time (12 % of the kernel's time, measured).
//  * What depends on the table alone (1 / f_line^2 per line, the dry
//    continuum's frequency factor per channel) is formed once per block in
//    shared memory, behind the table.
//  * The optional O3 lines have no cutoff and no mixing: each is the merged
//    rational of its two halves, with the O3 density scale folded into the
//    strength, summed into the H2O accumulator (both are multiplied by f^2).
//  * 128 threads a block and at most 85 registers: six blocks, 24 warps, an
//    SM, and 1,440 blocks at the HATPRO scan shape (1024 x 180 points), so
//    every SM has ten or eleven to work through and none waits for a tail.
//  * Past 16 channels (the Radiometrics MP-3000A has 22) the same body is
//    instantiated wider, 2 F accumulators a thread, at up to 96 registers
//    and five blocks (20 warps) an SM, without spills up to 32 channels.
//    It forms the line state once a point, where channel groups of at most
//    16 (22: two launches of 11, 80 registers, 24 warps) form it once a
//    group: at 22 channels and 4096 x 180 points, 0.52 against 0.59 ms in a
//    graph, and the MP-3000A archive cell's rate 3.6 % higher (PERF.md).
//    The wider bodies are in absorption_f17_24.cu and absorption_f25_32.cu,
//    the body itself in absorption_points.cuh.

#include "absorption_points.cuh"

namespace {

// The instantiation for nf channels in 1..16, or null.
void* absorption_points_f1_16(int nf) {
  switch (nf) {
    MWR_K1_CASE(1) MWR_K1_CASE(2) MWR_K1_CASE(3) MWR_K1_CASE(4)
    MWR_K1_CASE(5) MWR_K1_CASE(6) MWR_K1_CASE(7) MWR_K1_CASE(8)
    MWR_K1_CASE(9) MWR_K1_CASE(10) MWR_K1_CASE(11) MWR_K1_CASE(12)
    MWR_K1_CASE(13) MWR_K1_CASE(14) MWR_K1_CASE(15) MWR_K1_CASE(16)
  }
  return nullptr;
}

// The instantiation for nf channels, or null.
PointsKernel points_kernel(int nf) {
  void* kernel = nf <= 16   ? absorption_points_f1_16(nf)
                 : nf <= 24 ? absorption_points_f17_24(nf)
                            : absorption_points_f25_32(nf);
  return reinterpret_cast<PointsKernel>(kernel);
}

}  // namespace

// alpha (F, N) for the N points of p, t, rho, lwc (and o3 unless null), all
// float32 on the device, at the nf <= 32 channels of `freqs`, an array on
// the HOST.  Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mwr_absorption_lb(const float* p, const float* t,
                                 const float* rho, const float* lwc,
                                 const float* o3, const float* freqs, int nf,
                                 const float* tables, int table_size,
                                 int n_h2o, int n_o2, int n_o3, int h2o_off,
                                 int o2_off, int o3_off, int gl_off, int n,
                                 float* out, void* stream) {
  const PointsKernel kernel = points_kernel(nf);
  if (kernel == nullptr || n < 1) return cudaErrorInvalidValue;
  const Layout lay{n_h2o, n_o2, n_o3, h2o_off, o2_off, o3_off, gl_off};
  Channels ch{};
  for (int c = 0; c < nf; ++c) ch.f[c] = freqs[c];
  const size_t smem = sizeof(float) * (table_size + extra_floats(lay));
  kernel<<<(n + kPointThreads - 1) / kPointThreads, kPointThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p, t, rho, lwc, o3, ch, tables,
                                                table_size, lay, n, out);
  return static_cast<int>(cudaGetLastError());
}

// Warps of K1 resident per SM at nf channels for a packed table of
// `table_floats` floats and `n_lines` lines in all (what the occupancy
// calculator says for its registers and shared memory), or minus the CUDA
// error.
extern "C" int mwr_absorption_resident_warps(int nf, int table_floats,
                                             int n_lines) {
  const PointsKernel kernel = points_kernel(nf);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (table_floats + n_lines + kMaxChannels);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kPointThreads, smem);
  return err == cudaSuccess ? blocks * (kPointThreads / 32)
                            : -static_cast<int>(err);
}
