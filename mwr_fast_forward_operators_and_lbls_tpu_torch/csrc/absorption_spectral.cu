// K6: monochromatic absorption alpha (F, N) [Np/km] over a runtime frequency
// grid of any length, for the N points of flattened (level x profile)
// arrays.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/spectral_kernel.py
//   ::absorption_spectral (body _build_kernel), reached on the spectral
//   forward (models/spectral.py::_forward_chunk).
// The arithmetic is K1's body (absorption.cuh) term for term, so it follows
// the plain formulas of ops/absorption/{h2o,o2,n2,liquid}.py, including the
// 1998 dry continuum for R98 *and* R03 (n2.py), which the packed table's
// header carries; the TPU kernel gives it to R98 only.  No O3, as on the TPU.
//
// What bounds it on Hopper: arithmetic.  Each (point, frequency) evaluates
// about 2 x 15 H2O and 2 x 49 O2 Lorentzian rationals with an IEEE fp32
// divide each (16 Gauss-Laguerre nodes more per qSD line for R19SD/R20SD),
// against 4 bytes of output: a 5760-point x 8192-frequency chunk writes
// 189 MB (56 us at 3.35 TB/s) and evaluates about 6e9 rationals.
//
// What the design does about it:
//  * A 2-D grid: blocks of 256 points along x, tiles of 16 frequencies along
//    y.  Each thread computes its point's widths, strengths, mixing terms and
//    continua once per tile and keeps 16 register sums, so that work is
//    amortised over 16 frequencies; every Lorentzian is exact fp32, with no
//    merge trees, mask classes or per-point row table (those are the TPU's
//    answers to its vector unit).
//  * All threads of a block share one frequency tile, so the Clough-cutoff
//    branch, which depends on (line, frequency), stays warp-uniform.
//  * The frequencies are a device array read per tile; the line tables are
//    staged in shared memory per block, as in K1.
//  * Stores go to (tile 16 + c) N + i in size_t, one coalesced row per
//    frequency: F N reaches 2.9e8 for one 50k spectrum.
//  * The last F mod 16 frequencies run the smaller-F instantiation of the
//    same body; grids longer than 65535 tiles are split over launches.

#include "absorption.cuh"

namespace {

constexpr int kTile = kMaxChannels;          // frequencies per tile
constexpr int kMaxTilesPerLaunch = 65535;    // the grid's y limit

}  // namespace

// alpha (F, N) at the F frequencies `freqs` for the N points of p, t, rho,
// lwc, all float32 on the device; the table carries no O3 lines.  Returns
// the CUDA error of the first launch that failed (0 when all were
// accepted).
extern "C" int mwr_absorption_spectral(const float* p, const float* t,
                                       const float* rho, const float* lwc,
                                       const float* freqs, int nf,
                                       const float* tables, int table_size,
                                       int n_h2o, int n_o2, int h2o_off,
                                       int o2_off, int gl_off, int n,
                                       float* out, void* stream) {
  if (nf < 1 || n < 1) return cudaErrorInvalidValue;
  const Layout lay{n_h2o, n_o2, 0, h2o_off, o2_off, gl_off, gl_off};
  const int full = nf / kTile;
  for (int t0 = 0; t0 < full; t0 += kMaxTilesPerLaunch) {
    const int tiles =
        full - t0 < kMaxTilesPerLaunch ? full - t0 : kMaxTilesPerLaunch;
    const size_t row = (size_t)t0 * kTile;
    const int err = dispatch<float>(kTile, p, t, rho, lwc, nullptr,
                                    freqs + row, tables, table_size, lay, n,
                                    out + row * n, nullptr, nullptr, stream,
                                    tiles);
    if (err) return err;
  }
  const int rest = nf - full * kTile;
  if (rest == 0) return 0;
  const size_t row = (size_t)full * kTile;
  return dispatch<float>(rest, p, t, rho, lwc, nullptr, freqs + row, tables,
                         table_size, lay, n, out + row * n, nullptr, nullptr,
                         stream);
}
