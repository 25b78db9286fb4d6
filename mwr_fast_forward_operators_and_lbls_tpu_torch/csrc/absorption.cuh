// What the absorption kernels K1 (absorption.cu), K4
// (absorption_tangents.cu) and K6 (absorption_spectral.cu) share: the layout
// of the packed line table and the approximate reciprocal of the line loops.
//
// Table layout (written by ops/cuda/absorption.py::line_tables): a header of
// scalars, then per-line columns (each `n_lines` floats long) for H2O, O2 and
// O3, then the 16 Gauss-Laguerre nodes and 16 weights of the qSD shape.

#pragma once

#include <cuda_runtime.h>

namespace {

// Header slots; keep in step with HEADER_FIELDS in ops/cuda/absorption.py.
enum Header {
  kCutoff = 0, kCf, kXcf, kCs, kXcs,
  kO2X, kWb300, kH2oFactor, kNonres, kO2Scale, kMixingBasisP,
  kN2Coef, kN2Exp, kN2Fdep,
};

constexpr int kMaxChannels = 16;
constexpr int kGlNodes = 16;

struct Layout {
  int n_h2o, n_o2, n_o3;
  int h2o, o2, o3, gl;
};

// The special-function unit's approximate reciprocal (1 ulp): for the line
// loops of K1, K4 and K6 only.
__device__ __forceinline__ float rcp_approx(float den) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(den));
  return r;
}

// num / den by that reciprocal.
__device__ __forceinline__ float ratio(float num, float den) {
  return num * rcp_approx(den);
}

}  // namespace
