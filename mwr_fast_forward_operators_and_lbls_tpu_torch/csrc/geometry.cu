// The K-matrix's slant geometry in float64: for each elevation e, layer l
// and profile b the chord ds [km] through the refracting atmosphere and its
// two sensitivities d(ds)/d(n_layer) and d(ds)/d(k), for each level the
// partials of the refractive index in T and rho, and the Snell column's
// r0 cos(e), each rounded once to float32.
//
// Replaces no TPU kernel: the JAX package's K-matrix
// (mwr_fast_forward_operators_and_lbls_tpu/models/jacobians.py, XLA) leaves
// this arithmetic to its compiler, which fuses it.  The port's eager torch
// dispatched it op by op, about 130 float64 launches a call
// (ops/cuda/geometry.py::slant_geometry_lb_reference).  The physics is that
// of ops/thermo.py::rho_to_e, ops/geometry.py::refractive_index,
// ::refractive_index_partials, ::chord_lengths and ::chord_sensitivities,
// in their order of operations: every product that torch rounds before an
// add is rounded here too (__dmul_rn, which nvcc never contracts into an
// fma), so the float64 values are those of the plain version and only the
// last rounding to float32 remains.
//
// What bounds it on Hopper: the float64 unit.  At the HATPRO K-matrix shape
// (E=10, L=180, B=256) it reads 0.74 MB and writes 5.88 MB, 2.0 us at
// 3.35 TB/s, but each of the 458,240 (elevation, layer, profile) takes two
// float64 square roots and six divides, each a sequence of float64 fma.  On
// an H100 SXM (700 W) it took 0.011 ms in a CUDA graph: blocks of 128
// threads ran 6 % faster than 256, and neither the elevation loop unrolled
// by two nor a thread per elevation (0.014 ms) was faster.  It is small
// beside the host time the op-by-op version cost: 2.2-2.8 ms a call.
//
// Design: one thread per (layer l, profile b), profiles fastest, in blocks
// of 128 (358 blocks at that shape, at most three an SM), so every
// load of z, p, T, rho [l, b] and every store of ds, dds [e, l, b] and
// dn [l, b] is a coalesced row.  A thread forms the refractive index of its
// two levels and of the ground level (the Snell invariant's), in registers,
// then walks the E elevations.  It writes dn of its bottom level; the last
// layer's threads also that of the top level, the first layer's r0 cos(e).

#include <cuda_runtime.h>

namespace {

// The physical constants the plain version takes from the port's
// constants/physics.py and ops/geometry.py, as the wrapper passes them.
struct Constants {
  double rv, earth_radius, k1, k2, k3;
};

// Vapour pressure e = rho T Rv / 1e5 [hPa] (thermo.rho_to_e).
__device__ __forceinline__ double vapour_pressure(double rho, double t,
                                                  const Constants& c) {
  return rho * t * c.rv / 1e5;
}

// n = 1 + 1e-6 N, N = K1 (p - e) / T + K2 e / T + K3 e / T^2
// (geometry.refractive_index).
__device__ __forceinline__ double refractive_index(double p, double t,
                                                   double e,
                                                   const Constants& c) {
  const double refractivity =
      c.k1 * (p - e) / t + c.k2 * e / t + c.k3 * e / (t * t);
  return 1.0 + __dmul_rn(1e-6, refractivity);
}

// dn/dT and dn/drho of one level, through e = rho T Rv / 1e5
// (geometry.refractive_index_partials, chained as models/jacobians.py
// chains them).
__device__ __forceinline__ void index_partials(double p, double t,
                                               double rho,
                                               const Constants& c,
                                               float* dn_t, float* dn_rho) {
  const double e = vapour_pressure(rho, t, c);
  const double inv_t = 1.0 / t;
  const double dn_de =
      1e-6 * ((c.k2 - c.k1) + __dmul_rn(c.k3, inv_t)) * inv_t;
  const double sum = __dmul_rn(c.k1, p - e) + __dmul_rn(c.k2, e)
                     + __dmul_rn(__dmul_rn(2.0 * c.k3, e), inv_t);
  const double dn_dt = -1e-6 * sum * inv_t * inv_t;
  *dn_t = (float)(dn_dt + __dmul_rn(dn_de, rho * c.rv / 1e5));
  *dn_rho = (float)(dn_de * (t * c.rv / 1e5));
}

__device__ __forceinline__ double clamp_min(double x, double lo) {
  return x < lo ? lo : x;           // NaN stays NaN, as torch.clamp_min
}

__global__ void slant_geometry_kernel(const double* __restrict__ cos_el,
                                      const float* __restrict__ z,
                                      const float* __restrict__ p,
                                      const float* __restrict__ t,
                                      const float* __restrict__ rho,
                                      int E, int L, int B, Constants c,
                                      float* __restrict__ ds,
                                      float* __restrict__ dds_dnl,
                                      float* __restrict__ dds_dk,
                                      float* __restrict__ dn_t,
                                      float* __restrict__ dn_rho,
                                      float* __restrict__ r0cos) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(L - 1) * B) return;
  const int b = (int)(i % B);
  const int l = (int)(i / B);
  const size_t bot = (size_t)l * B + b, top = bot + B;

  double n_level[2];
  for (int j = 0; j < 2; ++j) {
    const size_t at = j ? top : bot;
    const double t_j = t[at];
    n_level[j] = refractive_index(p[at], t_j,
                                  vapour_pressure(rho[at], t_j, c), c);
  }
  index_partials(p[bot], t[bot], rho[bot], c, dn_t + bot, dn_rho + bot);
  if (l == L - 2)
    index_partials(p[top], t[top], rho[top], c, dn_t + top, dn_rho + top);

  const double z0 = z[b], t0 = t[b];
  const double n0 = refractive_index(p[b], t0, vapour_pressure(rho[b], t0, c),
                                     c);
  const double r0 = c.earth_radius + z0;
  const double n0r0 = n0 * r0;
  const double z_bot = z[bot], z_top = z[top];
  const double r_bot = c.earth_radius + z_bot, r_top = c.earth_radius + z_top;
  const double dz = z_top - z_bot;
  const double n_layer = 0.5 * (n_level[0] + n_level[1]);
  const double inv_n_layer = 1.0 / n_layer;
  const double span = dz * (r_top + r_bot);

  for (int e = 0; e < E; ++e) {
    const double rk = n0r0 * cos_el[e] / n_layer;
    const double seg_top = sqrt(clamp_min((r_top - rk) * (r_top + rk), 0.0));
    const double seg_bot = sqrt(clamp_min((r_bot - rk) * (r_bot + rk), 0.0));
    const double denom = seg_top + seg_bot;
    const double denom_c = clamp_min(denom, 1.0);
    // chord_lengths
    const size_t out = ((size_t)e * (L - 1) + l) * B + b;
    ds[out] = (float)(span / denom_c * 1e-3);
    // chord_sensitivities: d(ds)/d(rk), zero where a clamp is active
    const double inv_top = seg_top > 0.0 ? 1.0 / clamp_min(seg_top, 1e-30)
                                         : 0.0;
    const double inv_bot = seg_bot > 0.0 ? 1.0 / clamp_min(seg_bot, 1e-30)
                                         : 0.0;
    const double dds_drk =
        denom > 1.0 ? span / (denom_c * denom_c) * rk * (inv_top + inv_bot)
                    : 0.0;
    dds_dnl[out] = (float)(dds_drk * (-rk / n_layer) * 1e-3);
    dds_dk[out] = (float)(dds_drk * inv_n_layer * 1e-3);
    if (l == 0) r0cos[(size_t)e * B + b] = (float)(r0 * cos_el[e]);
  }
}

constexpr int kThreads = 128;

}  // namespace

// The slant geometry of the K-matrix from cos(elevation) (E,) in float64 and
// the float32 level-major profiles z [m], p [hPa], T [K], rho [g/m^3]
// (L, B), all on the device: ds, dds_dnl, dds_dk (E, L-1, B), dn_t, dn_rho
// (L, B) and r0cos (E, B), float32.  rv, earth_radius and k1..k3 are
// constants/physics.py's RV and EARTH_RADIUS and ops/geometry.py's Rueeger
// coefficients.  Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int mwr_slant_geometry_lb(const double* cos_el, const float* z,
                                     const float* p, const float* t,
                                     const float* rho, int E, int L, int B,
                                     double rv, double earth_radius,
                                     double k1, double k2, double k3,
                                     float* ds, float* dds_dnl,
                                     float* dds_dk, float* dn_t,
                                     float* dn_rho, float* r0cos,
                                     void* stream) {
  if (E < 1 || L < 2 || B < 1) return cudaErrorInvalidValue;
  const long long blocks = ((long long)(L - 1) * B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  slant_geometry_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cos_el, z, p, t, rho, E, L, B, Constants{rv, earth_radius, k1, k2, k3},
      ds, dds_dnl, dds_dk, dn_t, dn_rho, r0cos);
  return static_cast<int>(cudaGetLastError());
}
