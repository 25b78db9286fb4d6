// K4: total absorption and its elementwise partials in T and rho, in one
// dual-number pass of the body in absorption.cuh (see the design notes
// there).

#include "absorption.cuh"

// alpha, dalpha/dT and dalpha/drho, each (F, N), for the N points of p, t,
// rho, lwc, all float32 on the device; the table carries no O3 lines.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mwr_absorption_tangents_lb(
    const float* p, const float* t, const float* rho, const float* lwc,
    const float* freqs, int nf, const float* tables, int table_size,
    int n_h2o, int n_o2, int h2o_off, int o2_off, int gl_off, int n,
    float* out, float* out_dt, float* out_dr, void* stream) {
  const Layout lay{n_h2o, n_o2, 0, h2o_off, o2_off, gl_off, gl_off};
  return dispatch<Dual>(nf, p, t, rho, lwc, nullptr, freqs, tables,
                        table_size, lay, n, out, out_dt, out_dr, stream);
}
