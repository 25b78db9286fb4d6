// K1: total absorption alpha (F, N) at a set of channels; the body and its
// design notes are in absorption.cuh.

#include "absorption.cuh"

// alpha (F, N) for the N points of p, t, rho, lwc (and o3 unless null), all
// float32 on the device.  Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int mwr_absorption_lb(const float* p, const float* t,
                                 const float* rho, const float* lwc,
                                 const float* o3, const float* freqs, int nf,
                                 const float* tables, int table_size,
                                 int n_h2o, int n_o2, int n_o3, int h2o_off,
                                 int o2_off, int o3_off, int gl_off, int n,
                                 float* out, void* stream) {
  const Layout lay{n_h2o, n_o2, n_o3, h2o_off, o2_off, o3_off, gl_off};
  return dispatch<float>(nf, p, t, rho, lwc, o3, freqs, tables, table_size,
                         lay, n, out, nullptr, nullptr, stream);
}
