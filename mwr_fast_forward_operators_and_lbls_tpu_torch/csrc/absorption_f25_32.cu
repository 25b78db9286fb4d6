// K1's bodies at 25 to 32 channels (absorption_points.cuh, notes in
// absorption.cu), in a file of their own: nvcc compiles each file in a
// process of its own, so these wide bodies build beside the rest.

#include "absorption_points.cuh"

void* absorption_points_f25_32(int nf) {
  switch (nf) {
    MWR_K1_CASE(25) MWR_K1_CASE(26) MWR_K1_CASE(27) MWR_K1_CASE(28)
    MWR_K1_CASE(29) MWR_K1_CASE(30) MWR_K1_CASE(31) MWR_K1_CASE(32)
  }
  return nullptr;
}
