// K1's bodies at 17 to 24 channels (absorption_points.cuh, notes in
// absorption.cu), in a file of their own: nvcc compiles each file in a
// process of its own, so these wide bodies build beside the rest.

#include "absorption_points.cuh"

void* absorption_points_f17_24(int nf) {
  switch (nf) {
    MWR_K1_CASE(17) MWR_K1_CASE(18) MWR_K1_CASE(19) MWR_K1_CASE(20)
    MWR_K1_CASE(21) MWR_K1_CASE(22) MWR_K1_CASE(23) MWR_K1_CASE(24)
  }
  return nullptr;
}
