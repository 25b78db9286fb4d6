"""Hand-written CUDA kernels of the port, each with its ctypes wrapper, its
launch count and its plain torch version:

  absorption.absorption_lb  <- csrc/absorption.cu  (total absorption, K1)
  rte.forward_lb            <- csrc/rte.cu         (geometry + RTE, K2)
"""
