"""Hand-written CUDA kernels of the port, each with its ctypes wrapper, its
launch count and its plain torch version:

  absorption.absorption_lb           <- csrc/absorption.cu           (K1)
  rte.forward_lb                     <- csrc/rte.cu                  (K2)
  rte.downwelling_lb                 <- csrc/rte.cu                  (K3)
  absorption.absorption_tangents_lb  <- csrc/absorption_tangents.cu  (K4)
  adjoint.kmatrix_assembled_lb,
  adjoint.kmatrix_assembled_rho_lwc_lb  <- csrc/adjoint.cu           (K5)
  spectral.absorption_spectral       <- csrc/absorption_spectral.cu  (K6)
  chain.chain                        <- csrc/chain.cu                (K7)
  geometry.slant_geometry_lb         <- csrc/geometry.cu    (K geometry)
  fastk.fastk_adjoint                <- csrc/fastk.cu       (the fast K)
"""
