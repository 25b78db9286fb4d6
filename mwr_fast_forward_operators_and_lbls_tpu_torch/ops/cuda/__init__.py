"""Hand-written CUDA kernels of the port, each with its ctypes wrapper, its
launch count and its plain torch version:

  absorption.absorption_lb           <- csrc/absorption.cu           (K1)
  rte.forward_lb                     <- csrc/rte.cu                  (K2)
  rte.forward_lb_vjp                 <- csrc/rte_vjp.cu              (K2v)
  rte.downwelling_lb                 <- csrc/rte.cu                  (K3)
  absorption.absorption_tangents_lb  <- csrc/absorption_tangents.cu  (K4)
  adjoint.kmatrix_assembled_lb,
  adjoint.kmatrix_assembled_rho_lwc_lb  <- csrc/adjoint.cu           (K5)
  spectral.absorption_spectral       <- csrc/absorption_spectral.cu  (K6)
  chain.chain                        <- csrc/chain.cu                (K7)
  geometry.slant_geometry_lb         <- csrc/geometry.cu    (K geometry)
  fastk.fastk_adjoint                <- csrc/fastk.cu       (the fast K)

Every wrapper but K7's microbenchmark takes `use_kernels: bool = True` and
decides by one rule, `launches`, whether its kernel runs: a CPU tensor, or
use_kernels=False, runs the plain version (the wrapper's `..._reference`,
in any dtype and differentiable); a CUDA float32 tensor with use_kernels
launches the kernel; a CUDA tensor of another dtype with use_kernels raises
ValueError.  The entry points in `models/` and `pipeline/` pass their
config's `use_kernels` through and decide nothing themselves.

A wrapper's `launches` counts the launches that ran (`count_launch`): a
call made while the stream captures a CUDA graph records its kernel
without running it, and goes to the wrapper's `captured` instead; whoever
replays the graph adds its launches to `launches` on each replay
(`models.fast._graphed_loss`).
"""

import torch


def launches(x: torch.Tensor, use_kernels: bool = True) -> bool:
    """The rule above, on the tensor `x` a wrapper decides by: True where
    the kernel launches, False where the plain version runs."""
    if not use_kernels or x.device.type == "cpu":
        return False
    if x.dtype != torch.float32:
        raise ValueError(f"the CUDA kernels are float32 only; got {x.dtype} "
                         f"on {x.device} (use_kernels=False runs the plain "
                         f"torch version in any dtype)")
    return True


def count_launch(wrapper) -> bool:
    """Counts one launch of `wrapper`'s kernel: in `wrapper.launches`, and
    True; while the current stream captures a CUDA graph, when the kernel
    is recorded and does not run, in `wrapper.captured`, and False."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        wrapper.captured = getattr(wrapper, "captured", 0) + 1
        return False
    wrapper.launches += 1
    return True
