"""mwr_fast_forward_operators_and_lbls_tpu_torch — the PyTorch/CUDA port of the
ground-based microwave radiative-transfer framework.

The JAX package `mwr_fast_forward_operators_and_lbls_tpu` beside it is the
reference.  This package imports torch, numpy and scipy, never jax, and
nothing of the JAX package: it keeps its own copy of the spectroscopy tables
(see `constants`).  Its subpackages mirror the JAX package's layout.  The
operators run on CUDA through hand-written kernels under `csrc/`, built with
nvcc at first use.
"""

__version__ = "0.1.0"

from .models.lbl import LBLConfig, forward_batch, forward_single  # noqa: F401
