"""Named host spans at the port's layer boundaries, in `torch.profiler`.

`span(name)` is the context manager each boundary is wrapped in.  Under a
running profiler (`parallel.profiling.trace`, or any `torch.profiler`
session) it is `torch.profiler.record_function(name)`: a `user_annotation`
event in the same Kineto trace as the CUDA activity, so the spans share a
clock with the device timeline and every device gap can be laid against
them.  Spans nest: the entry point's span is the root of each call and the
parent chain of an event names the layer that caused it.  With no profiler
running it is one shared `contextlib.nullcontext()`, and a span costs one
check of `torch.autograd._profiler_enabled()`.

The spans mark host work only: they sit in the batched entry points and,
in the kernel wrappers, after the CPU early return, so no `torch.func`
transform of a plain path runs inside one.

`SPAN_NAMES` is every name the port emits:

  lbl.*       models.lbl.forward_batch
  kmatrix.*   models.jacobians.kmatrix_batch_fast
  fast.*      models.fast.fast_forward_batch (the fast operator)
  fastk.*     models.jacobians.kmatrix_fast_adjoint_batch (its closed-form K)
  oem.*       models.retrieval.retrieve_batch (the 1D-Var retrieval; its
              oem.forward and oem.jacobian hold the fast.* and fastk.* spans)
  distill.*   models.fast.train_step (the distillation's training step; on
              the card its loss and backward replay CUDA graphs, so the
              fast.* and cuda.* spans under distill.loss and
              distill.backward appear in an optimizer's first step only)
  spectral.*  models.spectral.forward_spectral and srf_convolve
  cuda.*      the kernel wrappers of ops/cuda (K1-K6, the K-matrix's
              slant geometry, the fast K and K2's backward), on the card
              only
  stage.*     pipeline.forward.forward_stage
"""

import contextlib

import torch

SPAN_NAMES = frozenset({
    "lbl.forward_batch", "lbl.layout", "lbl.refractive_index",
    "lbl.output_layout",
    "kmatrix.kmatrix_batch_fast", "kmatrix.layout", "kmatrix.dalpha_dlwc",
    "kmatrix.slant_geometry", "kmatrix.output_layout",
    "fast.forward_batch", "fast.layout", "fast.extinction",
    "fast.refractive_index", "fast.output_layout",
    "fastk.kmatrix_fast_adjoint_batch", "fastk.geometry", "fastk.partials",
    "fastk.rte_adjoint", "fastk.assembly",
    "oem.retrieve_batch", "oem.prior", "oem.forward", "oem.jacobian",
    "oem.accept", "oem.solve", "oem.dofs",
    "distill.train_step", "distill.loss", "distill.backward",
    "distill.optimizer",
    "spectral.forward_spectral", "spectral.layout",
    "spectral.slant_geometry", "spectral.chunk", "spectral.srf_convolve",
    "cuda.absorption_lb", "cuda.forward_lb", "cuda.downwelling_lb",
    "cuda.absorption_tangents_lb", "cuda.kmatrix_assembled_lb",
    "cuda.kmatrix_assembled_rho_lwc_lb", "cuda.absorption_spectral",
    "cuda.slant_geometry_lb", "cuda.fastk_adjoint", "cuda.forward_lb_vjp",
    "stage.forward_stage", "stage.screen", "stage.upload", "stage.enqueue",
    "stage.mask", "stage.pull",
})

_OFF = contextlib.nullcontext()


def span(name: str):
    """The span `name` (one of `SPAN_NAMES`) under a running profiler, and
    a shared null context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
