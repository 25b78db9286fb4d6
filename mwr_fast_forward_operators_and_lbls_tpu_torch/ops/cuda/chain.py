"""Primitive-rate microbenchmark kernel K7 (`csrc/chain.cu`), its wrapper and
plain version.

`chain` maps x (any shape) to sum_{j<8} op^k(x (1 + j 1e-3)) for one of the
elementwise primitives in `OPS`; timing it gives the card's rate for that
primitive (`parallel/profiling.py::measure_peaks`).  On CPU tensors it runs
`chain_reference`; on CUDA tensors it launches K7 or raises.
"""

import struct

import torch

from . import _build

N_CHAINS = 8


def _f32(value: float) -> float:
    """`value` rounded to float32, as the kernel's literals are: a float64
    evaluation of the plain version then follows the same recurrence."""
    return struct.unpack("f", struct.pack("f", value))[0]


_A, _B, _SHIFT, _SCALE = _f32(1.0000001), _f32(1e-9), _f32(1.3), _f32(1e-6)
# name -> (kernel selector, default applications per chain, plain version).
# fma, div and exp are the primitives of the roofline; div_fast and exp_fast
# are the approximate intrinsics, whose plain versions are the exact forms.
OPS = {
    "fma": (0, 96, lambda v: v * _A + _B),
    "div": (1, 24, lambda v: 1.0 / (v + _SHIFT)),
    "exp": (2, 24, lambda v: torch.exp(v * _SCALE)),
    "div_fast": (3, 24, lambda v: 1.0 / (v + _SHIFT)),
    "exp_fast": (4, 24, lambda v: torch.exp(v * _SCALE)),
}


def default_k(op: str) -> int:
    return OPS[op][1]


def chain_reference(x, op: str = "fma", k=None):
    """Plain version of K7: 8 scaled copies of x, `op` applied k times to
    each, summed.  `v * a + b` rounds twice here and once in the kernel's
    fmaf.  The constants are the kernel's float32 literals, so on a float64
    x this is the exact recurrence the kernel rounds.

    Only the fma chain's value depends on k: it drifts by a + b / v per
    step, most where v is small against b.  The div and exp maps contract
    to a fixed point (the divide by 0.3 a step, expf within three steps),
    so from k = 24 on their values hold the form of the primitive, not the
    chain's length."""
    _, k_default, fn = OPS[op]
    k = k_default if k is None else k
    a = [x * _f32(1.0 + j * 1e-3) for j in range(N_CHAINS)]
    for _ in range(k):
        a = [fn(v) for v in a]
    acc = a[0]
    for v in a[1:]:
        acc = acc + v
    return acc


def chain(x, op: str = "fma", k=None, threads: int = 256):
    """sum_{j<8} op^k(x (1 + j 1e-3)), shaped like x.

    op is a key of `OPS`; k the applications per chain: the kernel is
    built for the primitive's default and for twice it.  CPU tensors take
    the plain version.  CUDA tensors (float32, contiguous) launch K7 with
    `threads` per block (blocks of 32 leave an SM half its resident warps).
    """
    if op not in OPS:
        raise ValueError(f"unknown primitive {op!r}; have {tuple(OPS)}")
    selector, k_default, _ = OPS[op]
    k = k_default if k is None else int(k)
    if x.device.type == "cpu":
        return chain_reference(x, op, k)
    if k not in (k_default, 2 * k_default):
        raise ValueError(f"the {op} chain is built for k = {k_default} or "
                         f"{2 * k_default}, got {k}")
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"x: the chain kernel takes contiguous float32 CUDA "
                        f"tensors, got {x.dtype} on {x.device}")
    if not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"{x.numel()} elements out of range")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads {threads} out of range")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.library().mwr_chain(
            selector, k, x.data_ptr(), out.data_ptr(), x.numel(), threads,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {err}")
    chain.launches += 1
    return out


chain.launches = 0
