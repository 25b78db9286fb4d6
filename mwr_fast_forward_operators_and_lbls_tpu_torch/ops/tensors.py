"""Argument promotion shared by the elementwise physics ops, and cached
device constants."""

import functools

import torch


def promote(*xs):
    """Tensors of one floating dtype (float32 at least) on one device.

    Python numbers and numpy arrays become tensors; the device is that of the
    first argument that is not on the CPU, so 0-d CPU scalars join CUDA
    profiles.
    """
    ts = [torch.as_tensor(x) for x in xs]
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ts),
                             torch.float32)
    device = next((t.device for t in ts if t.device.type != "cpu"),
                  ts[0].device)
    return [t.to(device=device, dtype=dtype) for t in ts]


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  Raises RuntimeError when
    None is given and there is no card: the CPU is used only on request."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def device_name(device: torch.device) -> str:
    """The card's name (`torch.cuda.get_device_name`), or the device's type
    off the card."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def input_device(x) -> torch.device:
    """The device an entry point works on, from one of its inputs: a tensor
    stays where it is (that is the caller asking, a CPU tensor for the
    CPU); a numpy array or a sequence goes to `resolve_device()`, the card."""
    if torch.is_tensor(x):
        return x.device
    try:
        return resolve_device()
    except RuntimeError as exc:
        raise RuntimeError(f"{exc}: give the profiles as CPU tensors, as "
                           f"demo_batch(..., device='cpu') does") from None


@functools.lru_cache(maxsize=64)
def _constant_vector(values: tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant_vector(values, dtype, device) -> torch.Tensor:
    """A 1-D tensor of `values` (channels, elevations) on `device`, made once
    and cached: a fresh host-to-device copy would wait for the stream.
    Treat it as read-only."""
    return _constant_vector(tuple(float(v) for v in values), dtype,
                            torch.device(device))
