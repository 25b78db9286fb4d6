"""Device meshes and multi-process bring-up.

Torch counterpart of the JAX package's `parallel/mesh.py`.  The workload is
embarrassingly parallel over profiles (and their elevation fan-out) and over
monochromatic frequencies, so a 2-D grid of devices covers every layout:

Axes:
  data:     profiles; a batch is split into one shard per row of the grid,
            and the only traffic is the gather of the outputs (and the
            gradient sum of a distillation step).
  spectral: the monochromatic frequency grid, split into one slice per
            column of a row.

A `Mesh` is a plain grid of `torch.device`s: torch has no sharded arrays,
so the sharded entry points (`parallel/sharding.py`) place each shard
themselves and run the entry point once per shard on its device.  A device
may stand in the grid more than once: `[torch.device("cuda")] * 4` is a
virtual mesh of one card (and `[torch.device("cpu")] * 8` one of the host's
cores), the counterpart of the JAX tests' virtual CPU devices, on which the
shards run one after the other.

Under `initialize_distributed` every process holds its own rows of the
grid: a mesh made then spans all processes' devices along `data`, process
`rank` owning the rows `rank * R .. (rank + 1) * R - 1` of the R rows it was
given.
"""

import dataclasses
import math
from typing import Sequence

import torch

from ..ops.tensors import resolve_device

DATA_AXIS = "data"
SPECTRAL_AXIS = "spectral"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, spectral) grid of devices.

    devices: this process's rows of the grid, each a tuple of its spectral
      columns' devices.
    processes, rank: the process group the grid spans along `data` (1 and 0
      without `initialize_distributed`).
    """

    devices: tuple
    processes: int = 1
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices) * self.processes,
                SPECTRAL_AXIS: len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        """The device the sharded entry points gather their outputs on."""
        return self.devices[0][0]

    @property
    def local_devices(self) -> list:
        return [d for row in self.devices for d in row]

    @property
    def virtual(self) -> bool:
        """True when entries share hardware: a device repeats, or the
        entries are the host's CPU."""
        devs = self.local_devices
        return len(set(devs)) < len(devs) or devs[0].type == "cpu"


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _process_group() -> tuple:
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None) -> None:
    """Join a process group of `world_size` processes as `rank`, reached at
    `init_method` (for instance `tcp://localhost:29500`), over NCCL where
    there is a CUDA card and gloo on the CPU.

    A no-op for one process, so that the same entry points run everywhere.
    Each process computes on the devices it sees: give each its own cards
    (`CUDA_VISIBLE_DEVICES`), as each host of a cluster has.
    """
    if world_size is None or world_size <= 1:
        return
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def visible_devices() -> list:
    """Every visible CUDA device; RuntimeError without one (as
    `resolve_device`): the CPU is used only on request."""
    resolve_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Sequence | None = None, data: int | None = None,
              spectral: int = 1) -> Mesh:
    """A (data, spectral) mesh over `devices` (default: every visible CUDA
    device; RuntimeError without one).

    If `data` is None the data axis takes every device that `spectral` does
    not.  Under `initialize_distributed`, `devices` are this process's and
    `data` counts the rows of all processes together.
    """
    devices = (visible_devices() if devices is None
               else [_canonical(d) for d in devices])
    processes, rank = _process_group()
    n = len(devices) * processes
    if data is None:
        if n % spectral:
            raise ValueError(f"{n} devices not divisible by "
                             f"spectral={spectral}")
        data = n // spectral
    if data * spectral != n:
        raise ValueError(f"mesh {data}x{spectral} != {n} devices")
    if len(devices) % spectral:
        raise ValueError(f"spectral={spectral} does not divide the "
                         f"{len(devices)} device(s) of each process")
    rows = tuple(tuple(devices[i:i + spectral])
                 for i in range(0, len(devices), spectral))
    return Mesh(rows, processes, rank)


def single_device_mesh(device=None) -> Mesh:
    """A 1x1 mesh of `device` (the CUDA card when None), in this process
    alone: lets every sharded entry point also run on one device."""
    return Mesh(((_canonical(resolve_device(device)),),))


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m >= n (batch padding for even shards)."""
    return int(math.ceil(n / m) * m)
