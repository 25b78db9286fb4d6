"""Sharded entry points: the batch split and the spectral split over a mesh.

Torch counterpart of the JAX package's `parallel/sharding.py`.  There the
inputs carry `NamedSharding`s and XLA (or `shard_map`, for the Pallas path)
runs one program per device.  Here the split is written out: each shard is
placed on its device of the mesh (`shard_profiles`, and the frequency slices
of `forward_spectral_sharded`), the port's entry point runs once per shard
on that device, and the outputs are gathered onto the mesh's lead device
(`map_data_shards`) and, under `initialize_distributed`, `all_gather`ed
across processes.  The gather is the only traffic: no shard depends on
another.

The launches are asynchronous, so shards on distinct cards overlap; the
shards of a virtual mesh run one after the other on the card's current
stream.  A shard whose kernel fails fails the call: nothing falls back to
the plain path or the CPU.
"""

import functools

import numpy as np
import torch

from ..models import lbl, spectral
from ..models.spectral import srf_convolve  # noqa: F401 (re-exported)
from .mesh import DATA_AXIS, SPECTRAL_AXIS, Mesh, pad_to_multiple


def _pad_rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """v with its leading axis padded to n by copies of row 0."""
    if v.shape[0] == n:
        return v
    return torch.cat([v, v[:1].expand(n - v.shape[0], *v.shape[1:])])


def shard_profiles(profiles: dict, mesh: Mesh):
    """Split a dict of (B, L) profile arrays over the `data` axis.

    B is padded up to a multiple of the data-axis size with copies of row 0,
    which keep the padded rows numerically benign.  Returns (placed, B):
    `placed` holds one dict of (B_pad / n_data, L) tensors per row of the
    mesh that this process owns, each on the row's first device; the
    sharded entry points slice their outputs back to B.
    """
    n_data = mesh.shape[DATA_AXIS]
    b = int(profiles["z"].shape[0])
    bp = pad_to_multiple(b, n_data)
    size = bp // n_data
    first = mesh.rank * len(mesh.devices)
    padded = {k: _pad_rows(torch.as_tensor(v), bp)
              for k, v in profiles.items()}
    placed = [{k: v[(first + i) * size:(first + i + 1) * size].to(row[0])
               for k, v in padded.items()}
              for i, row in enumerate(mesh.devices)]
    return placed, b


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x (this process's rows) concatenated with every other process's, in
    rank order; x itself in one process."""
    if mesh.processes == 1:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.processes)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _gather(parts: list, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards' outputs concatenated along `dim` on the lead device; one
    part is returned as it is."""
    if len(parts) == 1:
        return parts[0].to(mesh.lead)
    return torch.cat([p.to(mesh.lead) for p in parts], dim=dim)


def map_data_shards(fn, placed: list, mesh: Mesh) -> dict:
    """fn(shard) -> {name: (b, ...)} on each data shard, on its device; the
    outputs gathered along the batch axis on the lead device and across
    processes (B_pad rows, in the order of `shard_profiles`)."""
    outs = [fn(shard) for shard in placed]
    return {k: _all_gather(_gather([o[k] for o in outs], mesh), mesh)
            for k in outs[0]}


def forward_sharded(profiles: dict, mesh: Mesh,
                    config: lbl.LBLConfig = lbl.LBLConfig()) -> dict:
    """Batch-data-parallel LBL forward over the mesh.

    profiles: dict of (B, L) arrays (padded to a multiple of the data-axis
    size).  Returns the dict of `lbl.forward_batch`, on the mesh's lead
    device.
    """
    placed, b = shard_profiles(profiles, mesh)
    out = forward_sharded_placed(placed, mesh, config)
    return {k: v[:b] for k, v in out.items()}


def forward_sharded_placed(placed: list, mesh: Mesh,
                           config: lbl.LBLConfig = lbl.LBLConfig()) -> dict:
    """`forward_sharded` for shards already padded and placed by
    `shard_profiles` (the hot-loop form: no padding or host-to-device copy
    per call).  Returns the padded batch.

    On the card each shard launches K1, then the refractive index in plain
    torch, then K2.  The data axis's spectral columns hold replicas of the
    shard: the forward runs once per shard, on the row's first device.
    """
    return map_data_shards(functools.partial(lbl.forward_batch,
                                             config=config), placed, mesh)


def forward_spectral_sharded(profiles: dict, f_ghz, mesh: Mesh,
                             model: str = "R24", elevations_deg=(90.0,),
                             freq_chunk: int = 4096) -> torch.Tensor:
    """Monochromatic LBL with the frequency grid split over `spectral` and
    the profiles over `data`: tb (B, E, F) on the mesh's lead device.

    The grid, rounded to float32, is padded to a multiple of the spectral
    size with its last frequency.  Each (data, spectral) entry runs
    `models/spectral.forward_spectral` on its shard of profiles and its
    slice of the grid (on the card, K6 then K3 per chunk of `freq_chunk`);
    the slices are gathered along frequency, the shards along the batch.
    Every frequency is computed alone, so the split changes no value.
    """
    n_s = mesh.shape[SPECTRAL_AXIS]
    f = (f_ghz if torch.is_tensor(f_ghz)
         else torch.from_numpy(np.asarray(f_ghz, np.float32)))
    f = f.to(torch.float32).reshape(-1)
    nf = f.numel()
    f = torch.cat([f, f[-1:].expand(pad_to_multiple(nf, n_s) - nf)])
    slices = f.chunk(n_s)
    placed, b = shard_profiles(profiles, mesh)
    elevs = tuple(float(e) for e in elevations_deg)

    def row_tb(shard, row):
        parts = [spectral.forward_spectral(
            {k: v.to(dev) for k, v in shard.items()}, fs.to(dev), elevs,
            model, freq_chunk=freq_chunk)["tb"]
            for fs, dev in zip(slices, row)]
        return _gather(parts, mesh, dim=2)

    rows = [row_tb(shard, row) for shard, row in zip(placed, mesh.devices)]
    return _all_gather(_gather(rows, mesh), mesh)[:b, :, :nf]
