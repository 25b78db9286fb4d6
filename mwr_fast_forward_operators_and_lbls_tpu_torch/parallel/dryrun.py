"""Multi-device dry run: every split of the mesh on a small batch, each held
to its unsharded counterpart.

Torch counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.
On an n-entry mesh (spectral=2 when n is even) it runs:

  (a) one data-parallel distillation step of the fast operator, with its
      weights `w` (features, channels) split by channel columns over
      `spectral`: each (data, spectral) entry takes the loss of its
      profiles and channels and its gradient, the gradients are summed onto
      the lead device (the all-reduce) and one Adam step follows; held to
      `fast.train_step` on the whole batch, on the same path (on the card
      K2 and K2v, on the CPU the plain version);
  (b) the spectral split, `forward_spectral_sharded` plus `srf_convolve`,
      against the dense `forward_spectral`;
  (c) the batch split, `forward_sharded`, at 24 and 180 levels against the
      unsharded `forward_batch` (1e-4 K, the JAX dry run's bound), and the
      kernel path against the plain path (1e-2 K);
  (d) the batch-split K-matrix (`kmatrix_batch_fast`, on the card K4, K5a
      and K5b per shard), finite and equal to the unsharded one.

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.parallel.dryrun [N]

runs it on the card (N entries: N cards where there are N, else N entries
of one card, a virtual mesh).
"""

import dataclasses
import sys

import torch

from ..models import fast, jacobians, lbl
from ..models import spectral as spec_mod
from . import mesh as mesh_mod
from . import sharding as shard_mod

TB_BOUND_K = 1e-4          # sharded against unsharded
KERNEL_BOUND_K = 1e-2      # the kernel path against the plain path
K_BOUND = 1e-4             # of max |K|, sharded against unsharded
LOSS_RTOL = 1e-5           # the sharded step's loss against the unsharded
W_BOUND = 1e-6             # its weights: 1 % of Adam's first step (1e-4)
WRT = ("t", "rho", "lwc")


def _rows(x: torch.Tensor, mesh: mesh_mod.Mesh, i: int) -> torch.Tensor:
    """The rows of a gathered (B, ...) tensor that local data row i holds."""
    size = x.shape[0] // mesh.shape[mesh_mod.DATA_AXIS]
    first = (mesh.rank * len(mesh.devices) + i) * size
    return x[first:first + size]


def _train_step_sharded(params: dict, optimizer, placed: list, targets,
                        mesh: mesh_mod.Mesh,
                        config: fast.FastConfig = fast.FastConfig()):
    """One distillation step with the batch split over `data` and the
    weights' channel columns over `spectral`: `fast.train_step` on the
    whole batch, computed per mesh entry.

    placed: `shard_profiles` of a batch whose size the data axis divides;
    targets: the teacher's tb (B, E, C) gathered on the lead device.  Each
    entry differentiates its profiles and channels (the channels'
    extinction and RTE are independent) on the path `fast.train_step`
    takes at `config.use_kernels` (on the card K2 and its backward K2v),
    the backward's products in full float32 as there, the gradients are
    summed onto the lead device (and over processes), and `optimizer` takes
    one step on `params["w"]`.  Returns the loss before the step.
    """
    w = params["w"]
    cols = torch.arange(w.shape[1]).chunk(mesh.shape[mesh_mod.SPECTRAL_AXIS])
    count = targets.numel()
    grad = torch.zeros_like(w)
    loss = torch.zeros((), dtype=w.dtype, device=w.device)
    for i, (shard, row) in enumerate(zip(placed, mesh.devices)):
        tgt = _rows(targets, mesh, i)
        for c, dev in zip(cols, row):
            sub = dataclasses.replace(
                config, freqs_ghz=tuple(config.freqs_ghz[j] for j in c),
                outputs=("tb",))
            w_part = w.detach()[:, c].to(dev).requires_grad_(True)
            pred = fast.fast_forward_batch(
                {"w": w_part}, {k: v.to(dev) for k, v in shard.items()},
                sub)["tb"]
            part = torch.sum((pred - tgt[:, :, c].to(dev)) ** 2) / count
            with fast._true_fp32_matmul():
                part.backward()
            grad[:, c] += w_part.grad.to(w.device)
            loss += part.detach().to(w.device)
    if mesh.processes > 1:
        import torch.distributed as dist

        dist.all_reduce(grad)
        dist.all_reduce(loss)
    optimizer.zero_grad(set_to_none=True)
    w.grad = grad
    optimizer.step()
    return loss


def _max_rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run (a)-(d) on an `n_devices`-entry mesh and print one line naming
    the platform.

    device: None for the CUDA card(s) (RuntimeError without one): the first
    n cards where there are n, else n entries of the first card (a virtual
    mesh); a device ("cpu") for n entries of it.  Any check that fails
    raises.  Returns the numbers checked: the sharded step's loss and
    weights with the unsharded step's, and each delta.
    """
    if device is None:
        cards = mesh_mod.visible_devices()
        devices = (cards[:n_devices] if len(cards) >= n_devices
                   else [cards[0]] * n_devices)
    else:
        devices = [torch.device(device)] * n_devices
    spectral = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    m = mesh_mod.make_mesh(devices, spectral=spectral)
    lead = m.lead

    # (a) data- and channel-split distillation step
    cfg = fast.FastConfig(elevations_deg=(90.0, 19.2))
    profiles = lbl.demo_batch(2 * n_devices, n_levels=24, device=lead)
    placed, _ = shard_mod.shard_profiles(profiles, m)
    teacher_cfg = lbl.LBLConfig(model=cfg.teacher_model,
                                freqs_ghz=cfg.freqs_ghz,
                                elevations_deg=cfg.elevations_deg,
                                outputs=("tb",))
    targets = shard_mod.forward_sharded_placed(placed, m, teacher_cfg)["tb"]
    params = fast.init_params(cfg, device=lead)
    ref = {"w": params["w"].clone()}
    loss = _train_step_sharded(params, fast.make_optimizer(params), placed,
                               targets, m, cfg)
    loss_ref = fast.train_step(ref, fast.make_optimizer(ref), profiles,
                               targets, cfg)
    w_delta = float((params["w"] - ref["w"]).detach().abs().max())
    if not (torch.isfinite(loss) and abs(float(loss) - float(loss_ref))
            <= LOSS_RTOL * abs(float(loss_ref)) and w_delta <= W_BOUND):
        raise RuntimeError(f"sharded step: loss {float(loss)} against "
                           f"{float(loss_ref)}, max |dw| {w_delta}")

    # (b) the spectral split and the SRF reduce
    f_grid = torch.linspace(50.0, 60.0, 16 * spectral)
    two = {k: v[:2] for k, v in profiles.items()}
    tb_mono = shard_mod.forward_spectral_sharded(two, f_grid, m,
                                                 elevations_deg=(90.0,))
    tb_chan = shard_mod.srf_convolve(
        tb_mono, torch.ones((4, f_grid.numel()), device=lead))
    dense = spec_mod.forward_spectral(two, f_grid, (90.0,))["tb"]
    spectral_delta = float((tb_mono - dense).abs().max())
    if not (bool(torch.isfinite(tb_chan).all())
            and spectral_delta < TB_BOUND_K):
        raise RuntimeError(f"spectral split: {spectral_delta} K")

    # (c) the batch split at 24 and 180 levels, (d) its K-matrix
    cfg_lbl = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 4.2))
    prof180 = lbl.demo_batch(2 * n_devices, n_levels=180, device=lead)
    deltas = {}
    for n_lev, prof, outputs in ((24, profiles, cfg_lbl.outputs),
                                 (180, prof180, ("tb",))):
        c = dataclasses.replace(cfg_lbl, outputs=outputs)
        out = shard_mod.forward_sharded(prof, m, c)
        want = lbl.forward_batch(prof, c)
        plain = shard_mod.forward_sharded(
            prof, m, dataclasses.replace(c, use_kernels=False))
        deltas[n_lev] = (float((out["tb"] - want["tb"]).abs().max()),
                         float((out["tb"] - plain["tb"]).abs().max()))
        if not (set(out) == set(outputs) and deltas[n_lev][0] < TB_BOUND_K
                and deltas[n_lev][1] < KERNEL_BOUND_K):
            raise RuntimeError(f"batch split at {n_lev} levels: sharded - "
                               f"unsharded, kernels - plain {deltas[n_lev]}")
    placed180, _ = shard_mod.shard_profiles(prof180, m)
    k = shard_mod.map_data_shards(
        lambda pr: jacobians.kmatrix_batch_fast(pr, cfg_lbl, wrt=WRT),
        placed180, m)
    k_ref = jacobians.kmatrix_batch_fast(prof180, cfg_lbl, wrt=WRT)
    k_delta = max(_max_rel(k[n], k_ref[n]) for n in WRT)
    if not (all(bool(torch.isfinite(k[n]).all()) for n in WRT)
            and k_delta <= K_BOUND):
        raise RuntimeError(f"batch-split K-matrix: {k_delta} of max |K|")

    platform = (f"{lead.type}, virtual mesh ({n_devices} entries on one "
                f"{'card' if lead.type == 'cuda' else 'host'})"
                if m.virtual else f"{lead.type}, {n_devices} devices")
    print(f"dryrun_multichip({n_devices}): mesh {m.shape} "
          f"platform={platform} loss={float(loss):.4f} "
          f"(unsharded {float(loss_ref):.4f}, max |dw| {w_delta:.2e}) "
          f"sharded_vs_unsharded_tb_delta={deltas[24][0]:.2e} K (24 "
          f"levels) / {deltas[180][0]:.2e} K (180 levels), kernels vs plain "
          f"{deltas[180][1]:.2e} K, spectral {spectral_delta:.2e} K, "
          f"K {k_delta:.2e} of max |K| ok")
    return {"mesh": m.shape, "virtual": m.virtual, "loss": float(loss),
            "loss_unsharded": float(loss_ref), "w": params["w"].detach(),
            "w_unsharded": ref["w"].detach(), "w_delta": w_delta,
            "tb_delta": {n: d[0] for n, d in deltas.items()},
            "kernel_delta": {n: d[1] for n, d in deltas.items()},
            "spectral_delta": spectral_delta, "k_delta": k_delta}


if __name__ == "__main__":  # pragma: no cover - hardware entry point
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
