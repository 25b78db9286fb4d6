"""The port's mesh and sharded entry points (`parallel/`) on 8 CPU entries:
the counterparts of tests/test_parallel.py, the sharded forward against the
JAX package's on its 8 virtual CPU devices, the dry run, and two processes
joined over gloo (the counterpart of tests/test_distributed.py)."""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mwr_fast_forward_operators_and_lbls_tpu_torch as tpkg
from mwr_fast_forward_operators_and_lbls_tpu.models import fast as jfast
from mwr_fast_forward_operators_and_lbls_tpu.models import lbl as jlbl
from mwr_fast_forward_operators_and_lbls_tpu.parallel import mesh as jmesh
from mwr_fast_forward_operators_and_lbls_tpu.parallel import (
    sharding as jshard)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
    fast, lbl, spectral)
from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import (
    dryrun, mesh as mesh_mod, scaling, sharding as shard_mod)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(tpkg.__file__)))
# the keys of the JAX package's `scaling.measure` rows
SCALING_KEYS = {"n_devices", "seconds", "spectra_per_s", "efficiency",
                "sharding_overhead_eff", "platform", "note"}


@pytest.fixture(scope="module")
def mesh8():
    return mesh_mod.make_mesh(CPU8, spectral=2)


def test_mesh_axes(mesh8):
    assert mesh8.shape == {"data": 4, "spectral": 2}
    assert mesh8.lead == torch.device("cpu") and mesh8.virtual
    assert len(mesh8.devices) == 4 and len(mesh8.local_devices) == 8
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(CPU8, data=3, spectral=2)
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(CPU8[:7], spectral=2)


def test_single_device_mesh_and_padding():
    m = mesh_mod.single_device_mesh("cpu")
    assert m.shape == {"data": 1, "spectral": 1}
    assert [mesh_mod.pad_to_multiple(n, 4) for n in (1, 4, 5, 8)] == \
        [4, 4, 8, 8]


def test_meshes_without_a_card_raise():
    """The default is the card: without one, every entry point that takes
    its devices from it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    for call in (mesh_mod.make_mesh, mesh_mod.single_device_mesh,
                 scaling.measure, lambda: dryrun.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device; pass "
                                               "device='cpu'"):
            call()


def test_forward_sharded_matches_single(mesh8):
    profiles = lbl.demo_batch(8, n_levels=60, device="cpu")
    cfg = lbl.LBLConfig(model="R17", elevations_deg=(90.0, 14.4))
    ref = lbl.forward_batch(profiles, cfg)
    out = shard_mod.forward_sharded(profiles, mesh8, cfg)
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert out[k].shape == v.shape, k
    np.testing.assert_allclose(out["tb"].numpy(), ref["tb"].numpy(),
                               rtol=0, atol=1e-4)


def test_a_profile_does_not_depend_on_its_batch():
    """The plain path computes each profile alone: the TB of a shard of 4
    equals that of the same profiles inside a batch of 16, to the bit, at
    the dry run's 180 levels and 4.2 degrees (its layer sum once ran in an
    order set by the batch, 1.2e-4 K apart)."""
    profiles = lbl.demo_batch(16, n_levels=180, device="cpu")
    cfg = lbl.LBLConfig(elevations_deg=(90.0, 4.2), outputs=("tb",))
    whole = lbl.forward_batch(profiles, cfg)["tb"]
    for s in range(0, 16, 4):
        part = lbl.forward_batch({k: v[s:s + 4] for k, v in profiles.items()},
                                 cfg)["tb"]
        np.testing.assert_array_equal(part.numpy(), whole[s:s + 4].numpy())


def test_forward_sharded_pads_odd_batch(mesh8):
    profiles = lbl.demo_batch(5, n_levels=40, device="cpu")
    cfg = lbl.LBLConfig(elevations_deg=(90.0,))
    out = shard_mod.forward_sharded(profiles, mesh8, cfg)
    assert out["tb"].shape[0] == 5
    np.testing.assert_allclose(out["tb"].numpy(),
                               lbl.forward_batch(profiles, cfg)["tb"].numpy(),
                               rtol=0, atol=1e-4)
    placed, b = shard_mod.shard_profiles(profiles, mesh8)
    assert b == 5 and len(placed) == 4
    assert all(s["z"].shape == (2, 40) for s in placed)
    # rows 5..7 of the padded batch are copies of row 0
    for k, v in profiles.items():
        assert torch.equal(placed[2][k][0], v[4])
        for row in (placed[2][k][1], placed[3][k][0], placed[3][k][1]):
            assert torch.equal(row, v[0])


def test_forward_sharded_matches_jax(mesh8):
    """The port's sharded forward against the JAX `forward_sharded` on its 8
    virtual CPU devices, at the tolerances `test_torch_lbl.py` holds the
    two `forward_batch`es to."""
    profiles = lbl.demo_batch(8, n_levels=60, device="cpu")
    cfg = lbl.LBLConfig(model="R17", elevations_deg=(90.0, 14.4))
    jcfg = jlbl.LBLConfig(model="R17", elevations_deg=(90.0, 14.4))
    out = shard_mod.forward_sharded(profiles, mesh8, cfg)
    want = jshard.forward_sharded(
        {k: jnp.asarray(v.numpy()) for k, v in profiles.items()},
        jmesh.make_mesh(jax.devices()[:8], spectral=2), jcfg)
    assert set(out) == set(want)
    np.testing.assert_allclose(out["tb"].numpy(), np.asarray(want["tb"]),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(out["t_mr"].numpy(), np.asarray(want["t_mr"]),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(out["tau_total"].numpy(),
                               np.asarray(want["tau_total"]), rtol=1e-3)
    np.testing.assert_allclose(out["trans_level"].numpy(),
                               np.asarray(want["trans_level"]), rtol=0,
                               atol=5e-3)


def test_spectral_sharded_matches_dense(mesh8):
    profiles = lbl.demo_batch(2, n_levels=40, device="cpu")
    f = np.linspace(51.0, 59.0, 25)        # odd: padded to 26 over 2
    tb = shard_mod.forward_spectral_sharded(profiles, f, mesh8,
                                            elevations_deg=(90.0,),
                                            freq_chunk=8)
    assert tb.shape == (2, 1, 25)
    dense = spectral.forward_spectral(profiles, f, (90.0,))["tb"]
    np.testing.assert_allclose(tb.numpy(), dense.numpy(), rtol=0, atol=1e-4)
    # the dense single-profile reference of tests/test_parallel.py
    f32 = torch.from_numpy(f.astype(np.float32))
    ref = torch.stack([lbl.forward_single(
        *(profiles[k][i] for k in ("z", "p", "t", "rho", "lwc")), f32,
        90.0)["tb"] for i in range(2)])
    np.testing.assert_allclose(tb[:, 0].numpy(), ref.numpy(), rtol=0,
                               atol=1e-4)


def test_srf_convolve_normalizes():
    tb = torch.stack([torch.full((6,), 100.0), torch.linspace(0, 5, 6)])
    w = torch.tensor([[1.0, 1, 1, 0, 0, 0], [0, 0, 0, 2, 2, 2]])
    out = shard_mod.srf_convolve(tb, w)
    np.testing.assert_allclose(out[0].numpy(), [100.0, 100.0], atol=1e-5)
    np.testing.assert_allclose(float(out[1, 1]), np.mean([3.0, 4.0, 5.0]),
                               atol=1e-5)


def test_scaling_harness():
    cfg = lbl.LBLConfig(model="R98", elevations_deg=(90.0,), outputs=("tb",))
    rows = scaling.measure(per_device_batch=2, n_levels=24,
                           device_counts=(1, 2), config=cfg, iters=3,
                           devices=CPU8)
    assert [r["n_devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["spectra_per_s"] > 0 for r in rows)
    assert all(set(r) == SCALING_KEYS for r in rows)
    assert all(r["platform"] == "cpu" and r["note"].startswith("virtual")
               for r in rows)


def test_dryrun_multichip_on_8_cpu_entries(capsys):
    out = dryrun.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out
    assert "dryrun_multichip(8): mesh {'data': 4, 'spectral': 2}" in line
    assert "platform=cpu, virtual mesh" in line and line.rstrip().endswith(
        "ok")
    # the sharded step against the unsharded one on the same batch
    assert out["loss"] == pytest.approx(out["loss_unsharded"], rel=1e-5)
    np.testing.assert_allclose(out["w"].numpy(), out["w_unsharded"].numpy(),
                               rtol=0, atol=1e-6)
    init = fast.init_params(fast.FastConfig(elevations_deg=(90.0, 19.2)),
                            device="cpu")["w"]
    # Adam's first step moves each weight by about its rate, 1e-4
    assert float((out["w"] - init).abs().max()) == pytest.approx(1e-4,
                                                                 rel=0.05)
    assert max(out["tb_delta"].values()) < 1e-4
    assert max(out["kernel_delta"].values()) < 1e-2
    assert out["spectral_delta"] < 1e-4 and out["k_delta"] <= 1e-4


def test_sharded_train_step_matches_the_jax_step(mesh8):
    """The dry run's split step from the JAX package's seeded weights
    (through `fast.params_from_numpy`) against the JAX `train_step` on the
    same batch and targets."""
    jcfg = jfast.FastConfig(elevations_deg=(90.0, 19.2))
    cfg = fast.FastConfig(elevations_deg=(90.0, 19.2))
    jparams = jfast.init_params(jcfg)
    w0 = np.array(jparams["w"])
    profiles = lbl.demo_batch(16, n_levels=24, device="cpu")
    jprof = {k: jnp.asarray(v.numpy()) for k, v in profiles.items()}
    targets = np.array(jlbl.forward_batch(jprof, jlbl.LBLConfig(
        freqs_ghz=jcfg.freqs_ghz, elevations_deg=jcfg.elevations_deg,
        outputs=("tb",)))["tb"])
    jnew, _, jloss = jfast.train_step(
        jparams, jfast._default_optimizer().init(jparams), jprof,
        jnp.asarray(targets), jcfg)

    params = fast.params_from_numpy({"w": w0}, device="cpu")
    placed, _ = shard_mod.shard_profiles(profiles, mesh8)
    loss = dryrun._train_step_sharded(params, fast.make_optimizer(params),
                                      placed, torch.from_numpy(targets),
                                      mesh8, cfg)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(params["w"].detach().numpy(),
                               np.asarray(jnew["w"]), rtol=0, atol=1e-6)


_WORKER = textwrap.dedent(f"""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]

    from {tpkg.__name__}.models import lbl
    from {tpkg.__name__}.parallel import mesh as m, sharding
    m.initialize_distributed(f"tcp://127.0.0.1:{{port}}", world_size=2,
                             rank=rank)
    mesh = m.make_mesh([torch.device("cpu")] * 2)   # 2 rows a process
    assert (mesh.shape, mesh.processes, mesh.rank) == (
        {{"data": 4, "spectral": 1}}, 2, rank), mesh
    # the same batch in both processes; each computes its own rows, at the
    # production 180 levels, padded from 5 to 8
    profiles = lbl.demo_batch(5, n_levels=180, device="cpu")
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 19.2, 4.2))
    res = sharding.forward_sharded(profiles, mesh, cfg)
    tb = sharding.forward_spectral_sharded(
        profiles, np.linspace(51.0, 59.0, 9), mesh, freq_chunk=4)
    np.savez(out, spectral=tb.numpy(),
             **{{k: v.numpy() for k, v in res.items()}})
    torch.distributed.destroy_process_group()
    print(f"proc {{rank}} OK")
""")


def test_two_process_gloo_forward_equals_single_process(tmp_path):
    """Two processes, two CPU entries each, joined over gloo on localhost:
    each process's `forward_sharded` (and spectral split) all-gathers the
    whole batch, equal to the single-process result on a 4-entry mesh."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(rank),
         str(tmp_path / f"out{rank}.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {rank} failed:\n{out}"
        assert f"proc {rank} OK" in out, out

    profiles = lbl.demo_batch(5, n_levels=180, device="cpu")
    cfg = lbl.LBLConfig(model="R24", elevations_deg=(90.0, 19.2, 4.2))
    mesh4 = mesh_mod.make_mesh([torch.device("cpu")] * 4)
    want = shard_mod.forward_sharded(profiles, mesh4, cfg)
    want_tb = shard_mod.forward_spectral_sharded(
        profiles, np.linspace(51.0, 59.0, 9), mesh4, freq_chunk=4)
    unsharded = lbl.forward_batch(profiles, cfg)["tb"]
    for rank in (0, 1):
        with np.load(tmp_path / f"out{rank}.npz") as got:
            assert set(got.files) == set(want) | {"spectral"}
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
            np.testing.assert_array_equal(got["spectral"], want_tb.numpy())
            np.testing.assert_allclose(got["tb"], unsharded.numpy(), rtol=0,
                                       atol=1e-4)
