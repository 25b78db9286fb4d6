"""The distillation cell `hatpro_distill_b4096`: its entries load, its
configuration is the port's training step, its inputs are seeded and of the
stated sizes, a whole run at a small size on the CPU is correct and a fault
of the forward, the backward or the optimizer is not, nor the control, its
reference's gradient is autograd of the frozen fast operator and its Adam
step torch's, and K2v's count is positive and not above its body as
coded."""

import ast

import numpy as np
import pytest
import torch

from mwrbench import control, guard, manifest, run
from mwrbench.drivers import distill as driver_mod
from mwrbench.reference import distill as ref_distill
from mwrbench.reference import fast as ref_fast
from mwrbench.rooflines import counts
from mwrbench.rooflines import distill as distill_counts

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "hatpro_distill_b4096"
CONFIG = "hatpro_g5_distill_l180"
SMALL = {"batch": 3, "pool": 2, "n_levels": 40,
         "elevations_deg": [90.0, 19.2, 4.2], "fast_fit_profiles": 24,
         "samples": 2, "trace_calls": 2}
NEW_METRICS = ("distill.launches_per_call", "distill.glue_idle_ms_per_call",
               "device.idle_pct.distill", "k2v_roofline", "distill.step_mfu",
               "distill.k2mid_roofline")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _limits():
    return manifest.read_json(manifest.workload_path(CELL))["limits"]


def test_the_manifest_holds_the_cell_the_config_and_the_metrics(bench):
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == CONFIG
    assert cell["traffic"] == "closed_step4096_pool4"
    (config,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert config["reduced"] == [] and config["file"].endswith(
        f"configs/{CONFIG}.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert [m for m in e2e if manifest.reports(e2e[m], CELL)] == [
        "profiles_per_s", "call_ms_p95", "setup_s"]
    for name in ("profiles_per_s", "call_ms_p95"):
        assert e2e[name]["workloads"][-1] == CELL
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "profiles_per_s"
        assert manifest.reader_path("metrics", name).is_file()
    assert [n for n, m in per_layer.items()
            if manifest.reports(m, CELL)] == list(NEW_METRICS)
    # new entries go last
    assert list(per_layer)[-len(NEW_METRICS):] == list(NEW_METRICS)
    assert bench["workloads"][-1]["name"] == CELL
    assert bench["configs"][-1]["name"] == CONFIG


def test_the_configuration_is_the_ports_training_step():
    from mwr_fast_forward_operators_and_lbls_tpu_torch.models import fast
    config = manifest.read_json(manifest.config_path(CONFIG))
    spec = manifest.read_json(manifest.workload_path(CELL))
    default = fast.FastConfig()
    assert tuple(config["channels_ghz"]) == default.freqs_ghz
    assert tuple(config["elevations_deg"]) == default.elevations_deg
    assert config["teacher_model"] == default.teacher_model == "R24"
    assert config["n_levels"] == 180 and config["n_features"] == 72
    assert config["dtype"] == "float32" and config["tf32"] is False
    params = {"w": torch.zeros(72, 14)}
    defaults = fast.make_optimizer(params).defaults
    assert config["lr"] == defaults["lr"]
    assert tuple(config["adam_betas"]) == ref_distill.ADAM_BETAS \
        == defaults["betas"]
    assert config["adam_eps"] == ref_distill.ADAM_EPS == defaults["eps"]
    assert defaults["weight_decay"] == 0 and not defaults["amsgrad"]
    assert config["minibatch"] == spec["batch"] == 4096
    assert config["archive_profiles"] == spec["pool"] * spec["batch"]
    assert spec["samples"] == 4 and spec["trace_calls"] == 20
    assert set(config["assumed"]) == {"archive", "targets", "epochs"}


def test_the_driver_calls_only_the_parents_entry_points():
    """FastConfig, make_optimizer and train_step, and distill_loss for the
    check's cotangent, which the port had before the step had a kernel
    path, so the cell runs on either."""
    tree = ast.parse((manifest.HERE / "drivers" / "distill.py").read_text())
    used = {n.attr for n in ast.walk(tree)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "fast"}
    assert used == {"FastConfig", "make_optimizer", "train_step",
                    "distill_loss"}


def test_the_inputs_are_seeded_and_of_the_stated_sizes():
    config = dict(manifest.read_json(manifest.config_path(CONFIG)),
                  n_levels=40, fast_fit_profiles=24,
                  elevations_deg=[90.0, 4.2])
    a = driver_mod.make_inputs(2**31 + 11, config, 3, 2, CPU)
    b = driver_mod.make_inputs(2**31 + 11, config, 3, 2, CPU)
    c = driver_mod.make_inputs(2**31 + 12, config, 3, 2, CPU)
    for k, v in a["profiles"].items():
        assert v.shape == (2, 3, 40) and v.dtype == np.float32, k
        assert np.array_equal(v, b["profiles"][k]), k
    assert a["targets"].shape == (2, 3, 2, 14)
    assert a["targets"].dtype == np.float32
    assert a["w"].shape == (72, 14) and a["w"].dtype == np.float32
    assert np.array_equal(a["targets"], b["targets"])
    assert np.array_equal(a["w"], b["w"])
    assert not np.array_equal(a["profiles"]["t"], c["profiles"]["t"])
    assert not np.array_equal(a["w"], c["w"])
    assert np.isfinite(a["targets"]).all()


def _run(bench, trace=False, wrap=None):
    return run.measure(CELL, 2**31 + 2701, 0.3, trace, CPU, bench,
                       overrides=SMALL, wrap=wrap)


def test_the_program_is_correct(bench):
    result = _run(bench)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    limits = _limits()
    assert result["checks"].keys() == limits.keys()
    for name, c in result["checks"].items():
        assert np.isfinite(c["value"]) and c["value"] <= limits[name], name
    assert set(result["metrics"]) == {"profiles_per_s", "call_ms_p95",
                                      "setup_s"}


def test_a_traced_run_reads_the_metrics_it_can_on_the_cpu(bench):
    """No device operation runs on the CPU: the readers of device time give
    none (and raise nothing); the spans' idle time and the step's share
    are read."""
    metrics = _run(bench, trace=True)["metrics"]
    assert set(metrics) <= set(NEW_METRICS)
    for name in ("distill.glue_idle_ms_per_call", "distill.step_mfu"):
        assert np.isfinite(metrics[name]["value"]), name
    assert "k2v_roofline" not in metrics


def _the_sums_gradient(out):
    """The gradient of the summed loss, not of the mean."""
    return dict(out, grad=out["grad"] * 1260.0)


def _a_zero_gradient(out):
    """A backward that gives nothing, as a K2v that wrote zeros would."""
    return dict(out, grad=torch.zeros_like(out["grad"]))


def _a_sign_flipped_gradient(out):
    return dict(out, grad=-out["grad"])


def _a_skipped_step(out):
    """An optimizer that left the weights as they were."""
    return dict(out, w1=out["before"][0].clone())


def _a_step_of_sgd(out):
    """The weights moved by lr times the gradient, not by Adam's step."""
    return dict(out, w1=out["before"][0] - 1e-4 * out["grad"])


def _loss_moved(out):
    return dict(out, loss=out["loss"] * 1.01)


def _a_nan_in_the_gradient(out):
    grad = out["grad"].clone()
    grad[5, 3] = float("nan")
    return dict(out, grad=grad)


def _other_weights(out):
    """The gradient and loss kept against weights the step did not start
    from."""
    before = out["before"].clone()
    before[0] *= 1.05
    return dict(out, before=before)


@pytest.mark.parametrize("fault, number", (
    (_the_sums_gradient, "grad_rel_max"), (_loss_moved, "loss_rel"),
    (_a_nan_in_the_gradient, "nan_mismatch"), (_other_weights, "loss_rel"),
    (_a_zero_gradient, "grad_rel_max"),
    (_a_sign_flipped_gradient, "grad_rel_max"),
    (_a_skipped_step, "update_gap"), (_a_step_of_sgd, "update_gap")))
def test_a_fault_is_not_correct(bench, fault, number):
    result = _run(bench, wrap=lambda call: lambda i: fault(call(i)))
    assert not result["correct"], result["checks"]
    c = result["checks"][number]
    assert not c["value"] <= c["limit"], result["checks"]


def test_the_control_is_not_correct():
    numbers = control.control_numbers(CELL, 7, torch.bfloat16, CPU, SMALL)
    limits = _limits()
    assert numbers.keys() == limits.keys()
    assert any(not numbers[k] <= limits[k] for k in limits), numbers


def test_the_reference_imports_nothing_of_the_port():
    assert guard.reference_imports_program() == []
    tree = ast.parse((manifest.HERE / "reference" / "distill.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"numpy", "torch", "", "physics"}


FREQS = (22.24, 31.4, 54.94, 58.0)
ELEVS = (90.0, 30.0, 4.2)


def _small_case():
    from mwrbench import inputs
    prof = inputs.profiles(5, 3, 40)
    w = ref_fast.fit_closed_form(inputs.profiles(6, 8, 40), FREQS, "R24")
    tgt = ref_fast.forward(w, {k: torch.from_numpy(v).double()
                               for k, v in prof.items()}, FREQS,
                           ELEVS)[0].numpy() + 0.7
    return prof, w.astype(np.float64), tgt


def test_the_reference_gradient_is_autograd_of_the_fast_forward():
    """`tb_of` is `reference/fast.py::forward`'s arithmetic, to the bit, and
    the gradient is that forward's loss differentiated: central differences
    of `forward` agree with it."""
    prof, w, tgt = _small_case()
    x = {k: torch.from_numpy(v).double() for k, v in prof.items()}
    want = ref_fast.forward(w, x, FREQS, ELEVS)[0]
    got = ref_distill.tb_of(torch.from_numpy(w), x, FREQS, ELEVS)
    assert torch.equal(got, want)
    loss, grad = ref_distill.loss_and_grad(w, prof, tgt, FREQS, ELEVS,
                                           block=2)

    def forward_loss(wv):
        tb = ref_fast.forward(wv, x, FREQS, ELEVS)[0].numpy()
        return float(np.mean((tb - tgt) ** 2))

    assert loss == pytest.approx(forward_loss(w), rel=1e-12)
    rng = np.random.default_rng(0)
    live = np.argwhere(np.abs(grad.numpy()) > 1e-3 * np.abs(
        grad.numpy()).max())
    for j, c in live[rng.choice(len(live), 6, replace=False)]:
        h = 1e-6 * max(abs(w[j, c]), 1e-3)
        up, dn = w.copy(), w.copy()
        up[j, c] += h
        dn[j, c] -= h
        fd = (forward_loss(up) - forward_loss(dn)) / (2 * h)
        assert float(grad[j, c]) == pytest.approx(fd, rel=1e-5, abs=1e-9)


def test_the_blocks_change_only_the_order_of_the_sums():
    prof, w, tgt = _small_case()
    one = ref_distill.loss_and_grad(w, prof, tgt, FREQS, ELEVS, block=3)
    many = ref_distill.loss_and_grad(w, prof, tgt, FREQS, ELEVS, block=1)
    assert one[0] == pytest.approx(many[0], rel=1e-13)
    torch.testing.assert_close(one[1], many[1], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("series", (0.0, 0.5, 1.0))
def test_k2v_count_is_positive_and_not_above_its_body(series):
    need = distill_counts.k2v_roofline(4096, 180, 14, 10)
    coded = distill_counts.k2v_roofline(4096, 180, 14, 10, as_coded=True,
                                        series_fraction=series)
    for field in ("fma_ops", "div_ops", "exp_ops", "hbm_bytes"):
        assert 0 < getattr(need, field) <= getattr(coded, field), field
    assert 0 < need.time_bound_s() <= coded.time_bound_s()


def test_the_step_is_counted_as_stated():
    config = manifest.read_json(manifest.config_path(CONFIG))
    spec = manifest.read_json(manifest.workload_path(CELL))
    call = distill_counts.distill_call(spec, config)
    b, k = 4096, 179
    assert [r.fma_ops for r in call["product"] + call["backward"]] == [
        72.0 * 14 * k * b] * 2
    assert call["k2mid"] == [counts.k2_roofline(b, 180, 14, 10,
                                                alpha_is_mid=True)]
    (k2v,) = call["k2v"]
    assert k2v == distill_counts.k2v_roofline(b, 180, 14, 10)
    # alpha_mid read, its gradient written, z, n, T, the cotangent, the
    # channels and the elevations' cosines
    assert k2v.hbm_bytes == 4.0 * (2 * 14 * k * b + 3 * 180 * b
                                   + 10 * 14 * b + 14) + 8.0 * 10
    # it scales with the batch but for the channels and elevations
    half = distill_counts.k2v_roofline(b // 2, 180, 14, 10)
    assert half.fma_ops < k2v.fma_ops < 2.0 * half.fma_ops + 1e4


def test_the_vjp_of_the_losss_own_cotangent_is_the_gradient():
    """`loss_and_vjp` with the cotangent 2 (tb - target) / N of the float64
    forward gives `loss_and_grad`'s loss and gradient."""
    prof, w, tgt = _small_case()
    x = {k: torch.from_numpy(v).double() for k, v in prof.items()}
    tb = ref_distill.tb_of(torch.from_numpy(w), x, FREQS, ELEVS).numpy()
    cot = 2.0 * (tb - tgt) / tgt.size
    loss, grad = ref_distill.loss_and_grad(w, prof, tgt, FREQS, ELEVS,
                                           block=2)
    loss2, vjp = ref_distill.loss_and_vjp(w, prof, tgt, cot, FREQS, ELEVS,
                                          block=2)
    assert loss2 == loss
    torch.testing.assert_close(vjp, grad, rtol=1e-12, atol=1e-18)


def test_the_reference_adam_step_is_torchs():
    """Five steps of `adam_step` in float64 are torch.optim.Adam's at the
    configuration's learning rate, from zero moments."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(72, 14, dtype=torch.float64, generator=gen)
    leaf = w.clone().requires_grad_(True)
    opt = torch.optim.Adam([leaf], lr=1e-4)
    m = v = torch.zeros_like(w)
    b1, b2 = ref_distill.ADAM_BETAS
    for t in range(5):
        g = torch.randn(72, 14, dtype=torch.float64, generator=gen)
        leaf.grad = g.clone()
        opt.step()
        w = ref_distill.adam_step(w, m, v, t, g, 1e-4)
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        torch.testing.assert_close(w, leaf.detach(), rtol=1e-14, atol=0.0)
