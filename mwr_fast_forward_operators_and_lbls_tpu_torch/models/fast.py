"""Fast forward operator: a predictor regression distilled from the LBL.

Torch counterpart of the JAX package's `models/fast.py`.  The regression
predicts layer-mean *extinction* [Np/km] from thermodynamic features, and the
exact refraction-bent slant geometry (`ops/geometry.py`) supplies the path
lengths, so one coefficient set serves every elevation angle.  The feature
map is built from the pressure and temperature scalings of the O2 60-GHz
complex (~ p^2 theta^n), the H2O lines (~ rho p theta^n), the self continuum
(~ rho^2 theta^n) and cloud liquid (~ lwc theta^n), times a piecewise-linear
hat basis over log-pressure: 18 x 4 = 72 features, linear in the weights
`w` (72, C).

    profiles (B, L) x elevations (E) x channels (C)  ->  TB (B, E, C)

`fast_forward_batch` is one pipeline: one transpose to the (L, B) layout,
the features as (72, L-1, B), one matrix product landing as (C, L-1, B), the
refractive index, then geometry and RTE on the layer-mean extinction
(`ops/cuda/rte.py::forward_lb` with `alpha_is_mid`): kernel K2, or its plain
version by the rule of `ops.cuda.launches`.  Training (`distill_loss`,
`train_step`, `distill`) runs the same pipeline under autograd: where K2
launches, its backward is K2v (`forward_lb_vjp`), autograd takes the
gradient on through the clamp and the product to the weights, and the
step's loss runs as a CUDA graph of that forward and backward
(`_graphed_loss`); elsewhere (the CPU, float64, use_kernels=False) autograd
differentiates the plain version.  The teacher's targets come from the LBL
absorption (kernel K1 where it launches).
"""

import contextlib
import dataclasses
import weakref

import numpy as np
import torch
from torch import nn

from ..constants import hatpro
from ..data import preprocess
from ..ops import geometry, rte, thermo
from ..ops.cuda import launches
from ..ops.cuda.absorption import absorption_lb
from ..ops.cuda.rte import forward_lb, forward_lb_vjp
from ..ops.spans import span
from ..ops.tensors import (constant_vector, input_device,
                           resolve_device)  # noqa: F401 (re-exported)
from . import lbl

N_BASE_FEATURES = 18
N_P_BINS = 4
N_FEATURES = N_BASE_FEATURES * N_P_BINS
# knots of the log-pressure hat basis [hPa]: 5 .. 1013
_LOGP_KNOTS = tuple(np.linspace(np.log(5.0), np.log(1013.0), N_P_BINS))
# the level columns of a profile, in the order the pipeline stacks them
_PROFILE_KEYS = ("z", "p", "t", "rho", "lwc")


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Static configuration of the fast operator."""

    freqs_ghz: tuple = tuple(hatpro.HATPRO_FREQS_GHZ.tolist())
    elevations_deg: tuple = tuple(hatpro.ELEVATIONS_DEG.tolist())
    teacher_model: str = "R24"
    dtype: str = "float32"
    # Passed to the kernels' wrappers (`ops.cuda.launches`): K2 serves and
    # K1 computes the teacher's targets where they launch.  False runs the
    # plain torch versions on any device.
    use_kernels: bool = True
    outputs: tuple = ("tb", "tau_total", "t_mr", "trans_level")


@contextlib.contextmanager
def _true_fp32_matmul():
    """Float32 matrix products inside the block run in full float32 on the
    card, whatever the process allows elsewhere: extinction spans five
    decades and the weights carry signed cancellations, so TF32's ~1e-3
    relative error would become several K at 4.2 degrees."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _knots(like):
    """The hat basis' knots k and their lower and upper neighbours lo, hi
    (100 log units beyond the ends), each (4, 1, ..., 1) against `like`."""
    k = np.asarray(_LOGP_KNOTS)
    lo = np.concatenate([[k[0] - 100.0], k[:-1]])
    hi = np.concatenate([k[1:], [k[-1] + 100.0]])
    shape = (N_P_BINS,) + (1,) * like.ndim
    return (constant_vector(v, like.dtype, like.device).reshape(shape)
            for v in (k, lo, hi))


def _hats(p_hpa_mid):
    """The N_P_BINS hat functions over log p, stacked on a new axis 0.

    Partition of unity inside [5, 1013] hPa, clamped (constant) outside, so
    the regression extrapolates flatly.
    """
    lp = torch.log(torch.clamp_min(p_hpa_mid, 1e-3))
    k, lo, hi = _knots(lp)
    up = torch.clamp((lp - lo) / (k - lo), 0.0, 1.0)
    dn = torch.clamp((hi - lp) / (hi - k), 0.0, 1.0)
    return torch.where(lp <= k, up, dn)


def _logp_hat_basis(p_hpa_mid):
    """Piecewise-linear hat functions over log p: (..., K) -> (..., K, 4)."""
    return torch.movedim(_hats(p_hpa_mid), 0, -1)


def _scaled_means(p_hpa, t_k, rho_gm3, lwc_gm3, axis: int = -1):
    """Layer means along `axis`, scaled to O(1): p [bar], theta = 300 / T,
    r = rho / 10, w = lwc; and the mean pressure in hPa for the hats."""
    x = torch.stack(torch.broadcast_tensors(p_hpa, t_k, rho_gm3, lwc_gm3))
    axis = axis % p_hpa.ndim + 1
    n = x.shape[axis]
    mid = 0.5 * (x.narrow(axis, 0, n - 1) + x.narrow(axis, 1, n - 1))
    return mid[0] * 1e-3, 300.0 / mid[1], mid[2] * 0.1, mid[3], mid[0]


def _theta_powers(th):
    """theta^0 .. theta^5, stacked on a new axis 0."""
    ones = torch.ones_like(th)
    return torch.cumprod(torch.stack([ones, th, th, th, th, th]), dim=0)


def _base_features(p, th, r, w):
    """The 18 monomials, stacked on a new axis 0: O2 band p^2 theta^0..5,
    H2O lines r p theta^0..4, self continuum r^2 theta^0..2, liquid
    w theta^0..2, dry continuum p theta^3."""
    t = _theta_powers(th)
    return torch.cat([(p * p) * t, (r * p) * t[:5], (r * r) * t[:3],
                      w * t[:3], p * t[3:4]])


def _base_feature_partials(p, th, r, w):
    """(d/dtheta, d/dr) of `_base_features`, each stacked like it."""
    t = _theta_powers(th)
    n = torch.arange(6, dtype=th.dtype, device=th.device).reshape(
        (6,) + (1,) * th.ndim)
    dt = n * torch.cat([torch.zeros_like(t[:1]), t[:5]])   # n theta^(n-1)
    zeros = torch.zeros_like(t)
    d_th = torch.cat([(p * p) * dt, (r * p) * dt[:5], (r * r) * dt[:3],
                      w * dt[:3], p * dt[3:4]])
    d_r = torch.cat([zeros, p * t[:5], (2.0 * r) * t[:3], zeros[:4]])
    return d_th, d_r


def _expand(base, hats, last: bool = True):
    """hat_b x base_j, (4, ...) x (18, ...) -> 72 features in the order
    b * 18 + j: on the last axis, or on axis 0 when `last` is False."""
    x = (hats[:, None] * base[None]).reshape(N_FEATURES, *base.shape[1:])
    return torch.movedim(x, 0, -1) if last else x


def layer_features(p_hpa, t_k, rho_gm3, lwc_gm3):
    """Per-layer feature map (..., L-1, 72) from level arrays (..., L).

    Layer means of p, T, vapor density and liquid; 18 physically scaled
    monomials times the 4-hat log-pressure basis.  Differentiable.
    """
    p, th, r, w, pm = _scaled_means(p_hpa, t_k, rho_gm3, lwc_gm3)
    return _expand(_base_features(p, th, r, w), _hats(pm))


def _weights(params: dict, like) -> torch.Tensor:
    return params["w"].to(device=like.device, dtype=like.dtype)


def init_params(config: FastConfig = FastConfig(), scale: float = 1e-3,
                seed: int = 0, device=None, generator=None) -> dict:
    """Random weights {"w": (72, C)} of `config.dtype` on `device` (the CUDA
    card when None), drawn on the CPU from `generator`, or from a new
    `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    w = torch.randn((N_FEATURES, len(config.freqs_ghz)), generator=generator,
                    dtype=torch.float32)
    return {"w": (scale * w).to(device=dev,
                                dtype=getattr(torch, config.dtype))}


def predict_extinction(params: dict, p_hpa, t_k, rho_gm3, lwc_gm3):
    """Layer extinction (..., L-1, C) [Np/km]: the feature map times the
    weights, clamped at zero.  The product is full float32, never TF32."""
    x = layer_features(p_hpa, t_k, rho_gm3, lwc_gm3)
    with _true_fp32_matmul():
        alpha = torch.matmul(x, _weights(params, x))
    return torch.clamp_min(alpha, 0.0)


def extinction_partials(params: dict, p_hpa, t_k, rho_gm3, lwc_gm3):
    """Layer extinction (..., L-1, C) and its partials in the layer-mean
    temperature and vapor density, in closed form.

    The features are monomials in (p, theta, r, w) times hats of p alone, so
    d/dT_mid = -(theta^2 / 300) d/dtheta and d/drho_mid = 0.1 d/dr of each;
    the clamp at zero gates both.  Because layer l depends on the levels
    only through its means, d alpha_mid[l] / dT_mid[l] is also what a
    forward-mode pass seeded with ones on the levels returns.
    """
    p, th, r, w, pm = _scaled_means(p_hpa, t_k, rho_gm3, lwc_gm3)
    hats = _hats(pm)
    d_th, d_r = _base_feature_partials(p, th, r, w)
    dth_dt = -(th * th) / 300.0
    wts = _weights(params, p)
    with _true_fp32_matmul():
        raw = torch.matmul(_expand(_base_features(p, th, r, w), hats), wts)
        d_t = torch.matmul(_expand(d_th * dth_dt, hats), wts)
        d_rho = torch.matmul(_expand(0.1 * d_r, hats), wts)
    live = raw > 0.0
    return (torch.clamp_min(raw, 0.0), torch.where(live, d_t, 0.0),
            torch.where(live, d_rho, 0.0))


def fast_forward_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                        elevation_deg, config: FastConfig = FastConfig()):
    """tb, tau_total, t_mr (C,) and trans_level (C, L) for one profile at
    one elevation, in plain torch."""
    f = constant_vector(config.freqs_ghz, t_k.dtype, t_k.device)
    e_hpa = thermo.rho_to_e(rho_gm3, t_k)
    ds = geometry.slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg)
    alpha = predict_extinction(params, p_hpa, t_k, rho_gm3, lwc_gm3)
    dtau = (alpha * ds[:, None]).T                              # (C, L-1)
    return rte.downwelling_tb_from_dtau(dtau, t_k, f)


def batch_arrays(profiles: dict, dtype) -> dict:
    """z, p, t, rho, lwc as (B, L) tensors of `dtype` on the profiles'
    device (`input_device`: numpy arrays go to the card); lwc is zero when
    absent."""
    device = input_device(profiles["p"])
    out = {k: torch.as_tensor(profiles[k]).to(device=device, dtype=dtype)
           for k in ("z", "p", "t", "rho")}
    lwc = profiles.get("lwc")
    out["lwc"] = (torch.zeros_like(out["rho"]) if lwc is None
                  else torch.as_tensor(lwc).to(device=device, dtype=dtype))
    return out


def serving_extinction(params: dict, p, t, rho, lwc):
    """Layer-mean extinction (C, L-1, B) from level-major (L, B) arrays: the
    features as (72, L-1, B), then one (C, 72) x (72, (L-1) B) product in
    full float32, clamped at zero."""
    ps, th, r, w, pm = _scaled_means(p, t, rho, lwc, axis=0)
    x = _expand(_base_features(ps, th, r, w), _hats(pm), last=False)
    with _true_fp32_matmul():
        alpha = torch.matmul(_weights(params, x).T, x.reshape(N_FEATURES, -1))
    return torch.clamp_min(alpha, 0.0).reshape(-1, *x.shape[1:])


def fast_forward_batch(params: dict, profiles: dict,
                       config: FastConfig = FastConfig()) -> dict:
    """Batched fast forward: dict of (B, L) profiles -> the outputs named in
    `config.outputs`: tb, tau_total, t_mr (B, E, C), trans_level
    (B, E, C, L).

    One transpose in, the extinction already in the (C, L-1, B) layout K2
    reads, then K2 or its plain version (`config.use_kernels`), one permute
    per output back to the public layout.
    """
    with span("fast.forward_batch"):
        a = batch_arrays(profiles, getattr(torch, config.dtype))
        with span("fast.layout"):
            z, p, t, rho, lwc = torch.stack(
                [a[k] for k in _PROFILE_KEYS]).transpose(
                    1, 2).contiguous().unbind(0)                # each (L, B)
        with span("fast.extinction"):
            alpha_mid = serving_extinction(params, p, t, rho, lwc)
        with span("fast.refractive_index"):
            n = geometry.refractive_index(p, t, thermo.rho_to_e(rho, t))
        stacked = forward_lb(config.freqs_ghz, config.elevations_deg,
                             alpha_mid, z, n, t, alpha_is_mid=True,
                             want_trans_level="trans_level" in config.outputs,
                             use_kernels=config.use_kernels)
        with span("fast.output_layout"):
            return {k: (v.permute(3, 0, 1, 2) if k == "trans_level"
                        else v.permute(2, 0, 1)).contiguous()
                    for k, v in stacked.items() if k in config.outputs}


# ---------------------------------------------------------------------------
# Distillation against the in-process LBL teacher
# ---------------------------------------------------------------------------

def teacher_layer_extinction(profiles: dict,
                             config: FastConfig = FastConfig()):
    """LBL layer-mean extinction targets (B, L-1, C) [Np/km]: the teacher
    release's absorption at the levels (kernel K1 where it launches),
    averaged over each layer."""
    lev = lbl.level_major_profiles(
        profiles, lbl.LBLConfig(dtype=config.dtype))
    alpha = absorption_lb(config.freqs_ghz, lev["p"], lev["t"], lev["rho"],
                          lev["lwc"], config.teacher_model,
                          use_kernels=config.use_kernels)       # (C, L, B)
    return (0.5 * (alpha[:, :-1] + alpha[:, 1:])).permute(2, 1, 0)


def fit_closed_form(profiles: dict, config: FastConfig = FastConfig(),
                    ridge: float = 1e-9) -> dict:
    """One-shot ridge regression of the feature map onto the LBL extinction.

    Features and targets are evaluated on the profiles' device in
    `config.dtype`; the 72 x 72 normal equations are formed and solved in
    float64 (the Gram matrix of the hat-expanded basis is too
    ill-conditioned for float32).  Rows are weighted by ~1/alpha, which
    emphasises the optically thin upper layers that dominate V-band TB.
    Returns {"w": (72, C)} in `config.dtype` on that device.
    """
    dtype = getattr(torch, config.dtype)
    a = batch_arrays(profiles, dtype)
    x = layer_features(a["p"], a["t"], a["rho"], a["lwc"])
    y = teacher_layer_extinction(a, config)
    xf = x.reshape(-1, N_FEATURES).double()
    yf = y.reshape(-1, y.shape[-1]).double()
    wgt = 1.0 / torch.clamp(yf.mean(dim=-1, keepdim=True), 1e-4, 10.0)
    xtx = (xf * wgt).T @ xf + ridge * torch.eye(
        N_FEATURES, dtype=torch.float64, device=xf.device)
    xty = (xf * wgt).T @ yf
    return {"w": torch.linalg.solve(xtx, xty).to(dtype)}


def distill_loss(params: dict, profiles: dict, targets,
                 config: FastConfig = FastConfig()):
    """TB-space L2 loss against precomputed teacher TBs (B, E, C), through
    `fast_forward_batch` at `config.use_kernels`: K2, whose backward is K2v,
    or its plain version."""
    pred = fast_forward_batch(params, profiles,
                              dataclasses.replace(config,
                                                  outputs=("tb",)))["tb"]
    return torch.mean((pred - targets) ** 2)


# each optimizer's graphed loss, for the configuration and shapes of its
# last step (`_graphed_loss`); it goes with the optimizer
_GRAPHED_LOSSES = weakref.WeakKeyDictionary()
# the wrappers whose kernels the graphed loss holds
_GRAPHED_WRAPPERS = (forward_lb, forward_lb_vjp)


def _graphed_loss(optimizer, params: dict, profiles: dict, targets,
                  config: FastConfig):
    """`distill_loss` as `torch.cuda.make_graphed_callables` makes it: one
    autograd node whose forward and backward each replay a CUDA graph of
    the kernels' pipeline (features, product, K2; K2v, the product's
    backward), taking the weights, the profiles and the targets as inputs.

    The training step's forward and backward are some 100 torch calls and
    70 launches of short kernels, which take the host longer than the card
    takes for the work (2.7 ms at B=4096 x 180 levels on an H100); a graph
    replay costs the host one launch.  The first step of an optimizer, and
    the first after the configuration or the shapes change, runs the
    pipeline eagerly three times (on copies of its arguments, with no
    effect on the weights) and captures it; the graphs and their memory
    (some 420 MiB at B=4096) are the optimizer's, and go with it or with
    the next capture.  Each call adds the kernels the graphs replay to
    their wrappers' `launches`.  The loss it gives is the graph's own
    buffer, overwritten by the next call."""
    dtype = getattr(torch, config.dtype)
    a = batch_arrays(profiles, dtype)
    args = (params["w"], *(a[k] for k in _PROFILE_KEYS),
            torch.as_tensor(targets).to(device=a["t"].device, dtype=dtype))
    key = (dataclasses.replace(config, outputs=("tb",)), a["t"].device,
           tuple(tuple(x.shape) for x in args))
    last = _GRAPHED_LOSSES.get(optimizer)
    if last is None or last[0] != key:
        _GRAPHED_LOSSES.pop(optimizer, None)

        def loss(w, *rest):
            return distill_loss({"w": w}, dict(zip(_PROFILE_KEYS, rest[:5])),
                                rest[5], config)

        sample = tuple(x.detach().clone().requires_grad_(x.requires_grad)
                       for x in args)
        before = [getattr(f, "captured", 0) for f in _GRAPHED_WRAPPERS]
        with _true_fp32_matmul():
            graphed = torch.cuda.make_graphed_callables(loss, sample)
        replayed = [getattr(f, "captured", 0) - n
                    for f, n in zip(_GRAPHED_WRAPPERS, before)]
        last = _GRAPHED_LOSSES[optimizer] = (key, graphed, replayed)
    _, graphed, replayed = last
    for f, n in zip(_GRAPHED_WRAPPERS, replayed):
        f.launches += n
    return graphed(*args)


def make_optimizer(params: dict, lr: float = 1e-4) -> torch.optim.Optimizer:
    """Adam over the weights, which become leaves that require grad.  On
    the card the update is torch's fused kernel, one launch a step where
    the multi-tensor path takes some ten and their host time."""
    params["w"].requires_grad_(True)
    return torch.optim.Adam([params["w"]], lr=lr,
                            fused=True if params["w"].is_cuda else None)


def train_step(params: dict, optimizer, profiles: dict, targets,
               config: FastConfig = FastConfig()):
    """One distillation step: updates `params["w"]` in place through
    `optimizer` and returns the loss before the update.  The backward's
    products, like the forward's, run in full float32, never TF32.  Where
    the kernels launch (`ops.cuda.launches`), the loss is `_graphed_loss`:
    the forward and backward replay CUDA graphs, and the gradient the
    backward leaves in the graph's buffer is copied to a `.grad` of the
    caller's, as autograd leaves it on every other path."""
    with span("distill.train_step"):
        optimizer.zero_grad(set_to_none=True)
        w = params["w"]
        with span("distill.loss"):
            graphed = launches(w, config.use_kernels)
            loss = (_graphed_loss(optimizer, params, profiles, targets,
                                  config) if graphed
                    else distill_loss(params, profiles, targets, config))
        with span("distill.backward"), _true_fp32_matmul():
            loss.backward()
            if graphed and w.grad is not None:
                w.grad = w.grad.clone()
        with span("distill.optimizer"):
            optimizer.step()
        return loss.detach().clone() if graphed else loss.detach()


def distill(profiles: dict, config: FastConfig = FastConfig(),
            steps: int = 200, log_every: int = 50,
            checkpoint_dir: str | None = None,
            checkpoint_every: int = 100):
    """Closed-form initialisation, then a TB-space fine-tune against the LBL
    teacher's TBs.  Returns (params, loss_history); all compute stays on the
    profiles' device.

    With `checkpoint_dir`, the weights, Adam's state and the step are saved
    every `checkpoint_every` steps (`parallel/checkpoint.py`), and a fresh
    call resumes from the newest step there: stopped and resumed, it ends
    where an uninterrupted call ends.
    """
    params = fit_closed_form(profiles, config)
    teacher_cfg = lbl.LBLConfig(
        model=config.teacher_model, freqs_ghz=config.freqs_ghz,
        elevations_deg=config.elevations_deg, dtype=config.dtype,
        use_kernels=config.use_kernels, outputs=("tb",))
    targets = lbl.forward_batch(profiles, teacher_cfg)["tb"]
    optimizer = make_optimizer(params)

    def state(step):
        return {"params": {"w": params["w"].detach()},
                "opt_state": optimizer.state_dict(), "step": step}

    mgr, start = None, 0
    if checkpoint_dir is not None:
        from ..parallel import checkpoint as ckpt_mod

        mgr = ckpt_mod.CheckpointManager(checkpoint_dir,
                                         every=checkpoint_every)
        restored = mgr.restore_or(state(0))
        with torch.no_grad():
            params["w"].copy_(restored["params"]["w"])
        optimizer.load_state_dict(restored["opt_state"])
        start = ckpt_mod.latest_step(restored)
    history = []
    for i in range(start, steps):
        loss = train_step(params, optimizer, profiles, targets, config)
        if mgr is not None:
            mgr.maybe_save(state(i + 1))
        if log_every and i % log_every == 0:
            history.append(float(loss))
    return {"w": params["w"].detach()}, history


def distill_on_dataset(ds, config: FastConfig = FastConfig(),
                       crop: int = 0, steps: int = 0, device=None) -> dict:
    """Fit the fast operator on a harmonized campaign dataset (the analogue
    of RTTOV-gb's offline coefficient training, done in-process here).

    Profiles with a non-finite value are left out; the rest go to `device`
    (the CUDA card when None).  With steps=0 this is the closed-form ridge
    fit only; steps>0 adds the TB-space fine-tune (`distill`).  Distilling
    on the target profile population matters: the regression extrapolates
    poorly outside the pressure/temperature range it was fit on.
    """
    raw = preprocess.profiles_for_forward(ds, crop=crop)
    mask = np.ones(raw["z"].shape[0], bool)
    for v in raw.values():
        mask &= np.isfinite(np.asarray(v)).all(axis=1)
    dev = resolve_device(device)
    profiles = {k: torch.from_numpy(np.asarray(v)[mask]).to(dev)
                for k, v in raw.items()}
    if steps:
        params, _ = distill(profiles, config, steps=steps)
        return params
    return fit_closed_form(profiles, config)


def params_from_numpy(params: dict, device=None) -> dict:
    """Weights {"w": (72, C)} as tensors on `device` (the CUDA card when
    None): the JAX package's weights as numpy arrays (or anything
    `np.asarray` takes), or the port's tensors, detached."""
    dev = resolve_device(device)
    return {k: (v.detach() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v))).to(dev)
            for k, v in params.items()}


def save_params(params: dict, path: str) -> None:
    """Write the weights as a numpy `.npz` archive (the JAX package's
    format: one array per key)."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_params(path: str, device=None) -> dict:
    """Read an `.npz` written by `save_params` of either package onto
    `device` (the CUDA card when None)."""
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)


class FastOperator(nn.Module):
    """The fast operator as a module; its parameter is the weight matrix
    `w` (72, C)."""

    def __init__(self, params: dict = None,
                 config: FastConfig = FastConfig(), device=None):
        super().__init__()
        self.config = config
        if params is None:
            params = init_params(config, device=device)
        elif device is not None:
            params = {"w": params["w"].to(device)}
        self.w = nn.Parameter(params["w"].detach().clone())

    def forward(self, profiles: dict) -> dict:
        return fast_forward_batch({"w": self.w}, profiles, self.config)
