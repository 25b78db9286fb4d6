"""Refit global spectroscopy scale factors against an external golden file.

The counterpart of the JAX package's `tools/fit_tables.py`, on the port's
`constants/` dataclasses and its plain `ops/absorption` in float64 on
`--device` (the CUDA card when not given), with gradients from
`torch.autograd`.  Given a golden absorption file produced by an *external*
LBL (the schema of tests/golden/absorption_<model>.json: freqs_ghz,
conditions, alpha table in Np/km), it fits multiplicative retune factors

    h2o_s1    water-vapor line intensities
    h2o_w3    water-vapor air-broadened widths
    h2o_cf    foreign continuum coefficient
    h2o_cs    self continuum coefficient
    o2_s      oxygen line intensities
    o2_w      oxygen widths
    o2_y      oxygen first-order mixing (y0)
    o2_y1     oxygen mixing temperature dependence (y1)
    o2_g      oxygen second-order intensity coupling (g0)
    o2_g1     oxygen coupling temperature dependence (g1)
    o2_dnu    oxygen second-order band shift (dnu0 and dnu1)

by Adam on the mean squared *log*-absorption error (log-space so window and
line-center points weigh equally).  Output is a JSON of fitted factors plus
before/after residuals; apply them by scaling the model dataclass (see
`apply_scales`) or by folding them into the tables.

The o2_y*/o2_g*/o2_dnu factors exist to close the R20/R24 Makarov-2020 ECS
mixing refit, which constants/o2_lines.py carries at the 2011-fit values
pending an external golden.  Constraining the temperature-dependence
factors (o2_y1/o2_g1) requires golden conditions at two or more
temperatures; with single-temperature goldens leave them at 1.

PER-LINE MODE (--per-line): `fit_per_line` fits additive per-line deltas on
the six O2 mixing arrays (y0, y1, g0, g1, dnu0, dnu1), regularized toward
the carried table (an L2 prior: the carried values are the prior mean) plus
a first-difference smoothness term over the table's line order (ECS mixing
coefficients vary smoothly with rotational quantum number, and the table is
ordered by N).  Requires golden conditions at >= 2 temperatures to separate
the y0/y1 (g0/g1) pairs.

The Adam update is written out, as in the JAX tool (beta 0.9/0.999; eps
1e-9 for the global fit and 1e-12 per line, added after the square root),
so that the two tools' trajectories can be compared step for step.  No
kernel is on this path: the fit differentiates the plain torch physics.

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.tools.fit_tables \
        --golden external.json --model R24 [--steps 400] [--out fitted.json] \
        [--per-line] [--l2 1e-3] [--smooth 1e-3] [--device cpu]
"""

import argparse
import json
import pathlib
import sys
from dataclasses import replace

import numpy as np
import torch

from ..constants.h2o_lines import H2O_MODELS
from ..constants.o2_lines import O2_MODELS
from ..ops.absorption import h2o_absorption, n2_absorption, o2_absorption
from ..ops.tensors import resolve_device

SCALE_NAMES = ("h2o_s1", "h2o_w3", "h2o_cf", "h2o_cs", "o2_s", "o2_w",
               "o2_y", "o2_y1", "o2_g", "o2_g1", "o2_dnu")


def _times(a, s):
    """a * s; where the factor is a tensor, a becomes a tensor of its dtype
    and device first (numpy does not multiply a tensor), so that autograd
    sees the product."""
    if torch.is_tensor(s):
        return torch.as_tensor(a, dtype=s.dtype, device=s.device) * s
    return a * s


def apply_scales(model_name: str, scales: dict):
    """Return (H2OModel, O2Model) copies with the retune factors applied
    (numbers, or tensors that may require grad)."""
    h = H2O_MODELS[model_name]
    o = O2_MODELS[model_name]
    h = replace(
        h,
        s1=_times(h.s1, scales.get("h2o_s1", 1.0)),
        w3=_times(h.w3, scales.get("h2o_w3", 1.0)),
        ws=_times(h.ws, scales.get("h2o_w3", 1.0)),
        cf=_times(h.cf, scales.get("h2o_cf", 1.0)),
        cs=_times(h.cs, scales.get("h2o_cs", 1.0)),
    )
    o = replace(
        o,
        s300=_times(o.s300, scales.get("o2_s", 1.0)),
        w300=_times(o.w300, scales.get("o2_w", 1.0)),
        y0=_times(o.y0, scales.get("o2_y", 1.0)),
        y1=_times(o.y1, scales.get("o2_y1", 1.0)),
        g0=_times(o.g0, scales.get("o2_g", 1.0)),
        g1=_times(o.g1, scales.get("o2_g1", 1.0)),
        dnu0=_times(o.dnu0, scales.get("o2_dnu", 1.0)),
        dnu1=_times(o.dnu1, scales.get("o2_dnu", 1.0)),
    )
    return h, o


def _alpha_with_scales(theta, model_name, f, p, t, rho):
    """Total absorption with log-scale retunes theta (one per SCALE_NAMES)."""
    s = {n: torch.exp(th) for n, th in zip(SCALE_NAMES, theta)}
    hm, om = apply_scales(model_name, s)
    e = rho * t / 217.0
    return (h2o_absorption(f, p, t, rho, hm)
            + o2_absorption(f, p, t, rho, om)
            + n2_absorption(f, p - e, t, variant=model_name))


def _golden_rows(golden: dict, dev: torch.device):
    """f (F,), the conditions as (p, t, rho) float64 scalars and the
    targets (n_conditions, F), all on `dev`."""
    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    f = f64(golden["freqs_ghz"])
    rows, targets = [], []
    for (p, t, rho), want in zip(golden["conditions"],
                                 golden["alpha"].values()):
        rows.append((f64(p), f64(t), f64(rho)))
        targets.append(f64(want))
    return f, rows, torch.stack(targets)


def _adam(theta, m, v, g, i, lr, eps):
    """One step of the hand-written Adam (beta 0.9/0.999, eps after the
    square root); returns theta, m, v."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat = m / (1 - 0.9 ** (i + 1))
    vhat = v / (1 - 0.999 ** (i + 1))
    return theta - lr * mhat / (torch.sqrt(vhat) + eps), m, v


def fit(golden: dict, model_name: str, steps: int = 400,
        lr: float = 0.03, device=None) -> dict:
    """Global log-scale retunes of `model_name` against `golden`, on
    `device` (the CUDA card when None) in float64."""
    dev = resolve_device(device)
    f, rows, targets = _golden_rows(golden, dev)

    def loss(theta):
        preds = torch.stack([
            _alpha_with_scales(theta, model_name, f, p, t, rho)
            for (p, t, rho) in rows])
        return torch.mean((torch.log(preds + 1e-14)
                           - torch.log(targets + 1e-14)) ** 2)

    def value_and_grad(theta):
        theta = theta.detach().requires_grad_(True)
        val = loss(theta)
        (g,) = torch.autograd.grad(val, theta)
        return val.detach(), g

    theta = torch.zeros(len(SCALE_NAMES), dtype=torch.float64, device=dev)
    m = v = torch.zeros_like(theta)
    loss0 = None
    for i in range(steps):
        val, g = value_and_grad(theta)
        if loss0 is None:
            loss0 = float(val)
        theta, m, v = _adam(theta, m, v, g, i, lr, 1e-9)
    with torch.no_grad():
        final = float(loss(theta))
    return {
        "model": model_name,
        "scales": {n: float(torch.exp(th))
                   for n, th in zip(SCALE_NAMES, theta)},
        "rms_log_residual_before": float(np.sqrt(loss0)),
        "rms_log_residual_after": float(np.sqrt(final)),
    }


# ---------------------------------------------------------------------------
# Per-line mode: additive deltas on the six O2 mixing arrays, regularized
# toward the carried table (the closure path for the Makarov-2020 ECS refit,
# constants/o2_lines.py::MIXING_PROVENANCE).
# ---------------------------------------------------------------------------

PER_LINE_NAMES = ("y0", "y1", "g0", "g1", "dnu0", "dnu1")

# Natural magnitude per array, used to make the regularization dimensionless
# even when a release carries an all-zero array (e.g. dnu in R19).
_PER_LINE_FLOOR = {"y0": 0.1, "y1": 0.1, "g0": 0.01, "g1": 0.01,
                   "dnu0": 1e-4, "dnu1": 1e-4}


def apply_per_line(model_name: str, deltas: dict):
    """Return an O2Model copy with additive per-line deltas applied
    (arrays, or tensors that may require grad)."""
    o = O2_MODELS[model_name]
    kw = {}
    for n in PER_LINE_NAMES:
        d = deltas.get(n)
        if d is not None:
            d = torch.as_tensor(d)
            kw[n] = torch.as_tensor(getattr(o, n), dtype=d.dtype,
                                    device=d.device) + d
    return replace(o, **kw)


def _per_line_scales(model_name: str) -> dict:
    o = O2_MODELS[model_name]
    return {n: max(float(np.max(np.abs(np.asarray(getattr(o, n))))),
                   _PER_LINE_FLOOR[n])
            for n in PER_LINE_NAMES}


def fit_per_line(golden: dict, model_name: str, steps: int = 1500,
                 lr: float = 0.02, l2: float = 1e-3,
                 smooth: float = 1e-3, device=None) -> dict:
    """Fit per-line O2 mixing deltas against an external golden, on
    `device` (the CUDA card when None) in float64.

    loss = mse(log alpha)  +  l2 * sum_n ||delta_n / scale_n||^2
         + smooth * sum_n ||diff(delta_n) / scale_n||^2

    The prior mean is the carried table itself (deltas start and are pulled
    toward 0), and the smoothness term encodes that ECS coefficients vary
    smoothly along the N-ordered line table.  Conditions at a single
    temperature leave the (y0, y1)/(g0, g1) splits unconstrained: supply
    multi-temperature goldens.
    """
    dev = resolve_device(device)
    f, rows, targets = _golden_rows(golden, dev)
    temps = {float(t) for (_, t, _) in rows}
    if len(temps) < 2:
        print("warning: single-temperature golden cannot constrain the "
              "y1/g1 temperature laws; fitting anyway", file=sys.stderr)

    n_lines = O2_MODELS[model_name].f.size
    scales = _per_line_scales(model_name)
    scale_vec = torch.tensor([scales[n] for n in PER_LINE_NAMES],
                             dtype=torch.float64, device=dev)[:, None]

    hm = H2O_MODELS[model_name]

    def alpha_of(theta, p, t, rho):
        om = apply_per_line(model_name,
                            {n: theta[i] for i, n in
                             enumerate(PER_LINE_NAMES)})
        e = rho * t / 217.0
        return (h2o_absorption(f, p, t, rho, hm)
                + o2_absorption(f, p, t, rho, om)
                + n2_absorption(f, p - e, t, variant=model_name))

    def loss(theta):
        preds = torch.stack([alpha_of(theta, p, t, rho)
                             for (p, t, rho) in rows])
        data = torch.mean((torch.log(preds + 1e-14)
                           - torch.log(targets + 1e-14)) ** 2)
        u = theta / scale_vec
        reg = l2 * torch.mean(u * u) \
            + smooth * torch.mean((u[:, 1:] - u[:, :-1]) ** 2)
        return data + reg, data

    def value_and_grad(theta):
        theta = theta.detach().requires_grad_(True)
        total, data = loss(theta)
        (g,) = torch.autograd.grad(total, theta)
        return data.detach(), g

    theta = torch.zeros((len(PER_LINE_NAMES), n_lines), dtype=torch.float64,
                        device=dev)
    m = v = torch.zeros_like(theta)
    data0 = None
    for i in range(steps):
        data, g = value_and_grad(theta)
        if data0 is None:
            data0 = float(data)
        theta, m, v = _adam(theta, m, v, g, i, lr, 1e-12)
    with torch.no_grad():
        final = float(loss(theta)[1])
    return {
        "model": model_name,
        "mode": "per_line",
        "l2": l2,
        "smooth": smooth,
        "deltas": {n: theta[i].cpu().numpy().tolist()
                   for i, n in enumerate(PER_LINE_NAMES)},
        "rms_log_residual_before": float(np.sqrt(data0)),
        "rms_log_residual_after": float(np.sqrt(final)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--golden", required=True,
                    help="external golden absorption JSON")
    ap.add_argument("--model", default="R24")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--per-line", action="store_true", dest="per_line",
                    help="fit per-line O2 mixing deltas (the ECS-refit "
                         "closure path) instead of global scale factors")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--l2", type=float, default=1e-3,
                    help="per-line prior weight (toward the carried table)")
    ap.add_argument("--smooth", type=float, default=1e-3,
                    help="per-line first-difference smoothness weight")
    ap.add_argument("--device", default=None,
                    help="the CUDA card when not given (an error where there "
                         "is none); 'cpu' fits on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    golden = json.loads(pathlib.Path(args.golden).read_text())
    if args.per_line:
        result = fit_per_line(golden, args.model,
                              steps=args.steps or 1500,
                              lr=args.lr or 0.02, l2=args.l2,
                              smooth=args.smooth, device=device)
    else:
        result = fit(golden, args.model, args.steps or 400,
                     lr=args.lr or 0.03, device=device)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
