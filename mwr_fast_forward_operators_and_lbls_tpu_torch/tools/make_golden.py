"""Generate the golden accuracy anchors from the port's own physics.

The counterpart of the JAX package's `tools/make_golden.py`, which froze the
files in `tests/golden/`.  Those files predate the port and this tool does
not rewrite them: it writes into `--out` (`build/golden_torch/` of the
checkout by default) and `compare` holds what it wrote to the frozen files.
Three families of files come out, in the JAX tool's format number for
number:

* ``literature.json`` -- the v2 external checkpoint set
  (`anchors.CHECKPOINTS`).  Every release must pass every checkpoint that
  applies to it (`anchors.run_checkpoints`, the ``tb`` kinds through K1 and
  K2 on `device`) before any value is written: the tool refuses to freeze
  values from a model outside the external envelope.
* ``absorption_<model>.json`` -- float64 absorption [Np/km] for all nine
  releases on the fixed grid of (frequency, pressure, temperature, vapor
  density) checkpoints, from the plain `ops/absorption.total_absorption`
  on `device` (text `.12e`).
* ``tb_standard.json`` -- float64 downwelling TBs of the three
  `anchors.standard_profiles` at 90, 30 and 4.2 degrees for R98, R17, R20
  and R24, from `lbl.forward_batch` on the plain path
  (`dtype="float64", use_kernels=False`: the kernels are float32 only),
  after the same physical gates (text `.10e`).

    python -m mwr_fast_forward_operators_and_lbls_tpu_torch.tools.make_golden \
        [--out DIR] [--device cpu]

It ends by printing `compare(out, tests/golden)` as one JSON line where the
checkout has `tests/golden/`.
"""

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from .. import anchors
from ..anchors import NP_TO_DB, standard_profiles
from ..constants.h2o_lines import ZENITH_SWEEP_MODELS
from ..models import lbl
from ..ops.absorption import total_absorption
from ..ops.tensors import resolve_device

REPO = pathlib.Path(__file__).resolve().parents[2]
GOLDEN_DIR = REPO / "tests" / "golden"
OUT_DIR = REPO / "build" / "golden_torch"

# Frequencies: the 14 HATPRO channels plus the diagnostic line centers.
FREQS_GHZ = [22.24, 23.04, 23.84, 25.44, 26.24, 27.84, 31.4,
             51.26, 52.28, 53.86, 54.94, 56.66, 57.3, 58.0,
             22.235, 60.0, 89.0, 118.75, 150.0, 183.31]

# (p [hPa], T [K], rho_v [g/m^3]) checkpoints spanning the retrieval range:
# moist surface, winter surface, mid-troposphere, upper troposphere,
# stratosphere.
CONDITIONS = [
    (1013.0, 288.15, 7.5),
    (1013.0, 273.15, 2.0),
    (850.0, 280.0, 4.0),
    (500.0, 250.0, 0.30),
    (200.0, 220.0, 0.003),
    (50.0, 215.0, 1e-5),
]


def check_literature(model: str = "R24", device=None) -> list:
    """Run the v2 anchor checkpoints for one release (the ``tb`` kinds on
    `device`, the card when None); raise SystemExit if any fails."""
    rows = anchors.run_checkpoints(model, device=device)
    for r in rows:
        status = "ok " if r["ok"] else "FAIL"
        print(f"  [{status}] {model:6s} {r['name']:28s} {r['value']:12.5f} "
              f"(external: {r['lo']:.5f}..{r['hi']:.5f})")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(
            f"literature anchors violated by {model}: "
            + ", ".join(r["name"] for r in bad)
            + " — refusing to freeze golden values from a model outside "
            "the external envelope")
    return rows


def absorption_payload(model: str, device) -> dict:
    """float64 absorption of `model` at FREQS_GHZ x CONDITIONS on `device`."""
    dev = resolve_device(device)
    f = torch.tensor(FREQS_GHZ, dtype=torch.float64, device=dev)
    table = {}
    for (p, t, rho) in CONDITIONS:
        a = total_absorption(
            f, *(torch.tensor(v, dtype=torch.float64, device=dev)
                 for v in (p, t, rho)), model=model)
        if a.dtype != torch.float64:
            raise RuntimeError(f"{model}: absorption in {a.dtype}")
        table[f"{p:g}hPa_{t:g}K_{rho:g}gm3"] = [
            float(f"{v:.12e}") for v in a.cpu().numpy()]
    return {
        "model": model,
        "freqs_ghz": FREQS_GHZ,
        "conditions": [list(c) for c in CONDITIONS],
        "units": "Np/km, float64",
        "provenance": ("frozen from this repo's fp64 physics after "
                       "external literature cross-check; regenerate via "
                       "tools/make_golden.py"),
        "alpha": table,
    }


def make_tb_anchor(device=None) -> dict:
    """float64 downwelling TBs for the standard profiles (the reference
    truth behind the <0.05 K claim), from the plain path on `device`."""
    dev = resolve_device(device)
    profs = {k: torch.from_numpy(np.asarray(v, np.float64)).to(dev)
             for k, v in standard_profiles().items()}
    elevs = (90.0, 30.0, 4.2)
    out = {}
    for model in ("R98", "R17", "R20", "R24"):
        cfg = lbl.LBLConfig(model=model, dtype="float64", use_kernels=False,
                            elevations_deg=elevs, outputs=("tb",))
        tb = lbl.forward_batch(profs, cfg)["tb"].cpu().numpy()
        # basic physical gates before freezing
        gates = {"float64": tb.dtype == np.float64,
                 "finite": bool(np.isfinite(tb).all()),
                 "2.7 K < tb < 320 K": bool((tb > 2.7).all()
                                            and (tb < 320.0).all()),
                 "K-band TB grows as elevation drops": bool(
                     (np.diff(tb[:, ::-1, 0], axis=1) < 0).all())}
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise RuntimeError(f"tb_standard {model}: gates failed: {failed}")
        out[model] = [[[float(f"{v:.10e}") for v in row]
                       for row in prof] for prof in tb]
    return {"elevations_deg": list(elevs),
            "freqs_ghz": list(np.asarray(
                lbl.LBLConfig().freqs_ghz, np.float64)),
            "profiles": "tools/make_golden.py standard_profiles()",
            "units": "K, float64, shape (profile, elevation, channel)",
            "tb": out}


def write_goldens(out_dir, device=None) -> pathlib.Path:
    """Cross-check every release against the literature, then write the
    golden files into `out_dir`.  Returns the directory."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    print("Cross-checking ALL releases against external checkpoints (v2):")
    for model in ZENITH_SWEEP_MODELS:
        check_literature(model, device)

    (out_dir / "literature.json").write_text(json.dumps(
        {"note": "external checkpoint set v2; provenance and measurement "
                 "method in mwr_fast_forward_operators_and_lbls_tpu/"
                 "anchors.py",
         "version": 2, "np_to_db": NP_TO_DB,
         "checkpoints": anchors.CHECKPOINTS}, indent=1))
    for model in ZENITH_SWEEP_MODELS:
        path = out_dir / f"absorption_{model}.json"
        path.write_text(json.dumps(absorption_payload(model, device),
                                   indent=1))
        print(f"wrote {path}")
    (out_dir / "tb_standard.json").write_text(
        json.dumps(make_tb_anchor(device), indent=1))
    print(f"wrote {out_dir / 'tb_standard.json'}")
    return out_dir


def compare(out_dir, golden_dir=GOLDEN_DIR) -> dict:
    """What `out_dir` holds against the golden files of `golden_dir`:
    per release the largest relative difference of the absorption table
    (|a - g| / |g|), the largest |dTB| [K] of tb_standard, and whether
    literature.json is equal."""
    out_dir, golden_dir = pathlib.Path(out_dir), pathlib.Path(golden_dir)

    def load(d, name):
        return json.loads((d / name).read_text())

    absorption = {}
    for model in ZENITH_SWEEP_MODELS:
        name = f"absorption_{model}.json"
        got, want = load(out_dir, name), load(golden_dir, name)
        if (list(got["alpha"]) != list(want["alpha"])
                or got["freqs_ghz"] != want["freqs_ghz"]
                or got["conditions"] != want["conditions"]):
            raise ValueError(f"{name}: a grid other than the golden's")
        a = np.asarray(list(got["alpha"].values()), np.float64)
        g = np.asarray(list(want["alpha"].values()), np.float64)
        absorption[model] = float(np.max(np.abs(a - g) / np.abs(g)))
    got, want = (load(d, "tb_standard.json") for d in (out_dir, golden_dir))
    if (got["elevations_deg"] != want["elevations_deg"]
            or got["freqs_ghz"] != want["freqs_ghz"]
            or set(got["tb"]) != set(want["tb"])):
        raise ValueError("tb_standard.json: a grid other than the golden's")
    tb = max(float(np.max(np.abs(np.asarray(got["tb"][m])
                                 - np.asarray(want["tb"][m]))))
             for m in want["tb"])
    return {"absorption_max_rel": absorption,
            "tb_standard_max_abs_k": tb,
            "literature_equal": (load(out_dir, "literature.json")
                                 == load(golden_dir, "literature.json"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory for the golden files (default: "
                         "build/golden_torch/ of the checkout)")
    ap.add_argument("--device", default=None,
                    help="the CUDA card when not given (an error where there "
                         "is none); 'cpu' computes on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = write_goldens(args.out, device)
    if GOLDEN_DIR.is_dir():
        print(json.dumps(compare(out, GOLDEN_DIR)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
