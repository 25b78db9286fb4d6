"""The port's host spans (`ops/spans.py`) in a `torch.profiler` trace.

On the CPU each batched entry point runs once under
`parallel.profiling.trace` and once without a profiler: the spans nest under
the entry's span in the order of the code, every name is in `SPAN_NAMES`,
and the outputs are the same bits either way.  The test marked `cuda`
checks on the card that each kernel K1-K6, the K-matrix's geometry kernel,
the fast K's kernel and K2's backward (K2v), is launched inside its
wrapper's `cuda.*` span.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu_torch.data.dataset import (
    Dataset, Variable)
from mwr_fast_forward_operators_and_lbls_tpu_torch.models import (
    fast, jacobians, lbl, retrieval, spectral)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import spans, thermo
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops import (
    geometry as physics_geometry)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    absorption, adjoint, fastk, geometry, rte)
from mwr_fast_forward_operators_and_lbls_tpu_torch.ops.cuda import (
    spectral as k6)
from mwr_fast_forward_operators_and_lbls_tpu_torch.parallel import profiling
from mwr_fast_forward_operators_and_lbls_tpu_torch.pipeline import (
    forward as stage)

torch.set_num_threads(1)

N_LEVELS = 96
CFG = lbl.LBLConfig(freqs_ghz=(22.24, 31.4, 54.94),
                    elevations_deg=(90.0, 30.0), outputs=("tb", "tau_total"))
GRID = np.linspace(22.0, 60.0, 20).astype(np.float32)
CHUNK = 8                                       # three chunks of the grid


def _profiles(batch=3, device="cpu"):
    return lbl.demo_batch(batch, N_LEVELS, device=device)


def _dataset(n_time=3):
    """A harmonized dataset of `n_time` times x 2 crops x N_LEVELS, the
    level variables top -> ground as the stage reads them."""
    crops = [{k: v.numpy() for k, v in
              lbl.demo_batch(n_time, N_LEVELS, seed=10 * c,
                             device="cpu").items()} for c in (0, 1)]

    def lev(fn):
        a = np.stack([fn(c) for c in crops], axis=-1)    # (time, L, 2)
        return np.ascontiguousarray(a.transpose(1, 0, 2)[::-1],
                                    dtype=np.float32)

    def mr(c):
        e = c["rho"] * c["t"] / 216.679
        return 1000.0 * 0.622 * e / (c["p"] - e)

    def liq(c):
        return c["lwc"] / 1000.0 / (c["p"] * 100.0 / (287.04 * c["t"]))

    ds = Dataset()
    dims = ("N_Levels", "time", "Crop")
    for name, fn in (("Level_Pressure", lambda c: c["p"]),
                     ("Level_Temperature", lambda c: c["t"]),
                     ("Level_H2O", mr), ("Level_z", lambda c: c["z"]),
                     ("Level_Liquid", liq)):
        ds[name] = Variable(dims, lev(fn))
    return ds


def _forward():
    return lbl.forward_batch(_profiles(), CFG)


def _kmatrix(wrt):
    return lambda: jacobians.kmatrix_batch_fast(_profiles(), CFG, wrt=wrt)


def _spectrum():
    out = spectral.forward_spectral(_profiles(), GRID, (90.0, 30.0), "R24",
                                    freq_chunk=CHUNK)
    weights = np.random.default_rng(0).random((3, GRID.size))
    return dict(out, srf=spectral.srf_convolve(out["tb"], weights))


N_ITER = 2


def _retrieve():
    """The retrieval of 3 profiles from TBs 1 K off the fast operator's,
    the priors 1 K warmer and 10 % moister."""
    prof = _profiles()
    fcfg = fast.FastConfig(freqs_ghz=CFG.freqs_ghz,
                           elevations_deg=CFG.elevations_deg,
                           outputs=("tb",))
    params = fast.fit_closed_form(prof, fcfg)
    tb = fast.fast_forward_batch(params, prof, fcfg)["tb"] + 1.0
    ocfg = retrieval.OEMConfig(freqs_ghz=CFG.freqs_ghz,
                               elevations_deg=CFG.elevations_deg,
                               n_iter=N_ITER)
    return retrieval.retrieve_batch(params, tb, prof["z"], prof["p"],
                                    prof["t"] + 1.0, 1.1 * prof["rho"],
                                    ocfg, prof["lwc"])


def _distill():
    """One distillation step from seeded weights towards TBs of 100 K."""
    fcfg = fast.FastConfig(freqs_ghz=CFG.freqs_ghz,
                           elevations_deg=CFG.elevations_deg)
    params = fast.init_params(fcfg, device="cpu")
    loss = fast.train_step(params, fast.make_optimizer(params), _profiles(),
                           torch.full((3, 2, 3), 100.0), fcfg)
    return {"loss": loss, "w": params["w"].detach()}


def _stage():
    ds = stage.forward_stage(_dataset(), models=("R24",),
                             with_jacobians=True, batch_size=2, device="cpu")
    return {k: torch.from_numpy(np.asarray(v.data))
            for k, v in ds.variables.items()}


ENTRIES = {
    "forward_batch": _forward,
    "kmatrix_fused": _kmatrix(("t", "rho", "lwc")),
    # "p" takes the closed form
    "kmatrix_closed_form": _kmatrix(("t", "rho", "lwc", "p")),
    "spectral": _spectrum,
    "stage": _stage,
    "retrieve": _retrieve,
    "distill": _distill,
}

# each entry's root spans and, under each root, its child spans in order
N_CHUNKS = -(-GRID.size // CHUNK)
FAST_TREE = ("fast.forward_batch", ["fast.layout", "fast.extinction",
                                    "fast.refractive_index",
                                    "fast.output_layout"])
# K4 (or its plain version) writes dalpha/dLWC on the kernels' pipeline; the
# closed form takes it under its own span
KMATRIX_FUSED_TREE = [("kmatrix.kmatrix_batch_fast",
                       ["kmatrix.layout", "kmatrix.slant_geometry",
                        "kmatrix.output_layout"])]
KMATRIX_CLOSED_TREE = [("kmatrix.kmatrix_batch_fast",
                        ["kmatrix.layout", "kmatrix.dalpha_dlwc",
                         "kmatrix.slant_geometry", "kmatrix.output_layout"])]
CROP = ["stage.screen", "stage.upload", "stage.enqueue", "stage.mask"]
TREES = {
    "forward_batch": [("lbl.forward_batch",
                       ["lbl.layout", "lbl.refractive_index",
                        "lbl.output_layout"])],
    "kmatrix_fused": KMATRIX_FUSED_TREE,
    "kmatrix_closed_form": KMATRIX_CLOSED_TREE,
    "spectral": [("spectral.forward_spectral",
                  ["spectral.layout", "spectral.slant_geometry"]
                  + ["spectral.chunk"] * N_CHUNKS),
                 ("spectral.srf_convolve", [])],
    "stage": [("stage.forward_stage", CROP + CROP + ["stage.pull"])],
    # the observations' fast forward, then the retrieval
    "retrieve": [FAST_TREE,
                 ("oem.retrieve_batch",
                  ["oem.prior", "oem.forward", "oem.jacobian", "oem.accept"]
                  + ["oem.solve", "oem.forward", "oem.jacobian",
                     "oem.accept"] * N_ITER
                  + ["oem.dofs"])],
    # on the CPU autograd runs the plain version's backward: no span there
    "distill": [("distill.train_step", ["distill.loss", "distill.backward",
                                        "distill.optimizer"])],
}


def _annotations(path):
    """(start, end, name) of every user annotation of the Chrome trace but
    those torch's optimizers record themselves ("Optimizer.step#Adam.step",
    "Optimizer.zero_grad#...")."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and not e["name"].startswith("Optimizer.")),
                  key=lambda s: (s[0], -s[1]))


def _tree(annotations):
    """[(name, [child names in order], [(child name, its children), ...])]
    for each root span, nesting by the interval each span covers."""
    roots, stack = [], []
    for lo, hi, name in annotations:
        while stack and not hi <= stack[-1][1]:
            stack.pop()
        node = (name, [], [])
        if stack:
            stack[-1][2][1].append(name)
            stack[-1][2][2].append(node)
        else:
            roots.append(node)
        stack.append((lo, hi, node))
    return roots


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{entry: (outputs without a profiler, outputs under profiling.trace,
    the trace's annotations)}."""
    out = {}
    for name, fn in ENTRIES.items():
        plain = fn()
        log = tmp_path_factory.mktemp(name)
        with profiling.trace(str(log)):
            traced = fn()
        out[name] = (plain, traced, _annotations(log / "trace.json"))
    return out


def test_a_span_outside_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = spans.span("lbl.layout")
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("stage.pull") is off
    with off as entered:
        assert entered is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("lbl.layout"):
            pass
    assert spans.span("lbl.layout") is off
    assert [e.name for e in prof.events()] == ["lbl.layout"]


def test_no_event_without_a_profiler(tmp_path):
    """Spans entered before a profiler starts record nothing into it."""
    with spans.span("lbl.forward_batch"):
        with profiling.trace(str(tmp_path)):
            with spans.span("lbl.layout"):
                pass
    assert [a[2] for a in _annotations(tmp_path / "trace.json")] == [
        "lbl.layout"]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_nest_under_the_entry_in_order(runs, entry):
    roots = _tree(runs[entry][2])
    assert [(name, children) for name, children, _ in roots] == TREES[entry]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_name_is_in_span_names(runs, entry):
    names = {a[2] for a in runs[entry][2]}
    assert names and names <= spans.SPAN_NAMES
    # on the CPU the wrappers take their plain versions before any span
    assert not any(n.startswith("cuda.") for n in names)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_outputs_are_the_same_bits_under_the_profiler(runs, entry):
    plain, traced, _ = runs[entry]
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k].nan_to_num(7.0),
                           traced[k].nan_to_num(7.0)), k


def test_the_stage_nests_the_entry_points_under_its_enqueue(runs):
    (root,) = _tree(runs["stage"][2])
    enqueues = [node for node in root[2] if node[0] == "stage.enqueue"]
    assert len(enqueues) == 2
    for node in enqueues:
        # two chunks of two and one time step, each the LBL and the K
        assert node[1] == ["lbl.forward_batch",
                           "kmatrix.kmatrix_batch_fast"] * 2


def test_the_retrieval_nests_the_fast_operator_and_its_k(runs):
    """Each step's forward holds the fast operator's spans, each Jacobian
    the closed-form K's."""
    root = _tree(runs["retrieve"][2])[-1]
    under = {"oem.forward": [FAST_TREE],
             "oem.jacobian": [("fastk.kmatrix_fast_adjoint_batch",
                               ["fastk.geometry", "fastk.partials",
                                "fastk.rte_adjoint", "fastk.assembly"])]}
    for name, _, nodes in root[2]:
        assert [(n, c) for n, c, _ in nodes] == under.get(name, []), name


def test_span_names_name_the_layers():
    layers = {n.split(".")[0] for n in spans.SPAN_NAMES}
    assert layers == {"lbl", "kmatrix", "spectral", "cuda", "stage", "fast",
                      "fastk", "oem", "distill"}
    wrappers = {n for n in spans.SPAN_NAMES if n.startswith("cuda.")}
    assert wrappers == {f"cuda.{fn.__name__}" for fn in WRAPPERS}


# each kernel wrapper and the kernels (by symbol) that one launch runs
WRAPPERS = {
    absorption.absorption_lb: ("absorption_points_kernel",),
    rte.forward_lb: ("downwelling",),
    rte.downwelling_lb: ("downwelling",),
    absorption.absorption_tangents_lb: ("absorption_tangents_kernel",),
    adjoint.kmatrix_assembled_lb: ("kmatrix_kernel",),
    adjoint.kmatrix_assembled_rho_lwc_lb: ("kmatrix_kernel",),
    k6.absorption_spectral: ("line_state_kernel", "spectral_kernel"),
    geometry.slant_geometry_lb: ("slant_geometry_kernel",),
    fastk.fastk_adjoint: ("fastk_adjoint_kernel",),
    rte.forward_lb_vjp: ("rte_vjp_kernel",),
}


@pytest.mark.cuda
def test_each_kernel_is_launched_inside_its_wrapper_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    prof = _profiles(8, dev)
    cfg = lbl.LBLConfig(outputs=("tb",))
    fcfg = fast.FastConfig(outputs=("tb",))
    params = fast.init_params(fcfg, device=dev)
    # K2's backward on the fast operator's layer extinction; the training
    # step itself replays it as part of a CUDA graph after its first call
    lev = {k: v.T.contiguous() for k, v in prof.items()}
    vjp_args = (fast.serving_extinction(params, lev["p"], lev["t"],
                                        lev["rho"], lev["lwc"]),
                lev["z"], physics_geometry.refractive_index(
                    lev["p"], lev["t"], thermo.rho_to_e(lev["rho"],
                                                        lev["t"])),
                lev["t"], torch.ones((10, 14, 8), device=dev))

    def calls():
        lbl.forward_batch(prof, cfg)
        jacobians.kmatrix_batch_fast(prof, cfg)
        spectral.forward_spectral(prof, torch.from_numpy(GRID).to(dev),
                                  (90.0,), "R24", freq_chunk=CHUNK)
        jacobians.kmatrix_fast_adjoint_batch(params, prof, fcfg)
        rte.forward_lb_vjp(fcfg.freqs_ghz, fcfg.elevations_deg, *vjp_args)

    calls()                                     # builds and warms up
    torch.cuda.synchronize()
    before = {fn: fn.launches for fn in WRAPPERS}
    with profiling.trace(str(tmp_path)):
        calls()
        torch.cuda.synchronize()
    launched = {fn: fn.launches - before[fn] for fn in WRAPPERS}
    assert all(launched.values()), launched

    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    host = {e["args"]["correlation"]: float(e["ts"]) for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
    wrapper_spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith("cuda.")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for fn, symbols in WRAPPERS.items():
        name = f"cuda.{fn.__name__}"
        mine = [s for s in wrapper_spans if s[2] == name]
        assert len(mine) == launched[fn], name
        inside = [k for k in kernels
                  if any(lo <= host[k["args"]["correlation"]] <= hi
                         for lo, hi, _ in mine)]
        got = sorted(y for k in inside for y in symbols if y in k["name"])
        assert got == sorted(symbols * launched[fn]), (name, got)
    # and no kernel of the port is launched outside every wrapper span
    ours = {y for symbols in WRAPPERS.values() for y in symbols}
    for k in kernels:
        if any(y in k["name"] for y in ours):
            t = host[k["args"]["correlation"]]
            assert any(lo <= t <= hi for lo, hi, _ in wrapper_spans), k["name"]
