"""The port's literature checkpoints (`anchors.py`): the table against the
JAX package's and the frozen `tests/golden/literature.json`, every release
against its checkpoints and row by row against the JAX `run_checkpoints`,
and the +3 % width falsifiability test of tests/test_golden.py."""

import json
import pathlib
from dataclasses import replace

import pytest
import torch

from mwr_fast_forward_operators_and_lbls_tpu import anchors as janchors
from mwr_fast_forward_operators_and_lbls_tpu_torch import anchors
from mwr_fast_forward_operators_and_lbls_tpu_torch.constants import (
    H2O_MODELS, O2_MODELS)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "literature.json"

# Both packages compute every kind in float32 (the JAX functions under its
# default precision, 64-bit mode off): the absorption and halfwidth rows
# agree to float32 rounding (about 1e-7 relative), the TBs as the two LBL
# forwards do (`test_torch_lbl.py`: 2e-2 K).
RTOL = 1e-5
TB_ATOL_K = 2e-2


def test_checkpoint_table_equals_the_jax_table():
    assert anchors.CHECKPOINTS == janchors.CHECKPOINTS
    assert anchors.ALL_RELEASES == janchors.ALL_RELEASES
    assert anchors._NON_SD == janchors._NON_SD
    assert anchors.NP_TO_DB == janchors.NP_TO_DB


def test_checkpoint_table_equals_the_frozen_json():
    frozen = json.loads(GOLDEN.read_text())
    assert frozen["version"] == 2
    assert frozen["np_to_db"] == anchors.NP_TO_DB
    assert json.loads(json.dumps(anchors.CHECKPOINTS)) == \
        frozen["checkpoints"]


@pytest.mark.parametrize("model", anchors.ALL_RELEASES)
def test_run_checkpoints_all_ok_and_equal_to_jax(model):
    rows = anchors.run_checkpoints(model, device="cpu")
    assert len(rows) >= 8  # envelopes + >=2 halfwidths + tb windows
    bad = [r for r in rows if not r["ok"]]
    assert not bad, f"{model} violates external anchors: {bad}"
    want = janchors.run_checkpoints(model)
    assert [(r["name"], r["kind"]) for r in rows] == \
        [(r["name"], r["kind"]) for r in want]
    for got, ref in zip(rows, want):
        assert got["lo"] == ref["lo"] and got["hi"] == ref["hi"]
        assert got["ok"] == ref["ok"]
        atol = TB_ATOL_K if got["kind"] == "tb" else 0.0
        assert got["value"] == pytest.approx(ref["value"], rel=RTOL,
                                             abs=atol), got["name"]


@pytest.mark.parametrize("model", ("R98", "R24"))
def test_perturbed_width_fails_anchors(model):
    """A +3 % width perturbation (the error scale the <0.05 K TB budget
    cares about) fails the halfwidth anchors, as in the JAX package."""
    hm = H2O_MODELS[model]
    hp = replace(hm, w3=hm.w3 * 1.03, ws=hm.ws * 1.03)
    rows = anchors.run_checkpoints(model, kinds=("halfwidth",),
                                   h2o_model=hp)
    h2o_rows = [r for r in rows if r["name"].startswith("h2o")]
    assert h2o_rows and all(not r["ok"] for r in h2o_rows), (model, rows)

    om = O2_MODELS[model]
    op = replace(om, w300=om.w300 * 1.03)
    rows = anchors.run_checkpoints(model, kinds=("halfwidth",),
                                   o2_model=op)
    o2_rows = [r for r in rows if r["name"].startswith("o2")]
    assert o2_rows and all(not r["ok"] for r in o2_rows), (model, rows)


def test_overrides_skip_the_tb_rows_and_need_no_device():
    """With a perturbed table the tb rows are skipped, as in the JAX
    package, so no device is resolved; without overrides the tb rows run
    on the card unless the caller asks for the CPU."""
    hm = H2O_MODELS["R24"]
    rows = anchors.run_checkpoints("R24", h2o_model=replace(hm))
    assert rows and all(r["kind"] != "tb" for r in rows)
    assert [r["value"] for r in rows] == [
        r["value"] for r in anchors.run_checkpoints("R24", device="cpu")
        if r["kind"] != "tb"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device; pass "
                                           "device='cpu'"):
        anchors.run_checkpoints("R24", kinds=("tb",))
