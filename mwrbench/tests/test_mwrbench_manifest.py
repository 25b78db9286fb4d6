"""`BENCHMARK.json` as committed passes the checks; each broken copy fails
loudly."""

import copy
import json

import pytest

from mwrbench import manifest


@pytest.fixture(scope="module")
def bench():
    return json.loads((manifest.ROOT / "BENCHMARK.json").read_text())


def test_the_committed_manifest_loads():
    bench = manifest.load()
    assert bench["command"][:3] == ["python3", "-m", "mwrbench.run"]


def _broken(bench, how):
    b = copy.deepcopy(bench)
    how(b)
    return b


BREAKS = {
    "unit with a space": lambda b: b["end_to_end"][0].update(
        unit="spectra per s"),
    "unit too long": lambda b: b["end_to_end"][0].update(
        unit="spectra_per_second_x"),
    "name with a slash": lambda b: b["per_layer"][0].update(name="a/b"),
    "moves a metric the cell lacks": lambda b: b["per_layer"][0].update(
        moves="profiles_per_s"),
    "unknown workload": lambda b: b["per_layer"][0].update(
        workloads=["no_such_cell"]),
    "no setup_s": lambda b: b.update(end_to_end=[
        m for m in b["end_to_end"] if m["name"] != "setup_s"]),
    "missing config file": lambda b: b["configs"][0].update(name="nope"),
    "missing reader": lambda b: b["per_layer"][0].update(name="no.reader"),
    "two metrics, one name": lambda b: b["per_layer"].append(
        dict(b["per_layer"][0])),
    "bad source": lambda b: b["per_layer"][0].update(source="guess"),
}


@pytest.mark.parametrize("what", sorted(BREAKS))
def test_a_broken_manifest_fails(bench, what, tmp_path):
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(_broken(bench, BREAKS[what])))
    with pytest.raises(manifest.ManifestError):
        manifest.load(path)


def test_a_missing_driver_fails(bench, tmp_path, monkeypatch):
    monkeypatch.setattr(manifest, "driver_path",
                        lambda name: tmp_path / f"{name}.py")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(manifest.ManifestError, match="no driver"):
        manifest.load(path)
