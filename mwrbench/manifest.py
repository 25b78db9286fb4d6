"""`BENCHMARK.json`, read and checked, and the files it names.

Every cell, configuration and metric is found by its name:

  mwrbench/configs/<config>.json      a configuration's sizes
  mwrbench/workloads/<cell>.json      a cell's config, driver and traffic
  mwrbench/drivers/<driver>.py        one per entry point (class Driver)
  mwrbench/end_to_end/<metric>.py     an end-to-end metric's reader
  mwrbench/metrics/<metric>.py        a per-layer metric's reader

`load` fails loudly, before any run, where the file breaks the rules the
harness relies on.
"""

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class ManifestError(ValueError):
    pass


def _need(cond, msg):
    if not cond:
        raise ManifestError(msg)


def _name(value, what):
    _need(isinstance(value, str) and NAME.fullmatch(value),
          f"{what}: {value!r} is not a name (letters, digits, _, ., -)")


def config_path(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def workload_path(name: str) -> Path:
    return HERE / "workloads" / f"{name}.json"


def driver_path(name: str) -> Path:
    return HERE / "drivers" / f"{name}.py"


def reader_path(kind: str, name: str) -> Path:
    return HERE / kind / f"{name}.py"


def _metric(m: dict, kind: str, cells: set):
    _name(m.get("name"), f"{kind} metric")
    _need(isinstance(m.get("unit"), str) and UNIT.fullmatch(m["unit"]),
          f"{m['name']}: unit {m.get('unit')!r}")
    _need(m.get("better") in ("lower", "higher"), f"{m['name']}: better")
    _need(m.get("source") in SOURCES, f"{m['name']}: source")
    for w in m.get("workloads", []):
        _need(w in cells, f"{m['name']}: unknown workload {w!r}")
    _need(reader_path(kind, m["name"]).is_file(),
          f"{m['name']}: no reader {reader_path(kind, m['name'])}")


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric` (every cell, without `workloads`)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The checked manifest."""
    _need(path.is_file(), f"no {path}")
    bench = json.loads(path.read_text())
    configs = {c["name"]: c for c in bench.get("configs", [])}
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    _need(configs and cells, "no configs or no workloads")
    for c in configs.values():
        _name(c["name"], "config")
        _need(config_path(c["name"]).is_file(),
              f"{c['name']}: no {config_path(c['name'])}")
        for key in c.get("reduced", []):
            _name(key, f"{c['name']}: reduced key")
    for w in cells.values():
        _name(w["name"], "workload")
        _name(w.get("traffic"), f"{w['name']}: traffic")
        _need(w.get("config") in configs,
              f"{w['name']}: unknown config {w.get('config')!r}")
        _need(w.get("chips") in (1, 4), f"{w['name']}: chips")
        spec = workload_path(w["name"])
        _need(spec.is_file(), f"{w['name']}: no {spec}")
        data = json.loads(spec.read_text())
        _need(data.get("config") == w["config"],
              f"{w['name']}: {spec.name} names config {data.get('config')!r}")
        _need(driver_path(data.get("driver", "")).is_file(),
              f"{w['name']}: no driver {data.get('driver')!r}")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    per_layer = bench.get("per_layer", [])
    _need("setup_s" in e2e, "no setup_s")
    for m in e2e.values():
        _metric(m, "end_to_end", set(cells))
    for m in per_layer:
        _metric(m, "metrics", set(cells))
        _need(m.get("moves") in e2e, f"{m['name']}: moves {m.get('moves')!r}")
        layer = m.get("layer")
        _need(isinstance(layer, str) and 0 < len(layer) <= 200
              and not set(layer) & set("\n\r\t"), f"{m['name']}: layer")
        for w in (m.get("workloads") or list(cells)):
            _need(reports(e2e[m["moves"]], w),
                  f"{m['name']}: cell {w} does not report {m['moves']}")
    names = [m["name"] for m in bench["end_to_end"]] + [
        m["name"] for m in per_layer]
    _need(len(names) == len(set(names)), "two metrics share a name")
    for w in cells:
        _need(any(reports(m, w) for m in per_layer),
              f"{w}: no per-layer metric")
        _need(sum(reports(m, w) for m in e2e.values()) >= 2,
              f"{w}: needs setup_s and one more end-to-end metric")
    return bench


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())
