"""Find a cell's pieces by name.

`BENCHMARK.json` at the checkout's root lists the configurations, cells
and metrics. Everything that belongs to one of them sits in a file of its
own, found by the name the manifest gives:

- a configuration: the `file` its manifest entry names (`configs/<name>.json`);
  its `driver` key names `drivers/<driver>.py`, the code that builds and
  drives that kind of system;
- a traffic mix: `traffic/<traffic>.json`, parameters only;
- a cell's correctness limits: `workloads/<cell>.json`;
- a metric: `metrics/<metric>.py`, a reader with `read(run) -> float | None`.

So a later cell or metric is new files and a manifest entry, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import types

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries of the metrics this cell reports
    per_layer: list
    bench_dir: pathlib.Path


def load_manifest(path: pathlib.Path = MANIFEST) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def reports(metric: dict, cell: str) -> bool:
    """A metric without a `workloads` key is reported by every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: pathlib.Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def find_cell(name: str, manifest_path: pathlib.Path = MANIFEST,
              bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    manifest_path = pathlib.Path(manifest_path)
    bench_dir = pathlib.Path(bench_dir)
    manifest = load_manifest(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        config=_read_json(manifest_path.parent / cfg_entry["file"], "configuration"),
        traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json", "traffic"),
        limits=_read_json(bench_dir / "workloads" / f"{name}.json", "cell")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)],
        bench_dir=bench_dir)


def _load_file(path: pathlib.Path, prefix: str) -> types.ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod_name = prefix + "".join(ch if ch.isalnum() else "_" for ch in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell) -> types.ModuleType:
    return _load_file(cell.bench_dir / "drivers" / f"{cell.config['driver']}.py",
                      "benchmark_driver_")


def load_reader(metric: str, bench_dir: pathlib.Path = BENCH_DIR) -> types.ModuleType:
    return _load_file(pathlib.Path(bench_dir) / "metrics" / f"{metric}.py", "benchmark_metric_")
