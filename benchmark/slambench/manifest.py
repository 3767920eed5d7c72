"""BENCHMARK.json and the files it names, found by name.

Every configuration, traffic mix, cell and per-layer metric is a file of its
own, so a later change adds one by adding a file and an entry:

* a configuration: the file its `configs` entry names (`file`);
* a traffic mix: `benchmark/traffic/<traffic>.json`, read by the one
  general generator (slambench/traffic.py);
* a cell's correctness limits: `benchmark/cells/<workload name>.json`;
* a per-layer metric: `benchmark/metrics/<metric name>.py`, a reader with a
  `read(run)` function (slambench/harness.py::WindowRecord is its `run`);
* a system driver: `benchmark/systems/<system>.py`, a `Driver` class, named
  by a configuration's `system`.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

def load(path: Path | None = None) -> dict:
    with open(path or MANIFEST) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json "
                   f"(known: {', '.join(w['name'] for w in man['workloads'])})")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_file(man: dict, name: str) -> Path:
    return ROOT / config_entry(man, name)["file"]


def traffic_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def cell_file(name: str) -> Path:
    return BENCH_DIR / "cells" / f"{name}.json"


def reader_file(metric: str) -> Path:
    return BENCH_DIR / "metrics" / f"{metric}.py"


def applies(metric: dict, cell: str) -> bool:
    """A metric entry is reported in a cell: its `workloads` list holds the
    cell, or it has no such list."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: the end-to-end ones with
    --trace 0, the per-layer ones with --trace 1."""
    return [m for m in man["per_layer" if trace else "end_to_end"] if applies(m, cell)]


def system_file(system: str) -> Path:
    return BENCH_DIR / "systems" / f"{system}.py"


def _load(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """The `read(run)` function of a per-layer metric's reader file."""
    return _load(reader_file(metric), "slambench_metric", metric).read


def load_driver(system: str):
    """The `Driver` class of a system's driver file; a name without a file
    raises, naming the directory the drivers live in."""
    path = system_file(system)
    if not path.is_file():
        raise KeyError(f"no driver for system {system!r}: {path.name} is not in {path.parent}")
    return _load(path, "slambench_system", system).Driver


def resolve(man: dict, cell: str) -> dict:
    """Everything a run of `cell` needs, found by name: its workload entry,
    configuration, traffic mix and limits."""
    w = workload(man, cell)
    return {"workload": w, "config_name": w["config"], "config": read_json(config_file(man, w["config"])),
            "traffic": read_json(traffic_file(w["traffic"])), "cell": read_json(cell_file(cell))}
