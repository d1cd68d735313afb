"""Everything the benchmark runs, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell names
a configuration (``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``), and has its comparison limits in
``perfbench/limits/<cell>.json``. A per-layer metric is read by
``perfbench/metrics/<metric>.py``, the reference model of a family is
``perfbench/reference/<family>.py``. Adding a cell, configuration, mix or
metric is adding such files and entries; no code here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    for cell in benchmark()["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict[str, float]:
    """The cell's limit on each number it compares."""
    return _json(BENCH_DIR / "limits" / f"{cell}.json")["limits"]


def metrics_of(cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those whose ``workloads`` name it, and those without the
    key."""
    return [m for m in benchmark()[section]
            if cell in m.get("workloads", [cell])]


def module(folder: str, name: str):
    """``perfbench/<folder>/<name>.py`` loaded by its path (a name may hold
    dots)."""
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader: ``read(run)`` of
    ``perfbench/metrics/<metric>.py``."""
    return module("metrics", metric).read
