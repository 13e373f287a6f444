"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``<config>`` is ``benchmark/configs/<config>.json``;
- a traffic mix ``<traffic>`` is ``benchmark/traffic/<traffic>.json``; its
  ``driver`` names ``benchmark/drivers/<driver>.py``, the general code
  that runs every mix of that kind from the mix's parameters;
- a data generator ``<generator>`` (named in a configuration's ``data``)
  is ``benchmark/generators/<generator>.py``, with ``rows`` and
  ``training_data``;
- a per-layer metric ``<name>`` is ``benchmark/metrics/<name>.py``, with
  ``UNIT``, ``SOURCE``, ``LAYER``, ``MOVES`` and ``read(ctx)``;
- the limits of a cell's correctness check are
  ``benchmark/limits/<cell>.json``.

A later change adds a cell by adding these files and entries; no file
here names a cell, a configuration, a mix, a generator or a metric.
"""
from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

from .env import BENCH_DIR, ROOT


def load_manifest(root: str = ROOT) -> Dict:
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        return json.load(fh)


def _json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> Dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as fh:
        return json.load(fh)


def config(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _json("configs", name, bench_dir)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _json("traffic", name, bench_dir)


def limits(cell: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _json("limits", cell, bench_dir)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "drivers", f"{name}.py"),
                   f"benchmark_driver_{name}")


def generator(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "generators", f"{name}.py"),
                   f"benchmark_generator_{name}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                   "benchmark_metric_" + name.replace(".", "_"))


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: Dict, cell_name: str, section: str) -> List[Dict]:
    """The entries of ``end_to_end`` or ``per_layer`` that a cell reports:
    those with no ``workloads`` key, and those that list the cell."""
    return [m for m in manifest[section]
            if cell_name in m.get("workloads", [cell_name])]
