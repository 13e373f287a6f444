"""Traffic ``train_loop_cat``: ``train_loop`` with the configuration's
``categorical`` columns handed to the program as ``categorical_feature``,
judged by the categorical reference (``reference/categorical.py``).

``train_loop``'s run, window, checks and record are used as they are (a
private copy of the module, as ``train_loop_csr`` takes it) with four
replacements: its reference step ``ref`` (the categorical bins, split rule,
judge and grower, bound to the configuration's categorical columns and
``max_bin``), its model-text reader ``modeltext`` and its walk ``walk``
are the categorical reference's, its dataset step passes the categorical
columns, and its window first asks for the program's ``categorical.*``
gauges: a program that records none cannot report the cell, and the run
stops with an error at the first batch boundary. The record gains, under
``categorical``:

- the program's gauges ``categorical.features``, ``.max_bins`` and
  ``.code_bytes`` (from the process-wide registry, so it holds one run
  per process);
- ``window_splits`` and ``window_cat_splits``: the splits of the window's
  trees and the categorical ones among them, from the parsed model text;
- ``judged_cat_nodes``: the categorical nodes of the checked trees, and
  ``checked_without_cat``: the checked trees that have none.

Mix parameters: those of ``train_loop``.
"""
from __future__ import annotations

from functools import partial
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from benchmark.harness import manifest
from benchmark.reference import categorical as cat

GAUGES = ("features", "max_bins", "code_bytes")


def reference(categorical: List[int], params: Dict) -> SimpleNamespace:
    """What ``train_loop`` reads as ``ref``, for these categorical
    columns."""
    return SimpleNamespace(
        Bins=partial(cat.Bins, categorical=categorical,
                     max_bin=int(params.get("max_bin", 255)),
                     min_data_in_bin=int(params.get("min_data_in_bin", 3))),
        SplitRule=cat.SplitRule, judge=cat.judge, grow=cat.grow,
        gradients=cat.gradients, wave_size=cat.wave_size,
        ordered_pairs=cat.ordered_pairs)


def categorical_gauges() -> Dict:
    """The program's ``categorical.*`` gauges (absent where it records
    none)."""
    from lightgbm_tpu_torch import observability as obs
    gauges = obs.get_registry().snapshot()["gauges"]
    return {k: gauges[f"categorical.{k}"] for k in GAUGES
            if f"categorical.{k}" in gauges}


def _datasets(lgt, d: Dict, params: Dict, categorical: List[int]):
    ds = lgt.Dataset(d["X_np"], label=d["y_np"],
                     categorical_feature=categorical)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(d["Xv_np"], label=d["yv_np"], reference=ds).construct()
    return ds, dv


def _asking(window_cls):
    """``train_loop``'s window, asking for the program's gauges first."""

    class _Window(window_cls):
        def __call__(self, env) -> None:
            if self.batches == 0 and not categorical_gauges():
                raise RuntimeError(
                    "the program records no categorical.* gauges, which "
                    "this cell reads: it cannot run the cell")
            super().__call__(env)
    return _Window


def split_counts(trees: List[Dict]) -> Dict[str, int]:
    """The splits of these trees and the categorical ones among them."""
    dts = [np.asarray(t["decision_type"], np.int64) for t in trees]
    return {"splits": int(sum(len(d) for d in dts)),
            "cat_splits": int(sum((d & cat.CATEGORICAL).sum() for d in dts))}


def run(job) -> Dict:
    """One run of ``train_loop`` with categorical columns; returns its
    record."""
    columns = [int(c) for c in job.config["data"]["categorical"]]
    params = dict(job.config["params"], **job.param_overrides)
    loop = manifest.driver("train_loop", job.bench_dir)
    loop.ref = reference(columns, params)
    loop.modeltext = cat
    loop.walk = cat
    loop._datasets = partial(_datasets, categorical=columns)
    loop._Window = _asking(loop._Window)
    record = loop.run(job)
    first, close = record["window_trees"]
    window = split_counts(record["trees"][first:close])
    judged = {d["tree"]: d["cat_nodes"] for d in record["judge_detail"]}
    record["categorical"] = dict(
        categorical_gauges(), window_splits=window["splits"],
        window_cat_splits=window["cat_splits"],
        judged_cat_nodes=int(sum(judged.values())),
        checked_without_cat=[t for t, k in judged.items() if k == 0])
    return record
