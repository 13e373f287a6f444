"""Traffic ``train_loop_csr``: ``train_loop`` with both sets handed to the
program as ``scipy.sparse.csr_matrix`` rows, as a user reads LibSVM files.

The generator's dense rows become CSR on the device, with the rest of data
generation and outside ``construct_s``: only each cell's nonzero values are
stored, so an absent value is an implicit zero. ``train_loop``'s run, window,
checks and record are used as they are (a private copy of the module, whose
data step and dataset step this driver replaces): the reference still
judges the trees from the dense rows. The record gains the program's
bundle counters (``efb.*``, from the process-wide registry, so it holds
one run per process) under ``efb``.

Mix parameters: those of ``train_loop``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.harness import manifest

ROW_BLOCK = 1 << 17
EFB_GAUGES = ("features", "bundles", "hist_bins", "code_bytes",
              "bundled_features")


def to_csr(X):
    """A dense ``[n, F]`` tensor as a ``scipy.sparse.csr_matrix`` of its
    nonzero values (f32), found on the tensor's device block by block."""
    import scipy.sparse as sp
    import torch
    n, F = X.shape
    counts, indices, values = [], [], []
    for lo in range(0, n, ROW_BLOCK):
        block = X[lo:lo + ROW_BLOCK]
        nz = block != 0
        counts.append(nz.sum(dim=1).cpu())
        indices.append(nz.nonzero()[:, 1].to(torch.int32).cpu())
        values.append(block[nz].cpu())
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(counts).numpy(), out=indptr[1:])
    return sp.csr_matrix((torch.cat(values).numpy(),
                          torch.cat(indices).numpy(), indptr), shape=(n, F))


class _CsrData:
    """``harness.data`` with the CSR form of the train and valid rows added
    to what ``training_data`` returns (``csr``, ``csr_v``)."""

    def __init__(self, datagen):
        self._datagen = datagen

    def __getattr__(self, name):
        return getattr(self._datagen, name)

    def training_data(self, *args, **kwargs) -> Dict:
        d = self._datagen.training_data(*args, **kwargs)
        d["csr"], d["csr_v"] = to_csr(d["X"]), to_csr(d["Xv"])
        return d


def _datasets(lgt, d: Dict, params: Dict):
    ds = lgt.Dataset(d.pop("csr"), label=d["y_np"])
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(d.pop("csr_v"), label=d["yv_np"],
                     reference=ds).construct()
    return ds, dv


def bundle_counters() -> Dict:
    """The program's ``efb.*`` gauges (absent where it records none)."""
    from lightgbm_tpu_torch import observability as obs
    gauges = obs.get_registry().snapshot()["gauges"]
    return {k: gauges[f"efb.{k}"] for k in EFB_GAUGES
            if f"efb.{k}" in gauges}


def run(job) -> Dict:
    """One run of ``train_loop`` on CSR input; returns its record."""
    loop = manifest.driver("train_loop", job.bench_dir)
    loop.datagen = _CsrData(loop.datagen)
    loop._datasets = _datasets
    record = loop.run(job)
    record["efb"] = bundle_counters()
    return record
