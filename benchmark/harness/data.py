"""Inputs made on the device from ``--seed``, in a few large calls.

A configuration's ``data`` block names its ``generator``, the module
``benchmark/generators/<generator>.py`` (found by name, as drivers are),
which gives ``rows(n, spec, gen, device)`` and ``training_data(spec, gen,
device)``. This module holds what generators share: the seeded generator,
equal-mass levels, and query sizes.

Every seed gets the same sizes: the same row counts, and the same set of
query sizes in another order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import manifest
from .env import BENCH_DIR


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 64) - 1))
    return g


def equal_mass_levels(X: torch.Tensor, levels: int, sample: int = 1 << 20):
    """Per feature, ``levels`` values of equal mass: ``(bounds [F, levels-1],
    values [F, levels])`` f32, from the quantiles of the first ``sample``
    rows."""
    S = X[:sample].double()
    qb = torch.arange(1, levels, dtype=torch.float64,
                      device=X.device) / levels
    qv = (torch.arange(levels, dtype=torch.float64, device=X.device)
          + 0.5) / levels
    bounds, values = [], []
    for f in range(X.shape[1]):
        col = S[:, f]
        col = col[~torch.isnan(col)]
        bounds.append(torch.quantile(col, qb))
        values.append(torch.quantile(col, qv))
    return torch.stack(bounds).float(), torch.stack(values).float()


def quantize(X: torch.Tensor, bounds: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """Each value replaced by its level; NaN stays NaN."""
    out = torch.empty_like(X)
    for f in range(X.shape[1]):
        col = X[:, f]
        idx = torch.searchsorted(bounds[f].contiguous(),
                                 col.contiguous()).clamp(max=values.shape[1]
                                                         - 1)
        out[:, f] = torch.where(torch.isnan(col), col, values[f][idx])
    return out


def query_sizes(rows: int, queries: int, mean: float, sigma: float,
                smallest: int, gen: torch.Generator) -> np.ndarray:
    """``queries`` sizes from the lognormal's quantiles (mean ``mean``),
    at least ``smallest``, adjusted to sum to ``rows``, in an order drawn
    from ``gen``: every seed has the same sizes."""
    mu = math.log(mean) - sigma * sigma / 2
    p = (torch.arange(queries, dtype=torch.float64) + 0.5) / queries
    sizes = torch.exp(mu + sigma * torch.special.ndtri(p)).round()
    sizes = sizes.clamp(min=smallest).to(torch.int64).numpy()
    diff = int(rows - sizes.sum())
    order = np.argsort(-sizes, kind="stable")
    step = 1 if diff > 0 else -1
    i = 0
    while diff:
        q = order[i % queries]
        if sizes[q] + step >= smallest:
            sizes[q] += step
            diff -= step
        i += 1
    perm = torch.randperm(queries, generator=gen,
                          device=gen.device).cpu().numpy()
    return sizes[perm].astype(np.int32)


def training_data(spec: Dict, seed: int, device,
                  rows: Optional[Dict] = None,
                  bench_dir: str = BENCH_DIR) -> Dict:
    """The train and valid rows of a configuration's ``data`` block, from
    the generator it names: ``X``, ``y``, ``Xv``, ``yv`` on ``device`` (and
    ``group``, ``group_v`` for ranking). ``rows`` overrides the row and
    query counts (tests)."""
    spec = dict(spec, **(rows or {}))
    return manifest.generator(spec["generator"], bench_dir).training_data(
        spec, generator(seed, device), device)


def rows(spec: Dict, n: int, gen: torch.Generator, device,
         bench_dir: str = BENCH_DIR):
    """``n`` raw rows ``(X, y)`` of the generator that ``spec`` names."""
    return manifest.generator(spec["generator"], bench_dir).rows(
        n, spec, gen, device)
