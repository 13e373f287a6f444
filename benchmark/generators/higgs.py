"""Generator ``higgs``: HIGGS-shaped binary rows, made on the device.

21 low-level kinematic-like and 7 derived f32 features, a share of NaN in
the configuration's ``nan_columns``, labels drawn from a planted logit:
the shape of the repository's smoke run (``chip_smoke.higgs_like``),
scaled to the published row counts. For training every feature keeps
``levels`` equal-mass values (see the configuration's ``assumed``);
scoring keeps the raw values.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import data

F32 = torch.float32


def rows(n: int, spec: Dict, gen: torch.Generator, device):
    """``(X [n, 28] f32, y [n] f32)``."""
    F = int(spec["features"])
    X = torch.empty((n, F), dtype=F32, device=device)
    X[:, :14] = torch.randn((n, 14), generator=gen, device=device)
    X[:, 14:21] = -torch.log1p(-torch.rand((n, 7), generator=gen,
                                           device=device))
    X[:, 21:] = X[:, :7] * X[:, 14:21] + 0.3 * torch.randn(
        (n, 7), generator=gen, device=device)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 3] + 0.6 * X[:, 21] * X[:, 1]
             + 0.5 * torch.log1p(X[:, 15]) - 0.4 * X[:, 5].abs() + 0.2)
    y = (torch.rand(n, generator=gen, device=device)
         < torch.sigmoid(logit)).to(F32)
    for col in spec["nan_columns"]:
        miss = torch.rand(n, generator=gen, device=device) \
            < float(spec["nan_share"])
        X[miss, col] = float("nan")
    return X, y


def training_data(spec: Dict, gen: torch.Generator, device) -> Dict:
    """Train and valid rows, each feature on the train rows' ``levels``
    equal-mass values."""
    X, y = rows(int(spec["train_rows"]), spec, gen, device)
    Xv, yv = rows(int(spec["valid_rows"]), spec, gen, device)
    bounds, values = data.equal_mass_levels(X, int(spec["levels"]))
    return {"X": data.quantize(X, bounds, values), "y": y,
            "Xv": data.quantize(Xv, bounds, values), "yv": yv}
