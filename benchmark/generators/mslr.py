"""Generator ``mslr``: MSLR-WEB30K-shaped ranking rows, made on the device.

137 features on ``levels`` equal-mass values, graded 0-4 labels from a
noisy latent relevance at its 55/75/90/97% quantiles, lognormal query
sizes: the shape of the repository's smoke run (``chip_smoke.msltr_like``),
scaled to the published row and query counts. Every seed has the same
query sizes, in another order.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import data

F32 = torch.float32


def rows(n: int, spec: Dict, gen: torch.Generator, device):
    """``(X [n, 137] f32 on ``levels`` equal-mass values, y [n] f32 0-4)``."""
    F = int(spec["features"])
    K = int(spec["levels"])
    u = torch.rand((n, F), generator=gen, device=device)
    X = (torch.floor(u * K) + 0.5) / K
    latent = (X[:, 0] * 3 + X[:, 1] * X[:, 2] * 2 - X[:, 3]
              + X[:, 4].square() * 1.5
              + 0.8 * torch.randn(n, generator=gen, device=device))
    q = torch.quantile(latent.double()[:1 << 22],
                       torch.tensor([0.55, 0.75, 0.9, 0.97],
                                    dtype=torch.float64, device=device))
    y = torch.searchsorted(q, latent.double().contiguous()).to(F32)
    return X.to(F32), y


def training_data(spec: Dict, gen: torch.Generator, device) -> Dict:
    """Train and valid rows with their query sizes (``group``,
    ``group_v``)."""
    n, nv = int(spec["train_rows"]), int(spec["valid_rows"])
    X, y = rows(n, spec, gen, device)
    Xv, yv = rows(nv, spec, gen, device)
    q = spec["queries"]
    shape = (float(q["mean"]), float(q["sigma"]), int(q["smallest"]))
    return {"X": X, "y": y, "Xv": Xv, "yv": yv,
            "group": data.query_sizes(n, int(spec["train_queries"]),
                                      *shape, gen),
            "group_v": data.query_sizes(nv, int(spec["valid_queries"]),
                                        *shape, gen)}
