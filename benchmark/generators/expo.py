"""Generator ``expo``: ASA Data Expo 2009 airline rows, made on the device.

The eight columns of the public airline-delay task, the shape of the
repository's smoke run (``chip_smoke.expo_like``), at the published row
counts:

- Month, DayofMonth and DayOfWeek uniform over 1-12, 1-31 and 1-7;
- UniqueCarrier Zipf (``carrier_zipf``) over its 22 carriers;
- Origin and Dest: Zipf(1) over their ``head`` most frequent airports,
  which take all but ``tail_share`` of the rows; the other airports share
  ``tail_share`` evenly, so that the counts of a 200,000-row sample part
  between the last head airport and the tail by some ten standard
  deviations (about 130 rows against 13);
- DepTime hhmm from an hour about 13:00, Distance a clipped lognormal,
  each kept on ``levels`` equal-mass values of the training rows.

Carrier and airport ids are a fixed shuffle of 1..n (the rank of a
category says nothing of its id); every id is passed as an f32 integer, as
users pass them. The label is a departure delay above 15 minutes, drawn
from a planted logit: an effect for each month, weekday, carrier, origin
and destination (drawn once from ``effects_seed`` on the CPU and centred,
so that every run and device shares one model) and an hour term.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import data

F32 = torch.float32
F64 = torch.float64
# (column, standard deviation of its effects)
EFFECTS = ((0, 0.4), (2, 0.3), (3, 0.6), (4, 0.8), (5, 0.7))
HOUR_SLOPE = 0.15


def _fixed(seed: int) -> torch.Generator:
    """A CPU generator: the same draws on every device."""
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def category_probabilities(spec: Dict, column: int) -> torch.Tensor:
    """f64 ``[cardinality]``: the share of rows of each category rank of a
    categorical column (rank 0 the most frequent)."""
    k = int(spec["cardinality"][column])
    if column in spec["airports"]:
        head = int(spec["head"])
        tail = float(spec["tail_share"])
        p = 1.0 / torch.arange(1, head + 1, dtype=F64)
        p = p / p.sum() * (1.0 - tail)
        return torch.cat([p, torch.full((k - head,), tail / (k - head),
                                        dtype=F64)])
    if column == spec["carrier"]:
        p = torch.arange(1, k + 1, dtype=F64) ** -float(spec["carrier_zipf"])
        return p / p.sum()
    return torch.full((k,), 1.0 / k, dtype=F64)


def category_ids(spec: Dict, column: int) -> torch.Tensor:
    """i64 ``[cardinality]``: the id of each category rank (1..n, a fixed
    shuffle for carriers and airports, in order for the calendar)."""
    k = int(spec["cardinality"][column])
    if column in spec["airports"] or column == spec["carrier"]:
        g = _fixed(int(spec["effects_seed"]) + 1 + column)
        return torch.randperm(k, generator=g) + 1
    return torch.arange(1, k + 1)


def effects(spec: Dict) -> Dict[int, torch.Tensor]:
    """f64 ``[cardinality]`` per column with an effect, by category rank,
    centred under the column's own category shares."""
    g = _fixed(int(spec["effects_seed"]))
    out = {}
    for col, sd in EFFECTS:
        k = int(spec["cardinality"][col])
        e = torch.randn(k, generator=g, dtype=F64) * sd
        out[col] = e - (e * category_probabilities(spec, col)).sum()
    return out


def rows(n: int, spec: Dict, gen: torch.Generator, device):
    """``(X [n, 8] f32, y [n] f32)``: the raw rows, before the numerical
    columns are put on their levels."""
    cats = spec["categorical"]
    X = torch.empty((n, int(spec["features"])), dtype=F32, device=device)
    rank = {}
    for col in cats:
        cdf = torch.cumsum(category_probabilities(spec, col), 0).to(device)
        u = torch.rand(n, generator=gen, device=device, dtype=F64)
        rank[col] = torch.clamp(torch.searchsorted(cdf, u), max=len(cdf) - 1)
        X[:, col] = category_ids(spec, col).to(device)[rank[col]].to(F32)
    hour = torch.clamp(13.0 + 4.5 * torch.randn(n, generator=gen,
                                                device=device), 0, 23).floor()
    minute = torch.randint(0, 60, (n,), generator=gen, device=device)
    X[:, 6] = hour * 100 + minute
    X[:, 7] = torch.clamp(torch.exp(6.4 + 0.6 * torch.randn(
        n, generator=gen, device=device)), 30, 4962).round()
    logit = torch.full((n,), float(spec["intercept"]), dtype=F64,
                       device=device) + HOUR_SLOPE * (hour.double() - 13.0)
    for col, e in effects(spec).items():
        logit += e.to(device)[rank[col]]
    y = (torch.rand(n, generator=gen, device=device, dtype=F64)
         < torch.sigmoid(logit)).to(F32)
    return X, y


def training_data(spec: Dict, gen: torch.Generator, device) -> Dict:
    """Train and valid rows, DepTime and Distance each on the train rows'
    ``levels`` equal-mass values."""
    X, y = rows(int(spec["train_rows"]), spec, gen, device)
    Xv, yv = rows(int(spec["valid_rows"]), spec, gen, device)
    num = [c for c in range(X.shape[1]) if c not in spec["categorical"]]
    bounds, values = data.equal_mass_levels(X[:, num], int(spec["levels"]))
    X[:, num] = data.quantize(X[:, num], bounds, values)
    Xv[:, num] = data.quantize(Xv[:, num], bounds, values)
    return {"X": X, "y": y, "Xv": Xv, "yv": yv}
