"""Generator ``bosch``: Bosch-shaped production-line rows, made on the device.

Each row is a part on its route through the stations of four lines. The
configuration's ``lines`` list the lines in column order; a line with a
``choice`` share is one of a set of which every part takes exactly one, a
line with a ``visit`` share is taken or not on its own. A line is a list of
forks, and a fork a list of alternative stations (their widths in
features), of which a part on the line takes one, each alternative alike.
Every feature of a station the part visits is present and every feature of
a station it does not visit is absent (0, not stored in CSR), so the
alternatives of a fork, and the lines of one choice, are exclusive in
every row.

A present value is one of a feature's ``levels`` nonzero values:
``negative_levels`` of them below zero, holding ``negative_share`` of the
mass, the rest above; the values are the feature's scale (drawn from the
configuration's ``scale_seed``) times fixed steps, so none is 0.0.
Labels: exactly ``round(positive_rate * n)`` positives, drawn without
replacement with weights ``noise_floor + exp(s)``, where ``s`` is a
planted logit over a few stations' values and the route.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

F32 = torch.float32
COLUMN_BLOCK = 64


def stations(spec: Dict) -> List[Dict]:
    """Every station in column order: its number ``s``, line, fork (a
    global index), first column and width."""
    out, col, fork = [], 0, 0
    for line in spec["lines"]:
        for alternatives in line["forks"]:
            for width in alternatives:
                out.append({"s": len(out), "line": line["name"],
                            "fork": fork, "col": col, "width": int(width)})
                col += int(width)
            fork += 1
    return out


def column(spec: Dict, station: int, feature: int) -> int:
    st = stations(spec)[station]
    if not 0 <= feature < st["width"]:
        raise ValueError(f"station {station} has {st['width']} features, "
                         f"not a feature {feature}")
    return st["col"] + feature


def route(n: int, spec: Dict, gen: torch.Generator,
          device) -> torch.Tensor:
    """``[n, stations]`` bool: the stations each row visits."""
    sts = stations(spec)
    visit = torch.zeros((n, len(sts)), dtype=torch.bool, device=device)
    chosen = [ln for ln in spec["lines"] if "choice" in ln]
    shares = torch.tensor([float(ln["choice"]) for ln in chosen],
                          dtype=torch.float64, device=device)
    pick = torch.multinomial(shares, n, replacement=True, generator=gen)
    on_line = {}
    for i, ln in enumerate(chosen):
        on_line[ln["name"]] = pick == i
    for ln in spec["lines"]:
        if "visit" in ln:
            on_line[ln["name"]] = torch.rand(
                n, generator=gen, device=device) < float(ln["visit"])
    fork_of = {}
    for st in sts:
        fork_of.setdefault(st["fork"], []).append(st)
    for members in fork_of.values():
        k = len(members)
        alt = torch.randint(0, k, (n,), generator=gen, device=device)
        line = on_line[members[0]["line"]]
        for j, st in enumerate(members):
            visit[:, st["s"]] = line & (alt == j)
    return visit


def level_values(spec: Dict, device) -> torch.Tensor:
    """``[features, levels]`` f32: each feature's nonzero values, ascending:
    ``negative_levels`` steps below zero, the rest above, times the
    feature's scale (from ``scale_seed``, so the train and valid rows of
    every seed share them)."""
    F, L = int(spec["features"]), int(spec["levels"])
    neg = int(spec["negative_levels"])
    steps = torch.cat([-torch.arange(neg, 0, -1, dtype=torch.float64),
                       torch.arange(1, L - neg + 1, dtype=torch.float64)])
    steps = steps / neg
    fixed = torch.Generator().manual_seed(int(spec["scale_seed"]))
    scale = torch.exp(0.3 * torch.randn(F, generator=fixed,
                                        dtype=torch.float64))
    return (scale[:, None] * steps[None, :]).to(F32).to(device)


def rows(n: int, spec: Dict, gen: torch.Generator, device
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(X [n, features] f32, dense with 0 for absent, y [n] f32)``."""
    F, L = int(spec["features"]), int(spec["levels"])
    neg = int(spec["negative_levels"])
    p_neg = float(spec["negative_share"])
    sts = stations(spec)
    if sum(st["width"] for st in sts) != F:
        raise ValueError(f"the stations' widths do not sum to {F} features")
    visit = route(n, spec, gen, device)
    values = level_values(spec, device)
    station_of_col = torch.cat([torch.full((st["width"],), st["s"],
                                           dtype=torch.long, device=device)
                                for st in sts])
    X = torch.zeros((n, F), dtype=F32, device=device)
    for lo in range(0, F, COLUMN_BLOCK):
        hi = min(lo + COLUMN_BLOCK, F)
        u = torch.rand((n, hi - lo), generator=gen, device=device)
        # a uniform level on the drawn side of zero
        k = torch.where(u < p_neg,
                        (u / p_neg * neg).long().clamp(max=neg - 1),
                        neg + ((u - p_neg) / (1 - p_neg) * (L - neg))
                        .long().clamp(max=L - neg - 1))
        x = values[lo:hi][torch.arange(hi - lo, device=device)[None, :], k]
        X[:, lo:hi] = torch.where(visit[:, station_of_col[lo:hi]], x,
                                  torch.zeros((), dtype=F32, device=device))
        del u, k, x
    y = labels(X, visit, spec, gen)
    return X, y


def labels(X: torch.Tensor, visit: torch.Tensor, spec: Dict,
           gen: torch.Generator) -> torch.Tensor:
    """Exactly ``round(positive_rate * n)`` positives, drawn without
    replacement with weights ``noise_floor + exp(s)`` (keys ``log(u) /
    w``, the largest taken)."""
    lab = spec["label"]
    n = X.shape[0]
    s = torch.zeros(n, dtype=torch.float64, device=X.device)
    for station, feature, weight in lab["values"]:
        s += float(weight) * X[:, column(spec, station, feature)].double()
    for station, weight in lab["routes"]:
        s += float(weight) * visit[:, station].double()
    w = float(lab["noise_floor"]) + torch.exp(s)
    u = torch.rand(n, generator=gen, device=X.device, dtype=torch.float64)
    key = torch.log(u.clamp(min=1e-300)) / w
    k = int(round(float(lab["positive_rate"]) * n))
    y = torch.zeros(n, dtype=F32, device=X.device)
    y[torch.topk(key, k).indices] = 1.0
    return y


def training_data(spec: Dict, gen: torch.Generator, device) -> Dict:
    """Train and valid rows, each drawn on its own."""
    X, y = rows(int(spec["train_rows"]), spec, gen, device)
    Xv, yv = rows(int(spec["valid_rows"]), spec, gen, device)
    return {"X": X, "y": y, "Xv": Xv, "yv": yv}
