"""The scoring cell's forest, made from the seed as LightGBM model text.

The shape of every tree (which leaf each split divides, leaf-wise, the
larger leaves first) comes from the configuration's ``shape_seed``, so
that every run walks the same depths; the run's seed draws each split's
feature, its threshold (a quantile of that feature in the scoring rows),
its NaN side, and the leaf values, on the device in a few calls.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..reference import modeltext


def tree_shapes(num_trees: int, num_leaves: int, shape_seed: int,
                smallest_share: float) -> List[Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]]:
    """Per tree ``(left_child, right_child, leaf_share)``: leaf-wise growth
    that splits a leaf with probability proportional to its share of the
    rows, each split dividing the share at a uniform fraction in
    ``[smallest_share, 1 - smallest_share]``."""
    rng = np.random.RandomState(shape_seed)
    out = []
    M = num_leaves - 1
    for _ in range(num_trees):
        share = np.zeros(num_leaves)
        share[0] = 1.0
        draws = rng.random_sample((M, 2))
        owner = {0: None}
        left = np.zeros(M, np.int64)
        right = np.zeros(M, np.int64)
        for i in range(M):
            cum = np.cumsum(share[:i + 1])
            li = min(int(np.searchsorted(cum, draws[i, 0] * cum[-1],
                                         side="right")), i)
            frac = smallest_share + (1.0 - 2 * smallest_share) * draws[i, 1]
            new = i + 1
            share[new] = share[li] * (1.0 - frac)
            share[li] *= frac
            if owner[li] is not None:
                pi, side = owner[li]
                (left if side == 0 else right)[pi] = i
            left[i], right[i] = ~li, ~new
            owner[li], owner[new] = (i, 0), (i, 1)
        out.append((left, right, share))
    return out


def make(spec: Dict, nan_columns, rows: torch.Tensor,
         gen: torch.Generator, batch_rows: int) -> Tuple[str, List[Dict]]:
    """``(model text, parsed trees)`` of the forest ``spec`` over the
    scoring rows ``rows`` ``[n, F]`` f32 (on the device)."""
    T, L = int(spec["num_trees"]), int(spec["num_leaves"])
    M = L - 1
    F = rows.shape[1]
    dev = rows.device
    shapes = tree_shapes(T, L, int(spec["shape_seed"]),
                         float(spec["smallest_share"]))
    feat = torch.randint(0, F, (T, M), generator=gen, device=dev)
    level = torch.randint(1, 1000, (T, M), generator=gen, device=dev)
    nan_left = torch.rand((T, M), generator=gen, device=dev) < 0.5
    leaf = torch.randn((T, L), generator=gen, device=dev,
                       dtype=torch.float64) * float(spec["leaf_scale"])
    sample = rows[:1 << 18].double()
    q = torch.arange(1000, dtype=torch.float64, device=dev) / 1000
    table = torch.stack([torch.nanquantile(sample[:, f], q)
                         for f in range(F)])                  # [F, 1000]
    thr = table[feat, level].cpu().numpy()
    feat, nan_left = feat.cpu().numpy(), nan_left.cpu().numpy()
    leaf = leaf.cpu().numpy()
    is_nan_col = np.zeros(F, bool)
    is_nan_col[list(nan_columns)] = True
    trees = []
    for t, (left, right, share) in enumerate(shapes):
        dtype = np.where(is_nan_col[feat[t]],
                         (modeltext.MISSING_NAN << 2)
                         | np.where(nan_left[t], modeltext.DEFAULT_LEFT, 0),
                         0).astype(np.int64)
        leaf_count = np.round(share * batch_rows).astype(np.int64)
        icount = np.zeros(M, np.int64)
        for i in range(M - 1, -1, -1):   # children come after their parent
            icount[i] = sum(icount[c] if c >= 0 else leaf_count[~c]
                            for c in (left[i], right[i]))
        trees.append({"num_leaves": L, "split_feature": feat[t],
                      "threshold": thr[t], "decision_type": dtype,
                      "left_child": left, "right_child": right,
                      "leaf_value": leaf[t], "leaf_count": leaf_count,
                      "internal_value": np.zeros(M), "internal_count": icount,
                      "shrinkage": 1.0})
    lo = torch.nan_to_num(sample, nan=np.inf).min(dim=0).values
    hi = torch.nan_to_num(sample, nan=-np.inf).max(dim=0).values
    infos = [f"[{a!r}:{b!r}]" for a, b in zip(lo.tolist(), hi.tolist())]
    text = modeltext.write(trees, F, "binary sigmoid:1", infos)
    return text, modeltext.parse(text)["trees"]
