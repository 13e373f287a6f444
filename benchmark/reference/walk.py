"""A plain walk of numerical trees over raw feature values, in PyTorch.

Each row starts at the root and takes one step per level: ``x <= threshold``
goes left; a NaN goes to the default side where the node's missing type
is NaN, and counts as 0.0 elsewhere; where the missing type is zero, a
value within 1e-20 of zero goes to the default side. This is LightGBM's
``Tree::Decision`` for numerical splits, written from its definition.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .modeltext import DEFAULT_LEFT, MISSING_NAN, MISSING_ZERO, depth_of

ZERO_RANGE = 1e-20


def _tensors(tree: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(tree[k]), device=device)
            for k in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child")}


def leaves(tree: Dict, X: torch.Tensor) -> torch.Tensor:
    """The leaf index of every row of ``X`` ``[n, F]`` (any float dtype,
    compared in f64)."""
    n = X.shape[0]
    if tree["num_leaves"] <= 1:
        return torch.zeros(n, dtype=torch.int64, device=X.device)
    t = _tensors(tree, X.device)
    cur = torch.zeros(n, dtype=torch.int64, device=X.device)
    for _ in range(depth_of(tree)):
        active = cur >= 0
        node = cur.clamp(min=0)
        feat = t["split_feature"][node]
        x = torch.gather(X, 1, feat[:, None])[:, 0].double()
        dt = t["decision_type"][node]
        missing = (dt >> 2) & 3
        default_left = (dt & DEFAULT_LEFT) != 0
        nan = torch.isnan(x)
        x = torch.where(nan & (missing != MISSING_NAN), torch.zeros_like(x),
                        x)
        left = x <= t["threshold"][node]
        is_default = torch.where(missing == MISSING_NAN, nan,
                                 (missing == MISSING_ZERO)
                                 & (x.abs() <= ZERO_RANGE))
        left = torch.where(is_default, default_left, left)
        nxt = torch.where(left, t["left_child"][node], t["right_child"][node])
        cur = torch.where(active, nxt, cur)
    return ~cur


def raw_scores(trees: List[Dict], X: torch.Tensor,
               dtype=torch.float64) -> torch.Tensor:
    """The sum of the trees' leaf values for every row, accumulated in
    ``dtype`` (f64 for the reference; the control passes a lower one)."""
    out = torch.zeros(X.shape[0], dtype=dtype, device=X.device)
    for tree in trees:
        lv = torch.as_tensor(tree["leaf_value"], device=X.device).to(dtype)
        out += lv[leaves(tree, X)]
    return out


def path_comparisons(trees: List[Dict], X: torch.Tensor) -> int:
    """The comparisons along each row's path in each tree: the work a walk
    of these rows must do at the least (the scoring roofline's count)."""
    total = 0
    for tree in trees:
        if tree["num_leaves"] <= 1:
            continue
        depth = np.zeros(tree["num_leaves"], np.int64)
        d_int = np.zeros(len(tree["split_feature"]), np.int64)
        for i in range(len(d_int)):
            for c in (tree["left_child"][i], tree["right_child"][i]):
                if c >= 0:
                    d_int[c] = d_int[i] + 1
                else:
                    depth[~c] = d_int[i] + 1
        lv = leaves(tree, X)
        total += int(torch.as_tensor(depth, device=X.device)[lv].sum())
    return total
