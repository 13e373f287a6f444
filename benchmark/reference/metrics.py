"""Plain references of the valid-set metrics, in PyTorch (f64).

Written from LightGBM's definitions (``binary_metric.hpp`` AUCMetric,
``rank_metric.hpp`` NDCGMetric with ``dcg_calculator.cpp``):

- ``auc``: the area under the ROC curve of the raw scores, rows of equal
  score taken together (the trapezoid over each group of ties); 1 where
  one class is absent;
- ``ndcg@k``: per query, the documents in descending score order (ties in
  their stored order), DCG@k over the ideal DCG@k with gains ``2^label -
  1`` and discounts ``1 / log2(2 + position)``; a query whose ideal DCG is
  0 counts 1; the mean over queries.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

F64 = torch.float64


def auc(score: torch.Tensor, label: torch.Tensor) -> float:
    s = score.double()
    y = (label > 0).to(F64)
    order = torch.sort(s, descending=True, stable=True).indices
    s, y = s[order], y[order]
    tp = torch.cumsum(y, 0)
    fp = torch.cumsum(1.0 - y, 0)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    tp, fp = tp[last], fp[last]
    if float(tp[-1]) == 0 or float(fp[-1]) == 0:
        return 1.0
    tp0 = torch.cat([tp.new_zeros(1), tp[:-1]])
    fp0 = torch.cat([fp.new_zeros(1), fp[:-1]])
    area = ((fp - fp0) * (tp + tp0) / 2.0).sum()
    return float(area / (tp[-1] * fp[-1]))


def ndcg_at(score: torch.Tensor, label: torch.Tensor,
            query_sizes: Sequence[int], k: int) -> float:
    dev = score.device
    sizes = torch.as_tensor(np.asarray(query_sizes, np.int64), device=dev)
    Q, M = sizes.shape[0], int(sizes.max())
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(M, device=dev)
    valid = pos[None, :] < sizes[:, None]
    idx = torch.where(valid, starts[:, None] + pos[None, :], 0)
    s = torch.where(valid, score.double()[idx], -torch.inf)
    lab = torch.where(valid, label.long()[idx], 0)
    gain = (torch.pow(2.0, lab.to(F64)) - 1.0) * valid
    kk = min(k, M)
    disc = 1.0 / torch.log2(torch.arange(kk, device=dev, dtype=F64) + 2.0)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    dcg = (torch.gather(gain, 1, order[:, :kk]) * disc).sum(dim=1)
    ideal = (torch.sort(gain, dim=1, descending=True).values[:, :kk]
             * disc).sum(dim=1)
    per_query = torch.where(ideal > 0, dcg / torch.where(ideal > 0, ideal,
                                                         1.0), 1.0)
    return float(per_query.mean())


def evaluate(params: Dict, score: torch.Tensor, label: torch.Tensor,
             query_sizes=None) -> Dict[str, float]:
    """Each metric the configuration names, under LightGBM's own name of
    its result (``auc``, ``ndcg@10``)."""
    names: List[str] = params["metric"]
    names = [names] if isinstance(names, str) else list(names)
    out: Dict[str, float] = {}
    for name in names:
        if name == "auc":
            out["auc"] = auc(score, label)
        elif name == "ndcg":
            for k in params.get("ndcg_eval_at", [1, 2, 3, 4, 5]):
                out[f"ndcg@{k}"] = ndcg_at(score, label, query_sizes, int(k))
        else:
            raise ValueError(f"the reference has no metric {name!r}")
    return out
