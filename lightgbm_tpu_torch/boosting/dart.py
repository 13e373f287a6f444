"""DART: Dropouts meet Multiple Additive Regression Trees (reference:
src/boosting/dart.hpp); port of ``lightgbm_tpu/boosting/dart.py``.

Per iteration: select a drop set among the previous trees (weighted or
uniform, dart.hpp:85-112) on the host from ``np.random.default_rng(
drop_seed)`` — the JAX package's generator, so the same draws — take the
dropped trees' contribution out of the training and validation scores,
train the new tree with shrinkage lr/(1+k) (xgboost mode: lr/(lr+k)), then
renormalise the dropped trees by k/(k+1) (xgboost mode: k/(k+lr))
(dart.hpp:133-180). Dropped contributions are replayed on the device by a
walk of the binned codes (``ops/predict.leaves_from_binned``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..utils.log import Log
from .gbdt import GBDT


class DART(GBDT):

    def __init__(self, config: Config, train_set):
        super().__init__(config, train_set)
        Log.info("Using DART")
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_rng = np.random.default_rng(config.drop_seed)

    def _select_drop(self) -> List[int]:
        cfg = self.config
        n = self.iter_
        if n == 0 or self._drop_rng.random() < cfg.skip_drop:
            return []
        drop = []
        if not cfg.uniform_drop:
            inv_avg = len(self.tree_weight) / self.sum_weight \
                if self.sum_weight > 0 else 0.0
            rate = cfg.drop_rate
            if cfg.max_drop > 0 and self.sum_weight > 0:
                rate = min(rate, cfg.max_drop * inv_avg / self.sum_weight)
            for i in range(n):
                if self._drop_rng.random() < \
                        rate * self.tree_weight[i] * inv_avg:
                    drop.append(i)
        else:
            rate = cfg.drop_rate
            if cfg.max_drop > 0:
                rate = min(rate, cfg.max_drop / max(n, 1))
            for i in range(n):
                if self._drop_rng.random() < rate:
                    drop.append(i)
        return drop

    def train_one_iter(self) -> None:
        cfg = self.config
        lr = cfg.learning_rate
        drop = self._select_drop()
        k = len(drop)
        if cfg.xgboost_dart_mode:
            shrinkage = lr if k == 0 else lr / (lr + k)
            factor = k / (k + lr) if k else 0.0
        else:
            shrinkage = lr / (1.0 + k)
            factor = k / (k + 1.0) if k else 0.0

        # the drop arithmetic is not undone by a rollback (as in the JAX
        # package, which rolls back by subtraction only)
        self._undo = None
        if k:
            drop_train = torch.zeros_like(self.score)
            drop_valid = [torch.zeros_like(vs.score) for vs in self.valid_sets]
            for i in drop:
                for c in range(self.num_models):
                    tree = self.models[i][c]
                    drop_train[c] += self._tree_contrib(tree, self.Xb)
                    for vi, vs in enumerate(self.valid_sets):
                        drop_valid[vi][c] += self._tree_contrib(tree, vs.Xb)
            score_adj = self.score - drop_train
            for vi, vs in enumerate(self.valid_sets):
                vs.score = vs.score - drop_valid[vi]
        else:
            score_adj = self.score

        score, new_valid = self._run_step(score_adj, shrinkage)
        f = torch.tensor(factor, dtype=torch.float32, device=self.device)
        self.score = score + drop_train * f if k else score
        for vi, vs in enumerate(self.valid_sets):
            new_v = torch.stack(new_valid[vi])
            vs.score = new_v + drop_valid[vi] * f if k else new_v

        # permanently renormalise the dropped trees (dart.hpp:138-158)
        for i in drop:
            self.models[i] = [t._replace(leaf_value=t.leaf_value * f)
                              for t in self.models[i]]
            if not cfg.uniform_drop:
                if cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + lr))
                else:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                self.tree_weight[i] *= factor
        self.tree_weight.append(shrinkage)
        self.sum_weight += shrinkage
