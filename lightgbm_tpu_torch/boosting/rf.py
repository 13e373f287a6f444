"""Random Forest mode (reference: src/boosting/rf.hpp); port of
``lightgbm_tpu/boosting/rf.py``.

Bagging is mandatory; gradients are always taken at zero scores so the
trees are independent (rf.hpp:97-104); each tree's leaf outputs go through
the objective's ConvertOutput (rf.hpp:160-167); the maintained score is the
running average of converted tree outputs (rf.hpp:117-121), and prediction
averages tree outputs without a final transform (average_output).
"""
from __future__ import annotations

import torch

from ..config import Config
from ..utils.log import Log
from .gbdt import GBDT


class RF(GBDT):
    average_output = True

    def __init__(self, config: Config, train_set):
        super().__init__(config, train_set)
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            Log.fatal("RF mode requires 0 < bagging_fraction < 1 and "
                      "bagging_freq > 0")
        if self.num_models != 1:
            Log.fatal("Cannot use RF for multi-class (rf.hpp:42)")
        Log.info("Using random forest")

    def _gradients(self, score):
        # trees are independent: gradients at zero score (rf.hpp:97-104)
        return super()._gradients(torch.zeros_like(score))

    def _tree_output_transform(self, tree):
        return tree._replace(
            leaf_value=self.objective.convert_output(tree.leaf_value))

    def _score_update(self, old_score_k, contrib, it: int):
        itf = torch.tensor(float(it), dtype=torch.float32,
                           device=self.device)
        return (old_score_k * itf + contrib) / (itf + 1.0)

    def _step_shrinkage(self) -> float:
        return 1.0         # rf.hpp:44-45
