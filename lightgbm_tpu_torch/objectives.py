"""Objective functions: score -> (gradient, hessian) as torch tensor math.

Port of ``lightgbm_tpu/objectives.py`` for the first slice: the L2 and
binary objectives (reference src/objective/regression_objective.hpp:13-75,
binary_objective.hpp:13-180) and the factory (objective_function.cpp:11-33).
The other objectives raise from ``config.check_port_supported`` (ROADMAP
A2). Each objective exposes:

- ``gradients(score[K, N], label[N], weight[N] | None) -> (g[K, N], h[K, N])``
  on whatever device the tensors live on, f32 throughout,
- ``convert_output(raw)`` — the sigmoid for binary,
- host-side ``init(metadata, num_data)`` and ``boost_from_average_score()``
  (gbdt.cpp:357-377).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .utils.log import Log


def _apply_weight(g, h, weight):
    if weight is None:
        return g, h
    return g * weight, h * weight


class Objective:
    """Base objective (reference: include/LightGBM/objective_function.h)."""

    name = "custom"
    num_models = 1
    is_constant_hessian = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data

    def gradients(self, score: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def boost_from_average_score(self) -> Optional[float]:
        """Init score when boost_from_average applies; None otherwise."""
        return None

    def _weighted_label_mean(self, metadata: Metadata) -> float:
        label = metadata.label.astype(np.float64)
        if metadata.weight is not None:
            w = metadata.weight.astype(np.float64)
            return float((label * w).sum() / w.sum())
        return float(label.mean())


class RegressionL2(Objective):
    """regression / l2 / mse (regression_objective.hpp:13-75)."""
    name = "regression"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.is_constant_hessian = metadata.weight is None
        self._avg = self._weighted_label_mean(metadata)

    def gradients(self, score, label, weight):
        g = score - label[None, :]
        h = torch.ones_like(g)
        return _apply_weight(g, h, weight)

    def boost_from_average_score(self):
        return self._avg


class BinaryLogloss(Objective):
    """binary (binary_objective.hpp:13-180)."""
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        if config.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      config.sigmoid)
        if config.is_unbalance and abs(config.scale_pos_weight - 1.0) > 1e-6:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time.")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        cnt_pos = int((metadata.label > 0).sum())
        cnt_neg = num_data - cnt_pos
        self.need_train = True
        if cnt_pos == 0 or cnt_neg == 0:
            Log.warning("Only contain one class.")
            self.need_train = False
        Log.info("Number of positive: %d, number of negative: %d",
                 cnt_pos, cnt_neg)
        w_neg, w_pos = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        self.label_weights = (w_neg, w_pos)

    def gradients(self, score, label, weight):
        sig = self.config.sigmoid
        is_pos = label > 0
        one = torch.ones((), dtype=score.dtype, device=score.device)
        y = torch.where(is_pos, one, -one)
        lw = torch.where(
            is_pos, torch.tensor(self.label_weights[1], dtype=score.dtype,
                                 device=score.device),
            torch.tensor(self.label_weights[0], dtype=score.dtype,
                         device=score.device))
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        abs_resp = torch.abs(response)
        g = response * lw
        h = abs_resp * (sig - abs_resp) * lw
        if not self.need_train:
            g = torch.zeros_like(g)
            h = torch.zeros_like(h)
        return _apply_weight(g, h, weight)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid * raw))


DEFAULT_LABEL_GAIN_SIZE = 31


def default_label_gain() -> List[float]:
    """2^i - 1 (reference: config.cpp label_gain default); read by the
    NDCG metric of the copied ``metrics.py``."""
    return [float((1 << i) - 1) for i in range(DEFAULT_LABEL_GAIN_SIZE)]


OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "l2": "regression", "l2_root": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "mean_absolute_error": "regression_l1",
    "l1": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "xentropy", "cross_entropy": "xentropy",
    "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    "lambdarank": "lambdarank",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_OBJECTIVE_CLASSES = {
    "regression": RegressionL2,
    "binary": BinaryLogloss,
}


def create_objective(config: Config) -> Optional[Objective]:
    """Factory (reference: objective_function.cpp:11-33). Objectives the
    port has not reached raise, naming their ROADMAP item."""
    name = OBJECTIVE_ALIASES.get(config.objective)
    if name is None:
        Log.fatal("Unknown objective type name: %s", config.objective)
    if name == "none":
        return None
    if name not in _OBJECTIVE_CLASSES:
        Log.fatal("objective=%s is not ported to lightgbm_tpu_torch yet "
                  "(ROADMAP A2)", config.objective)
    return _OBJECTIVE_CLASSES[name](config)
