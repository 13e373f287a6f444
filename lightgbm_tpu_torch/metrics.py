"""Evaluation metrics — a host-numpy copy of ``lightgbm_tpu/metrics.py``.

Reference: src/metric/ factory metric.cpp:13-47 and the per-family headers.
Every metric here runs on the host over converted scores fetched from the
device, in f64, matching the reference's double accumulators. The port
keeps its own copy because importing the JAX package would pull in JAX.

Each metric returns a list of (name, value, is_higher_better).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .config import Config
from .dataset import Metadata
from .utils.log import Log

MetricResult = Tuple[str, float, bool]


def _xp(arr):
    """The array namespace of the loss bodies: numpy (host-only metrics)."""
    return np


def _wavg(loss: np.ndarray, weight: Optional[np.ndarray]) -> float:
    if weight is None:
        return float(loss.mean())
    return float((loss * weight).sum() / weight.sum())


class Metric:
    name = "metric"
    is_higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.num_data = num_data

    def eval(self, score: np.ndarray) -> List[MetricResult]:
        """`score` is [num_models, N] converted output (probabilities etc.)."""
        raise NotImplementedError


class _PointwiseRegressionMetric(Metric):
    def loss(self, s, y):
        raise NotImplementedError

    def transform(self, v: float) -> float:
        return v

    def eval(self, score):
        y = self.metadata.label.astype(np.float64)
        s = score[0].astype(np.float64)
        return [(self.name, self.transform(_wavg(self.loss(s, y), self.metadata.weight)),
                 self.is_higher_better)]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def loss(self, s, y):
        return (s - y) ** 2


class RMSEMetric(_PointwiseRegressionMetric):
    name = "rmse"

    def loss(self, s, y):
        return (s - y) ** 2

    def transform(self, v):
        return float(np.sqrt(v))


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"

    def loss(self, s, y):
        return _xp(s).abs(s - y)


class HuberLossMetric(_PointwiseRegressionMetric):
    name = "huber"

    def loss(self, s, y):
        xp = _xp(s)
        d = self.config.huber_delta
        diff = s - y
        return xp.where(xp.abs(diff) <= d, 0.5 * diff * diff,
                        d * (xp.abs(diff) - 0.5 * d))


class FairLossMetric(_PointwiseRegressionMetric):
    name = "fair"

    def loss(self, s, y):
        xp = _xp(s)
        c = self.config.fair_c
        x = xp.abs(s - y)
        return c * x - c * c * xp.log(1.0 + x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def loss(self, s, y):
        xp = _xp(s)
        eps = 1e-10
        return s - y * xp.log(xp.maximum(s, eps))


class BinaryLoglossMetric(_PointwiseRegressionMetric):
    name = "binary_logloss"

    def loss(self, p, y):
        xp = _xp(p)
        eps = 1e-15
        p = xp.clip(p, eps, 1.0 - eps)
        is_pos = y > 0
        return xp.where(is_pos, -xp.log(p), -xp.log(1.0 - p))


class BinaryErrorMetric(_PointwiseRegressionMetric):
    name = "binary_error"

    def loss(self, p, y):
        xp = _xp(p)
        is_pos = y > 0
        return xp.where(is_pos, p <= 0.5, p > 0.5).astype(xp.float64
            if xp is np else xp.float32)


class AUCMetric(Metric):
    """auc (binary_metric.hpp AUCMetric): weighted rank-sum."""
    name = "auc"
    is_higher_better = True

    def eval(self, score):
        y = (self.metadata.label > 0).astype(np.float64)
        s = score[0].astype(np.float64)
        w = self.metadata.weight
        w = np.ones_like(y) if w is None else w.astype(np.float64)
        order = np.argsort(-s, kind="mergesort")
        s, y, w = s[order], y[order], w[order]
        tp = np.cumsum(w * y)
        fp = np.cumsum(w * (1.0 - y))
        # ROC trapezoid over prediction-tie groups
        last_in_group = np.concatenate([s[1:] != s[:-1], [True]])
        tp_g = tp[last_in_group]
        fp_g = fp[last_in_group]
        if tp_g[-1] == 0 or fp_g[-1] == 0:
            return [(self.name, 1.0, True)]
        tp_prev = np.concatenate([[0.0], tp_g[:-1]])
        fp_prev = np.concatenate([[0.0], fp_g[:-1]])
        area = float(((fp_g - fp_prev) * (tp_g + tp_prev) / 2.0).sum())
        return [(self.name, area / (tp_g[-1] * fp_g[-1]), True)]


class NDCGMetric(Metric):
    """ndcg@k (rank_metric.hpp:16-120 + dcg_calculator.cpp)."""
    name = "ndcg"
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("The NDCG metric requires query information")
        from .objectives import default_label_gain
        gains = self.config.label_gain or default_label_gain()
        self.label_gain = np.asarray(gains, dtype=np.float64)
        self.eval_at = list(self.config.ndcg_eval_at)

    def eval(self, score):
        qb = self.metadata.query_boundaries
        label = self.metadata.label.astype(np.int64)
        s = score[0].astype(np.float64)
        qw = self.metadata.query_weights
        nq = len(qb) - 1
        sums = np.zeros(len(self.eval_at))
        sum_w = 0.0
        for q in range(nq):
            lo, hi = qb[q], qb[q + 1]
            w = 1.0 if qw is None else float(qw[q])
            sum_w += w
            ls = label[lo:hi]
            order = np.argsort(-s[lo:hi], kind="mergesort")
            ideal = np.sort(ls)[::-1]
            discounts = 1.0 / np.log2(np.arange(len(ls)) + 2.0)
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(ls))
                max_dcg = float((self.label_gain[ideal[:kk]] * discounts[:kk]).sum())
                if max_dcg <= 0.0:
                    sums[j] += w  # all-negative query counts as 1 (rank_metric.hpp:70-73,101)
                else:
                    dcg = float((self.label_gain[ls[order[:kk]]] * discounts[:kk]).sum())
                    sums[j] += w * dcg / max_dcg
        return [(f"ndcg@{k}", float(sums[j] / sum_w), True)
                for j, k in enumerate(self.eval_at)]


class MapMetric(Metric):
    """map@k (map_metric.hpp): mean average precision for binary relevance."""
    name = "map"
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("The MAP metric requires query information")
        self.eval_at = list(self.config.ndcg_eval_at)

    def eval(self, score):
        qb = self.metadata.query_boundaries
        label = (self.metadata.label > 0).astype(np.float64)
        s = score[0].astype(np.float64)
        qw = self.metadata.query_weights
        nq = len(qb) - 1
        sums = np.zeros(len(self.eval_at))
        sum_w = 0.0
        for q in range(nq):
            lo, hi = qb[q], qb[q + 1]
            w = 1.0 if qw is None else float(qw[q])
            sum_w += w
            ls = label[lo:hi]
            order = np.argsort(-s[lo:hi], kind="mergesort")
            rel = ls[order]
            hits = np.cumsum(rel)
            prec = hits / (np.arange(len(rel)) + 1.0)
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(rel))
                nrel = rel[:kk].sum()
                ap = float((prec[:kk] * rel[:kk]).sum() / nrel) if nrel > 0 else 0.0
                sums[j] += w * ap
        return [(f"map@{k}", float(sums[j] / sum_w), True)
                for j, k in enumerate(self.eval_at)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score):
        y = self.metadata.label.astype(np.int64)
        p = score[y, np.arange(len(y))].astype(np.float64)
        loss = -np.log(np.clip(p, 1e-15, None))
        return [(self.name, _wavg(loss, self.metadata.weight), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score):
        y = self.metadata.label.astype(np.int64)
        pred = score.argmax(axis=0)
        return [(self.name, _wavg((pred != y).astype(np.float64),
                                  self.metadata.weight), False)]


class CrossEntropyMetric(_PointwiseRegressionMetric):
    name = "xentropy"

    def loss(self, p, y):
        xp = _xp(p)
        eps = 1e-15
        p = xp.clip(p, eps, 1.0 - eps)
        return -y * xp.log(p) - (1.0 - y) * xp.log(1.0 - p)


class CrossEntropyLambdaMetric(Metric):
    """xentlambda (xentropy_metric.hpp): loss on the lambda parameterization."""
    name = "xentlambda"

    def eval(self, score):
        y = self.metadata.label.astype(np.float64)
        hhat = score[0].astype(np.float64)  # convert_output = log1p(exp(raw))
        z = 1.0 - np.exp(-hhat)
        z = np.clip(z, 1e-15, 1.0 - 1e-15)
        loss = -y * np.log(z) - (1.0 - y) * np.log(1.0 - z)
        return [(self.name, _wavg(loss, self.metadata.weight), False)]


class KLDivMetric(_PointwiseRegressionMetric):
    name = "kldiv"

    def loss(self, p, y):
        xp = _xp(p)
        eps = 1e-15
        p = xp.clip(p, eps, 1.0 - eps)
        yc = xp.clip(y, eps, 1.0 - eps)
        ey = xp.where((y > 0) & (y < 1),
                      y * xp.log(yc) + (1.0 - y) * xp.log(1.0 - yc), 0.0)
        return ey - (y * xp.log(p) + (1.0 - y) * xp.log(1.0 - p))


METRIC_FACTORY = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "l2_root": RMSEMetric, "root_mean_squared_error": RMSEMetric, "rmse": RMSEMetric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "huber": HuberLossMetric,
    "fair": FairLossMetric,
    "poisson": PoissonMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "xentropy": CrossEntropyMetric, "cross_entropy": CrossEntropyMetric,
    "xentlambda": CrossEntropyLambdaMetric, "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric, "kullback_leibler": KLDivMetric,
}

DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "binary": "binary_logloss", "lambdarank": "ndcg",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "xentropy": "xentropy", "xentlambda": "xentlambda",
}


def create_metrics(config: Config, objective_name: Optional[str]) -> List[Metric]:
    """Factory (metric.cpp:13-47) + default-metric-from-objective resolution."""
    names = list(config.metric)
    if not names:
        if objective_name and objective_name in DEFAULT_METRIC_FOR_OBJECTIVE:
            names = [DEFAULT_METRIC_FOR_OBJECTIVE[objective_name]]
    out = []
    for n in names:
        n = n.strip()
        if n in ("", "none", "null", "na", "custom"):
            continue
        cls = METRIC_FACTORY.get(n)
        if cls is None:
            Log.warning("Unknown metric type name: %s", n)
            continue
        out.append(cls(config))
    return out
