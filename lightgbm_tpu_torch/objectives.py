"""Objective functions: score -> (gradient, hessian) as torch tensor math.

Port of ``lightgbm_tpu/objectives.py`` (reference src/objective/*.hpp and
the factory objective_function.cpp:11-33): L2, L1, Huber, Fair, Poisson,
binary, multiclass softmax and one-vs-all, cross-entropy (plain and
lambda) and lambdarank. Each objective exposes:

- ``gradients(score[K, N], label[N], weight[N] | None) -> (g[K, N], h[K, N])``
  on whatever device the tensors live on, f32 throughout,
- ``convert_output(raw)`` — sigmoid / softmax / exp transform,
- host-side ``init(metadata, num_data)`` (label checks, class counts, the
  query structure) and ``boost_from_average_score()`` (gbdt.cpp:357-377).

Lambdarank runs the JAX package's formulation: queries padded to
power-of-two lengths and processed as batched ``[Q, M, M]`` pair matrices,
here in chunks of at most ``QUERY_CHUNK_BUDGET`` pair elements (a budget
sized for the card's memory, not the TPU's); the chunking does not change
the per-query arithmetic.
"""
from __future__ import annotations

import math
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


def _gaussian_hessian(score, label, grad, eta, weight=None):
    """ApproximateHessianWithGaussian (utils/common.h:486-495)."""
    w = 1.0 if weight is None else weight
    diff = score - label
    x = torch.abs(diff)
    a = 2.0 * torch.abs(grad) * w
    c = torch.clamp((torch.abs(score) + torch.abs(label)) * eta, min=1.0e-10)
    return w * torch.exp(-x * x / (2.0 * c * c)) * a / (
        c * math.sqrt(2.0 * math.pi))


def _full(like, value):
    return torch.full((), value, dtype=like.dtype, device=like.device)


class RegressionL1(Objective):
    """regression_l1 / mae (regression_objective.hpp:80-147)."""
    name = "regression_l1"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._avg = self._weighted_label_mean(metadata)

    def gradients(self, score, label, weight):
        label = label[None, :]
        diff = score - label
        sign = torch.where(diff >= 0.0, _full(diff, 1.0), _full(diff, -1.0))
        g = sign if weight is None else sign * weight
        h = _gaussian_hessian(score, label, g, self.config.gaussian_eta,
                              weight)
        return g, h

    def boost_from_average_score(self):
        return self._avg


class RegressionHuber(Objective):
    """huber (regression_objective.hpp:151-233)."""
    name = "huber"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._avg = self._weighted_label_mean(metadata)

    def gradients(self, score, label, weight):
        label = label[None, :]
        delta = self.config.huber_delta
        diff = score - label
        inner = torch.abs(diff) <= delta
        g_out = torch.where(diff >= 0.0, _full(diff, delta),
                            _full(diff, -delta))
        eta = self.config.gaussian_eta
        if weight is not None:
            g = torch.where(inner, diff * weight, g_out * weight)
            h = torch.where(inner, weight.expand_as(diff),
                            _gaussian_hessian(score, label, g_out * weight,
                                              eta, weight))
        else:
            g = torch.where(inner, diff, g_out)
            h = torch.where(inner, _full(diff, 1.0),
                            _gaussian_hessian(score, label, g_out, eta))
        return g, h

    def boost_from_average_score(self):
        return self._avg


class RegressionFair(Objective):
    """fair (regression_objective.hpp:237-297)."""
    name = "fair"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._avg = self._weighted_label_mean(metadata)

    def gradients(self, score, label, weight):
        c = self.config.fair_c
        x = score - label[None, :]
        g = c * x / (torch.abs(x) + c)
        h = c * c / (torch.abs(x) + c) ** 2
        return _apply_weight(g, h, weight)

    def boost_from_average_score(self):
        return self._avg


class RegressionPoisson(Objective):
    """poisson (regression_objective.hpp:301-399): the score is a log-rate."""
    name = "poisson"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        label = metadata.label
        if label.min() < 0.0:
            Log.fatal("[poisson]: at least one target label is negative.")
        if label.sum() == 0.0:
            Log.fatal("[poisson]: sum of labels is zero.")
        self._init_score = math.log(self._weighted_label_mean(metadata))

    def gradients(self, score, label, weight):
        ef = torch.exp(score)
        return _apply_weight(ef - label[None, :], ef, weight)

    def convert_output(self, raw):
        return torch.exp(raw)

    def boost_from_average_score(self):
        return self._init_score


class BinaryLogloss(Objective):
    """binary (binary_objective.hpp:13-180); with ``positive_class`` the
    one-vs-all sub-objective of class ``k`` (label == k is positive)."""
    name = "binary"

    def __init__(self, config: Config, positive_class: Optional[int] = None):
        super().__init__(config)
        if config.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      config.sigmoid)
        if config.is_unbalance and abs(config.scale_pos_weight - 1.0) > 1e-6:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time.")
        self.positive_class = positive_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.positive_class is not None:
            pos = metadata.label.astype(np.int32) == self.positive_class
        else:
            pos = metadata.label > 0
        cnt_pos = int(pos.sum())
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
        if self.positive_class is not None:
            is_pos = label.to(torch.int32) == self.positive_class
        else:
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


class MulticlassSoftmax(Objective):
    """multiclass softmax (multiclass_objective.hpp:16-140)."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_models = config.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        li = metadata.label.astype(np.int64)
        if li.min() < 0 or li.max() >= self.num_models:
            Log.fatal("Label must be in [0, %d), but found %d in label",
                      self.num_models,
                      int(li.min() if li.min() < 0 else li.max()))

    def gradients(self, score, label, weight):
        p = _softmax0(score)                                  # [K, N]
        classes = torch.arange(self.num_models, dtype=torch.int32,
                               device=score.device)
        onehot = label.to(torch.int32)[None, :] == classes[:, None]
        g = p - onehot.to(p.dtype)
        h = 2.0 * p * (1.0 - p)
        return _apply_weight(g, h, weight)

    def convert_output(self, raw):
        return _softmax0(raw)


def _softmax0(x):
    """Softmax over the class axis, in ``jax.nn.softmax``'s steps."""
    e = torch.exp(x - x.max(dim=0, keepdim=True).values)
    return e / e.sum(dim=0, keepdim=True)


class MulticlassOVA(Objective):
    """multiclassova (multiclass_objective.hpp:139+): K independent binary
    objectives, class ``k`` positive in the ``k``-th."""
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_models = config.num_class
        self.subs = [BinaryLogloss(config, positive_class=k)
                     for k in range(self.num_models)]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        for sub in self.subs:
            sub.init(metadata, num_data)

    def gradients(self, score, label, weight):
        parts = [sub.gradients(score[k:k + 1], label, weight)
                 for k, sub in enumerate(self.subs)]
        return (torch.cat([g for g, _ in parts], dim=0),
                torch.cat([h for _, h in parts], dim=0))

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.config.sigmoid * raw))


class CrossEntropy(Objective):
    """xentropy (xentropy_objective.hpp:39-137): labels in [0, 1]."""
    name = "xentropy"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        label = metadata.label
        if label.min() < 0.0 or label.max() > 1.0:
            Log.fatal("[xentropy]: label must be in [0, 1]")
        if metadata.weight is not None:
            if metadata.weight.min() < 0.0:
                Log.fatal("[xentropy]: at least one weight is negative.")
            if metadata.weight.sum() == 0.0:
                Log.fatal("[xentropy]: sum of weights is zero.")
        pavg = min(max(self._weighted_label_mean(metadata), 1e-15),
                   1.0 - 1e-15)
        self._init_score = math.log(pavg / (1.0 - pavg))

    def gradients(self, score, label, weight):
        z = torch.sigmoid(score)
        return _apply_weight(z - label[None, :], z * (1.0 - z), weight)

    def convert_output(self, raw):
        return torch.sigmoid(raw)

    def boost_from_average_score(self):
        return self._init_score


class CrossEntropyLambda(Objective):
    """xentlambda (xentropy_objective.hpp:143-260)."""
    name = "xentlambda"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        label = metadata.label
        if label.min() < 0.0 or label.max() > 1.0:
            Log.fatal("[xentlambda]: label must be in [0, 1]")
        if metadata.weight is not None and metadata.weight.min() <= 0.0:
            Log.fatal("[xentlambda]: at least one weight is non-positive.")
        havg = float(label.astype(np.float64).sum()) / num_data
        self._init_score = math.log(max(math.expm1(havg), 1e-15))

    def gradients(self, score, label, weight):
        label = label[None, :]
        if weight is None:
            z = torch.sigmoid(score)
            return z - label, z * (1.0 - z)
        w = weight
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        g = (1.0 - label / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        h = a * (1.0 + label * b)
        return g, h

    def convert_output(self, raw):
        return torch.log1p(torch.exp(raw))

    def boost_from_average_score(self):
        return self._init_score


# ---------------------------------------------------------------------------
# lambdarank
# ---------------------------------------------------------------------------

DEFAULT_LABEL_GAIN_SIZE = 31


def default_label_gain() -> List[float]:
    """2^i - 1 (reference: config.cpp label_gain default); read by
    lambdarank and by the NDCG metric of the copied ``metrics.py``."""
    return [float((1 << i) - 1) for i in range(DEFAULT_LABEL_GAIN_SIZE)]


class LambdarankNDCG(Objective):
    """lambdarank (rank_objective.hpp:19-208), in the JAX package's
    formulation (``lightgbm_tpu/objectives.py:388-571``): queries padded to
    power-of-two lengths (at least 8) and bucketed by that length; each
    bucket's queries go through the reference's per-query double loop
    (rank_objective.hpp:113-160) as batched ``[Q, M, M]`` pair matrices
    with the sigmoid computed directly; ``pos_of_row`` maps the bucket
    layout back to row order with one gather. The pre-partitioned layout
    hook of the JAX package (``set_row_layout``) belongs to the
    multi-device learners (ROADMAP A16) and is not here."""
    name = "lambdarank"

    # pair elements per chunk: 2^26 f32 is 256 MB per [Q, M, M] tensor,
    # about ten of which are alive at once; the JAX package's 2^22 is
    # sized for a TPU core's memory and would cost ~16x the launches
    QUERY_CHUNK_BUDGET = 1 << 26

    def __init__(self, config: Config):
        super().__init__(config)
        if config.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero",
                      config.sigmoid)
        gains = config.label_gain or default_label_gain()
        self.label_gain = np.asarray(gains, dtype=np.float64)
        self.optimize_pos_at = config.max_position
        self._dev = None

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("Lambdarank tasks require query information")
        qb = metadata.query_boundaries.astype(np.int64)
        label = metadata.label.astype(np.int64)
        if label.min() < 0 or label.max() >= len(self.label_gain):
            Log.fatal("Label (%d) excceed the max label gain size",
                      int(label.max()))
        self.num_queries = len(qb) - 1
        sizes = np.diff(qb)
        # inverse max DCG at optimize_pos_at per query (dcg_calculator.cpp)
        inv_max_dcg = np.zeros(self.num_queries, dtype=np.float64)
        gains = self.label_gain
        for q in range(self.num_queries):
            ls = np.sort(label[qb[q]:qb[q + 1]])[::-1][: self.optimize_pos_at]
            dcg = float((gains[ls] / np.log2(np.arange(len(ls)) + 2.0)).sum())
            inv_max_dcg[q] = 1.0 / dcg if dcg > 0.0 else 0.0

        # bucket queries by padded length: 8, 16, ... up to the longest
        max_m = int(sizes.max()) if len(sizes) else 1
        lengths = [8]
        while lengths[-1] < max_m:
            lengths.append(lengths[-1] * 2)
        self.buckets = []
        pos_of_row = np.zeros(num_data, dtype=np.int64)
        base = 0
        for m in lengths:
            lo = m // 2 if m > lengths[0] else 0
            qsel = np.nonzero((sizes <= m) & (sizes > lo))[0]
            if len(qsel) == 0:
                continue
            doc_idx = np.full((len(qsel), m), num_data, dtype=np.int64)
            for r, q in enumerate(qsel):
                n = int(sizes[q])
                doc_idx[r, :n] = np.arange(qb[q], qb[q + 1])
                pos_of_row[qb[q]:qb[q + 1]] = base + r * m + np.arange(n)
            self.buckets.append({"doc_idx": doc_idx,
                                 "inv_max_dcg": inv_max_dcg[qsel]
                                 .astype(np.float32),
                                 "m": m})
            base += doc_idx.size
        self.total_slots = base
        self.pos_of_row = pos_of_row
        self._dev = None

    def _device_arrays(self, device):
        """The bucket layout as tensors on ``device``, made once."""
        if self._dev is None or self._dev[0] != device:
            buckets = [(b["m"],
                        torch.as_tensor(b["doc_idx"], device=device),
                        torch.as_tensor(b["doc_idx"] < self.num_data,
                                        device=device),
                        torch.as_tensor(b["inv_max_dcg"], device=device))
                       for b in self.buckets]
            self._dev = (device, buckets,
                         torch.as_tensor(self.pos_of_row, device=device),
                         torch.as_tensor(self.label_gain,
                                         dtype=torch.float32, device=device))
        return self._dev[1:]

    def _query_grads(self, s, l, mask, inv_max_dcg, label_gain):
        """A batch of padded queries: s, l, mask ``[Q, M]``, inv_max_dcg
        ``[Q]``; returns (g, h) ``[Q, M]`` in document order. The JAX
        package's ``_query_grads`` over a leading query axis."""
        Q, M = s.shape
        dev = s.device
        sig = self.config.sigmoid
        f32 = torch.float32
        s_m = torch.where(mask, s, torch.full((), -1e30, dtype=f32,
                                              device=dev))
        # jnp.argsort is stable: equal scores keep document order (every
        # query is one long tie at iteration 0)
        order = torch.argsort(-s_m, dim=1, stable=True)
        s_s = torch.gather(s_m, 1, order)
        valid_s = torch.gather(mask, 1, order)
        l_s = torch.where(valid_s, torch.gather(l, 1, order),
                          torch.zeros((), dtype=l.dtype, device=dev)
                          ).to(torch.int32)
        gain = label_gain[l_s.long()]
        disc = 1.0 / torch.log2(torch.arange(M, dtype=f32, device=dev) + 2.0)
        n_valid = valid_s.sum(dim=1)
        best = s_s[:, 0]
        worst = torch.gather(s_s, 1, torch.clamp(n_valid - 1, min=0)[:, None]
                             )[:, 0]
        ds = s_s[:, :, None] - s_s[:, None, :]          # high=i, low=j
        pair_ok = ((l_s[:, :, None] > l_s[:, None, :])
                   & valid_s[:, :, None] & valid_s[:, None, :])
        dcg_gap = gain[:, :, None] - gain[:, None, :]
        paired_disc = torch.abs(disc[:, None] - disc[None, :])
        delta_ndcg = dcg_gap * paired_disc * inv_max_dcg[:, None, None]
        delta_ndcg = torch.where((best != worst)[:, None, None],
                                 delta_ndcg / (0.01 + torch.abs(ds)),
                                 delta_ndcg)
        p_lambda = 2.0 / (1.0 + torch.exp(2.0 * sig * ds))
        p_hess = p_lambda * (2.0 - p_lambda)
        zero = torch.zeros((), dtype=f32, device=dev)
        lam = torch.where(pair_ok, -p_lambda * delta_ndcg, zero)
        hes = torch.where(pair_ok, 2.0 * p_hess * delta_ndcg, zero)
        g_sorted = lam.sum(dim=2) - lam.sum(dim=1)
        h_sorted = hes.sum(dim=2) + hes.sum(dim=1)
        # back to document order (``.at[order].set``: order is a permutation)
        g = torch.empty_like(g_sorted).scatter_(1, order, g_sorted)
        h = torch.empty_like(h_sorted).scatter_(1, order, h_sorted)
        return g, h

    def gradients(self, score, label, weight):
        n = self.num_data
        buckets, pos_of_row, label_gain = self._device_arrays(score.device)
        # one appended zero row: the padding documents read it
        s_ext = torch.cat([score[0, :n], score.new_zeros(1)])
        l_ext = torch.cat([label[:n], label.new_zeros(1)])
        g_parts, h_parts = [], []
        for m, doc_idx, mask, imd in buckets:
            chunk_q = max(1, self.QUERY_CHUNK_BUDGET // (m * m))
            for lo in range(0, doc_idx.shape[0], chunk_q):
                di = doc_idx[lo:lo + chunk_q]
                g, h = self._query_grads(s_ext[di], l_ext[di],
                                         mask[lo:lo + chunk_q],
                                         imd[lo:lo + chunk_q], label_gain)
                g_parts.append(g.reshape(-1))
                h_parts.append(h.reshape(-1))
        g = torch.cat(g_parts)[pos_of_row][None, :]
        h = torch.cat(h_parts)[pos_of_row][None, :]
        return _apply_weight(g, h, weight)


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
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(config: Config) -> Optional[Objective]:
    """Factory (reference: objective_function.cpp:11-33)."""
    name = OBJECTIVE_ALIASES.get(config.objective)
    if name is None:
        Log.fatal("Unknown objective type name: %s", config.objective)
    if name == "none":
        return None
    return _OBJECTIVE_CLASSES[name](config)
