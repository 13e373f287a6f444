"""GOSS: Gradient-based One-Side Sampling (reference: src/boosting/goss.hpp);
port of ``lightgbm_tpu/boosting/goss.py``.

Keeps the top ``top_rate`` share of rows by sum-over-models |g*h|
(goss.hpp:88-98) — exactly ``top_k`` rows, the lower row index first among
equal weights, as ``lax.top_k`` — Bernoulli-samples ``other_rate`` of the
rest from the iteration's bagging key and scales their gradients and
hessians by ``(N - top_k) / other_k`` (goss.hpp:100-126). Sampling starts
after ``int(1 / learning_rate)`` iterations (goss.hpp:134-137). Mask-based:
rows left out get weight 0.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..utils import prng
from ..utils.log import Log
from .gbdt import GBDT


class GOSS(GBDT):
    # as the JAX package (goss.py:24 there): a batch of iterations falls
    # back to one at a time
    supports_tree_batch = False

    def __init__(self, config: Config, train_set):
        super().__init__(config, train_set)
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        Log.info("Using GOSS")
        self.bagging_on = False

    def _sampling(self, g, h, bag_mask, key, it: int):
        cfg = self.config
        N = self.num_data
        if it < int(1.0 / cfg.learning_rate):
            return self.pad_mask, g, h
        top_k = max(1, int(N * cfg.top_rate))
        other_k = max(1, int(N * cfg.other_rate))
        f32 = dict(dtype=torch.float32, device=self.device)
        weights = torch.sum(torch.abs(g * h), dim=0) * self.pad_mask
        if self._row_sharded:
            # the top-k is over the world's rows: gather every block's
            # weights, choose, keep this rank's block
            weights = self._gather_rows(weights)
        is_top = torch.zeros(weights.shape[0], dtype=torch.bool,
                             device=self.device)
        is_top[prng.top_k_indices(weights, top_k)] = True
        if self._row_sharded:
            is_top = self._local_rows(is_top)
        is_top &= self.pad_mask > 0
        rest = ~is_top & (self.pad_mask > 0)
        prob = torch.tensor(other_k / max(N - top_k, 1), **f32)
        sel_other = rest & (prng.uniform(key, self.num_rows, self.device,
                                         offset=self._row0) < prob)
        mask = (is_top | sel_other).to(torch.float32)
        scale = torch.where(sel_other, torch.tensor((N - top_k) / other_k,
                                                    **f32),
                            torch.tensor(1.0, **f32))[None, :]
        return mask, g * scale, h * scale
