"""Tree-learner communication strategies: the serial one.

Port of ``lightgbm_tpu/parallel/comm.py:79-229`` (``BlockMeta``,
``find_block_splits``, ``SerialComm``). The grower reaches histogram
reduction, scalar reduction and split search only through a strategy
object, as in the JAX package, so the data-, feature- and voting-parallel
strategies on ``torch.distributed`` can plug in later (ROADMAP A16)
without touching the grower.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.split_finder import (SplitCandidates, per_feature_best_numerical,
                                reduce_features)


class BlockMeta(NamedTuple):
    """Per-feature metadata of the feature block this device scans; arrays
    are ``[F_block]`` and ``offset`` maps a local feature index to its
    global one."""
    feature_ok: torch.Tensor
    num_bins: torch.Tensor
    missing_code: torch.Tensor
    default_bin: torch.Tensor
    is_cat: torch.Tensor
    offset: int


def find_block_splits(hist, pg, ph, pc, bm: BlockMeta, spec
                      ) -> SplitCandidates:
    """Best split per slot over this block's (numerical) features."""
    pf = per_feature_best_numerical(
        hist, pg, ph, pc, bm.num_bins, bm.missing_code, bm.default_bin,
        bm.feature_ok & ~bm.is_cat, **spec.hyperparams())
    return reduce_features(pf, bm.offset, num_bins_padded=hist.shape[2])


@dataclass(frozen=True)
class SerialComm:
    """Single-device no-op strategy (reference SerialTreeLearner)."""
    num_features: int = 0

    def reduce_scalars(self, *xs):
        return xs

    def hist_X(self, X):
        """The columns this device histograms (all of them)."""
        return X

    def reduce_hist(self, hist):
        """[S, F_hist, B, 3] partial -> global sums (identity here)."""
        return hist

    def reduced_hist_features(self, F_hist: int) -> int:
        return F_hist

    def block_meta(self, feature_ok, num_bins, missing_code, default_bin,
                   is_cat) -> BlockMeta:
        return BlockMeta(feature_ok, num_bins, missing_code, default_bin,
                         is_cat, 0)

    def find_splits(self, hist, pg, ph, pc, bm: BlockMeta, spec
                    ) -> SplitCandidates:
        return find_block_splits(hist, pg, ph, pc, bm, spec)
