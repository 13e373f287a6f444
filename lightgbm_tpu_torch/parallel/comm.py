"""Tree-learner communication strategies: the serial one.

Port of ``lightgbm_tpu/parallel/comm.py:79-229`` (``BlockMeta``,
``block_per_feature`` / ``find_block_splits`` with the categorical merge,
unbundled and bundled, ``SerialComm``). The grower reaches histogram
reduction, scalar reduction and split search only through a strategy
object, as in the JAX package, so the data-, feature- and voting-parallel
strategies on ``torch.distributed`` can plug in later (ROADMAP A16)
without touching the grower.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..ops.categorical import per_feature_best_categorical
from ..ops.split_finder import (PerFeatureBest, SplitCandidates,
                                per_feature_best_bundled,
                                per_feature_best_numerical, reduce_features,
                                unpack_bundled_hist)


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
    # inner indices of the categorical features (None: there are none)
    cat_idx: Optional[torch.Tensor] = None


def block_per_feature(hist, pg, ph, pc, bm: BlockMeta, spec, bundle=None):
    """Best split per (slot, feature) over this block: the numerical scan
    for numerical features, the one-hot / sorted-prefix scan for
    categorical ones, merged per feature (reference FindBestThreshold
    dispatch, feature_histogram.hpp:72-104; parallel/comm.py:93-143 there).
    Returns ``(PerFeatureBest, cat_mask [S, F, B] or None)``.

    With ``bundle`` (``grower.BundleDecode``) ``hist`` is bundle space
    ``[S, G, Bb, 3]``: the numerical scan runs on it directly, and the
    categorical features are unpacked from their own bundle columns only,
    scanned in their own bins and put back at their feature index."""
    if bundle is not None:
        pf = per_feature_best_bundled(
            hist, pg, ph, pc, bm.num_bins, bm.missing_code, bm.default_bin,
            bm.feature_ok & ~bm.is_cat, bundle.col, bundle.lo, bundle.hi,
            bundle.off, bundle.code_feat, **spec.hyperparams())
        ci = bm.cat_idx
        if ci is None:
            return pf, None
        hist_c = unpack_bundled_hist(
            hist, bundle.col[ci], bundle.unpack_bin[ci], pg, ph, pc,
            bm.default_bin[ci])                         # [S, Fc, B, 3]
        B = spec.num_bins_padded
    else:
        pf = per_feature_best_numerical(
            hist, pg, ph, pc, bm.num_bins, bm.missing_code, bm.default_bin,
            bm.feature_ok & ~bm.is_cat, **spec.hyperparams())
        ci = bm.cat_idx
        if ci is None:
            return pf, None
        # the scan is per feature: run it on the categorical columns only
        hist_c = hist[:, ci]
        B = hist.shape[2]
    pf_cat, mask_c = per_feature_best_categorical(
        hist_c, pg, ph, pc, bm.num_bins[ci], bm.missing_code[ci],
        (bm.feature_ok & bm.is_cat)[ci], **spec.hyperparams(),
        **spec.cat_hyperparams())
    merged = PerFeatureBest(*[nv.index_copy(1, ci, cv)
                              for nv, cv in zip(pf, pf_cat)])
    S, F = pf.gain.shape
    mask = torch.zeros((S, F, B), dtype=torch.bool, device=hist.device)
    mask[:, ci] = mask_c
    return merged, mask


def find_block_splits(hist, pg, ph, pc, bm: BlockMeta, spec, bundle=None
                      ) -> SplitCandidates:
    """Best split per slot over this block's features (feature argmax, the
    lowest feature index on a tie). The candidates' left sets stay in the
    features' own bins under EFB too (parallel/comm.py:146-156 there)."""
    pf, mask = block_per_feature(hist, pg, ph, pc, bm, spec, bundle)
    if mask is None:
        nb_pad = spec.num_bins_padded if bundle is not None \
            else hist.shape[2]
        return reduce_features(pf, bm.offset, num_bins_padded=nb_pad)
    return reduce_features(pf, bm.offset, is_cat=bm.is_cat, cat_mask=mask)


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
                   is_cat, cat_idx=None) -> BlockMeta:
        return BlockMeta(feature_ok, num_bins, missing_code, default_bin,
                         is_cat, 0, cat_idx)

    def find_splits(self, hist, pg, ph, pc, bm: BlockMeta, spec,
                    bundle=None) -> SplitCandidates:
        return find_block_splits(hist, pg, ph, pc, bm, spec, bundle)
