"""Vectorised best-split search over histograms, numerical half.

Port of ``lightgbm_tpu/ops/split_finder.py:85-211,470-516``
(reference FeatureHistogram::FindBestThreshold,
src/treelearner/feature_histogram.hpp:72-101,314-455): the reference's two
sequential scans per feature become masked cumulative sums over the bin
axis, evaluated for every (slot, feature, threshold, direction) at once,
then one argmax. Semantics kept exactly, tie-breaks included:

- gain = GetLeafSplitGain(l) + GetLeafSplitGain(r) with L1 thresholding,
  valid iff gain > parent_gain + min_gain_to_split (:101,362);
- MissingType::NaN — the NaN bin (last) is left out of the accumulating
  side, so missing rows follow the scan direction's remainder: the reverse
  scan sends them left (default_left), the forward scan right;
- MissingType::Zero — the zero bin is left out likewise and its threshold
  skipped (skip_default_bin);
- features with num_bin <= 2 or MissingType::None scan the reverse
  direction only, with the 2-bin NaN default-direction fix (:96-98);
- ties: reverse before forward, then the lowest threshold, then the lowest
  feature (``torch.argmax`` returns the first maximal index).

Categorical and bundle-space scans are not in this slice (ROADMAP A9,
A11); ``SplitCandidates`` keeps their fields so the tree arrays match the
JAX package's layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")


class SplitCandidates(NamedTuple):
    """Best split per slot (all ``[S]`` unless noted)."""
    gain: torch.Tensor          # f32, improvement over parent (-inf if none)
    feature: torch.Tensor       # i32 inner feature index
    threshold: torch.Tensor     # i32 bin threshold (left: bin <= threshold)
    default_left: torch.Tensor  # bool
    left_g: torch.Tensor        # f32 sum of gradients in the left child
    left_h: torch.Tensor        # f32
    left_c: torch.Tensor        # f32 row count in the left child
    is_cat: torch.Tensor        # bool: categorical split (always False here)
    cat_mask: torch.Tensor      # bool [S, B]: categorical left set


class PerFeatureBest(NamedTuple):
    """Best split per (slot, feature); all ``[S, F]``."""
    gain: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor


def leaf_split_gain(sum_g, sum_h, l1: float, l2: float):
    """(|g|-l1)_+^2 / (h+l2) — feature_histogram.hpp:290-296."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return reg * reg / (sum_h + l2)


def leaf_output(sum_g, sum_h, l1: float, l2: float):
    """-sign(g)(|g|-l1)_+ / (h+l2) — feature_histogram.hpp:304-310; a zero
    denominator or a non-finite result gives 0."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    denom = sum_h + l2
    out = -torch.sign(sum_g) * reg / denom
    return torch.where((denom > 0) & torch.isfinite(out), out,
                       torch.zeros_like(out))


def per_feature_best_numerical(
    hist: torch.Tensor,          # [S, F, B, 3] (sum_g, sum_h, count)
    parent_g: torch.Tensor,      # [S]
    parent_h: torch.Tensor,      # [S]
    parent_c: torch.Tensor,      # [S]
    num_bins: torch.Tensor,      # [F] i32
    missing_code: torch.Tensor,  # [F] i32: 0=none, 1=zero, 2=nan
    default_bin: torch.Tensor,   # [F] i32
    feature_ok: torch.Tensor,    # [F] bool
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: float,
    min_sum_hessian_in_leaf: float,
    min_gain_to_split: float,
) -> PerFeatureBest:
    """Best numerical threshold for every (slot, feature) pair; gains are
    already shifted by the parent gain + min_gain_to_split, so a finite
    value means a valid improvement."""
    S, F, B, _ = hist.shape
    dev = hist.device
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    g = hist[..., 0]
    h = hist[..., 1]
    c = hist[..., 2]
    bins = torch.arange(B, dtype=torch.int32, device=dev)[None, :]   # [1, B]
    nb = num_bins[:, None]                                           # [F, 1]
    db = default_bin[:, None]
    valid_bin = bins < nb                                            # [F, B]

    is_nan = missing_code[:, None] == 2
    is_zero = missing_code[:, None] == 1
    full_mode = (num_bins > 2) & (missing_code != 0)                 # [F]

    excl_full = (is_nan & (bins == nb - 1)) | (is_zero & (bins == db))
    excl = (excl_full & full_mode[:, None]) | ~valid_bin             # [F, B]
    inc = (~excl).to(torch.float32)[None, :, :]                      # [1, F, B]

    cum_g = torch.cumsum(g * inc, dim=2)
    cum_h = torch.cumsum(h * inc, dim=2)
    cum_c = torch.cumsum(c * inc, dim=2)
    tot_g = cum_g[..., -1:]
    tot_h = cum_h[..., -1:]
    tot_c = cum_c[..., -1:]
    pg = parent_g[:, None, None]
    ph = parent_h[:, None, None]
    pc = parent_c[:, None, None]

    def child_gains(lg, lh, lc, rg, rh, rc):
        ok = ((lc >= min_data_in_leaf) & (rc >= min_data_in_leaf)
              & (lh >= min_sum_hessian_in_leaf)
              & (rh >= min_sum_hessian_in_leaf))
        gains = (leaf_split_gain(lg, lh, lambda_l1, lambda_l2)
                 + leaf_split_gain(rg, rh, lambda_l1, lambda_l2))
        return torch.where(ok, gains, neg_inf)

    # forward scan (dir=+1): left = included bins <= t, missing -> right
    fwd_lg, fwd_lh, fwd_lc = cum_g, cum_h, cum_c
    fwd_rg, fwd_rh, fwd_rc = pg - fwd_lg, ph - fwd_lh, pc - fwd_lc
    fwd_thr_ok = (full_mode[:, None] & (bins <= nb - 2)
                  & ~(is_zero & (bins == db)))                       # skip_default_bin
    # a NaN-type forward scan over a leaf with no NaN rows splits exactly
    # as the reverse scan at the same threshold; exact arithmetic makes the
    # two gains equal and the reverse scan wins that tie, so the forward
    # candidates are dropped there instead of letting f32 rounding decide
    nan_rows = torch.gather(
        c, 2, (num_bins.long() - 1).clamp(min=0)[None, :, None]
        .expand(S, F, 1))[..., 0]                                    # [S, F]
    fwd_live = ~is_nan[None, :, 0] | (nan_rows > 0)                  # [S, F]
    fwd_thr_ok = fwd_thr_ok[None] & fwd_live[..., None]
    fwd_gain = torch.where(fwd_thr_ok,
                           child_gains(fwd_lg, fwd_lh, fwd_lc,
                                       fwd_rg, fwd_rh, fwd_rc), neg_inf)

    # reverse scan (dir=-1): right = included bins > t, missing -> left
    rev_rg, rev_rh, rev_rc = tot_g - cum_g, tot_h - cum_h, tot_c - cum_c
    rev_lg, rev_lh, rev_lc = pg - rev_rg, ph - rev_rh, pc - rev_rc
    rev_max_thr = torch.where(full_mode & (missing_code == 2),
                              num_bins - 3, num_bins - 2)
    rev_thr_ok = ((bins <= rev_max_thr[:, None]) & (bins >= 0)
                  & ~(full_mode[:, None] & is_zero & (bins == db - 1)))
    rev_gain = torch.where(rev_thr_ok[None],
                           child_gains(rev_lg, rev_lh, rev_lc,
                                       rev_rg, rev_rh, rev_rc), neg_inf)

    # default direction: reverse sends missing left, except the 2-bin NaN
    # fix (feature_histogram.hpp:96-98)
    rev_default_left = ~(~full_mode & (missing_code == 2))           # [F]

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    feature_gate = torch.where(feature_ok[None, :, None], zero, neg_inf)
    parent_gain_shift = (leaf_split_gain(parent_g, parent_h, lambda_l1,
                                         lambda_l2)
                         + min_gain_to_split)[:, None, None]
    rev_gain = rev_gain + feature_gate
    fwd_gain = fwd_gain + feature_gate
    rev_gain = torch.where(rev_gain > parent_gain_shift,
                           rev_gain - parent_gain_shift, neg_inf)
    fwd_gain = torch.where(fwd_gain > parent_gain_shift,
                           fwd_gain - parent_gain_shift, neg_inf)

    # best over (direction, threshold); reverse first mirrors the
    # reference's dir=-1-then-dir=+1 strict-improvement order (:89-93)
    flat = torch.cat([rev_gain, fwd_gain], dim=2)                    # [S, F, 2B]
    best_idx = torch.argmax(flat, dim=2)                             # [S, F]
    best_gain = torch.gather(flat, 2, best_idx[..., None])[..., 0]
    is_rev = best_idx < B
    t_idx = (best_idx % B)

    def pick(rev_arr, fwd_arr):
        r = torch.gather(rev_arr, 2, t_idx[..., None])[..., 0]
        f = torch.gather(fwd_arr, 2, t_idx[..., None])[..., 0]
        return torch.where(is_rev, r, f)

    return PerFeatureBest(
        gain=best_gain,
        threshold=t_idx.to(torch.int32),
        default_left=is_rev & rev_default_left[None, :],
        left_g=pick(rev_lg, fwd_lg),
        left_h=pick(rev_lh, fwd_lh),
        left_c=pick(rev_lc, fwd_lc),
    )


def reduce_features(pf: PerFeatureBest, feature_offset: int = 0,
                    num_bins_padded: int = 0) -> SplitCandidates:
    """Argmax over the feature axis -> one candidate per slot (the lowest
    feature index wins a tie)."""
    S, F = pf.gain.shape
    dev = pf.gain.device
    f_idx = torch.argmax(pf.gain, dim=1)                             # [S]
    srange = torch.arange(S, device=dev)

    def gather(arr):
        return arr[srange, f_idx]

    B = num_bins_padded or 1
    return SplitCandidates(
        gain=gather(pf.gain),
        feature=(f_idx + feature_offset).to(torch.int32),
        threshold=gather(pf.threshold).to(torch.int32),
        default_left=gather(pf.default_left),
        left_g=gather(pf.left_g),
        left_h=gather(pf.left_h),
        left_c=gather(pf.left_c),
        is_cat=torch.zeros(S, dtype=torch.bool, device=dev),
        cat_mask=torch.zeros((S, B), dtype=torch.bool, device=dev),
    )


def find_best_splits_numerical(
    hist, parent_g, parent_h, parent_c, num_bins, missing_code, default_bin,
    feature_ok, **kwargs,
) -> SplitCandidates:
    """Single-shard numerical best split per slot."""
    pf = per_feature_best_numerical(
        hist, parent_g, parent_h, parent_c, num_bins, missing_code,
        default_bin, feature_ok, **kwargs)
    return reduce_features(pf, num_bins_padded=hist.shape[2])
