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

The categorical scan is ``ops/categorical.py``; ``reduce_features``
carries its left sets to the winner. Under EFB the numerical scan runs on
bundle space (``per_feature_best_bundled``, split_finder.py:243-468 there)
and only the categorical members are unpacked (``unpack_bundled_hist``).
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
    is_cat: torch.Tensor        # bool: categorical split
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


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums over the bin axis, added in f64: the card's
    ``cumsum`` adds in a tree order and the CPU's in a row, so f32 sums
    would round apart and a split whose gain is 0 in exact arithmetic (a
    leaf whose rows share one g/h ratio) could come out above 0 on one and
    below on the other. In f64 the sums of at most a few thousand f32 bins
    are exact whenever their magnitudes lie within 2^29 of each other, and
    the f32 result is then the same on both, and equal to f32 addition on
    exact-arithmetic (quantised) histograms."""
    return torch.cumsum(x.double(), dim=-1).float()


def per_feature_best_numerical(
    hist: torch.Tensor,          # [S, F, B, 3] (sum_g, sum_h, count)
    parent_g: torch.Tensor,      # [S] (or [S, F])
    parent_h: torch.Tensor,      # [S] (or [S, F])
    parent_c: torch.Tensor,      # [S] (or [S, F])
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
    value means a valid improvement. Parent sums ``[S, F]`` give every
    column its own parent: the voting learner scans each slot's selected
    columns as the columns of one slot (``parallel/comm.py``)."""
    S, F, B, _ = hist.shape
    dev = hist.device
    neg_inf = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
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

    cum_g = prefix_sums(g * inc)
    cum_h = prefix_sums(h * inc)
    cum_c = prefix_sums(c * inc)
    tot_g = cum_g[..., -1:]
    tot_h = cum_h[..., -1:]
    tot_c = cum_c[..., -1:]
    def per_slot(x):                 # [S] or [S, F] -> broadcast on bins
        return x[..., None] if x.dim() == 2 else x[:, None, None]
    pg, ph, pc = per_slot(parent_g), per_slot(parent_h), per_slot(parent_c)

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
    parent_gain_shift = per_slot(leaf_split_gain(parent_g, parent_h,
                                                 lambda_l1, lambda_l2)
                                 + min_gain_to_split)
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


def unpack_bundled_hist(hist_g: torch.Tensor, col: torch.Tensor,
                        unpack_bin: torch.Tensor, pg: torch.Tensor,
                        ph: torch.Tensor, pc: torch.Tensor,
                        default_bin: torch.Tensor) -> torch.Tensor:
    """EFB unpack (split_finder.py:214-236 there): ``[T, G, Bb, 3]``
    bundle-space histograms of the features ``col`` / ``unpack_bin`` ``[Fs,
    B]`` name -> ``[T, Fs, B, 3]`` in their own bins, each default bin
    rebuilt from the leaf totals by subtraction (reference
    Dataset::FixHistogram, dataset.cpp:750-769). The member sums are added
    in f64 and the default bin rounded once, as in :func:`prefix_sums`."""
    T = hist_g.shape[0]
    Fs, B = unpack_bin.shape
    h = hist_g[:, col.long()]                                    # [T, Fs, Bb, 3]
    idx = unpack_bin.clamp(min=0).long()[None, :, :, None].expand(T, Fs, B, 3)
    hf = torch.gather(h, 2, idx)                                 # [T, Fs, B, 3]
    hf = torch.where((unpack_bin >= 0)[None, :, :, None], hf,
                     torch.zeros((), dtype=hf.dtype, device=hf.device))
    totals = torch.stack([pg, ph, pc], dim=-1).double()          # [T, 3]
    deficit = (totals[:, None, :] - hf.double().sum(dim=2)).float()
    rows = torch.arange(Fs, device=hf.device)
    hf[:, rows, default_bin.long()] += deficit
    return hf


_BIG_T = 2 ** 30            # threshold sentinel of the min-reduction


def per_feature_best_bundled(
    hist: torch.Tensor,          # [T, G, Bb, 3] bundle space
    parent_g: torch.Tensor,      # [T]
    parent_h: torch.Tensor,      # [T]
    parent_c: torch.Tensor,      # [T]
    num_bins: torch.Tensor,      # [F] i32 (original features)
    missing_code: torch.Tensor,  # [F] i32: 0=none, 1=zero, 2=nan
    default_bin: torch.Tensor,   # [F] i32
    feature_ok: torch.Tensor,    # [F] bool
    col: torch.Tensor,           # [F] i32 bundled column of feature f
    lo: torch.Tensor,            # [F] i32 first code of f's range
    hi: torch.Tensor,            # [F] i32 one past its last code
    off: torch.Tensor,           # [F] i32 orig_bin = code - off in [lo, hi)
    code_feat: torch.Tensor,     # [G, Bb] i32 owner of each code, -1 none
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: float,
    min_sum_hessian_in_leaf: float,
    min_gain_to_split: float,
) -> PerFeatureBest:
    """Best numerical threshold per (slot, original feature) without
    leaving bundle space (the JAX package's ``per_feature_best_bundled``,
    split_finder.py:243-468; the reference finds splits on FeatureGroup
    bins and rebuilds only the shared default bin, dataset.cpp:750-769).

    One cumulative sum runs along each bundled column's codes; a member's
    prefix sum at its code ``c`` is ``CC[c] - CC[lo - 1]``, and its default
    bin (which has no code) holds ``parent - (CC[hi - 1] - CC[lo - 1])`` and
    joins every prefix from the default bin on. These sums are added in f64
    and rounded to f32 once (:func:`prefix_sums`, ROADMAP C11), so they are
    exact on exact-arithmetic histograms and do not depend on the device's
    addition order. The default-bin threshold, which has no code when the
    member's bin 0 is its default, is evaluated in a ``[T, F]`` side
    channel. Ties follow the feature-space scan: reverse beats forward on
    equal gain, the lowest threshold wins within a direction, and
    :func:`reduce_features` keeps the lowest original feature."""
    T, G, Bb, _ = hist.shape
    F = num_bins.shape[0]
    dev = hist.device
    neg_inf = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    iota_b = torch.arange(Bb, dtype=torch.int32, device=dev)[None, :]
    owned = code_feat >= 0
    cfs = torch.where(owned, code_feat, 0).long()                # safe index
    nb_c, mc_c, db_c = num_bins[cfs], missing_code[cfs], default_bin[cfs]
    t_c = iota_b - off[cfs]                                      # orig bin
    full_c = (nb_c > 2) & (mc_c != 0)
    # the NaN bin in full mode stays out of the accumulating side; the zero
    # bin never has a code (the owner rule drops off + db)
    excl_c = full_c & (((mc_c == 2) & (t_c == nb_c - 1))
                       | ((mc_c == 1) & (t_c == db_c)))
    h64 = hist.double()
    CCs = torch.cumsum(h64 * (owned & ~excl_c).double()[None, :, :, None],
                       dim=2)                        # scan-included mass
    CCu = torch.cumsum(h64 * owned.double()[None, :, :, None],
                       dim=2)                        # every owned code
    flatS = CCs.reshape(T, G * Bb, 3)
    flatU = CCu.reshape(T, G * Bb, 3)
    colL = col.long()

    def at_pos(flat, cpos):
        """CC at the per-feature code ``cpos`` ``[F]`` -> ``[T, F, 3]``; a
        position below 0 reads zero mass."""
        idx = colL * Bb + torch.clamp(cpos, 0, Bb - 1).long()
        v = flat[:, idx]
        return torch.where((cpos >= 0)[None, :, None], v,
                           torch.zeros((), dtype=v.dtype, device=dev))

    base_s = at_pos(flatS, lo - 1)                               # [T, F, 3]
    base_u = at_pos(flatU, lo - 1)
    member_u = at_pos(flatU, hi - 1) - base_u
    fullF = (num_bins > 2) & (missing_code != 0)
    dincF = ~(fullF & (missing_code == 1))
    totals = torch.stack([parent_g, parent_h, parent_c],
                         dim=-1).double()[:, None, :]            # [T, 1, 3]
    deficit = totals - member_u                                  # default bin
    def_inc = torch.where(dincF[None, :, None], deficit,
                          torch.zeros((), dtype=deficit.dtype, device=dev))
    tot_f64 = (at_pos(flatS, hi - 1) - base_s) + def_inc         # [T, F, 3]
    tot_f = tot_f64.float()

    def per_code(fv):
        """``[T, F, 3]`` per-feature values at the code positions."""
        return fv[:, cfs.reshape(-1)].reshape(T, G, Bb, 3)

    cum_c = ((CCs - per_code(base_s))
             + torch.where((t_c >= db_c)[None, :, :, None], per_code(def_inc),
                           torch.zeros((), dtype=torch.float64, device=dev))
             ).float()                                           # rounded once
    tot_c = per_code(tot_f)
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

    lg_c, lh_c, lc_c = cum_c[..., 0], cum_c[..., 1], cum_c[..., 2]
    # forward (dir=+1): left = included bins <= t, missing -> right. As in
    # the feature-space scan (ROADMAP C1), a NaN-type member's forward
    # candidates are dropped in a leaf without NaN rows, where they tie the
    # reverse scan's in exact arithmetic; its NaN bin is its last code
    nan_rows = hist[:, colL, torch.clamp(hi - 1, 0, Bb - 1).long(), 2]
    fwd_live = (missing_code != 2)[None, :] | (nan_rows > 0)     # [T, F]
    fwd_ok_c = (owned & full_c & (t_c <= nb_c - 2))[None] \
        & fwd_live[:, cfs.reshape(-1)].reshape(T, G, Bb)
    fwd_gain_c = torch.where(
        fwd_ok_c, child_gains(lg_c, lh_c, lc_c, pg - lg_c, ph - lh_c,
                                    pc - lc_c), neg_inf)
    # reverse (dir=-1): right = included bins > t, missing -> left
    rev_r = tot_c - cum_c
    rg_c, rh_c, rc_c = rev_r[..., 0], rev_r[..., 1], rev_r[..., 2]
    rev_max_c = torch.where(full_c & (mc_c == 2), nb_c - 3, nb_c - 2)
    rev_ok_c = (owned & (t_c <= rev_max_c) & (t_c >= 0)
                & ~(full_c & (mc_c == 1) & (t_c == db_c - 1)))
    rev_gain_c = torch.where(
        rev_ok_c[None], child_gains(pg - rg_c, ph - rh_c, pc - rc_c,
                                    rg_c, rh_c, rc_c), neg_inf)

    # per-feature reduction over the code grid: the largest gain, then the
    # lowest threshold reaching it (the flat argmax's first occurrence)
    idxF = torch.where(owned, code_feat, F).reshape(-1).long()   # [G*Bb]
    tflat = t_c.reshape(-1)

    def seg_best(gain_c):
        gflat = gain_c.reshape(T, G * Bb)
        mg = torch.full((T, F + 1), NEG_INF, dtype=torch.float32, device=dev)
        mg = mg.scatter_reduce(1, idxF[None, :].expand(T, -1), gflat,
                               reduce="amax")[:, :F]
        back = mg[:, cfs.reshape(-1)]                            # [T, G*Bb]
        tcand = torch.where((gflat == back) & torch.isfinite(gflat),
                            tflat[None, :], _BIG_T)
        bt = torch.full((T, F + 1), _BIG_T, dtype=torch.int32, device=dev)
        bt = bt.scatter_reduce(1, idxF[None, :].expand(T, -1), tcand,
                               reduce="amin")[:, :F]
        return mg, bt

    # the default-bin threshold ([T, F] side channel), from the same sums
    dbF = default_bin
    cum_db = ((at_pos(flatS, off + dbF) - base_s) + def_inc).float()
    lgd, lhd, lcd = cum_db[..., 0], cum_db[..., 1], cum_db[..., 2]
    pgF, phF, pcF = parent_g[:, None], parent_h[:, None], parent_c[:, None]
    fwd_db_ok = (fullF & (dbF <= num_bins - 2)
                 & (missing_code != 1))[None] & fwd_live
    fwd_db_gain = torch.where(
        fwd_db_ok, child_gains(lgd, lhd, lcd, pgF - lgd, phF - lhd,
                                     pcF - lcd), neg_inf)
    rev_maxF = torch.where(fullF & (missing_code == 2), num_bins - 3,
                           num_bins - 2)
    rev_db_ok = (dbF <= rev_maxF) & (dbF >= 0)
    rev_rd = tot_f - cum_db
    rgd, rhd, rcd = rev_rd[..., 0], rev_rd[..., 1], rev_rd[..., 2]
    rev_db_gain = torch.where(
        rev_db_ok[None], child_gains(pgF - rgd, phF - rhd, pcF - rcd,
                                     rgd, rhd, rcd), neg_inf)

    def combine(mg_bt, gdb):
        mg, bt = mg_bt
        use_db = (gdb > mg) | ((gdb == mg) & torch.isfinite(gdb)
                               & (dbF[None, :] < bt))
        return (torch.where(use_db, gdb, mg),
                torch.where(use_db, dbF[None, :].expand_as(bt), bt))

    rev_g, rev_t = combine(seg_best(rev_gain_c), rev_db_gain)
    fwd_g, fwd_t = combine(seg_best(fwd_gain_c), fwd_db_gain)
    use_rev = rev_g >= fwd_g                     # reverse first on ties
    best_g = torch.where(use_rev, rev_g, fwd_g)
    best_t = torch.where(use_rev, rev_t, fwd_t).to(torch.int32)
    best_t = torch.where(torch.isfinite(best_g), best_t,
                         torch.zeros_like(best_t))

    # the winner's left sums, rebuilt from the same sums the gains used
    p_win = off[None, :] + best_t                                # [T, F]
    idx_win = (colL[None, :] * Bb
               + torch.clamp(p_win, 0, Bb - 1).long())
    cw = torch.gather(flatS, 1, idx_win[:, :, None].expand(T, F, 3))
    cw = torch.where((p_win >= 0)[..., None], cw,
                     torch.zeros((), dtype=cw.dtype, device=dev))
    cum_w = ((cw - base_s)
             + torch.where((best_t >= dbF[None, :])[..., None], def_inc,
                           torch.zeros((), dtype=torch.float64, device=dev))
             ).float()
    tot32 = torch.stack([parent_g, parent_h, parent_c], dim=-1)[:, None, :]
    rev_l = tot32 - (tot_f - cum_w)              # parent - reverse right
    left = torch.where(use_rev[..., None], rev_l, cum_w)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    feature_gate = torch.where(feature_ok, zero, neg_inf)[None, :]
    parent_gain_shift = (leaf_split_gain(parent_g, parent_h, lambda_l1,
                                         lambda_l2)
                         + min_gain_to_split)[:, None]
    best_g = best_g + feature_gate
    best_g = torch.where(best_g > parent_gain_shift,
                         best_g - parent_gain_shift, neg_inf)
    rev_dl = ~(~fullF & (missing_code == 2))
    return PerFeatureBest(
        gain=best_g,
        threshold=best_t,
        default_left=use_rev & rev_dl[None, :],
        left_g=left[..., 0],
        left_h=left[..., 1],
        left_c=left[..., 2],
    )


def reduce_features(pf: PerFeatureBest, feature_offset: int = 0,
                    num_bins_padded: int = 0, is_cat=None,
                    cat_mask=None) -> SplitCandidates:
    """Argmax over the feature axis -> one candidate per slot (the lowest
    feature index wins a tie). ``is_cat`` ``[F]`` and ``cat_mask`` ``[S, F,
    B]`` carry the categorical left sets through to the winner."""
    S, F = pf.gain.shape
    dev = pf.gain.device
    f_idx = torch.argmax(pf.gain, dim=1)                             # [S]
    srange = torch.arange(S, device=dev)

    def gather(arr):
        return arr[srange, f_idx]

    if is_cat is None:
        B = num_bins_padded or 1
        win_cat = torch.zeros(S, dtype=torch.bool, device=dev)
        win_mask = torch.zeros((S, B), dtype=torch.bool, device=dev)
    else:
        win_cat = is_cat[f_idx]
        win_mask = cat_mask[srange, f_idx]                           # [S, B]
    return SplitCandidates(
        gain=gather(pf.gain),
        feature=(f_idx + feature_offset).to(torch.int32),
        threshold=gather(pf.threshold).to(torch.int32),
        default_left=gather(pf.default_left),
        left_g=gather(pf.left_g),
        left_h=gather(pf.left_h),
        left_c=gather(pf.left_c),
        is_cat=win_cat,
        cat_mask=win_mask,
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
