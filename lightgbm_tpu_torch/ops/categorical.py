"""Categorical best-split search over histograms, on the device.

Port of ``lightgbm_tpu/ops/categorical.py:37-203`` (reference
FeatureHistogram::FindBestThresholdCategorical,
src/treelearner/feature_histogram.hpp:104-259). Two modes, chosen per
feature by ``num_bin <= max_cat_to_onehot``:

- **one-hot**: every category is a candidate singleton left set;
- **sorted prefix**: categories with count >= ``cat_smooth`` are sorted by
  ``sum_g / (sum_h + cat_smooth)`` (a stable sort, as ``jnp.argsort``);
  candidate left sets are prefixes of that order from both ends (dir=+1
  from the smallest ratio, dir=-1 from the largest), at most
  ``min(max_cat_threshold, (used + 1) / 2)`` categories, with ``cat_l2``
  added to ``lambda_l2``; ``min_data_per_group`` gates evaluation on the
  count gathered since the last evaluated prefix (:185-210).

The JAX package runs that last rule as a ``lax.scan`` over the prefix
positions. Here every quantity that does not depend on the rule (prefix
sums, gains, the ``continue`` and ``break`` predicates, and ``broke`` as a
running OR of them) is computed for all positions at once, and the one true
recurrence (the count since the last evaluation, reset on each evaluation)
becomes a chain of jumps: from "last evaluated before position s" the next
evaluation is the first eligible ``i >= s`` whose count since ``s`` reaches
``min_data_per_group``; the chain is followed by pointer doubling in
``ceil(log2(n_scan))`` steps instead of ``n_scan`` sequential ones. The
count since ``s`` is a difference of prefix sums, equal to the scan's
running sum because counts are whole numbers below 2^24 (row counts of a
leaf).

The winning left set comes back as a boolean mask over bins per (slot,
feature), the device form of the reference's ``cat_threshold`` bitset
(tree.h:257-284); the grower routes rows by it and the host finalize turns
it into raw-category bitsets.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .split_finder import PerFeatureBest, leaf_split_gain, prefix_sums

NEG_INF = float("-inf")
K_EPS = 1e-15                     # kEpsilon (reference meta.h)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[..., idx]`` along the last axis with a per-(slot, feature) index
    ``idx`` of shape ``a.shape[:-1] + (n,)``."""
    return torch.gather(a, -1, idx)


def _eval_positions(elig: torch.Tensor, cnt: torch.Tensor,
                    min_data_per_group: float) -> torch.Tensor:
    """The prefix positions the scan evaluates, ``[..., P]`` bool.

    ``elig[..., i]``: position ``i`` may be evaluated (step in range, not
    broken, not skipped by ``continue``); ``cnt[..., i]``: the count of the
    category taken at ``i``. The scan adds ``cnt`` to a running count,
    evaluates an eligible position once that count reaches
    ``min_data_per_group`` and then resets it to 0."""
    P = elig.shape[-1]
    dev = elig.device
    cum = torch.cumsum(cnt, dim=-1)                                  # C[i]
    zero = torch.zeros(cum.shape[:-1] + (1,), dtype=cum.dtype, device=dev)
    start = torch.cat([zero, cum], dim=-1)          # count before state s
    pos = torch.arange(P, device=dev)
    state = torch.arange(P + 1, device=dev)
    # from state s (last evaluation at s - 1; s = 0: none yet) position i
    # is next if i >= s, eligible, and the count since s is enough
    reach = (elig[..., None, :] & (pos[None, :] >= state[:, None])
             & (cum[..., None, :] - start[..., :, None]
                >= min_data_per_group))                      # [..., P+1, P]
    found = reach.any(dim=-1)
    first = torch.argmax(reach.to(torch.uint8), dim=-1)
    end = P + 1                                      # absorbing: no more
    nxt = torch.where(found, first + 1, end)                   # [..., P+1]
    nxt = torch.cat([nxt, torch.full(nxt.shape[:-1] + (1,), end,
                                     dtype=nxt.dtype, device=dev)], dim=-1)
    # states f^1(0) .. f^(2^k)(0) by doubling: visited holds the chain so
    # far, jump the map applied 2^k times
    visited = nxt[..., :1]
    jump = nxt
    while visited.shape[-1] < P:
        visited = torch.cat([visited, _take(jump, visited)], dim=-1)
        jump = _take(jump, jump)
    hit = torch.zeros(nxt.shape, dtype=torch.bool, device=dev)
    hit.scatter_(-1, visited, True)
    return hit[..., 1:P + 1]                     # state i + 1 <=> position i


def per_feature_best_categorical(
    hist: torch.Tensor,           # [S, F, B, 3] (sum_g, sum_h, count)
    parent_g: torch.Tensor,       # [S]
    parent_h: torch.Tensor,       # [S]
    parent_c: torch.Tensor,       # [S]
    num_bins: torch.Tensor,       # [F] i32
    missing_code: torch.Tensor,   # [F] i32 (0=none, 1=zero, 2=nan)
    cat_ok: torch.Tensor,         # [F] bool: categorical & usable this tree
    *,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: float,
    min_sum_hessian_in_leaf: float,
    min_gain_to_split: float,
    cat_smooth: float,
    cat_l2: float,
    max_cat_threshold: int,
    max_cat_to_onehot: int,
    min_data_per_group: float,
) -> Tuple[PerFeatureBest, torch.Tensor]:
    """Best categorical split per (slot, feature) and its left-set mask
    ``[S, F, B]``; gains are shifted by the parent gain + min_gain_to_split
    (``-inf``: no valid split)."""
    S, F, B, _ = hist.shape
    dev = hist.device
    f32 = torch.float32
    neg_inf = torch.full((), NEG_INF, dtype=f32, device=dev)
    g = hist[..., 0]
    h = hist[..., 1]
    c = hist[..., 2]
    bins = torch.arange(B, device=dev)[None, None, :]                # [1,1,B]
    # used_bin = num_bin - 1 + (missing_type == None): the trailing bin is
    # the NaN / overflow bin unless the feature is fully categorical
    used_bin = num_bins.long() - (missing_code != 0).long()          # [F]
    in_range = bins < used_bin[None, :, None]                        # [1,F,B]

    mdl = min_data_in_leaf
    msh = min_sum_hessian_in_leaf
    l1 = lambda_l1
    pg = parent_g[:, None, None]
    ph = parent_h[:, None, None]
    pc = parent_c[:, None, None]
    min_gain_shift = (leaf_split_gain(parent_g, parent_h, l1, lambda_l2)
                      + min_gain_to_split)                           # [S]

    # ---------------- one-hot mode (:122-155) ------------------------------
    oh_lh = h + K_EPS
    oh_rg, oh_rh, oh_rc = pg - g, ph - oh_lh, pc - c
    oh_ok = (in_range & (c >= mdl) & (oh_rc >= mdl)
             & (h >= msh) & (oh_rh >= msh))
    oh_gain = (leaf_split_gain(g, oh_lh, l1, lambda_l2)
               + leaf_split_gain(oh_rg, oh_rh, l1, lambda_l2))
    oh_gain = torch.where(oh_ok, oh_gain, neg_inf)                   # [S,F,B]
    oh_best = torch.argmax(oh_gain, dim=2)                           # [S,F]
    oh_best_gain = _take(oh_gain, oh_best[..., None])[..., 0]

    # ---------------- sorted-prefix mode (:156-231) ------------------------
    l2s = lambda_l2 + cat_l2
    valid = in_range & (c >= cat_smooth)                             # [S,F,B]
    ctr = g / (h + cat_smooth)
    sort_key = torch.where(valid, ctr, torch.full((), float("inf"),
                                                  dtype=f32, device=dev))
    order = torch.argsort(sort_key, dim=2, stable=True)              # [S,F,B]
    rank = torch.empty_like(order).scatter_(
        2, order, bins.expand(S, F, B).contiguous())     # bin -> position
    vmask = _take(valid, order).to(f32)
    sc = _take(c, order) * vmask
    cum_g = prefix_sums(_take(g, order) * vmask)
    cum_h = prefix_sums(_take(h, order) * vmask)
    cum_c = prefix_sums(sc)
    used_cnt = valid.sum(dim=2)                                      # [S,F]
    max_num_cat = torch.clamp((used_cnt + 1) // 2, max=max_cat_threshold)

    n_scan = max(1, min(int(max_cat_threshold), B))
    i = torch.arange(n_scan, device=dev)                             # [P]
    uc = used_cnt[..., None]
    # left sums after taking i + 1 categories; dir 0 = +1, dir 1 = -1
    j = torch.clamp(uc - 2 - i, -1, B - 1)                           # [S,F,P]
    j0 = torch.clamp(j, min=0)

    def both(cum):
        tot = cum[..., -1:]
        rev = tot - torch.where(j < 0, torch.zeros((), dtype=f32, device=dev),
                                _take(cum, j0))
        return torch.stack([cum[..., :n_scan], rev])                 # [2,S,F,P]

    lg, lh, lc = both(cum_g), both(cum_h), both(cum_c)
    jj = torch.clamp(uc - 1 - i, 0, B - 1)
    cnt = torch.stack([sc[..., :n_scan], _take(sc, jj)])            # [2,S,F,P]
    lh_eps = lh + K_EPS
    step_ok = (i < max_num_cat[..., None]) & (i < uc)               # [S,F,P]
    pg4, ph4, pc4 = pg[None], ph[None], pc[None]
    cont1 = (lc < mdl) | (lh_eps < msh)                              # :195-196
    rc = pc4 - lc
    rh = ph4 - lh_eps
    brk = (~cont1) & ((rc < mdl) | (rc < min_data_per_group)         # :198-201
                      | (rh < msh))
    broke = torch.cumsum((step_ok[None] & brk).to(torch.int32), dim=-1) > 0
    elig = step_ok[None] & ~broke & ~cont1
    evaluated = _eval_positions(elig, cnt, min_data_per_group)       # :205-207
    gain_i = (leaf_split_gain(lg, lh_eps, l1, l2s)
              + leaf_split_gain(pg4 - lg, ph4 - lh_eps, l1, l2s))
    better = evaluated & (gain_i > min_gain_shift[None, :, None, None])
    cand = torch.where(better, gain_i, neg_inf)
    # the scan keeps the first position of the largest gain (strict >)
    sp_k = torch.argmax(cand, dim=-1)                                # [2,S,F]
    sp_gain = _take(cand, sp_k[..., None])[..., 0]

    # pick direction (dir=+1 wins ties: argmax picks the first)
    sp_dir = torch.argmax(sp_gain, dim=0)                            # [S,F]
    sp_best_gain = torch.gather(sp_gain, 0, sp_dir[None])[0]
    sp_best_k = torch.gather(sp_k, 0, sp_dir[None])[0]               # [S,F]

    # ---------------- merge modes + build outputs --------------------------
    use_onehot = (num_bins <= max_cat_to_onehot)[None, :]            # [1,F]
    raw_gain = torch.where(use_onehot, oh_best_gain, sp_best_gain)
    shift = min_gain_shift[:, None]
    gain = torch.where(cat_ok[None, :] & (raw_gain > shift),
                       raw_gain - shift, neg_inf)                    # [S,F]

    oh_mask = bins == oh_best[..., None]                             # [S,F,B]
    is_fwd = sp_dir == 0
    sp_mask = torch.where(
        is_fwd[..., None], rank <= sp_best_k[..., None],
        rank >= (used_cnt - 1 - sp_best_k)[..., None]) & valid
    mask = torch.where(use_onehot[..., None], oh_mask, sp_mask)
    mask = mask & (gain > NEG_INF)[..., None]

    # left sums of the winner
    kb = torch.clamp(sp_best_k, 0, B - 1)[..., None]
    jb = torch.clamp(used_cnt - 2 - sp_best_k, -1, B - 1)[..., None]

    def sp_left(cum):
        fwd_v = _take(cum, kb)[..., 0]
        rev_v = cum[..., -1] - torch.where(
            jb < 0, torch.zeros((), dtype=f32, device=dev),
            _take(cum, torch.clamp(jb, min=0)))[..., 0]
        return torch.where(is_fwd, fwd_v, rev_v)

    ob = oh_best[..., None]
    left = [torch.where(use_onehot, _take(a, ob)[..., 0], sp_left(cum))
            for a, cum in ((g, cum_g), (h, cum_h), (c, cum_c))]
    pf = PerFeatureBest(
        gain=gain,
        threshold=torch.zeros((S, F), dtype=torch.int32, device=dev),
        default_left=torch.zeros((S, F), dtype=torch.bool, device=dev),
        left_g=left[0], left_h=left[1], left_c=left[2])
    return pf, mask
