"""Plain reference of categorical splits, in PyTorch and NumPy (f64).

Written from LightGBM v2.0.10's definitions, not from the program. What is
not categorical it takes from ``gbdt.py`` (numerical bins, the numerical
scan, histograms, gradients, the wave rule), ``modeltext.py`` and
``walk.py``, and it edits none of them.

- bins (``bin.cpp:293-361``): a categorical column's categories in
  descending count (ties: the smaller id first); bins are kept while under
  99% of the rows are covered or there are fewer than ``min(categories,
  max_bin)`` of them, and a category of fewer than ``min_data_in_bin``
  rows past the second ends the list. Where categories are left over, the
  last kept bin also takes them, negative ids and NaN, and no split sends
  it left; where every category is kept, NaN and negative ids take a bin of
  their own after them, which no split sends left; where every category is
  kept and none is missing, every bin can go left. A numerical column keeps
  ``gbdt.Bins``' rule: a bin for each distinct value, NaN last.
- the search (``FindBestThresholdCategorical``,
  ``feature_histogram.hpp:104-259``), over the bins a split may send left:
  where ``num_bin <= max_cat_to_onehot``, each category alone on the left;
  otherwise the categories of at least ``cat_smooth`` rows, sorted by
  ``sum_g / (sum_h + cat_smooth)``, taken as prefixes from both ends (the
  smallest ratio first, then the largest) of up to ``min(max_cat_threshold,
  (used + 1) / 2)`` categories; a prefix is evaluated only once
  ``min_data_per_group`` rows have gathered since the last evaluated one,
  and the search of a direction ends where the right side falls below
  ``min_data_in_leaf``, ``min_data_per_group`` or the hessian floor. The
  sorted mode's children are scored at ``lambda_l2 + cat_l2``, the gain
  over the parent's term at ``lambda_l2``. It is written as the plain loop
  over prefix positions that LightGBM runs.
- a node's best allowed gain is the larger of the numerical scan's best
  (``gbdt.best_split`` over the numerical columns) and the categorical
  search's; in ``judge`` both count only splits that keep the hessian
  floor with ``gbdt.HESSIAN_MARGIN`` of it to spare, as ``gbdt.judge``
  does. The categorical loop itself runs at the stated floor: which
  prefixes it evaluates depends on the floor (a prefix below it adds its
  rows to the next one's ``min_data_per_group``), so a raised floor would
  evaluate other prefixes, not fewer. Where two neighbours of the sorted
  order have ratios that agree within ``RATIO_TIE`` of their own sums,
  the program's f32 sums may order them either way, and LightGBM's search
  is not continuous there: at the ``max_cat_threshold`` cap such a tie
  decides whether a large or a small category is the last one on the left
  (gains 10% apart on one node of ``expo.train``). ``judge``'s best
  allowed gain of such a column is the least best over the orders with one
  tied pair swapped.
- leaf outputs: the children of a split take ``-G / (H + l2)`` at the
  ``l2`` their split was scored at, ``lambda_l2 + cat_l2`` below a
  sorted-mode categorical split (its ``left_output`` / ``right_output``)
  and ``lambda_l2`` elsewhere, times the learning rate.
- the decision (``Tree::CategoricalDecision``, ``tree.h:257-284``): a row
  goes left where the bit of its raw category is set in the node's
  ``cat_threshold`` bitset, whose words the node's ``threshold`` indexes
  through ``cat_boundaries``; a negative id, NaN or a category past the
  bitset goes right. A bitset that holds a category of a bin no split may
  send left is a split the definitions do not allow: ``judge`` reads it as
  a ``split_gap`` of 1.

Departures from LightGBM:

- the bins come from the full rows' counts, where LightGBM counts a row
  sample (200,000 rows); the benchmark's data keeps the two on the same
  splittable set (``benchmark/tests/test_benchmark_expo.py``), and below
  200,000 rows the two are the same rows;
- a category 0 is refused: LightGBM keeps it out of the first bin by a
  swap the benchmark's ids (from 1) never need;
- the sorted mode sorts stably (``std::sort`` leaves the order of equal
  ratios open) and leaves out ``kEpsilon`` in the hessian sums;
- the control (:func:`grow` with a ``precision``) scans every column over
  its rounded bins cast to f32, the categorical search summing those f32
  values in f64.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import gbdt, modeltext
from .gbdt import (F64, HESSIAN_MARGIN, gradients, histogram, leaf_output,
                   ordered_pairs, waiting_gaps, wave_size)
from .modeltext import DEFAULT_LEFT, MISSING_NAN, _ints, parents

__all__ = ["Bins", "SplitRule", "judge", "grow", "parse", "leaves",
           "raw_scores", "gradients", "ordered_pairs", "wave_size",
           "HESSIAN_MARGIN"]

CATEGORICAL = 1                        # decision_type bit 0
NEG_INF = -math.inf
# the relative error of a category's g and h sums that the program's f32
# histograms (subtracted from their parents' down the tree) may carry, with
# room: ratios that agree within it may come in either order
RATIO_TIE = 1e-4


# ---------------------------------------------------------------- bins


class Bins(gbdt.Bins):
    """``gbdt.Bins`` with the ``categorical`` columns binned by LightGBM's
    categorical rule from the full rows' counts. Per categorical column
    ``f``: ``category[f]`` (i64, the raw category of each bin a split may
    send left, in bin order), ``num_bin[f]`` and ``shared[f]`` (the raw
    categories of the last bin where it is one no split may send left,
    else None). ``B`` covers every column's bins (a numerical column's NaN
    bin stays the last)."""

    def __init__(self, X: torch.Tensor, categorical: Sequence[int] = (),
                 max_bin: int = 255, min_data_in_bin: int = 3):
        n, F = X.shape
        self.is_cat = [f in set(categorical) for f in range(F)]
        self.levels: List[torch.Tensor] = []
        self.has_nan = []
        self.category: Dict[int, np.ndarray] = {}
        self.num_bin: Dict[int, int] = {}
        self.shared: Dict[int, Optional[np.ndarray]] = {}
        lookup = {}
        for f in range(F):
            col = X[:, f]
            nan = torch.isnan(col)
            self.has_nan.append(bool(nan.any()))
            if not self.is_cat[f]:
                self.levels.append(torch.unique(col[~nan]).double())
                continue
            self.levels.append(torch.zeros(0, dtype=F64, device=X.device))
            lookup[f] = self._categories(f, col, nan, max_bin,
                                         min_data_in_bin)
        num_levels = [len(u) for f, u in enumerate(self.levels)
                      if not self.is_cat[f]]
        self.B = max([m + 1 for m in num_levels]
                     + list(self.num_bin.values()))
        self.codes = torch.empty((n, F), dtype=torch.int16, device=X.device)
        for f in range(F):
            col = X[:, f]
            if self.is_cat[f]:
                table = lookup[f]
                v = torch.where(torch.isnan(col) | (col < 0), -1.0, col)
                v = torch.clamp(v.long(), max=table.shape[0] - 1)
                self.codes[:, f] = torch.where(
                    v >= 0, table[torch.clamp(v, min=0)],
                    self.num_bin[f] - 1).to(torch.int16)
                continue
            x = col.double()
            code = torch.searchsorted(self.levels[f], x)
            self.codes[:, f] = torch.where(torch.isnan(x), self.B - 1,
                                           code).to(torch.int16)

    def _categories(self, f: int, col: torch.Tensor, nan: torch.Tensor,
                    max_bin: int, min_data_in_bin: int) -> torch.Tensor:
        """LightGBM's categorical bins of one column; returns the device
        table of the bin of each id (past the kept ones: the last bin)."""
        neg = ~nan & (col < 0)
        ok = ~nan & ~neg
        ids = col[ok].long()
        if not torch.equal(ids.to(col.dtype), col[ok]):
            raise ValueError(f"column {f}: categories must be whole numbers")
        counts = torch.bincount(ids).cpu().numpy()
        cats = np.nonzero(counts)[0]
        if len(cats) and cats[0] == 0:
            raise ValueError(f"column {f}: category 0 is refused (ids from 1)")
        cnt = counts[cats]
        order = np.argsort(-cnt, kind="stable")     # ties: the smaller id
        cats, cnt = cats[order], cnt[order]
        na_cnt = int(nan.sum()) + int(neg.sum())
        total = int(col.shape[0])
        cut = int((total - na_cnt) * 0.99)
        keep_at_least = min(len(cats), max_bin)
        kept, used = 0, 0
        while kept < len(cats) and (used < cut or kept < keep_at_least):
            if cnt[kept] < min_data_in_bin and kept > 1:
                break
            used += int(cnt[kept])
            kept += 1
        if kept < len(cats):
            # the last kept bin takes the leftovers, negative ids and NaN
            self.num_bin[f] = kept
            self.category[f] = cats[:kept - 1]
            self.shared[f] = cats[kept - 1:]
        elif na_cnt:
            self.num_bin[f] = kept + 1                 # a NaN bin after them
            self.category[f] = cats
            self.shared[f] = np.zeros(0, np.int64)
        else:
            self.num_bin[f] = kept
            self.category[f] = cats
            self.shared[f] = None
        table = np.full(int(cats.max()) + 2 if len(cats) else 1,
                        self.num_bin[f] - 1, np.int64)
        table[cats[:kept]] = np.arange(kept)
        return torch.as_tensor(table, device=col.device)

    @property
    def numerical(self) -> List[int]:
        return [f for f, c in enumerate(self.is_cat) if not c]

    @property
    def cat_features(self) -> List[int]:
        return [f for f, c in enumerate(self.is_cat) if c]

    def used_bin(self, f: int) -> int:
        """The bins of categorical column ``f`` a split may send left."""
        return len(self.category[f])

    def cat_left_table(self, f: int, bitset: np.ndarray
                       ) -> Tuple[torch.Tensor, bool]:
        """``([B] bool: the bins a categorical split of column ``f`` with
        this bitset sends left, whether it names a category of a bin no
        split may send left)``."""
        table = np.zeros(self.B, dtype=bool)
        used = self.used_bin(f)
        table[:used] = in_bitset(bitset, self.category[f])
        shared = self.shared[f]
        bad = shared is not None and bool(in_bitset(bitset, shared).any())
        if bad:
            table[self.num_bin[f] - 1] = True
        return torch.as_tensor(table, device=self.codes.device), bad


def in_bitset(words: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Whether each value's bit is set in the 32-bit ``words``."""
    v = np.asarray(values, np.int64)
    inside = (v >= 0) & (v < 32 * len(words))
    w = np.asarray(words, np.int64)[np.clip(v >> 5, 0, max(len(words) - 1,
                                                           0))] \
        if len(words) else np.zeros(len(v), np.int64)
    return inside & (((w >> (v & 31)) & 1) == 1)


def bitset_of(values: Sequence[int]) -> np.ndarray:
    """The 32-bit words whose bits are ``values``."""
    values = [int(v) for v in values]
    words = np.zeros(max(values) // 32 + 1 if values else 1, np.int64)
    for v in values:
        words[v >> 5] |= 1 << (v & 31)
    return words


# ------------------------------------------------------------- the scan


class SplitRule(gbdt.SplitRule):
    """``gbdt.SplitRule`` with the categorical settings (LightGBM
    v2.0.10's defaults where the configuration gives none)."""

    def __init__(self, params: Dict):
        super().__init__(params)
        self.cat_smooth = float(params.get("cat_smooth", 10.0))
        self.cat_l2 = float(params.get("cat_l2", 10.0))
        self.max_cat_threshold = int(params.get("max_cat_threshold", 32))
        self.max_cat_to_onehot = int(params.get("max_cat_to_onehot", 4))
        self.min_data_per_group = float(params.get("min_data_per_group",
                                                   100))

    def child_l2(self, num_bin: int) -> float:
        """The ``l2`` the children of a categorical split are scored and
        valued at: ``lambda_l2 + cat_l2`` in the sorted mode."""
        return self.l2 if num_bin <= self.max_cat_to_onehot \
            else self.l2 + self.cat_l2


def _term(G: float, H: float, l1: float, l2: float) -> float:
    reg = max(abs(G) - l1, 0.0)
    return reg * reg / (H + l2)


def categorical_search(hist_f: np.ndarray, tot: Tuple[float, float, float],
                       rule: SplitRule, num_bin: int, used: int,
                       margin: float = 0.0, ties: Optional[Dict] = None):
    """LightGBM's categorical search of one column at one node: ``(gain
    over the parent, the bins sent left, the children's l2)``; gain
    ``-inf`` (and no bins) where no split is allowed. ``hist_f`` ``[B,
    3]`` f64; ``used`` bins may go left. The loop runs at the stated
    hessian floor (which prefixes it evaluates depends on the floor
    through ``min_data_per_group``); ``margin`` then counts an evaluated
    split only where both sides keep the floor raised by that share of
    it, and takes the least best over the orders that swap one pair of
    tied ratios (:func:`_tied_orders`). ``ties``, where given, gains
    ``pairs``, the tied pairs swapped, and ``plain``, the gain the sorted
    order alone gives."""
    G, H, C = tot
    min_h = rule.min_h
    keep_h = rule.min_h * (1.0 + margin)
    l1, l2 = rule.l1, rule.l2
    parent = _term(G, H, l1, l2)
    shift = parent + rule.min_gain
    g, h, c = hist_f[:used, 0], hist_f[:used, 1], hist_f[:used, 2]
    l2c = rule.child_l2(num_bin)
    best, best_bins = NEG_INF, None
    if num_bin <= rule.max_cat_to_onehot:
        for t in range(used):
            if c[t] < rule.min_data or h[t] < min_h or c[t] <= 0:
                continue
            if C - c[t] < rule.min_data or C - c[t] <= 0:
                continue
            if H - h[t] < min_h:
                continue
            gain = _term(g[t], h[t], l1, l2c) + _term(G - g[t], H - h[t],
                                                      l1, l2c)
            if gain > shift and gain > best and h[t] >= keep_h \
                    and H - h[t] >= keep_h:
                best, best_bins = gain, [t]
    else:
        cand = np.nonzero(c >= rule.cat_smooth)[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            # the control's rounded bins may cancel a denominator: +-inf
            ratio = g[cand] / (h[cand] + rule.cat_smooth)
        cand = cand[np.argsort(ratio, kind="stable")]
        max_num = min(rule.max_cat_threshold, (len(cand) + 1) // 2)

        def search(order):
            out, bins_ = NEG_INF, None
            for seq in (order, order[::-1]):
                sg = sh = sc = group = 0.0
                for i in range(min(len(seq), max_num)):
                    t = seq[i]
                    sg += g[t]
                    sh += h[t]
                    sc += c[t]
                    group += c[t]
                    if sc < rule.min_data or sh < min_h or sc <= 0:
                        continue
                    if C - sc < rule.min_data \
                            or C - sc < rule.min_data_per_group or C - sc <= 0:
                        break
                    if H - sh < min_h:
                        break
                    if group < rule.min_data_per_group:
                        continue
                    group = 0.0
                    gain = _term(sg, sh, l1, l2c) + _term(G - sg, H - sh, l1,
                                                          l2c)
                    if gain > shift and gain > out and sh >= keep_h \
                            and H - sh >= keep_h:
                        out, bins_ = gain, [int(b) for b in seq[:i + 1]]
            return out, bins_

        best, best_bins = search(cand)
        plain = best
        if margin > 0.0:
            # orders the program's rounding may give: the least best
            for order in _tied_orders(cand, g, h, rule.cat_smooth, max_num):
                alt, alt_bins = search(order)
                if ties is not None:
                    ties["pairs"] = ties.get("pairs", 0) + 1
                if alt < best:
                    best, best_bins = alt, alt_bins
        if ties is not None:
            ties["plain"] = plain - parent
    if best_bins is None:
        return NEG_INF, None, l2c
    return best - parent, np.asarray(best_bins, np.int64), l2c


def _tied_orders(order: np.ndarray, g: np.ndarray, h: np.ndarray,
                 cat_smooth: float, max_num: int):
    """The sorted order with one pair of neighbours swapped, for each pair
    within ``max_num + 1`` of either end whose ratios agree to within
    ``RATIO_TIE`` of their own sums (the prefixes beyond never count)."""
    n = len(order)
    den = h[order] + cat_smooth
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = g[order] / den
        tol = RATIO_TIE * (np.abs(g[order]) + np.abs(ratio) * h[order]) / den
    for k in range(n - 1):
        if min(k, n - 2 - k) > max_num:
            continue
        if abs(ratio[k + 1] - ratio[k]) <= tol[k] + tol[k + 1]:
            swapped = order.copy()
            swapped[k], swapped[k + 1] = order[k + 1], order[k]
            yield swapped


def node_best(bins: Bins, hist: torch.Tensor, tot: torch.Tensor,
              rule: SplitRule, margin: float = 0.0,
              ties: Optional[Dict] = None) -> Dict:
    """The best allowed split of a node over every column: ``gain``,
    ``feature`` and, numerical, ``k`` / ``nan_left`` (``gbdt.best_split``),
    or, categorical, the ``left`` bins and the children's ``l2``. ``ties``,
    where given, gains ``tied`` (a column had a tied pair within reach)
    and ``moved`` (the tie rule lowered the node's best gain)."""
    best = {"gain": NEG_INF}
    num = bins.numerical
    if num:
        gain, fi, k, nan_left = gbdt.best_split(hist[num], tot, rule, margin)
        best = {"gain": gain, "feature": num[fi], "cat": False, "k": k,
                "nan_left": nan_left, "l2": rule.l2}
    cat = bins.cat_features
    plain = best["gain"]
    pairs = 0
    if cat:
        h_cat = hist[cat].double().cpu().numpy()
        t = tuple(float(v) for v in tot)
        for j, f in enumerate(cat):
            col = {} if ties is not None else None
            gain, left, l2c = categorical_search(
                h_cat[j], t, rule, bins.num_bin[f], bins.used_bin(f), margin,
                col)
            if col:
                pairs += col.get("pairs", 0)
                plain = max(plain, col.get("plain", NEG_INF))
            if gain > best["gain"]:
                best = {"gain": gain, "feature": f, "cat": True,
                        "left": left, "l2": l2c}
    if ties is not None:
        ties["tied"] = pairs > 0
        ties["moved"] = best["gain"] < max(plain, best["gain"])
    return best


# ------------------------------------------------------------- judging


def _cat_bitset(tree: Dict, i: int) -> np.ndarray:
    idx = int(tree["threshold"][i])
    lo, hi = tree["cat_boundaries"][idx], tree["cat_boundaries"][idx + 1]
    return tree["cat_threshold"][lo:hi]


def _node_table(bins: Bins, tree: Dict, i: int, rule: SplitRule):
    """``(left table over bins, children's l2, names a bin no split may
    send left)`` of internal node ``i``."""
    f = int(tree["split_feature"][i])
    if int(tree["decision_type"][i]) & CATEGORICAL:
        table, bad = bins.cat_left_table(f, _cat_bitset(tree, i))
        return table, rule.child_l2(bins.num_bin[f]), bad
    return bins.left_table(f, float(tree["threshold"][i]),
                           int(tree["decision_type"][i])), rule.l2, False


def judge(tree: Dict, bins: Bins, g: torch.Tensor, h: torch.Tensor,
          rule: SplitRule, learning_rate: float, wave: int = 1,
          hessian_margin: float = HESSIAN_MARGIN) -> Dict:
    """``gbdt.judge`` over numerical and categorical splits: the same
    ``split_gap``, ``leaf_gap`` and ``count_mismatch``, with each node's
    best allowed gain the larger of the numerical and the categorical
    search's, a categorical split's rows routed by its bitset and its gain
    taken at its children's ``l2``, and each leaf's reference value at the
    ``l2`` of the split that made it. ``detail`` adds ``cat_nodes``, the
    tree's categorical splits, ``tie_nodes``, the judged nodes (splits and
    leaves) with a pair of tied ratios within reach of the cap, and
    ``tie_moved``, those whose best allowed gain the tie rule lowered."""
    n = g.shape[0]
    dev = g.device
    M = len(tree["split_feature"])
    L = tree["num_leaves"]
    root = torch.arange(n, device=dev)
    pending = {("n", 0) if M else ("l", 0): (root, histogram(bins, g, h,
                                                             root),
                                             rule.l2)}
    best_int = np.full(M, NEG_INF)
    loose_int = np.full(M, NEG_INF)
    tied = moved = 0                  # nodes with tied ratios; lowered
    broken = []                       # splits the definitions refuse
    taken = np.full(M, NEG_INF)
    best_leaf = np.full(L, NEG_INF)
    own_term = np.zeros(M)
    leaf_ref = np.zeros(L)
    mismatch = 0
    for i in range(M):
        rows, hist, _ = pending.pop(("n", i))
        tot = hist[0].sum(dim=0)
        if int(tree["internal_count"][i]) != rows.shape[0]:
            mismatch += 1
        f = int(tree["split_feature"][i])
        table, l2c, bad = _node_table(bins, tree, i, rule)
        ties = {}
        best_int[i] = node_best(bins, hist, tot, rule, hessian_margin,
                                ties)["gain"]
        tied, moved = tied + ties["tied"], moved + ties["moved"]
        loose_int[i] = node_best(bins, hist, tot, rule)["gain"]
        left_sum = (hist[f] * table[:, None]).sum(dim=0)
        right_sum = tot - left_sum
        taken[i] = (_term(float(left_sum[0]), float(left_sum[1]), rule.l1,
                          l2c)
                    + _term(float(right_sum[0]), float(right_sum[1]),
                            rule.l1, l2c)
                    - _term(float(tot[0]), float(tot[1]), rule.l1, rule.l2))
        own_term[i] = _term(float(tot[0]), float(tot[1]), rule.l1, rule.l2)
        if bad or not rule.allows(left_sum, tot, hessian_margin):
            broken.append(i)
        go_left = table[bins.codes[rows, f].long()]
        lr_rows = (rows[go_left], rows[~go_left])
        small = 0 if lr_rows[0].shape[0] <= lr_rows[1].shape[0] else 1
        h_small = histogram(bins, g, h, lr_rows[small])
        hists = [None, None]
        hists[small], hists[1 - small] = h_small, hist - h_small
        del hist
        for side, child in enumerate((int(tree["left_child"][i]),
                                      int(tree["right_child"][i]))):
            key = ("n", child) if child >= 0 else ("l", ~child)
            pending[key] = (lr_rows[side], hists[side], l2c)
    for leaf in range(L):
        rows, hist, l2 = pending.pop(("l", leaf))
        tot = hist[0].sum(dim=0)
        if int(tree["leaf_count"][leaf]) != rows.shape[0]:
            mismatch += 1
        ties = {}
        best_leaf[leaf] = node_best(bins, hist, tot, rule,
                                    hessian_margin, ties)["gain"]
        tied, moved = tied + ties["tied"], moved + ties["moved"]
        leaf_ref[leaf] = learning_rate * leaf_output(
            float(tot[0]), float(tot[1]), rule.l1, l2)

    finite = best_int[np.isfinite(best_int)]
    norm0 = float(np.median(finite)) if len(finite) else 0.0
    gap, worst, loose = 0.0, None, 0.0
    for i in range(M):
        if np.isfinite(best_int[i]):
            gi = (best_int[i] - taken[i]) / max(best_int[i], norm0, 1e-300)
            if gi > gap:
                gap, worst = gi, ("split", i, float(best_int[i]),
                                  float(taken[i]), float(own_term[i]),
                                  int(tree["internal_count"][i]))
        if np.isfinite(loose_int[i]):
            loose = max(loose, (loose_int[i] - taken[i])
                        / max(loose_int[i], norm0, 1e-300))
    for b, floor in waiting_gaps(tree, best_int, best_leaf, taken, wave):
        gi = (b - floor) / max(b, norm0, 1e-300)
        if gi > gap:
            gap, worst = gi, ("waiting", float(b), float(floor))
    if broken:
        gap, worst = 1.0, ("a split the definitions refuse", broken[:5])
    lv = np.asarray(tree["leaf_value"], np.float64)[:L]
    ref_norm = float(np.median(np.abs(leaf_ref)))
    leaf_gap = float(np.max(np.abs(lv - leaf_ref)
                            / np.maximum(np.maximum(np.abs(leaf_ref),
                                                    ref_norm), 1e-300)))
    cat_nodes = int((np.asarray(tree["decision_type"], np.int64)
                     & CATEGORICAL).sum())
    return {"split_gap": float(max(gap, 0.0)), "leaf_gap": leaf_gap,
            "count_mismatch": int(mismatch),
            "detail": {"worst": worst, "split_gap_no_margin": float(loose),
                       "cat_nodes": cat_nodes, "tie_nodes": int(tied),
                       "tie_moved": int(moved)}}


# -------------------------------------------------------------- growing


def _round(t: torch.Tensor, precision: Optional[torch.dtype]):
    return t if precision is None else t.to(precision).to(F64)


def grow(bins: Bins, g: torch.Tensor, h: torch.Tensor, rule: SplitRule,
         num_leaves: int, learning_rate: float, wave: int = 1,
         precision: Optional[torch.dtype] = None) -> Dict:
    """``gbdt.grow`` with categorical candidates: the reference's own tree,
    leaf-wise in waves of ``wave`` splits, as :func:`parse` gives one.
    ``precision`` (the control) rounds g, h and every histogram bin to that
    dtype and scans the numerical columns in f32."""
    g, h = _round(g, precision), _round(h, precision)
    dev = g.device
    n = g.shape[0]

    def hist_of(rows):
        return _round(histogram(bins, g, h, rows), precision)

    def scan(hist):
        if precision is None:
            return node_best(bins, hist, hist[0].sum(dim=0), rule)
        h32 = hist.float()
        return node_best(bins, h32, h32[0].sum(dim=0), rule)

    root = torch.arange(n, device=dev)
    leaves_ = [(root, hist_of(root))]
    leaf_l2 = [rule.l2]
    cands = [scan(leaves_[0][1])]
    nodes = []                         # (leaf, candidate, count, new)
    while len(leaves_) < num_leaves:
        gains = np.array([c["gain"] for c in cands])
        order = sorted((i for i in range(len(gains))
                        if math.isfinite(gains[i])),
                       key=lambda i: (-gains[i], i))
        picked = order[:min(wave, num_leaves - len(leaves_))]
        if not picked:
            break
        for li in picked:
            c = cands[li]
            rows, hist = leaves_[li]
            f = c["feature"]
            table = torch.zeros(bins.B, dtype=torch.bool, device=dev)
            if c["cat"]:
                table[torch.as_tensor(c["left"], device=dev)] = True
            else:
                table[:c["k"] + 1] = True
                table[bins.B - 1] = c["nan_left"]
            go_left = table[bins.codes[rows, f].long()]
            lrows, rrows = rows[go_left], rows[~go_left]
            if lrows.shape[0] <= rrows.shape[0]:
                hl = hist_of(lrows)
                hr = hist - hl
            else:
                hr = hist_of(rrows)
                hl = hist - hr
            new = len(leaves_)
            nodes.append((li, c, rows.shape[0], new))
            leaves_[li] = (lrows, hl)
            leaves_.append((rrows, hr))
            leaf_l2[li] = c["l2"]
            leaf_l2.append(c["l2"])
        for li in picked:
            cands[li] = scan(leaves_[li][1])
        cands += [scan(leaves_[i][1]) for i in range(len(cands),
                                                      len(leaves_))]
    M = len(nodes)
    L = len(leaves_)
    left = np.zeros(M, np.int64)
    right = np.zeros(M, np.int64)
    owner = {0: None}
    for i, (li, c, cnt, new) in enumerate(nodes):
        if i:
            p, side = owner[li]
            (left if side == 0 else right)[p] = i
        left[i], right[i] = ~li, ~new
        owner[li] = (i, 0)
        owner[new] = (i, 1)
    thr = np.zeros(M)
    dtype = np.zeros(M, np.int64)
    feat = np.zeros(M, np.int64)
    icount = np.zeros(M, np.int64)
    boundaries, words = [0], []
    for i, (li, c, cnt, new) in enumerate(nodes):
        f = c["feature"]
        feat[i] = f
        icount[i] = cnt
        if c["cat"]:
            w = bitset_of(bins.category[f][c["left"]])
            thr[i] = len(boundaries) - 1
            boundaries.append(boundaries[-1] + len(w))
            words.append(w)
            dtype[i] = CATEGORICAL
            continue
        u = bins.levels[f]
        thr[i] = float(u[min(c["k"], len(u) - 1)])
        if bins.has_nan[f]:
            dtype[i] = (MISSING_NAN << 2) | (DEFAULT_LEFT if c["nan_left"]
                                             else 0)
    leaf_value = np.zeros(L)
    leaf_count = np.zeros(L, np.int64)
    for li, (rows, hist) in enumerate(leaves_):
        tot = hist[0].sum(dim=0)
        if precision is not None:
            tot = tot.float().double()
        leaf_value[li] = learning_rate * leaf_output(
            float(tot[0]), float(tot[1]), rule.l1, leaf_l2[li])
        leaf_count[li] = rows.shape[0]
    return {"num_leaves": L, "split_feature": feat, "threshold": thr,
            "decision_type": dtype, "left_child": left, "right_child": right,
            "leaf_value": leaf_value, "leaf_count": leaf_count,
            "internal_count": icount, "internal_value": np.zeros(M),
            "shrinkage": learning_rate,
            "cat_boundaries": np.asarray(boundaries, np.int64),
            "cat_threshold": np.concatenate(words) if words
            else np.zeros(0, np.int64)}


# ------------------------------------------------ model text and walking


def parse(text: str) -> Dict:
    """``modeltext.parse`` of a model whose trees may hold categorical
    splits: each tree also has ``cat_boundaries`` and ``cat_threshold``
    (i64 words; ``[0]`` and none where the tree has no categorical split).
    ``modeltext.parse`` reads every other field; it refuses ``num_cat``
    for the numerical walk's sake, so it is handed the text with
    ``num_cat=0`` and the bitsets are read here."""
    model = modeltext.parse(re.sub(r"^(\s*)num_cat=\d+", r"\1num_cat=0", text,
                                   flags=re.M))
    blocks = text.split("feature importances:")[0].split("Tree=")[1:]
    for tree, block in zip(model["trees"], blocks):
        fields = dict(line.strip().split("=", 1) for line in
                      block.splitlines()[1:] if "=" in line)
        cats = int(fields.get("num_cat", "0"))
        tree["cat_boundaries"] = _ints(fields["cat_boundaries"]) if cats \
            else np.zeros(1, np.int64)
        tree["cat_threshold"] = _ints(fields["cat_threshold"]) if cats \
            else np.zeros(0, np.int64)
    return model


def leaves(tree: Dict, X: torch.Tensor) -> torch.Tensor:
    """The leaf of every row of ``X`` ``[n, F]``: ``walk.leaves``' rule at
    a numerical node, the bitset at a categorical one."""
    n = X.shape[0]
    dev = X.device
    if tree["num_leaves"] <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    dt_np = np.asarray(tree["decision_type"], np.int64)
    t = {k: torch.as_tensor(np.asarray(tree[k]), device=dev)
         for k in ("split_feature", "threshold", "left_child",
                   "right_child")}
    dt = torch.as_tensor(dt_np, device=dev)
    is_cat = (dt & CATEGORICAL) != 0
    bounds = np.asarray(tree["cat_boundaries"], np.int64)
    n_cat = len(bounds) - 1
    width = int(np.diff(bounds).max()) if n_cat > 0 else 1
    bits = np.zeros((max(n_cat, 1), width), np.int64)
    for c in range(n_cat):
        w = tree["cat_threshold"][bounds[c]:bounds[c + 1]]
        bits[c, :len(w)] = w
    bits = torch.as_tensor(bits, device=dev)
    n_words = torch.as_tensor(np.diff(bounds) if n_cat > 0 else [0],
                              device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    p_int, _ = parents(tree)
    depth = np.zeros(len(dt_np), np.int64)
    for i in range(1, len(dt_np)):
        depth[i] = depth[p_int[i]] + 1
    for _ in range(int(depth.max()) + 1):
        active = cur >= 0
        node = cur.clamp(min=0)
        x = torch.gather(X, 1, t["split_feature"][node][:, None])[:, 0] \
            .double()
        d = dt[node]
        missing = (d >> 2) & 3
        default_left = (d & DEFAULT_LEFT) != 0
        nan = torch.isnan(x)
        xn = torch.where(nan & (missing != MISSING_NAN),
                         torch.zeros_like(x), x)
        left = xn <= t["threshold"][node]
        is_default = torch.where(missing == MISSING_NAN, nan,
                                 (missing == 1) & (xn.abs() <= 1e-20))
        left = torch.where(is_default, default_left, left)
        # the categorical decision: the bit of the raw category
        ci = torch.clamp(t["threshold"][node].long(), 0, max(n_cat - 1, 0))
        v = torch.where(nan | (x < 0), -1.0, x).long()
        inside = (v >= 0) & (v < 32 * n_words[ci])
        word = bits[ci, torch.clamp(v >> 5, 0, width - 1)]
        in_set = inside & (((word >> (v & 31).clamp(min=0)) & 1) == 1)
        left = torch.where(is_cat[node], in_set, left)
        nxt = torch.where(left, t["left_child"][node],
                          t["right_child"][node])
        cur = torch.where(active, nxt, cur)
    return ~cur


def raw_scores(trees: List[Dict], X: torch.Tensor,
               dtype=torch.float64) -> torch.Tensor:
    """The sum of the trees' leaf values for every row, in ``dtype``."""
    out = torch.zeros(X.shape[0], dtype=dtype, device=X.device)
    for tree in trees:
        lv = torch.as_tensor(tree["leaf_value"], device=X.device).to(dtype)
        out += lv[leaves(tree, X)]
    return out
