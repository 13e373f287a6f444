"""Plain reference of one boosting step of a histogram GBDT, in PyTorch.

Written from LightGBM's published definitions, not from the program:

- bins: every distinct value of a feature is a bin of its own (the
  benchmark's data draws as many distinct values per feature as LightGBM's
  bin finding keeps one to a bin at ``max_bin``: 250 for HIGGS, 254 for
  MS-LTR); a NaN is the last bin;
- gradients: binary logloss, and LambdaRank over NDCG (LightGBM v2.0.10's
  ``rank_objective.hpp``: every pair of a query with different labels, the
  pair's NDCG change at ``max_position`` divided by ``0.01 + |score gap|``,
  the sigmoid computed directly), in f64;
- a split: a threshold between two values of one feature, and a side for
  NaN; its gain is ``G_L^2 / (H_L + l2) + G_R^2 / (H_R + l2) - G^2 / (H +
  l2)`` (with L1 thresholding of each ``G``), valid where both children hold
  ``min_sum_hessian_in_leaf`` and ``min_data_in_leaf``;
- growth: leaf-wise up to ``num_leaves``, in waves: each wave splits the
  ``wave`` leaves there at its start whose best splits gain most (the
  configuration states ``wave``: LightGBM splits one leaf at a time, the
  port's default growth up to 25); a leaf's value is ``-G / (H + l2)``
  times the learning rate.

:func:`judge` holds a tree the program grew against these definitions at
the rows and gradients the reference works out itself; :func:`grow` grows
the reference's own tree, at f64 or at the control's lower precision.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .modeltext import DEFAULT_LEFT, MISSING_NAN, MISSING_ZERO, parents

F64 = torch.float64
ROW_CHUNK = 1 << 21
PAIR_BUDGET = 1 << 25          # elements of one [Q, M, M] pair tensor
ZERO_RANGE = 1e-20
# the share of min_sum_hessian_in_leaf by which a child's f32 hessian sum
# may miss its f64 value: the program subtracts each child's sums from its
# parent's in f32, and a root of 10.5M rows holds a hessian sum near 2.6e6,
# whose f32 spacing is 0.25 (1/400 of the floor of 100) at every level
HESSIAN_MARGIN = 1e-2


# ---------------------------------------------------------------- bins


class Bins:
    """The reference's own binning of raw rows: ``codes`` ``[N, F]``
    (int16), each feature's sorted distinct values ``levels[f]``, ``B`` =
    the most values of any feature plus the NaN bin (the last), and
    ``has_nan[f]``."""

    def __init__(self, X: torch.Tensor):
        n, F = X.shape
        self.levels: List[torch.Tensor] = []
        self.has_nan = []
        for f in range(F):
            col = X[:, f]
            nan = torch.isnan(col)
            self.has_nan.append(bool(nan.any()))
            self.levels.append(torch.unique(col[~nan]).double())
        self.B = max(len(u) for u in self.levels) + 1
        self.codes = torch.empty((n, F), dtype=torch.int16, device=X.device)
        for f in range(F):
            col = X[:, f].double()
            code = torch.searchsorted(self.levels[f], col)
            self.codes[:, f] = torch.where(torch.isnan(col), self.B - 1,
                                           code).to(torch.int16)

    @property
    def num_features(self) -> int:
        return len(self.levels)

    def left_table(self, f: int, threshold: float, decision_type: int
                   ) -> torch.Tensor:
        """``[B]`` bool: which codes of feature ``f`` a numerical split at
        ``threshold`` sends left (LightGBM's ``Tree::Decision``)."""
        u = self.levels[f]
        dev = u.device
        missing = (decision_type >> 2) & 3
        default_left = bool(decision_type & DEFAULT_LEFT)
        table = torch.zeros(self.B, dtype=torch.bool, device=dev)
        left = u <= threshold
        if missing == MISSING_ZERO:
            left = torch.where(u.abs() <= ZERO_RANGE,
                               torch.full_like(left, default_left), left)
        table[:len(u)] = left
        if missing == MISSING_NAN:
            table[self.B - 1] = default_left
        elif missing == MISSING_ZERO:
            table[self.B - 1] = default_left        # NaN counts as zero
        else:
            table[self.B - 1] = 0.0 <= threshold
        return table


# ----------------------------------------------------------- gradients


def binary_gradients(score: torch.Tensor, label: torch.Tensor,
                     sigmoid: float = 1.0):
    """LightGBM's binary logloss gradients and hessians, in f64."""
    s = score.double()
    y = torch.where(label > 0, 1.0, -1.0).to(F64)
    response = -y * sigmoid / (1.0 + torch.exp(y * sigmoid * s))
    absr = response.abs()
    return response, absr * (sigmoid - absr)


def label_gains(n: int = 31) -> np.ndarray:
    """LightGBM's default ``label_gain``: ``2^i - 1``."""
    return np.array([(1 << i) - 1 for i in range(n)], np.float64)


def lambdarank_gradients(score: torch.Tensor, label: torch.Tensor,
                         query_sizes: np.ndarray, max_position: int = 20,
                         sigmoid: float = 1.0):
    """LambdaRank's gradients and hessians, in f64: queries in batches of
    one padded length, each as ``[Q, M, M]`` pair matrices."""
    dev = score.device
    n = score.shape[0]
    s_all = score.double()
    gains = torch.as_tensor(label_gains(), device=dev)
    lab = label.long()
    g_out = torch.zeros(n, dtype=F64, device=dev)
    h_out = torch.zeros(n, dtype=F64, device=dev)
    sizes = np.asarray(query_sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = np.argsort(sizes, kind="stable")
    i = 0
    while i < len(order):
        m = int(sizes[order[i]])
        j = i
        while j < len(order) and (j - i + 1) * int(sizes[order[j]]) ** 2 \
                <= max(PAIR_BUDGET, m * m):
            j += 1
        qs = order[i:j]
        M = int(sizes[qs].max())
        pos = torch.arange(M, device=dev)
        st = torch.as_tensor(starts[qs], device=dev)
        nq = torch.as_tensor(sizes[qs], device=dev)
        valid = pos[None, :] < nq[:, None]
        idx = torch.where(valid, st[:, None] + pos[None, :], 0)
        s = torch.where(valid, s_all[idx], -math.inf)
        lq = torch.where(valid, lab[idx], 0)
        # inverse max DCG at max_position, from the labels
        top = torch.sort(lq, dim=1, descending=True).values[:, :max_position]
        disc_top = 1.0 / torch.log2(torch.arange(top.shape[1], device=dev,
                                                 dtype=F64) + 2.0)
        max_dcg = (gains[top] * disc_top).sum(dim=1)
        inv_max = torch.where(max_dcg > 0, 1.0 / max_dcg,
                              torch.zeros_like(max_dcg))
        srt = torch.sort(s, dim=1, descending=True, stable=True)
        s_s, o = srt.values, srt.indices
        l_s = torch.gather(lq, 1, o)
        v_s = torch.gather(valid, 1, o)
        disc = 1.0 / torch.log2(pos.to(F64) + 2.0)
        best = s_s[:, 0]
        worst = torch.gather(s_s, 1, (nq - 1)[:, None])[:, 0]
        ds = s_s[:, :, None] - s_s[:, None, :]
        ds = torch.where(v_s[:, :, None] & v_s[:, None, :], ds,
                         torch.zeros_like(ds))
        pair = (l_s[:, :, None] > l_s[:, None, :]) & v_s[:, :, None] \
            & v_s[:, None, :]
        g_gap = gains[l_s][:, :, None] - gains[l_s][:, None, :]
        delta = g_gap * (disc[:, None] - disc[None, :]).abs()[None] \
            * inv_max[:, None, None]
        delta = torch.where((best != worst)[:, None, None],
                            delta / (0.01 + ds.abs()), delta)
        p = 2.0 / (1.0 + torch.exp(2.0 * sigmoid * ds))
        lam = torch.where(pair, -p * delta, torch.zeros_like(p))
        hes = torch.where(pair, 2.0 * p * (2.0 - p) * delta,
                          torch.zeros_like(p))
        g_s = lam.sum(dim=2) - lam.sum(dim=1)
        h_s = hes.sum(dim=2) + hes.sum(dim=1)
        rows = torch.gather(idx, 1, o)
        g_out.index_put_((rows[v_s],), g_s[v_s])
        h_out.index_put_((rows[v_s],), h_s[v_s])
        i = j
    return g_out, h_out


def ordered_pairs(label: np.ndarray, query_sizes: np.ndarray) -> int:
    """The pairs of documents of one query with different labels, each
    counted once: the pairs LambdaRank must work on."""
    total = 0
    start = 0
    for n in np.asarray(query_sizes, np.int64):
        counts = np.bincount(np.asarray(label[start:start + n], np.int64))
        total += (int(n) * int(n) - int((counts * counts).sum())) // 2
        start += int(n)
    return total


# ----------------------------------------------------------- histograms


def histogram(bins: Bins, g: torch.Tensor, h: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """``[F, B, 3]`` f64 sums of g, h and the row count per code."""
    F, B = bins.num_features, bins.B
    dev = g.device
    out = torch.zeros((3, F * B), dtype=F64, device=dev)
    offs = torch.arange(F, device=dev) * B
    for lo in range(0, rows.shape[0], ROW_CHUNK):
        r = rows[lo:lo + ROW_CHUNK]
        idx = (bins.codes[r].long() + offs).reshape(-1)
        out[0] += torch.bincount(idx, weights=g[r, None].expand(-1, F)
                                 .reshape(-1), minlength=F * B)
        out[1] += torch.bincount(idx, weights=h[r, None].expand(-1, F)
                                 .reshape(-1), minlength=F * B)
        out[2] += torch.bincount(idx, minlength=F * B).to(F64)
    return out.reshape(3, F, B).permute(1, 2, 0).contiguous()


# ------------------------------------------------------------- the scan


def _leaf_gain(G, H, l1, l2):
    reg = torch.clamp(G.abs() - l1, min=0.0)
    return reg * reg / (H + l2)


def leaf_output(G: float, H: float, l1: float, l2: float) -> float:
    reg = max(abs(G) - l1, 0.0)
    denom = H + l2
    return 0.0 if denom <= 0 else -math.copysign(reg, G) / denom


class SplitRule:
    """The split constraints and regularisation of a configuration."""

    def __init__(self, params: Dict):
        self.min_h = float(params.get("min_sum_hessian_in_leaf", 1e-3))
        self.min_data = float(params.get("min_data_in_leaf", 20))
        self.l1 = float(params.get("lambda_l1", 0.0))
        self.l2 = float(params.get("lambda_l2", 0.0))
        self.min_gain = float(params.get("min_gain_to_split", 0.0))

    def gains(self, left: torch.Tensor, tot: torch.Tensor,
              margin: float = 0.0) -> torch.Tensor:
        """Gain over the parent of each candidate ``left`` ``[..., 3]``,
        ``-inf`` where the split is not allowed; ``margin`` raises the
        hessian floor by that share of it."""
        right = tot - left
        min_h = self.min_h * (1.0 + margin)
        ok = ((left[..., 1] >= min_h) & (right[..., 1] >= min_h)
              & (left[..., 2] >= self.min_data)
              & (right[..., 2] >= self.min_data)
              & (left[..., 2] > 0) & (right[..., 2] > 0))
        gain = (_leaf_gain(left[..., 0], left[..., 1], self.l1, self.l2)
                + _leaf_gain(right[..., 0], right[..., 1], self.l1, self.l2)
                - _leaf_gain(tot[0], tot[1], self.l1, self.l2))
        gain = torch.where(ok & (gain > self.min_gain), gain,
                           torch.full_like(gain, -math.inf))
        return gain

    def allows(self, left: torch.Tensor, tot: torch.Tensor,
               margin: float = 0.0) -> bool:
        """Whether a given split keeps the constraints, its hessian floor
        lowered by ``margin`` of it."""
        right = tot - left
        min_h = self.min_h * (1.0 - margin)
        return bool(left[1] >= min_h and right[1] >= min_h
                    and left[2] >= self.min_data and right[2] >= self.min_data
                    and left[2] > 0 and right[2] > 0)

    def raw_gain(self, left: torch.Tensor, tot: torch.Tensor) -> float:
        """A given split's gain over the parent, with no constraint."""
        right = tot - left
        return float(_leaf_gain(left[0], left[1], self.l1, self.l2)
                     + _leaf_gain(right[0], right[1], self.l1, self.l2)
                     - _leaf_gain(tot[0], tot[1], self.l1, self.l2))


def best_split(hist: torch.Tensor, tot: torch.Tensor, rule: SplitRule,
               margin: float = 0.0):
    """``(gain, feature, k, nan_left)`` of the best split of a node: left
    takes the values of codes ``<= k``, and NaN where ``nan_left``; gain
    ``-inf`` where no split is allowed (``margin``: see
    :meth:`SplitRule.gains`)."""
    F, B, _ = hist.shape
    cum = torch.cumsum(hist[:, :B - 1, :], dim=1)          # [F, B-1, 3]
    nan = hist[:, B - 1, :]                                 # [F, 3]
    cand = torch.stack([cum, cum + nan[:, None, :]], dim=0)  # [2, F, B-1, 3]
    gain = rule.gains(cand, tot, margin)
    flat = int(torch.argmax(gain.reshape(-1)))
    best = float(gain.reshape(-1)[flat])
    side, rest = divmod(flat, F * (B - 1))
    f, k = divmod(rest, B - 1)
    return best, f, k, bool(side)


# ------------------------------------------------------------- judging


def _node_rows(bins: Bins, rows: torch.Tensor, table: torch.Tensor, f: int):
    go_left = table[bins.codes[rows, f].long()]
    return rows[go_left], rows[~go_left]


def waves(tree: Dict, wave: int) -> List[range]:
    """The tree's splits by wave: each wave applies, in gain order, the
    best ``min(wave, leaves left to make)`` splits of the leaves there at
    its start, and numbers them in that order; a wave ends early where its
    next split is of a leaf it made itself, or where fewer leaves could
    split."""
    M = len(tree["split_feature"])
    p_int, _ = parents(tree)
    out, a = [], 0
    while a < M:
        b = a
        cap = min(wave, tree["num_leaves"] - 1 - a)
        while b < M and b - a < cap and p_int[b] < a:
            b += 1
        out.append(range(a, b))
        a = b
    return out


def waiting_gaps(tree: Dict, best_int, best_leaf, taken, wave: int):
    """``(best gain, least gain taken instead)`` of every node that waited
    through a wave: a node there at the wave's start and not split in it
    may gain no more than the wave's least split where the wave was full,
    and nothing where it was not."""
    M = len(tree["split_feature"])
    L = tree["num_leaves"]
    p_int, p_leaf = parents(tree)
    created = np.concatenate([p_int, p_leaf])      # -1: the root
    best = np.concatenate([best_int, best_leaf])
    split_at = np.concatenate([np.arange(M), np.full(L, M)])
    if M == 0:
        return
    for w in waves(tree, wave):
        full = len(w) == min(wave, L - 1 - w.start)
        floor = taken[w.start:w.stop].min() if full else 0.0
        for n in range(M + L):
            if created[n] < w.start and split_at[n] >= w.stop \
                    and np.isfinite(best[n]) and best[n] > floor:
                yield best[n], floor


def judge(tree: Dict, bins: Bins, g: torch.Tensor, h: torch.Tensor,
          rule: SplitRule, learning_rate: float, wave: int = 1,
          hessian_margin: float = HESSIAN_MARGIN) -> Dict:
    """How far a grown tree departs from the definitions at these
    gradients, and the tree's counts against the rows it routes:

    - ``split_gap``: the widest gap, over the tree's splits, between the
      best gain the node allowed and the gain of the split taken, and over
      its nodes, between a node's best gain and the least gain of a split
      taken while it waited (leaf-wise growth takes the best leaf first);
      each over the node's best gain or the tree's median best gain,
      whichever is larger;
    - ``leaf_gap``: the widest gap between a leaf's value and the learning
      rate times ``-G / (H + l2)`` of its rows, over that reference value
      or the tree's median one, whichever is larger;
    - ``count_mismatch``: nodes whose ``internal_count`` / ``leaf_count``
      differs from the rows routed there.

    The best gain a node allowed is taken over the splits that keep the
    hessian floor ``min_sum_hessian_in_leaf`` with ``hessian_margin`` of it
    to spare; a split taken that misses the floor by more than that margin
    reads 1. The margin is the rounding of a child's hessian sum in the
    program's stated f32, which subtracts it from its parent's: a split at
    the floor may be allowed on one side of the comparison and not on the
    other. ``detail`` gives the node behind ``split_gap`` (for a split:
    its best gain, the gain taken, its own ``G^2 / (H + l2)`` and its rows)
    and the gap without the margin.
    """
    n = g.shape[0]
    dev = g.device
    M = len(tree["split_feature"])
    L = tree["num_leaves"]
    p_int, p_leaf = parents(tree)
    root = torch.arange(n, device=dev)
    pending = {("n", 0) if M else ("l", 0): (root, histogram(bins, g, h,
                                                             root))}
    best_int = np.full(M, -math.inf)
    loose_int = np.full(M, -math.inf)
    broken = []                       # splits taken below the floor
    taken = np.full(M, -math.inf)
    best_leaf = np.full(L, -math.inf)
    own_term = np.zeros(M)            # the node's G^2 / (H + l2)
    leaf_ref = np.zeros(L)
    mismatch = 0
    for i in range(M):
        rows, hist = pending.pop(("n", i))
        tot = hist[0].sum(dim=0)
        if int(tree["internal_count"][i]) != rows.shape[0]:
            mismatch += 1
        f = int(tree["split_feature"][i])
        table = bins.left_table(f, float(tree["threshold"][i]),
                                int(tree["decision_type"][i]))
        best_int[i] = best_split(hist, tot, rule, margin=hessian_margin)[0]
        loose_int[i] = best_split(hist, tot, rule)[0]
        left_sum = (hist[f] * table[:, None]).sum(dim=0)
        taken[i] = rule.raw_gain(left_sum, tot)
        own_term[i] = float(_leaf_gain(tot[0], tot[1], rule.l1, rule.l2))
        if not rule.allows(left_sum, tot, hessian_margin):
            broken.append(i)
        lr_rows = _node_rows(bins, rows, table, f)
        small = 0 if lr_rows[0].shape[0] <= lr_rows[1].shape[0] else 1
        h_small = histogram(bins, g, h, lr_rows[small])
        hists = [None, None]
        hists[small], hists[1 - small] = h_small, hist - h_small
        del hist
        for side, child in enumerate((int(tree["left_child"][i]),
                                      int(tree["right_child"][i]))):
            key = ("n", child) if child >= 0 else ("l", ~child)
            pending[key] = (lr_rows[side], hists[side])
    for leaf in range(L):
        rows, hist = pending.pop(("l", leaf))
        tot = hist[0].sum(dim=0)
        if int(tree["leaf_count"][leaf]) != rows.shape[0]:
            mismatch += 1
        best_leaf[leaf] = best_split(hist, tot, rule,
                                     margin=hessian_margin)[0]
        leaf_ref[leaf] = learning_rate * leaf_output(
            float(tot[0]), float(tot[1]), rule.l1, rule.l2)

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
        gap, worst = 1.0, ("below the hessian floor", broken[:5])
    lv = np.asarray(tree["leaf_value"], np.float64)[:L]
    ref_norm = float(np.median(np.abs(leaf_ref)))
    leaf_gap = float(np.max(np.abs(lv - leaf_ref)
                            / np.maximum(np.maximum(np.abs(leaf_ref),
                                                    ref_norm), 1e-300)))
    return {"split_gap": float(max(gap, 0.0)), "leaf_gap": leaf_gap,
            "count_mismatch": int(mismatch),
            "detail": {"worst": worst, "split_gap_no_margin": float(loose)}}


# -------------------------------------------------------------- growing


def _round(t: torch.Tensor, precision: Optional[torch.dtype]):
    return t if precision is None else t.to(precision).to(F64)


def grow(bins: Bins, g: torch.Tensor, h: torch.Tensor, rule: SplitRule,
         num_leaves: int, learning_rate: float, wave: int = 1,
         precision: Optional[torch.dtype] = None) -> Dict:
    """The reference's own tree, grown leaf-wise in waves of ``wave``
    splits (1: LightGBM's one leaf at a time), as :func:`modeltext.parse`
    gives one. ``precision`` (the control) rounds the gradients, the
    hessians and every histogram bin to that dtype and scans in f32."""
    g, h = _round(g, precision), _round(h, precision)
    dev = g.device
    n = g.shape[0]

    def hist_of(rows):
        return _round(histogram(bins, g, h, rows), precision)

    def scan(hist):
        if precision is None:
            return best_split(hist, hist[0].sum(dim=0), rule)
        h32 = hist.float()
        return best_split(h32, h32[0].sum(dim=0), rule)

    root = torch.arange(n, device=dev)
    leaves = [(root, hist_of(root))]
    cands = [scan(leaves[0][1])]
    nodes = []                         # (leaf, f, k, nan_left, count, new)
    while len(leaves) < num_leaves:
        # a wave: the best splits of the leaves there now, in gain order
        # (ties: the lower leaf), as many as the wave and the budget allow
        gains = np.array([c[0] for c in cands])
        order = sorted((i for i in range(len(gains))
                        if math.isfinite(gains[i])),
                       key=lambda i: (-gains[i], i))
        picked = order[:min(wave, num_leaves - len(leaves))]
        if not picked:
            break
        for li in picked:
            gain, f, k, nan_left = cands[li]
            rows, hist = leaves[li]
            table = torch.zeros(bins.B, dtype=torch.bool, device=dev)
            table[:k + 1] = True
            table[bins.B - 1] = nan_left
            lrows, rrows = _node_rows(bins, rows, table, f)
            if lrows.shape[0] <= rrows.shape[0]:
                hl = hist_of(lrows)
                hr = hist - hl
            else:
                hr = hist_of(rrows)
                hl = hist - hr
            new = len(leaves)
            nodes.append((li, f, k, nan_left, rows.shape[0], new))
            leaves[li] = (lrows, hl)
            leaves.append((rrows, hr))
        for li in picked:
            cands[li] = scan(leaves[li][1])
        cands += [scan(leaves[i][1]) for i in range(len(cands),
                                                     len(leaves))]
    M = len(nodes)
    L = len(leaves)
    left = np.zeros(M, np.int64)
    right = np.zeros(M, np.int64)
    # each split turns leaf li into internal node i: the child pointer that
    # named ~li in its parent now names i
    owner = {0: None}
    for i, (li, f, k, nan_left, cnt, new) in enumerate(nodes):
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
    for i, (li, f, k, nan_left, cnt, new) in enumerate(nodes):
        feat[i] = f
        u = bins.levels[f]
        thr[i] = float(u[min(k, len(u) - 1)])
        if bins.has_nan[f]:
            dtype[i] = (MISSING_NAN << 2) | (DEFAULT_LEFT if nan_left else 0)
        icount[i] = cnt
    leaf_value = np.zeros(L)
    leaf_count = np.zeros(L, np.int64)
    for li, (rows, hist) in enumerate(leaves):
        tot = hist[0].sum(dim=0)
        if precision is not None:
            tot = tot.float().double()
        leaf_value[li] = learning_rate * leaf_output(
            float(tot[0]), float(tot[1]), rule.l1, rule.l2)
        leaf_count[li] = rows.shape[0]
    return {"num_leaves": L, "split_feature": feat, "threshold": thr,
            "decision_type": dtype, "left_child": left, "right_child": right,
            "leaf_value": leaf_value, "leaf_count": leaf_count,
            "internal_count": icount, "internal_value": np.zeros(M),
            "shrinkage": learning_rate}


def wave_size(params: Dict) -> int:
    """The splits a wave applies under the configuration's
    ``tpu_wave_size`` and ``tpu_hist_slots`` (both stated in the file)."""
    return max(1, min(int(params["tpu_wave_size"]),
                      int(params["tpu_hist_slots"]),
                      int(params["num_leaves"])))


def gradients(objective: str, score: torch.Tensor, label: torch.Tensor,
              query_sizes: Optional[Sequence[int]] = None,
              params: Optional[Dict] = None):
    """The objective's gradients and hessians at ``score``, in f64."""
    params = params or {}
    sig = float(params.get("sigmoid", 1.0))
    if objective == "binary":
        return binary_gradients(score, label, sig)
    if objective == "lambdarank":
        return lambdarank_gradients(score, label, np.asarray(query_sizes),
                                    int(params.get("max_position", 20)), sig)
    raise ValueError(f"the reference has no objective {objective!r}")
