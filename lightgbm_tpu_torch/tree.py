"""Host-side tree model: export, raw-value prediction, serialization glue.

The device grower (grower.py) produces TreeArrays in *inner* coordinates
(used-feature indices, bin thresholds). This module converts them into the
reference's model-space tree (include/LightGBM/tree.h:23): real feature
indices, real-valued thresholds (bin upper bounds), decision_type bit packing
(categorical bit 0, default_left bit 1, missing type bits 2-3 —
tree.h:184-211), and implements NumericalDecision/CategoricalDecision
semantics for raw-value prediction (tree.h:218-284) vectorized over rows.

Split records are ALWAYS original-feature space regardless of the training
representation: under EFB the bundle-space scan translates the winning
(bundled column, bundle bin) back to (feature, original bin) for the
<= wave_size chosen splits before they reach TreeArrays (the reference's
FeatureGroup threshold translation), so nothing here ever sees a bundle
coordinate and exported models are representation-independent.

The PyTorch port keeps this host-numpy copy of ``lightgbm_tpu/tree.py`` so that it
never imports the JAX package; tests/test_torch_host.py pins the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .binning import BIN_CATEGORICAL, K_ZERO_RANGE, MISSING_NAN, MISSING_NONE, MISSING_ZERO

MISSING_TYPE_CODE = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}
CODE_TO_MISSING = {v: k for k, v in MISSING_TYPE_CODE.items()}

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2


@dataclass
class Tree:
    """One decision tree in model space (reference tree.h:356-395 layout)."""
    num_leaves: int
    split_feature: np.ndarray      # i32 [M] real feature index
    threshold_bin: np.ndarray      # i32 [M]
    threshold: np.ndarray          # f64 [M] real threshold (bin upper bound)
    decision_type: np.ndarray      # u8  [M]
    left_child: np.ndarray         # i32 [M]
    right_child: np.ndarray        # i32 [M]
    split_gain: np.ndarray         # f64 [M]
    internal_value: np.ndarray     # f64 [M]
    internal_count: np.ndarray     # i64 [M]
    leaf_value: np.ndarray         # f64 [L]
    leaf_count: np.ndarray         # i64 [L]
    leaf_parent: np.ndarray        # i32 [L]
    shrinkage: float = 1.0
    # categorical splits: threshold_bin is an index into cat_boundaries
    cat_boundaries: Optional[np.ndarray] = None   # i32 [ncat+1]
    cat_threshold: Optional[np.ndarray] = None    # u32 bitset pool
    # piecewise-linear leaves (linear_tree=true; later-LightGBM tree.h
    # leaf_const_/leaf_coeff_/leaf_features_): per-leaf REAL feature index
    # lists + coefficients; a leaf with an empty feature list is a constant
    # leaf. A linear leaf's output is leaf_const + coeff . x, with
    # leaf_value the missing-value fallback.
    leaf_features: Optional[List[np.ndarray]] = None   # per leaf, i32 [k_l]
    leaf_coeff: Optional[List[np.ndarray]] = None      # per leaf, f64 [k_l]
    leaf_const: Optional[np.ndarray] = None            # f64 [L]

    @property
    def num_internal(self) -> int:
        return max(self.num_leaves - 1, 0)

    @property
    def is_linear(self) -> bool:
        """True iff any leaf carries a fitted linear model."""
        return self.leaf_features is not None and \
            any(len(f) for f in self.leaf_features)

    # -- prediction on raw feature values ------------------------------------

    def _decide(self, node: int, fvals: np.ndarray) -> np.ndarray:
        """Vectorized Decision (tree.h:287-293) for rows at `node`;
        returns child (>=0 node, <0 ~leaf) per row."""
        dt = int(self.decision_type[node])
        if dt & K_CATEGORICAL_MASK:
            int_fval = np.where(np.isnan(fvals), -1, fvals).astype(np.int64)
            cat_idx = int(self.threshold_bin[node])
            lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
            bitset = self.cat_threshold[lo:hi]
            in_set = np.zeros(len(fvals), dtype=bool)
            ok = (int_fval >= 0) & (int_fval < 32 * len(bitset))
            iv = np.clip(int_fval, 0, max(32 * len(bitset) - 1, 0))
            if len(bitset):
                in_set = ok & ((bitset[iv // 32] >> (iv % 32)) & 1).astype(bool)
            return np.where(in_set, self.left_child[node], self.right_child[node])
        missing_type = (dt >> 2) & 3
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        v = fvals.astype(np.float64)
        nan_mask = np.isnan(v)
        if missing_type != 2:
            v = np.where(nan_mask, 0.0, v)
        if missing_type == 1:
            is_default = np.abs(v) <= K_ZERO_RANGE
        elif missing_type == 2:
            is_default = nan_mask
        else:
            is_default = np.zeros(len(v), dtype=bool)
        default_child = self.left_child[node] if default_left else self.right_child[node]
        go_left = v <= self.threshold[node]
        out = np.where(go_left, self.left_child[node], self.right_child[node])
        return np.where(is_default, default_child, out)

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Leaf index per row, raw feature matrix [N, num_total_features]."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        cur = np.zeros(n, dtype=np.int64)  # start at root node 0
        out = np.full(n, -1, dtype=np.int64)
        active = np.arange(n)
        for _ in range(self.num_leaves + 1):
            if len(active) == 0:
                break
            nodes = cur[active]
            next_nodes = np.empty(len(active), dtype=np.int64)
            for node in np.unique(nodes):
                sel = nodes == node
                rows = active[sel]
                next_nodes[sel] = self._decide(int(node),
                                               X[rows, self.split_feature[node]])
            settled = next_nodes < 0
            out[active[settled]] = ~next_nodes[settled]
            cur[active] = next_nodes
            active = active[~settled]
        return out.astype(np.int32)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.leaf_outputs(X, self.predict_leaf(X))

    def _linear_tables(self):
        """Cached -1-padded per-leaf (features, coefficients, lengths)
        tables for the vectorized ``leaf_outputs`` gather. Padding lanes
        carry feature 0 / coefficient +0.0 and are value-masked to +0.0,
        so the padded accumulation is an EXACT no-op per IEEE-754
        (nonzero + ±0.0 and +0.0 + +0.0 are both exact) — bit-identical
        to the ragged per-leaf loop."""
        tabs = getattr(self, "_linear_tables_cache", None)
        if tabs is None:
            L = self.num_leaves
            klen = np.array([len(f) for f in self.leaf_features[:L]],
                            np.int64)
            K = max(int(klen.max()), 1)
            feat = np.zeros((L, K), np.int64)
            coeff = np.zeros((L, K), np.float64)
            for li in range(L):
                k = klen[li]
                if k:
                    feat[li, :k] = self.leaf_features[li]
                    coeff[li, :k] = self.leaf_coeff[li]
            tabs = (feat, coeff, klen)
            self._linear_tables_cache = tabs
        return tabs

    def leaf_outputs(self, X: np.ndarray, leaf_idx: np.ndarray) -> np.ndarray:
        """f64 output per row GIVEN its leaf assignment.

        Constant trees: the leaf_value gather. Linear trees: rows in a
        linear leaf with every leaf feature present get ``leaf_const +
        sum_k coeff_k * x_k`` (sequential in k — the EXACT operation order
        the codegen oracle emits, so both stay bit-identical); rows with a
        NaN leaf feature fall back to the constant ``leaf_value``
        (later-LightGBM semantics). The one home of linear-leaf evaluation
        on the host — ``ServingEngine`` calls it per (tree, chunk) so a
        served linear model cannot drift from ``Booster.predict``. One
        row-gather + K fused accumulation passes: O(rows * K), no per-leaf
        scan over the chunk."""
        out = self.leaf_value[leaf_idx].astype(np.float64)
        if not self.is_linear:
            return out
        feat_t, coeff_t, klen = self._linear_tables()
        feats = feat_t[leaf_idx]                               # [n, K]
        coeff = coeff_t[leaf_idx]
        used = np.arange(feat_t.shape[1])[None, :] < klen[leaf_idx][:, None]
        xs = np.take_along_axis(np.asarray(X, np.float64), feats, axis=1)
        xs = np.where(used, xs, 0.0)      # padding lanes: exact +0.0 terms
        nanrow = np.isnan(xs).any(axis=1)
        acc = self.leaf_const[leaf_idx].astype(np.float64)
        for k in range(feat_t.shape[1]):
            acc = acc + coeff[:, k] * xs[:, k]
        lin = klen[leaf_idx] > 0
        return np.where(lin & ~nanrow, acc, out)

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:137-142); linear leaves scale intercept
        and coefficients with the constant."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        if self.leaf_const is not None:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [c * rate for c in self.leaf_coeff]
            self._linear_tables_cache = None   # coefficients changed
        self.shrinkage *= rate

    # -- TreeSHAP feature contributions (reference tree.h:340-354
    #    Tree::PredictContrib via TreeSHAP; Lundberg & Lee's algorithm) ------

    def _child_count(self, child: int) -> float:
        return float(self.leaf_count[~child] if child < 0
                     else self.internal_count[child])

    def expected_value(self) -> float:
        """Count-weighted mean of leaf outputs (reference Tree::ExpectedValue,
        src/io/tree.cpp:632)."""
        if self.num_leaves <= 1:
            return float(self.leaf_value[0]) if len(self.leaf_value) else 0.0
        total = float(self.internal_count[0])
        if total <= 0:
            return 0.0
        return float(np.dot(self.leaf_count[: self.num_leaves],
                            self.leaf_value[: self.num_leaves]) / total)

    def tree_shap_row(self, x: np.ndarray, phi: np.ndarray) -> None:
        """Add this tree's per-feature contributions for one row into
        ``phi`` [num_total_features + 1] (last slot = expected value)."""
        phi[-1] += self.expected_value()
        if self.num_leaves <= 1:
            return

        # path entries: (feature_index, zero_fraction, one_fraction, pweight)
        def extend(path, zero_frac, one_frac, fi):
            # rows must be copied: both recursion branches extend the same
            # parent path and the weight updates below mutate rows in place
            path = [row[:] for row in path] \
                + [[fi, zero_frac, one_frac, 1.0 if not path else 0.0]]
            l = len(path) - 1
            for i in range(l - 1, -1, -1):
                path[i + 1][3] += one_frac * path[i][3] * (i + 1) / (l + 1)
                path[i][3] = zero_frac * path[i][3] * (l - i) / (l + 1)
            return path

        def unwind(path, i):
            l = len(path) - 1
            one_frac, zero_frac = path[i][2], path[i][1]
            path = [row[:] for row in path]
            n = path[l][3]
            for j in range(l - 1, -1, -1):
                if one_frac != 0.0:
                    tmp = path[j][3]
                    path[j][3] = n * (l + 1) / ((j + 1) * one_frac)
                    n = tmp - path[j][3] * zero_frac * (l - j) / (l + 1)
                else:
                    path[j][3] = path[j][3] * (l + 1) / (zero_frac * (l - j))
            for j in range(i, l):
                path[j][0], path[j][1], path[j][2] = \
                    path[j + 1][0], path[j + 1][1], path[j + 1][2]
            return path[:-1]

        def unwound_sum(path, i):
            l = len(path) - 1
            one_frac, zero_frac = path[i][2], path[i][1]
            total = 0.0
            n = path[l][3]
            for j in range(l - 1, -1, -1):
                if one_frac != 0.0:
                    tmp = n * (l + 1) / ((j + 1) * one_frac)
                    total += tmp
                    n = path[j][3] - tmp * zero_frac * (l - j) / (l + 1)
                else:
                    total += path[j][3] / (zero_frac * (l - j) / (l + 1))
            return total

        def recurse(node, path, zero_frac, one_frac, parent_fi):
            path = extend(path, zero_frac, one_frac, parent_fi)
            if node < 0:                               # leaf
                leaf_v = float(self.leaf_value[~node])
                for i in range(1, len(path)):
                    w = unwound_sum(path, i)
                    phi[path[i][0]] += w * (path[i][2] - path[i][1]) * leaf_v
                return
            fi = int(self.split_feature[node])
            hot = int(self._decide(node, x[fi:fi + 1].astype(np.float64))[0])
            cold = (int(self.right_child[node]) if hot == self.left_child[node]
                    else int(self.left_child[node]))
            cnt = self._child_count(hot) + self._child_count(cold)
            hot_frac = self._child_count(hot) / cnt if cnt > 0 else 0.0
            cold_frac = self._child_count(cold) / cnt if cnt > 0 else 0.0
            inc_zero, inc_one = 1.0, 1.0
            for i in range(1, len(path)):
                if path[i][0] == fi:
                    inc_zero, inc_one = path[i][1], path[i][2]
                    path = unwind(path, i)
                    break
            recurse(hot, path, inc_zero * hot_frac, inc_one, fi)
            recurse(cold, path, inc_zero * cold_frac, 0.0, fi)

        recurse(0, [], 1.0, 1.0, -1)

    def predict_contrib(self, X: np.ndarray, num_total_features: int) -> np.ndarray:
        out = np.zeros((X.shape[0], num_total_features + 1))
        for r in range(X.shape[0]):
            self.tree_shap_row(X[r], out[r])
        return out

    def add_bias(self, bias: float) -> None:
        """Tree::AddBias — fold boost-from-average into the first tree.
        Linear leaves shift the intercept too (their output path bypasses
        leaf_value except on missing-feature rows)."""
        self.leaf_value = self.leaf_value + bias
        self.internal_value = self.internal_value + bias
        if self.leaf_const is not None:
            lin = np.array([len(f) > 0 for f in self.leaf_features])
            self.leaf_const = np.where(lin[: len(self.leaf_const)],
                                       self.leaf_const + bias,
                                       self.leaf_const)
            self._linear_tables_cache = None   # intercepts changed

    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        depth = np.zeros(self.num_internal, dtype=np.int64)
        md = 1
        for node in range(self.num_internal):
            d = depth[node]
            for child in (self.left_child[node], self.right_child[node]):
                if child >= 0:
                    depth[child] = d + 1
                else:
                    md = max(md, d + 1)
        return int(md)


def tree_from_device_arrays(arrs, mappers, real_feature_idx: np.ndarray) -> Tree:
    """Convert grower TreeArrays (host numpy pytree) to a model-space Tree."""
    nl = int(arrs.num_leaves)
    M = max(nl - 1, 0)
    L = max(nl, 1)
    split_feature_inner = np.asarray(arrs.split_feature[:M], dtype=np.int32)
    threshold_bin = np.array(arrs.threshold_bin[:M], dtype=np.int32)
    default_left = np.asarray(arrs.default_left[:M], dtype=bool)

    threshold = np.zeros(M, dtype=np.float64)
    decision_type = np.zeros(M, dtype=np.uint8)
    # categorical splits: convert the device bin-mask into a raw-category
    # bitset pool (reference Tree::SplitCategorical converts bins to category
    # values via BinMapper, tree.h:82-100; bitset layout tree.h:257-284)
    dev_is_cat = np.asarray(getattr(arrs, "is_cat", np.zeros(0, bool)))
    dev_cat_mask = np.asarray(getattr(arrs, "cat_mask", np.zeros((0, 0), bool)))
    cat_boundaries: List[int] = [0]
    cat_words: List[np.ndarray] = []
    for i in range(M):
        mapper = mappers[split_feature_inner[i]]
        dt = 0
        if mapper.bin_type == BIN_CATEGORICAL:
            dt |= K_CATEGORICAL_MASK
        if default_left[i]:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= MISSING_TYPE_CODE[mapper.missing_type] << 2
        decision_type[i] = dt
        if mapper.bin_type != BIN_CATEGORICAL:
            threshold[i] = float(mapper.bin_upper_bound[threshold_bin[i]])
        else:
            mask_bins = np.nonzero(dev_cat_mask[i])[0] if i < len(dev_is_cat) else []
            cats = [int(mapper.bin_2_categorical[b]) for b in mask_bins
                    if b < len(mapper.bin_2_categorical)
                    and mapper.bin_2_categorical[b] >= 0]
            n_words = (max(cats) // 32 + 1) if cats else 1
            words = np.zeros(n_words, dtype=np.uint32)
            for cval in cats:
                words[cval // 32] |= np.uint32(1) << np.uint32(cval % 32)
            cat_idx = len(cat_boundaries) - 1
            threshold_bin[i] = cat_idx
            threshold[i] = float(cat_idx)
            cat_boundaries.append(cat_boundaries[-1] + n_words)
            cat_words.append(words)

    # piecewise-linear leaves (ops/linear.py): device arrays hold INNER
    # feature indices, -1-padded; the host model keeps per-leaf ragged
    # lists in REAL feature space (what every interchange format writes)
    leaf_features = leaf_coeff = leaf_const = None
    dev_lf = getattr(arrs, "leaf_feat", None)
    if dev_lf is not None:
        dev_lf = np.asarray(dev_lf)
        dev_lc = np.asarray(arrs.leaf_coeff, dtype=np.float64)
        dev_const = np.asarray(arrs.leaf_const, dtype=np.float64)
        leaf_features, leaf_coeff = [], []
        for li in range(L):
            sel = dev_lf[li] >= 0
            leaf_features.append(
                real_feature_idx[dev_lf[li][sel]].astype(np.int32))
            leaf_coeff.append(dev_lc[li][sel])
        leaf_const = dev_const[:L]

    has_cat = len(cat_words) > 0
    return Tree(
        num_leaves=nl,
        split_feature=real_feature_idx[split_feature_inner].astype(np.int32),
        threshold_bin=threshold_bin,
        threshold=threshold,
        decision_type=decision_type,
        left_child=np.asarray(arrs.left_child[:M], dtype=np.int32),
        right_child=np.asarray(arrs.right_child[:M], dtype=np.int32),
        split_gain=np.asarray(arrs.split_gain[:M], dtype=np.float64),
        internal_value=np.asarray(arrs.internal_value[:M], dtype=np.float64),
        internal_count=np.asarray(arrs.internal_count[:M], dtype=np.int64),
        leaf_value=np.asarray(arrs.leaf_value[:L], dtype=np.float64),
        leaf_count=np.asarray(arrs.leaf_count[:L], dtype=np.int64),
        leaf_parent=np.asarray(arrs.leaf_parent[:L], dtype=np.int32),
        cat_boundaries=np.asarray(cat_boundaries, dtype=np.int32) if has_cat else None,
        cat_threshold=np.concatenate(cat_words).astype(np.uint32) if has_cat else None,
        leaf_features=leaf_features,
        leaf_coeff=leaf_coeff,
        leaf_const=leaf_const,
    )
