"""Vectorised tree traversal on the device.

Port of ``lightgbm_tpu/ops/predict.py`` for the slice: the binned-data
walk and training score update (``leaves_from_binned``,
``add_tree_scores``) and the batch forest predictor behind
``Booster.predict`` (``StackedForest``, ``forest_walk_leaves`` at
predict.py:300, ``forest_predict_raw`` at :411; reference
predictor.hpp:25-241, Tree::GetLeaf tree.h:434-487).

Float thresholds are rank-encoded on the host: per feature, the sorted
unique thresholds of the whole forest form a grid; each raw value maps to
its rank by f64 ``searchsorted`` (exact), each node stores its threshold's
rank, and the device walks every tree with integer compares only — so
traversal is exact and agrees with the host predictor row for row. Missing
values follow NumericalDecision (tree.h:218-243) through per-(row,
feature) NaN / zero masks. Leaf values are summed in f64 on the device.
The rank-encoded walk covers numerical splits; a forest holding a
categorical split is predicted by the host ``Tree.predict`` instead, said
once per process, as the JAX package does (predict.py:423-440). A forest
of linear leaves (``forest_walk_linear``, predict.py:349-396 there) adds
each leaf's ``const + coeff . x`` over the raw f32 values (the leaf's
constant where a leaf feature is missing) and sums the trees in f32, as
the JAX package does. The binned-data walk takes categorical nodes by their
left-set masks, and bundled (EFB) codes through ``decode_bundled_bin``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..binning import K_ZERO_RANGE
from ..grower import decode_bundled_bin
from ..utils.log import Log

# the host route for categorical forests is said once per process
_CATEGORICAL_HOST_ROUTE = {"logged": False}


def leaves_from_binned(tree, Xb: torch.Tensor, num_bins: torch.Tensor,
                       missing_code: torch.Tensor, default_bin: torch.Tensor,
                       bundle=None, has_cat=None) -> torch.Tensor:
    """Leaf index ``[N]`` of every row of a binned matrix, for one grower
    ``TreeArrays``; a categorical node sends a row left iff its bin is in
    the node's left set (reference Tree::CategoricalDecision,
    tree.h:257-284). With ``bundle`` (``grower.BundleDecode``) ``Xb`` holds
    bundled codes, decoded per node. ``has_cat`` says whether the tree may
    hold categorical splits (the booster's ``spec.use_categorical``; None:
    read from the tree). The walk reads the host once per tree level;
    a booster's valid sets get the same ids from the grower's routing
    (``grower.TreeGrower``), which needs no walk."""
    N = Xb.shape[0]
    sf = tree.split_feature.long()
    mc, nb, db = missing_code[sf], num_bins[sf], default_bin[sf]
    miss_bin = torch.where(mc == 2, nb - 1, torch.where(mc == 1, db, -1))
    cur = torch.zeros(N, dtype=torch.int64, device=Xb.device)
    if int(tree.num_leaves) <= 1:
        return torch.zeros(N, dtype=torch.int32, device=Xb.device)
    if has_cat is None:
        has_cat = bool(tree.is_cat.any())
    B = tree.cat_mask.shape[1]
    flat_mask = tree.cat_mask.reshape(-1)
    for _ in range(tree.leaf_value.shape[0]):     # depth <= num_leaves
        at_node = cur >= 0
        if not bool(at_node.any()):
            break
        nid = torch.clamp(cur, min=0)
        f = sf[nid]
        if bundle is None:
            b = torch.gather(Xb, 1, f[:, None])[:, 0].to(torch.int32)
        else:
            b = decode_bundled_bin(Xb, f, bundle, default_bin)
        go_left = torch.where(b == miss_bin[nid], tree.default_left[nid],
                              b <= tree.threshold_bin[nid])
        if has_cat:
            go_left = torch.where(tree.is_cat[nid],
                                  flat_mask[nid * B + b.long()], go_left)
        child = torch.where(go_left, tree.left_child[nid],
                            tree.right_child[nid]).long()
        cur = torch.where(at_node, child, cur)
    return (-cur - 1).to(torch.int32)


def add_tree_scores(score: torch.Tensor, tree, leaf_ids: torch.Tensor
                    ) -> torch.Tensor:
    """score + leaf_value[leaf] — the leaf-partition fast path of the
    training score update (ScoreUpdater::AddScore, score_updater.hpp:49-56)."""
    return score + tree.leaf_value[leaf_ids.long()]


class StackedForest:
    """Host-built stacked arrays for a list of model-space Trees,
    rank-encoded for the integer device walk of their numerical splits
    (``has_categorical``: the forest goes to the host instead)."""

    def __init__(self, trees, num_features: int):
        self.has_categorical = any(
            (np.asarray(t.decision_type) & 1).any() for t in trees)
        T = len(trees)
        M = max([t.num_internal for t in trees] + [1])
        L = max([t.num_leaves for t in trees] + [1])
        self.num_trees = T
        # linear leaves: -1-padded (feature, coefficient) tables per leaf
        # for the walk's epilogue; None when every leaf is constant
        self.has_linear = any(t.is_linear for t in trees)
        self.leaf_const32 = self.leaf_coeff32 = self.leaf_feat = None
        if self.has_linear:
            Kf = max(max((len(f) for f in t.leaf_features), default=0)
                     for t in trees if t.leaf_features is not None)
            Kf = max(Kf, 1)
            self.leaf_const32 = np.zeros((T, L), np.float32)
            self.leaf_coeff32 = np.zeros((T, L, Kf), np.float32)
            self.leaf_feat = np.full((T, L, Kf), -1, np.int32)
            for i, t in enumerate(trees):
                if t.leaf_features is None:
                    continue
                self.leaf_const32[i, :len(t.leaf_const)] = t.leaf_const
                for li, feats in enumerate(t.leaf_features):
                    if len(feats):
                        self.leaf_feat[i, li, :len(feats)] = feats
                        self.leaf_coeff32[i, li, :len(feats)] = \
                            t.leaf_coeff[li]
        split_feature = np.zeros((T, M), np.int32)
        thr_rank = np.zeros((T, M), np.int32)
        decision = np.zeros((T, M), np.uint8)
        left = np.full((T, M), -1, np.int32)
        right = np.full((T, M), -1, np.int32)
        leaf_value = np.zeros((T, L), np.float64)
        root_is_leaf = np.zeros(T, bool)

        grids = [[] for _ in range(num_features)]
        for t in trees:
            for n in range(t.num_internal):
                grids[int(t.split_feature[n])].append(float(t.threshold[n]))
        self.grids = [np.array(sorted(set(g)), np.float64) for g in grids]

        for i, t in enumerate(trees):
            m = t.num_internal
            if m == 0 or t.num_leaves <= 1:
                root_is_leaf[i] = True
                leaf_value[i, 0] = t.leaf_value[0] if len(t.leaf_value) \
                    else 0.0
                continue
            split_feature[i, :m] = t.split_feature[:m]
            decision[i, :m] = t.decision_type[:m]
            left[i, :m] = t.left_child[:m]
            right[i, :m] = t.right_child[:m]
            leaf_value[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            for n in range(m):
                # with value codes c(v) = #{g < v}, v <= thr <=> c(v) <= rank
                thr_rank[i, n] = np.searchsorted(
                    self.grids[int(t.split_feature[n])],
                    float(t.threshold[n]), side="left")
        self.split_feature = split_feature
        self.thr_rank = thr_rank
        self.decision = decision
        self.left = left
        self.right = right
        self.leaf_value = leaf_value
        self.root_is_leaf = root_is_leaf
        # rank of 0.0 per feature: what a NaN becomes when the node's
        # missing type is not nan (tree.h:224-227)
        self.zero_rank = np.array(
            [np.searchsorted(g, 0.0, side="left") for g in self.grids]
            or [0], np.int32)

    def encode_rows(self, X: np.ndarray):
        """Raw ``[N, F]`` f64 -> (rank codes i32, NaN mask, zero mask)."""
        N, F = X.shape
        is_nan = np.isnan(X)
        is_zero = is_nan | (np.abs(np.where(is_nan, 0.0, X)) <= K_ZERO_RANGE)
        codes = np.zeros((N, F), np.int32)
        for f, grid in enumerate(self.grids):
            if len(grid):
                codes[:, f] = np.searchsorted(grid, X[:, f], side="left")
        return codes, is_nan, is_zero

    def to(self, device):
        """The stacked arrays as device tensors, in walk argument order."""
        return [torch.as_tensor(a, device=device) for a in
                (self.split_feature, self.thr_rank, self.decision, self.left,
                 self.right, self.root_is_leaf, self.zero_rank)]


def forest_walk_leaves(split_feature, thr_rank, decision, left, right,
                       root_is_leaf, zero_rank, codes, is_nan, is_zero
                       ) -> torch.Tensor:
    """Leaf index ``[N, T]`` for every (row, tree); integer-exact. All T
    trees advance together, one frontier step per tree level."""
    T, M = split_feature.shape
    N = codes.shape[0]
    t_iota = torch.arange(T, device=codes.device)[None, :]          # [1, T]
    cur = torch.where(root_is_leaf[None, :], -1, 0).to(torch.int64)
    cur = cur.expand(N, T).contiguous()
    decision = decision.to(torch.int32)
    for _ in range(M + 1):                       # depth <= internal nodes
        at_node = cur >= 0
        if not bool(at_node.any()):
            break
        nid = torch.clamp(cur, min=0)
        f = split_feature[t_iota, nid].long()                       # [N, T]
        node_dt = decision[t_iota, nid]
        v_rank = torch.gather(codes, 1, f)
        v_nan = torch.gather(is_nan, 1, f)
        v_zero = torch.gather(is_zero, 1, f)
        missing_type = (node_dt >> 2) & 3
        default_left = (node_dt & 2) != 0
        v_rank_eff = torch.where(v_nan & (missing_type != 2),
                                 zero_rank[f], v_rank)
        is_default = torch.where(missing_type == 1, v_zero,
                                 (missing_type == 2) & v_nan)
        go_left = torch.where(is_default, default_left,
                              v_rank_eff <= thr_rank[t_iota, nid])
        child = torch.where(go_left, left[t_iota, nid],
                            right[t_iota, nid]).long()
        cur = torch.where(at_node, child, cur)
    return -cur - 1


def forest_walk_linear(leaves, leaf_value32, leaf_const, leaf_coeff,
                       leaf_feat, raw, raw_nan) -> torch.Tensor:
    """Leaf output ``[N, T]`` f32 of a linear forest from its walked
    ``leaves`` ``[N, T]``: ``const + sum_k coeff_k * x_k`` over the
    NaN-sanitized raw values ``raw`` ``[N, F]`` (f32), or the leaf's
    constant where a leaf feature is missing (``raw_nan``) or the leaf has
    no features — the host ``Tree.predict``'s rule."""
    N, T = leaves.shape
    Kf = leaf_feat.shape[2]
    t_iota = torch.arange(T, device=leaves.device)[None, :]
    feats = leaf_feat[t_iota, leaves]                           # [N, T, Kf]
    coeff = leaf_coeff[t_iota, leaves]
    const = leaf_const[t_iota, leaves]
    base = leaf_value32[t_iota, leaves]
    idx = torch.clamp(feats, min=0).long().reshape(N, T * Kf)
    vals = torch.gather(raw, 1, idx).reshape(N, T, Kf)
    miss = torch.gather(raw_nan, 1, idx).reshape(N, T, Kf)
    used = feats >= 0
    vals = torch.where(used, vals, torch.zeros((), dtype=vals.dtype,
                                                device=vals.device))
    lin = used[..., 0] & ~(miss & used).any(dim=2)
    acc = const + (coeff * vals).sum(dim=2)
    return torch.where(lin, acc, base)


def forest_predict_raw(trees, X: np.ndarray, num_features: int, device,
                       chunk_rows: int = 1 << 16) -> np.ndarray:
    """Raw-score batch prediction of a forest on ``device``: f64 ``[N]``.

    Rows are rank-encoded on the host in chunks, walked on the device, and
    their leaf values summed over trees in f64 there (a linear forest: its
    leaf outputs in f32, as the JAX package's walk). A forest holding a
    categorical split is predicted by the host ``Tree.predict``, as in the
    JAX package (predict.py:423-440)."""
    forest = StackedForest(trees, num_features)
    if forest.has_categorical:
        if not _CATEGORICAL_HOST_ROUTE["logged"]:
            _CATEGORICAL_HOST_ROUTE["logged"] = True
            Log.info("forest holds categorical splits: batch predict takes "
                     "the host Tree.predict for it, as the JAX package does")
        Xh = np.asarray(X, np.float64)
        out = np.zeros(Xh.shape[0], np.float64)
        for t in trees:
            out += t.predict(Xh)
        return out
    dev = forest.to(device)
    leaf_value = torch.as_tensor(forest.leaf_value, device=device)
    t_iota = torch.arange(forest.num_trees, device=device)[None, :]
    if forest.has_linear:
        lin = [torch.as_tensor(a, device=device) for a in (
            forest.leaf_value.astype(np.float32), forest.leaf_const32,
            forest.leaf_coeff32, forest.leaf_feat)]
    out = np.zeros(X.shape[0], np.float64)
    for lo in range(0, X.shape[0], chunk_rows):
        chunk = np.asarray(X[lo:lo + chunk_rows], np.float64)
        codes, is_nan, is_zero = forest.encode_rows(chunk)
        leaves = forest_walk_leaves(
            *dev, torch.as_tensor(codes, device=device),
            torch.as_tensor(is_nan, device=device),
            torch.as_tensor(is_zero, device=device))
        if forest.has_linear:
            # the epilogue reads raw f32 values, NaN set to 0 beside the
            # missing plane (predict.py:470-477 there)
            raw32 = chunk.astype(np.float32)
            raw_nan = np.isnan(raw32)
            np.nan_to_num(raw32, copy=False, nan=0.0)
            outs = forest_walk_linear(
                leaves, *lin, torch.as_tensor(raw32, device=device),
                torch.as_tensor(raw_nan, device=device))
            out[lo:lo + chunk_rows] = outs.sum(dim=1).cpu().numpy()
        else:
            out[lo:lo + chunk_rows] = leaf_value[t_iota, leaves].sum(
                dim=1).cpu().numpy()
    return out
