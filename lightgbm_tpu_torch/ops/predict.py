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
feature) NaN / zero masks. The forest walk runs the forest's depth in
fixed steps and reads nothing on the host, so a batch chunk reads it once
(its result) and the serving engine captures the walk into CUDA graphs;
leaf values are summed in f64 on the device (``Booster.predict``) or on
the host in tree order (the serving engine).
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

from typing import Dict, Optional

import numpy as np
import torch

from .. import observability as obs
from ..analysis.contracts.registry import trace_entry
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
    (``has_categorical``: the forest goes to the host instead).
    ``max_depth`` is the most walk steps any row needs, counted from the
    child arrays, so the walk runs a fixed number of steps and reads
    nothing on the host."""

    # elements (rows * features) up to which ``encode_rows`` takes the one
    # complex searchsorted over the concatenated grid; past it the
    # per-feature loop's cheaper float compares win (the JAX package's
    # crossover, predict.py:240-245 there; both branches give equal codes)
    VEC_ENCODE_MAX_ELEMS = 8192

    def __init__(self, trees, num_features: int):
        self.has_categorical = any(
            (np.asarray(t.decision_type) & 1).any() for t in trees)
        T = len(trees)
        M = max([t.num_internal for t in trees] + [1])
        L = max([t.num_leaves for t in trees] + [1])
        self.num_trees = T
        self.max_leaves = L
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

        # per-feature threshold grid over the numerical splits of the forest
        grids = [[] for _ in range(num_features)]
        for t in trees:
            for n in range(t.num_internal):
                if not (t.decision_type[n] & 1):
                    grids[int(t.split_feature[n])].append(
                        float(t.threshold[n]))
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
                if not (t.decision_type[n] & 1):
                    # with value codes c(v) = #{g < v}:
                    # v <= thr <=> c(v) <= rank
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
        self.max_depth = _max_depth(left, right, root_is_leaf)
        # the tree list, for the serving path's linear-leaf epilogue
        # (``Tree.leaf_outputs``) on the host
        self._trees = trees
        # rank of 0.0 per feature: what a NaN becomes when the node's
        # missing type is not nan (tree.h:224-227)
        self.zero_rank = np.array(
            [np.searchsorted(g, 0.0, side="left") for g in self.grids]
            or [0], np.int32)
        # the grids concatenated, keyed (feature, threshold) as complex128:
        # numpy sorts complex numbers lexicographically with exact float
        # compares on each part, so one searchsorted over the concatenation
        # gives every per-feature searchsorted's code (ties and +-inf
        # included; NaN keys sort past every segment and are patched)
        self.grid_sizes = np.array([len(g) for g in self.grids], np.int64)
        self.grid_offsets = np.concatenate(
            ([0], np.cumsum(self.grid_sizes))).astype(np.int64)
        total = int(self.grid_offsets[-1]) if len(self.grid_sizes) else 0
        self._grid_keys = np.empty(total, np.complex128)
        if total:
            self._grid_keys.real = np.repeat(
                np.arange(len(self.grids)), self.grid_sizes)
            self._grid_keys.imag = np.concatenate(
                [g for g in self.grids if len(g)])
        self._feat_iota = np.arange(num_features, dtype=np.float64)
        self._device_tensors = {}

    @property
    def leaf_value64(self) -> np.ndarray:
        """The f64 leaf values ``[T, L]`` the serving path adds on the host
        in tree order (``leaf_value`` is already f64 here)."""
        return self.leaf_value

    def encode_rows(self, X: np.ndarray):
        """Raw ``[N, F]`` f64 -> (rank codes i32, NaN mask, zero mask).

        c(v) = #{grid thresholds < v} (f64 on the host), so the device's
        integer compare c(v) <= rank(thr) is the f64 compare v <= thr,
        ties included. Small batches take the one searchsorted over the
        concatenated grid, large ones the per-feature loop
        (``VEC_ENCODE_MAX_ELEMS``); both give equal codes."""
        N, F = X.shape
        is_nan = np.isnan(X)
        # missing_type zero treats NaN as 0 first (tree.h:224-227)
        is_zero = is_nan | (np.abs(np.where(is_nan, 0.0, X)) <= K_ZERO_RANGE)
        if N * F <= self.VEC_ENCODE_MAX_ELEMS and self._grid_keys.size:
            codes = self._encode_vectorized(X, is_nan)
        else:
            codes = self._encode_loop(X)
        return codes, is_nan, is_zero

    def _encode_loop(self, X: np.ndarray) -> np.ndarray:
        """Per-feature searchsorted: the reference the vectorised branch is
        held to, and the large-batch branch."""
        N, F = X.shape
        codes = np.zeros((N, F), np.int32)
        for f, grid in enumerate(self.grids):
            if len(grid):
                codes[:, f] = np.searchsorted(grid, X[:, f], side="left")
        return codes

    def _encode_vectorized(self, X: np.ndarray, is_nan: np.ndarray
                           ) -> np.ndarray:
        """One searchsorted over the concatenated (feature, threshold)
        grid: the complex compare selects the feature's segment, then
        compares the thresholds in f64."""
        keys = np.empty(X.shape, np.complex128)
        keys.real = self._feat_iota[None, :]
        keys.imag = X
        flat = np.searchsorted(self._grid_keys, keys.ravel(), side="left")
        codes = (flat.reshape(X.shape)
                 - self.grid_offsets[:-1][None, :]).astype(np.int32)
        if is_nan.any():
            # a NaN key sorts past every segment; the loop's
            # searchsorted(grid, nan) is len(grid)
            codes[is_nan] = np.broadcast_to(
                self.grid_sizes[None, :].astype(np.int32), X.shape)[is_nan]
        return codes

    def to(self, device):
        """The stacked arrays as device tensors, in walk argument order
        (uploaded once per device and kept)."""
        return self._on(device)[0]

    def leaf_tables(self, device):
        """``[leaf_value]`` f64 on ``device``, and for a linear forest the
        f32 leaf values, constants, coefficients and features of the walk's
        epilogue after it (uploaded once per device and kept)."""
        return self._on(device)[1]

    def _on(self, device):
        key = str(device)
        got = self._device_tensors.get(key)
        if got is None:
            walk = [torch.as_tensor(a, device=device) for a in
                    (self.split_feature, self.thr_rank, self.decision,
                     self.left, self.right, self.root_is_leaf,
                     self.zero_rank)]
            leaf = [self.leaf_value]
            if self.has_linear:
                leaf += [self.leaf_value.astype(np.float32),
                         self.leaf_const32, self.leaf_coeff32,
                         self.leaf_feat]
            got = self._device_tensors[key] = (
                walk, [torch.as_tensor(a, device=device) for a in leaf])
        return got


def _max_depth(left: np.ndarray, right: np.ndarray,
               root_is_leaf: np.ndarray) -> int:
    """The most internal nodes on any root-to-leaf path of a stacked
    forest: the walk steps its deepest row takes (0 when every tree is a
    leaf). Counted level by level over all trees at once; a child index
    below 0 is a leaf."""
    M = left.shape[1]
    ti = np.nonzero(~root_is_leaf)[0]
    ni = np.zeros(len(ti), np.int64)
    depth = 0
    while ti.size:
        depth += 1
        if depth > M:
            raise ValueError("forest child arrays hold a cycle")
        lc, rc = left[ti, ni], right[ti, ni]
        ti = np.concatenate([ti[lc >= 0], ti[rc >= 0]])
        ni = np.concatenate([lc[lc >= 0], rc[rc >= 0]]).astype(np.int64)
    return depth


@trace_entry("predict.forest_walk")
def forest_walk_leaves(split_feature, thr_rank, decision, left, right,
                       root_is_leaf, zero_rank, codes, is_nan, is_zero,
                       depth: int) -> torch.Tensor:
    """Leaf index ``[N, T]`` int32 for every (row, tree); integer-exact.

    All T trees advance together, one frontier step per tree level, for
    exactly ``depth`` steps (``StackedForest.max_depth``): a row at a leaf
    is left as it is by a later step, so the leaves are those of the JAX
    package's ``while_loop`` (predict.py:300-346 there), and nothing is
    read on the host. The steps are fixed-shape device ops, so the
    serving engine captures them into one CUDA graph per batch bucket."""
    T, M = split_feature.shape
    N = codes.shape[0]
    # the node tables flattened, indexed by tree * M + node
    base = torch.arange(T, device=codes.device)[None, :] * M        # [1, T]
    sf = split_feature.reshape(-1).long()
    thr = thr_rank.reshape(-1)
    dt = decision.reshape(-1).to(torch.int32)
    lc = left.reshape(-1).long()
    rc = right.reshape(-1).long()
    cur = torch.where(root_is_leaf, -1, 0).long()[None, :].expand(N, T)
    for _ in range(depth):
        at_node = cur >= 0
        idx = base + torch.clamp(cur, min=0)                        # [N, T]
        f = sf[idx]
        node_dt = dt[idx]
        v_rank = torch.gather(codes, 1, f)
        v_nan = torch.gather(is_nan, 1, f)
        v_zero = torch.gather(is_zero, 1, f)
        missing_type = (node_dt >> 2) & 3
        default_left = (node_dt & 2) != 0
        # NaN converts to 0 unless missing_type is nan (tree.h:224-227);
        # in rank space 0.0 is the feature's zero_rank
        v_rank_eff = torch.where(v_nan & (missing_type != 2),
                                 zero_rank[f], v_rank)
        is_default = torch.where(missing_type == 1, v_zero,
                                 (missing_type == 2) & v_nan)
        go_left = torch.where(is_default, default_left,
                              v_rank_eff <= thr[idx])
        child = torch.where(go_left, lc[idx], rc[idx])
        cur = torch.where(at_node, child, cur)
    return (-cur - 1).to(torch.int32)


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


def forest_cost_report(forest: "StackedForest", rows: int,
                       route: str) -> Optional[Dict]:
    """The forest walk's cost report (``lightgbm_tpu/ops/predict.py:
    470-480`` there), analytic from the dispatch's shapes
    (``observability/costs.py``), once per forest shape and chunk rows:
    ``flops`` one compare per (row, tree, walk step) and one add per (row,
    tree); arguments the chunk's rank codes (i32) and NaN / zero masks,
    the node tables and the f64 leaf values (with linear leaves also the
    raw f32 values, their missing plane and the leaf models); the output
    the chunk's f64 raw scores; ``bytes_accessed`` arguments plus output,
    each read or written once. Gated on ``costs.enabled()``."""
    from ..observability import costs as obs_costs
    T, M = forest.split_feature.shape
    L = forest.leaf_value.shape[1]
    F = len(forest.grids)
    linear = bool(forest.has_linear)
    site = "predict.forest_walk" + (".linear" if linear else "")

    def make():
        args = rows * F * (4 + 1 + 1) + T * M * (4 + 4 + 1 + 4 + 4) \
            + T + F * 4 + T * L * 8
        if linear:
            Kf = forest.leaf_feat.shape[2]
            args += rows * F * (4 + 1) + T * L * (4 + 4 + Kf * 8)
        out = rows * 8
        ops = rows * T * (max(forest.max_depth, 1) + 1)
        return obs_costs.analytic_report(
            site, dict(rows=int(rows), trees=int(T), depth=int(
                forest.max_depth), route=route),
            flops=ops, bytes_accessed=args + out, argument_bytes=args,
            output_bytes=out)
    return obs_costs.capture(
        site, make, fingerprint=(int(rows), F, int(T), int(L), M, linear,
                                 int(forest.max_depth)))


def forest_predict_raw(trees, X: np.ndarray, num_features: int, device,
                       chunk_rows: int = 1 << 16,
                       forest: "StackedForest" = None) -> np.ndarray:
    """Raw-score batch prediction of a forest on ``device``: f64 ``[N]``.

    Rows are rank-encoded on the host in chunks, walked on the device, and
    their leaf values summed over trees in f64 there (a linear forest: its
    leaf outputs in f32, as the JAX package's walk); each chunk reads the
    host once, for its result. Pass a prebuilt ``forest`` (the booster's
    cache) to stack and upload it once across calls. A forest holding a
    categorical split is predicted by the host ``Tree.predict``, as in the
    JAX package (predict.py:423-440). Each chunk runs in four spans:
    ``predict.encode`` (the host rank encode), ``predict.upload`` (its
    copies), ``predict.walk`` (the walk and the sum, enqueued) and
    ``predict.fetch`` (the wait for its result)."""
    if forest is None:
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
    leaf_value, *lin = forest.leaf_tables(device)
    t_iota = torch.arange(forest.num_trees, device=device)[None, :]
    out = np.zeros(X.shape[0], np.float64)
    for lo in range(0, X.shape[0], chunk_rows):
        chunk = np.asarray(X[lo:lo + chunk_rows], np.float64)
        if lo == 0:
            # the walk's cost report, once per shape (host arithmetic)
            forest_cost_report(forest, chunk.shape[0],
                               "cuda" if torch.device(device).type == "cuda"
                               else "plain")
        with obs.span("predict.encode", rows=chunk.shape[0]):
            codes, is_nan, is_zero = forest.encode_rows(chunk)
        # uploads that do not wait for the card: the chunk's one host read
        # is its result
        with obs.span("predict.upload"):
            inputs = [torch.from_numpy(a).to(device, non_blocking=True)
                      for a in (codes, is_nan, is_zero)]
        with obs.span("predict.walk"):
            leaves = forest_walk_leaves(*dev, *inputs, forest.max_depth)
            if forest.has_linear:
                # the epilogue reads raw f32 values, NaN set to 0 beside
                # the missing plane (predict.py:470-477 there)
                raw32 = chunk.astype(np.float32)
                raw_nan = np.isnan(raw32)
                np.nan_to_num(raw32, copy=False, nan=0.0)
                sums = forest_walk_linear(
                    leaves, *lin, *(torch.from_numpy(a).to(
                        device, non_blocking=True)
                        for a in (raw32, raw_nan))).sum(dim=1)
            else:
                sums = leaf_value[t_iota, leaves].sum(dim=1)
        with obs.span("predict.fetch"):
            out[lo:lo + chunk_rows] = sums.cpu().numpy()
    return out
