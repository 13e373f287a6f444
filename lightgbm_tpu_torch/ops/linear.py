"""Piecewise-linear leaves: per-leaf ridge models fitted after growth.

Port of ``lightgbm_tpu/ops/linear.py`` (``linear_tree=true``; reference
linear_tree_learner.cpp CalculateLinear; arXiv 1802.05640). After a tree
is grown, every leaf fits a linear model over the numerical features of its
root-to-leaf path (at most ``linear_max_features``, nearest split first)
that minimises the leaf's second-order objective

    sum_r [ g_r * f(x_r) + 1/2 h_r * f(x_r)^2 ] + 1/2 lambda |beta|^2,

whose normal equations are ``(X^T H X + lambda I) beta = -X^T g`` with the
design row ``z = [1, x_f1 .. x_fK]``. Semantics kept exactly:

- rows with a missing value (NaN) in any of the leaf's features are left
  out of the fit and predict the leaf's constant ``leaf_value``; zeros stay
  numeric;
- a leaf keeps its constant output (an empty feature list) when a
  categorical split lies on its path, when it has no numerical path
  feature, when fewer than ``nfeat + 2`` rows are fitted, or when the
  Cholesky factorisation fails;
- shrinkage scales the intercept and the coefficients like the constant.

What differs from the JAX package, and why:

- the moments are accumulated in f64 and the solve runs in f64, its result
  rounded to f32 once (ROADMAP C11's rule for the scans). The accumulation
  is a one-hot matrix product over fixed row chunks (``MOMENT_CHUNK_ROWS``),
  added chunk after chunk: on the card no float atomics decide the order,
  so two runs give the same bits (``index_add_`` and ``bincount`` would
  not), and the card and the CPU differ only by f64 rounding;
- ``torch.linalg.cholesky_ex`` reports a matrix that is not positive
  definite in ``info`` instead of raising; the solve reads it on the device
  (no host sync), as the JAX package reads its NaN factor;
- the path walk runs on the host over the finished tree's few arrays (one
  transfer per tree) and stops at the root, where the JAX package's
  ``fori_loop`` runs a fixed ``max_steps``; it takes node parents from the
  grown nodes only, where the JAX package also reads the scratch node's
  children (ROADMAP C15);
- the per-row output adds the K coefficient terms one after the other, so
  that the card and the CPU add them in the same order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..analysis.contracts.registry import trace_entry

# rows of one chunk of the moment accumulation: its one-hot operand is
# MOMENT_CHUNK_ROWS x (L+1) f64 (512 MB at 255 leaves)
MOMENT_CHUNK_ROWS = 1 << 18


def leaf_path_features(tree, is_cat: torch.Tensor, max_features: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-leaf path features of a grown tree (linear.py:60-113 there).

    Walks each leaf toward the root and collects the first
    ``max_features`` distinct numerical split features, nearest first.
    Returns ``(leaf_feat [L+1, K] i32 (-1 pad), has_cat [L+1] bool,
    nfeat [L+1] i32)`` on the tree's device; a categorical split anywhere
    on the path sets ``has_cat``."""
    dev = tree.leaf_value.device
    L1 = tree.leaf_value.shape[0]
    M1 = tree.left_child.shape[0]
    # the tree's links in one transfer
    links = torch.cat([tree.left_child.long(), tree.right_child.long(),
                       tree.split_feature.long(), tree.is_cat.long(),
                       tree.leaf_parent.long(),
                       tree.num_leaves.long().reshape(1)]).cpu().numpy()
    lc, rc, sf = links[:M1], links[M1:2 * M1], links[2 * M1:3 * M1]
    node_cat = links[3 * M1:4 * M1].astype(bool) | is_cat.cpu().numpy()[
        np.clip(sf, 0, is_cat.shape[0] - 1)]
    K = max_features
    # parent of each internal node from the child links of the grown nodes
    # (leaf_parent covers leaves only; a child c < 0 is leaf ~c). The
    # scratch node is left out: its children are not links of the tree
    real = np.arange(M1) < int(links[-1]) - 1
    node_parent = np.full(M1, -1, np.int64)
    iota = np.arange(M1)
    node_parent[lc[real & (lc >= 0)]] = iota[real & (lc >= 0)]
    node_parent[rc[real & (rc >= 0)]] = iota[real & (rc >= 0)]
    node = links[4 * M1:4 * M1 + L1]
    feats = np.full((L1, K), -1, np.int32)
    nfeat = np.zeros(L1, np.int32)
    has_cat = np.zeros(L1, bool)
    rows = np.arange(L1)
    for _ in range(M1):                      # a path has at most M nodes
        valid = node >= 0
        if not valid.any():
            break
        nid = np.maximum(node, 0)
        f = sf[nid]
        c = node_cat[nid]
        has_cat |= valid & c
        seen = (feats == f[:, None]).any(axis=1)
        add = valid & ~c & ~seen & (nfeat < K)
        feats[rows[add], nfeat[add]] = f[add]
        nfeat += add
        node = np.where(valid, node_parent[nid], -1)
    return (torch.as_tensor(feats, device=dev),
            torch.as_tensor(has_cat, device=dev),
            torch.as_tensor(nfeat, device=dev))


def _gather_leaf_values(Xraw: torch.Tensor, Xmiss: torch.Tensor,
                        feats: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw value and missing flag of each row's K leaf features
    (linear.py:116-133 there); ``feats`` ``[R, K]``, -1 = unused (value 0,
    not missing). ``Xraw`` is NaN-sanitised, ``Xmiss`` its missing plane."""
    used = feats >= 0
    idx = torch.clamp(feats, min=0).long()
    vals = torch.gather(Xraw, 1, idx)
    vals = torch.where(used, vals, torch.zeros((), dtype=vals.dtype,
                                                device=vals.device))
    miss = torch.gather(Xmiss, 1, idx) & used
    return vals, miss


def accumulate_leaf_moments(Xraw, Xmiss, leaf_id, leaf_feat, g, h, included,
                            chunk_rows: int = MOMENT_CHUNK_ROWS):
    """Per-leaf normal-equation moments (linear.py:136-184 there), in f64:
    ``(XTHX [L+1, K+1, K+1], XTg [L+1, K+1], cnt [L+1])`` over the design
    rows ``z = [1, x_f1 .. x_fK]``; a row with a missing leaf feature, or
    outside the bag (``included`` 0), adds nothing. One ``[L+1, R] x [R,
    C]`` product per chunk of rows, the chunks added in order."""
    N = Xraw.shape[0]
    L1, K = leaf_feat.shape
    K1 = K + 1
    dev = Xraw.device
    f64 = torch.float64
    leaf_iota = torch.arange(L1, device=dev, dtype=torch.int32)[None, :]
    acc = torch.zeros((L1, K1 * K1 + K1 + 1), dtype=f64, device=dev)
    for lo in range(0, N, chunk_rows):
        hi_ = min(lo + chunk_rows, N)
        lid = leaf_id[lo:hi_]
        feats = leaf_feat[lid.long()]                            # [R, K]
        vals, miss = _gather_leaf_values(Xraw[lo:hi_], Xmiss[lo:hi_], feats)
        w = included[lo:hi_].to(f64) * (~miss.any(dim=1)).to(f64)
        z = torch.cat([torch.ones((hi_ - lo, 1), dtype=f64, device=dev),
                       vals.to(f64)], dim=1)                     # [R, K1]
        outer = (z[:, :, None] * z[:, None, :]).reshape(hi_ - lo, K1 * K1)
        ch = torch.cat([outer * (h[lo:hi_].to(f64) * w)[:, None],
                        z * (g[lo:hi_].to(f64) * w)[:, None], w[:, None]],
                       dim=1)                                    # [R, C]
        onehot = (lid[:, None] == leaf_iota).to(f64)             # [R, L1]
        acc += onehot.t() @ ch
    XTHX = acc[:, :K1 * K1].reshape(L1, K1, K1)
    XTg = acc[:, K1 * K1:K1 * K1 + K1]
    cnt = acc[:, -1]
    return XTHX, XTg, cnt


def solve_leaf_models(XTHX, XTg, leaf_feat, nfeat, has_cat, cnt,
                      linear_lambda: float):
    """Ridge solve ``(XTHX + lambda I) beta = -XTg`` of every leaf by one
    batched Cholesky (linear.py:187-233 there), in the moments' precision.

    Design dimensions past ``nfeat`` carry an identity diagonal so the
    factorisation stays well posed; the ridge term spares the intercept. A
    leaf is linear iff it has a numerical path feature, no categorical
    split on its path, at least ``nfeat + 2`` fitted rows and a factor
    that succeeded (``info == 0``) with a finite solution. Returns
    ``(leaf_const [L+1] f32, leaf_coeff [L+1, K] f32, leaf_feat' [L+1, K]
    i32, degraded [L+1] bool)``; ``degraded`` marks the fittable leaves
    that keep their constant."""
    L1, K1, _ = XTHX.shape
    dev = XTHX.device
    dt = XTHX.dtype
    iota1 = torch.arange(K1, device=dev)[None, :]
    dim_real = iota1 <= nfeat[:, None]                           # [L+1, K1]
    diag_add = torch.where(
        dim_real, torch.where(iota1 > 0, linear_lambda, 0.0), 1.0).to(dt)
    eye = torch.eye(K1, dtype=torch.bool, device=dev)[None]
    A = XTHX + torch.diag_embed(diag_add)
    pad2 = (~dim_real)[:, :, None] | (~dim_real)[:, None, :]
    A = torch.where(pad2 & ~eye, torch.zeros((), dtype=dt, device=dev), A)
    b = -XTg * dim_real.to(dt)
    chol, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(chol, b[:, :, None], upper=False)
    beta = torch.linalg.solve_triangular(chol.transpose(1, 2), y,
                                         upper=True)[:, :, 0]
    solvable = ((info == 0) & torch.isfinite(beta).all(dim=1)
                & torch.isfinite(torch.diagonal(chol, dim1=1, dim2=2))
                .all(dim=1))
    fittable = (nfeat > 0) & ~has_cat
    ok = fittable & solvable & (cnt >= (nfeat + 2).to(cnt.dtype))
    zero = torch.zeros((), dtype=dt, device=dev)
    leaf_const = torch.where(ok, beta[:, 0], zero).to(torch.float32)
    leaf_coeff = torch.where(ok[:, None] & dim_real[:, 1:], beta[:, 1:],
                             zero).to(torch.float32)
    leaf_feat_out = torch.where(ok[:, None], leaf_feat,
                                torch.full_like(leaf_feat, -1))
    return leaf_const, leaf_coeff, leaf_feat_out, fittable & ~ok


@trace_entry("linear.fit")
def fit_linear_leaves(tree, Xraw, Xmiss, leaf_id, g, h, included, is_cat, *,
                      max_features: int, linear_lambda: float):
    """The whole fit (linear.py:236-261 there): path features, moments,
    batched Cholesky. Runs after ``grow_tree`` on the masked g/h the tree
    grew on, before shrinkage. Returns ``(tree with leaf_feat / leaf_coeff
    / leaf_const set, degraded leaf count as a device scalar)``."""
    leaf_feat, has_cat, nfeat = leaf_path_features(tree, is_cat,
                                                   max_features)
    XTHX, XTg, cnt = accumulate_leaf_moments(
        Xraw, Xmiss, leaf_id, leaf_feat, g, h, included)
    leaf_const, leaf_coeff, leaf_feat, degraded = solve_leaf_models(
        XTHX, XTg, leaf_feat, nfeat, has_cat, cnt, linear_lambda)
    # the scratch row (leaf L) stays inert
    L = tree.leaf_value.shape[0] - 1
    leaf_const[L] = 0.0
    leaf_coeff[L] = 0.0
    leaf_feat[L] = -1
    real = torch.arange(L + 1, device=degraded.device) < tree.num_leaves
    n_degraded = (degraded & real).sum()
    return tree._replace(leaf_feat=leaf_feat, leaf_coeff=leaf_coeff,
                         leaf_const=leaf_const), n_degraded


def linear_cost_report(n_rows: int, num_features: int, num_leaves: int,
                       max_features: int, route: str = "cuda",
                       force: bool = True) -> Optional[Dict]:
    """The linear fit's cost report at one shape class (``lightgbm_tpu/
    ops/linear.py:284-320`` there), analytic (``observability/costs.py``):
    ``flops`` the moments' one-hot products (``2 (L+1) N C`` in f64, ``C
    = (K+1)^2 + K + 2`` channels) and their channel rows (``N (K+1)^2``),
    plus the batched Cholesky and two triangular solves (``(L+1) ((K+1)^3
    / 3 + 2 (K+1)^2)``); arguments the raw f32 slice, its missing plane,
    the leaf ids, g / h / counts and the leaf path features; the output
    the leaf models; the temp one chunk's one-hot and channel matrices
    (f64) and the moments. Published once per site (``linear.fit.k<K>``)
    and shape; an explicit call runs whatever ``costs.enabled()`` says."""
    from ..observability import costs as obs_costs
    N, F, L1, K = int(n_rows), int(num_features), int(num_leaves) + 1, \
        int(max_features)
    K1 = K + 1
    C = K1 * K1 + K1 + 1
    R = min(MOMENT_CHUNK_ROWS, max(N, 1))
    site = f"linear.fit.k{K}"

    def make():
        flops = 2 * L1 * N * C + N * K1 * K1 + L1 * (K1 ** 3 // 3
                                                      + 2 * K1 * K1)
        args = N * F * (4 + 1) + N * 4 + 3 * N * 4 + L1 * K * 4
        out = L1 * (4 + K * 4 + K * 4 + 1)
        temp = R * (L1 + C) * 8 + L1 * C * 8
        return obs_costs.analytic_report(
            site, dict(rows=N, features=F, num_leaves=L1 - 1,
                       max_features=K, chunk_rows=R, route=route),
            flops=flops, bytes_accessed=args + out, argument_bytes=args,
            output_bytes=out, temp_bytes=temp)
    return obs_costs.capture(site, make, fingerprint=(N, F, L1, K, R),
                             force=force)


def linear_leaf_scores(tree, leaf_id, Xraw, Xmiss) -> torch.Tensor:
    """Per-row output ``[N]`` f32 of a linear tree (linear.py:264-281
    there): ``const + sum_k coeff_k * x_k`` for a row in a linear leaf with
    every leaf feature present, the constant ``leaf_value`` otherwise. The
    K terms are added one after the other."""
    lid = leaf_id.long()
    feats = tree.leaf_feat[lid]                                  # [N, K]
    coeff = tree.leaf_coeff[lid]
    vals, miss = _gather_leaf_values(Xraw, Xmiss, feats)
    acc = tree.leaf_const[lid]
    for k in range(feats.shape[1]):
        acc = acc + coeff[:, k] * vals[:, k]
    lin = (feats[:, 0] >= 0) & ~miss.any(dim=1)
    return torch.where(lin, acc, tree.leaf_value[lid])
