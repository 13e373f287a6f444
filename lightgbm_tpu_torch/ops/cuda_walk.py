"""Wrapper of the hand-written forest-walk kernel (``csrc/walk.cu``).

``ops/predict.forest_predict_raw`` hands each chunk's rank codes and NaN /
zero masks (``ops/cuda_encode.encode_rows``) here for a forest of constant
leaves: :func:`forest_walk_sums` walks every row through every tree and
gives its raw score, the leaf values summed in f64 in tree order. The
source note in ``csrc/walk.cu`` states the arithmetic, the bound and the
design.

The kernel reads the node tables packed into records by :func:`pack_nodes`:
8 bytes a node where the forest's ranges allow, else 16.
``StackedForest.walk_nodes`` packs them once and uploads them once per
device.

Build and load: ``ops/native.py`` (library stem ``libgbdt_walk``);
:func:`declare` binds the C entries. Nothing is built or imported when this
module is imported.

Dispatch: for tensors on the CPU, :func:`forest_walk_sums` runs the plain
version :func:`forest_walk_sums_plain`, the route before the kernel
(``forest_walk_leaves``, then a ``torch.sum`` of the gathered leaf values);
for CUDA tensors it launches the kernel or raises — it never falls back.
The kernel adds in tree order, the plain version in ``torch.sum``'s order,
so the two differ by f64 rounding only: per row at most ``4 T 2**-53
sum_t |v_t|`` over its T leaf values (:func:`sum_tolerance`). Launches are
counted on the host (:func:`launch_count`, :func:`reset_launch_count`); the
rows each route walks are counted in the registry as
``predict.walk.rows_cuda`` and ``predict.walk.rows_plain``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import observability as obs
from . import native
from .native import check_tensor

SOURCE = native.source_path("walk.cu")
STEM = "libgbdt_walk"

_launches = 0          # kernel launches since the last reset


def declare(lib: ctypes.CDLL) -> None:
    """Bind the C entries of ``csrc/walk.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gbdt_forest_walk.argtypes = [p, p, p, p, ll, i, p, i, p, p, i, i, i,
                                     p, p]
    lib.gbdt_forest_walk.restype = i
    lib.gbdt_walk_group.argtypes = [i, i, i, i, i]
    lib.gbdt_walk_group.restype = i


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def pack_nodes(split_feature: np.ndarray, thr_rank: np.ndarray,
               decision: np.ndarray, left: np.ndarray, right: np.ndarray,
               num_leaves: int, num_features: int) -> np.ndarray:
    """The kernel's node records ``[T, M, W]`` int32 from a stacked forest's
    ``[T, M]`` tables. A node's missing type becomes the mask of the row
    word's bit that takes its default side (zero: 2, NaN: 1, else 0).
    W = 2 (8 bytes) where every feature index is below 2**13, every rank
    below 2**16 and every child in int16: feature | mask << 13 | default
    left << 15 | rank << 16, then left | right << 16. Else W = 4: feature |
    mask << 29 | default left << 31, rank, left, right. Raises where a
    child lies outside ``[-num_leaves, M)`` or a feature index outside the
    rows, which the kernel would read out of bounds."""
    T, M = split_feature.shape
    for name, child in (("left", left), ("right", right)):
        if child.size and (child.min() < -num_leaves or child.max() >= M):
            raise ValueError(f"{name} child outside [-{num_leaves}, {M})")
    sf = split_feature.astype(np.int64)
    if num_features > 1 << 29 or (sf.size and (
            sf.min() < 0 or sf.max() >= max(num_features, 1))):
        raise ValueError(f"split feature outside [0, {num_features}) or "
                         f"past 2**29")
    dt = decision.astype(np.int64)
    mt = (dt >> 2) & 3
    mask = np.where(mt == 1, 2, np.where(mt == 2, 1, 0))
    default_left = (dt >> 1) & 1
    thr = thr_rank.astype(np.int64)
    lc, rc = left.astype(np.int64), right.astype(np.int64)
    narrow = (num_features <= 1 << 13 and M <= 1 << 15
              and num_leaves <= 1 << 15
              and (thr.size == 0 or thr.max() < 1 << 16))
    if narrow:
        words = [sf | mask << 13 | default_left << 15 | thr << 16,
                 (lc & 0xFFFF) | (rc & 0xFFFF) << 16]
    else:
        words = [sf | mask << 29 | default_left << 31, thr, lc, rc]
    # each word's low 32 bits, as int32
    return (np.stack(words, axis=-1) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def group_size(forest, device) -> int:
    """Trees the kernel stages in a block's shared memory at once for
    ``forest`` (0: it walks in device memory instead)."""
    lib = native.load(SOURCE, STEM, declare)
    T, M, W = forest.walk_nodes(device).shape
    return int(lib.gbdt_walk_group(len(forest.grids), M, forest.max_leaves,
                                   W, T))


def sum_tolerance(leaf_values: np.ndarray) -> np.ndarray:
    """Per row, how far two sums of the row's T f64 leaf values ``[N, T]``
    taken in different orders may differ: each partial sum rounds by at
    most 2**-53 of its magnitude, which is at most ``sum_t |v_t|``, so two
    orders part by at most ``2 T 2**-53 sum_t |v_t|``; twice that is
    allowed."""
    T = leaf_values.shape[1]
    return 4 * T * 2.0 ** -53 * np.abs(leaf_values).sum(axis=1)


def forest_walk_sums_plain(forest, codes: torch.Tensor, is_nan: torch.Tensor,
                           is_zero: torch.Tensor) -> torch.Tensor:
    """The route before the kernel, in torch ops: the leaves of
    ``forest_walk_leaves`` (the forest's depth in fixed steps) and the
    gathered leaf values summed with ``torch.sum``."""
    from .predict import forest_walk_leaves
    dev = codes.device
    leaves = forest_walk_leaves(*forest.to(dev), codes, is_nan, is_zero,
                                forest.max_depth)
    t_iota = torch.arange(forest.num_trees, device=dev)[None, :]
    return forest.leaf_tables(dev)[0][t_iota, leaves].sum(dim=1)


def forest_walk_sums(forest, codes: torch.Tensor, is_nan: torch.Tensor,
                     is_zero: torch.Tensor) -> torch.Tensor:
    """Raw f64 score ``[N]`` of every row of a chunk under ``forest`` (a
    ``StackedForest`` of constant leaves) from its rank codes (int32) and
    NaN / zero masks, each ``[N, F]`` on one device. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    global _launches
    N, F = codes.shape
    if codes.device.type == "cpu":
        obs.inc("predict.walk.rows_plain", int(N))
        return forest_walk_sums_plain(forest, codes, is_nan, is_zero)
    check_tensor("is_nan", is_nan, (torch.bool,), (N, F))
    check_tensor("is_zero", is_zero, (torch.bool,), (N, F))
    check_tensor("codes", codes, (torch.int32,))
    dev = codes.device
    walk = forest.to(dev)
    root_is_leaf, zero_rank = walk[5], walk[6]
    leaf_value = forest.leaf_tables(dev)[0]
    nodes = forest.walk_nodes(dev)
    T, M, W = nodes.shape
    check_tensor("nodes", nodes, (torch.int32,))
    check_tensor("leaf_value", leaf_value, (torch.float64,),
                 (T, forest.max_leaves))
    check_tensor("root_is_leaf", root_is_leaf, (torch.bool,), (T,))
    check_tensor("zero_rank", zero_rank, (torch.int32,), (max(F, 1),))
    for name, t in (("is_nan", is_nan), ("is_zero", is_zero),
                    ("nodes", nodes), ("leaf_value", leaf_value),
                    ("root_is_leaf", root_is_leaf),
                    ("zero_rank", zero_rank)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device} must be on {dev}")
    lib = native.load(SOURCE, STEM, declare)
    out = torch.empty(N, dtype=torch.float64, device=dev)
    if N == 0:
        return out
    native.launch("walk kernel", lib.gbdt_forest_walk, dev,
                  codes.data_ptr(), is_nan.data_ptr(), is_zero.data_ptr(),
                  zero_rank.data_ptr(), N, F, nodes.data_ptr(), W,
                  leaf_value.data_ptr(), root_is_leaf.data_ptr(), T, M,
                  forest.max_leaves, out.data_ptr())
    _launches += 1
    obs.inc("predict.walk.rows_cuda", int(N))
    return out
