"""Exclusive Feature Bundling (EFB): host-side planning and encoding.

A copy of ``lightgbm_tpu/efb.py`` (this package imports nothing of the JAX
package; ``tests/test_torch_efb.py`` pins the copy to the original on the
same inputs). Reference counterpart: Dataset::Construct's FindGroups /
FastFeatureBundling (src/io/dataset.cpp:66-210, :212-295) and the
FeatureGroup bundled-bin encoding (include/LightGBM/feature_group.h:30-52).

EFB packs mutually (almost) exclusive features into one bundled column
whose codes concatenate the members' non-default bin ranges, so the
histogram kernel runs over G bundled columns instead of F features.

Encoding (FeatureGroup::PushData semantics):
- bundle code 0 == every member feature at its default bin;
- member j with original bins ``0..nb_j-1`` and default bin d_j occupies the
  code range ``[lo_j, hi_j)`` where codes map back as
  ``orig_bin = code - off_j``; the default bin has no code (rows at default
  push nothing) and is reconstructed downstream by subtraction from leaf
  totals — the reference's FixHistogram (dataset.cpp:750-769).
- on a conflict row (two members non-default) the later member in group
  order wins; the loser's mass lands in its default bin. Bounded by
  ``max_conflict_rate`` exactly as in the reference.

Everything here is NumPy on the host. Two changes of layout, none of
result: ``_find_groups`` reads each feature's sampled mask as one
contiguous row, and ``materialize_bundles`` walks the rows in blocks so
that its per-member column reads stay in cache whatever the bin matrix's
memory order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


_MAX_SEARCH_GROUPS = 100          # reference max_search_group (dataset.cpp:75)
_SAMPLE_ROWS = 100_000


@dataclass
class BundlePlan:
    """Result of planning + materializing bundles for one dataset.
    ``X_bundled`` is None when planned without a bin matrix (deferred
    device ingest plans from a row sample); ``materialize_bundles`` fills
    it if the plan wins."""
    X_bundled: Optional[np.ndarray]  # [N, G] uint8/uint16 bundled codes
    groups: List[List[int]]        # group -> member (inner) feature indices
    group_total_bins: np.ndarray   # [G] i64 bins per bundled column (incl. 0)
    # per ORIGINAL (inner) feature arrays [F]:
    col: np.ndarray                # bundled column holding feature f
    lo: np.ndarray                 # first bundle code of f's non-default range
    hi: np.ndarray                 # one-past-last bundle code
    off: np.ndarray                # orig_bin = code - off for code in [lo, hi)
    unpack_bin: np.ndarray         # [F, B] bundle-bin for (f, orig_bin); -1 =
                                   # default/invalid (reconstructed by FixHistogram)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def max_bundle_bins(self) -> int:
        return int(self.group_total_bins.max()) if len(self.group_total_bins) else 1


def _find_groups(masks: np.ndarray, counts: np.ndarray, order: np.ndarray,
                 nbins_eff: np.ndarray, max_error_cnt: int, filter_cnt: float,
                 num_data: int, max_group_bins: int) -> List[List[int]]:
    """Greedy conflict-bounded grouping (reference FindGroups,
    dataset.cpp:66-137). ``cols[f]`` is the sampled non-default mask."""
    S = masks.shape[0]
    # one contiguous row per feature: the loop below reads a feature's mask
    # once per group it tries (the original reads the strided column)
    cols = np.ascontiguousarray(masks.T)
    feats: List[List[int]] = []
    marks: List[np.ndarray] = []
    conflict: List[int] = []
    bins: List[int] = []
    for f in order:
        f = int(f)
        placed = False
        avail = [g for g in range(len(feats))
                 if bins[g] + nbins_eff[f] <= max_group_bins]
        # reference searches the newest group + a random subset capped at 100;
        # newest-first over a deterministic cap keeps the same O(1) behavior
        for g in reversed(avail[-_MAX_SEARCH_GROUPS:]):
            rest = max_error_cnt - conflict[g]
            if rest < 0:
                continue
            cnt = int(np.count_nonzero(marks[g] & cols[f]))
            if cnt <= rest:
                rest_nonzero = (counts[f] - cnt) * num_data / max(S, 1)
                if rest_nonzero < filter_cnt:
                    continue
                feats[g].append(f)
                conflict[g] += cnt
                marks[g] |= cols[f]
                bins[g] += int(nbins_eff[f])
                placed = True
                break
        if not placed:
            feats.append([f])
            marks.append(cols[f].copy())
            conflict.append(0)
            bins.append(1 + int(nbins_eff[f]))
    return feats


def build_code_feat(plan: "BundlePlan", cols_pad: int, bins_pad: int,
                    default_bin: np.ndarray) -> np.ndarray:
    """[cols_pad, bins_pad] i32 inverse code map: the member feature owning
    each bundle code, -1 for unowned positions.

    The native bundle-space split scan (ops/split_finder.py
    per_feature_best_bundled) is driven by this table: code 0 (all members
    at default), bin padding, and the default-bin hole at
    ``off[f] + default_bin[f]`` are unowned — the default bin's mass is
    never stored (reference FeatureGroup encoding, feature_group.h:30-52)
    and is reconstructed by subtraction at scan time. For shift-1 members
    (default bin 0) the hole position ``lo - 1`` falls OUTSIDE the member's
    range and must not clobber the neighbouring member's last code, hence
    the in-range test."""
    F = plan.col.shape[0]
    cf = np.full((cols_pad, bins_pad), -1, np.int32)
    for f in range(F):
        g, lo, hi, off = (int(plan.col[f]), int(plan.lo[f]),
                          int(plan.hi[f]), int(plan.off[f]))
        if hi > lo:
            cf[g, lo:hi] = f
            hole = off + int(default_bin[f])
            if lo <= hole < hi:
                cf[g, hole] = -1
    return cf


def sample_row_indices(num_data: int, max_rows: int = _SAMPLE_ROWS,
                       rng_seed: int = 1) -> np.ndarray:
    """The sorted row indices :func:`sample_rows` would draw — exposed so
    a DEFERRED dataset (tpu_ingest, dataset.DeferredBinning) can bin
    exactly this sample through the host oracle and plan from it: the
    plan is a pure function of the sample, so planning from
    ``bin_rows(sample_row_indices(N))`` is bit-identical to planning from
    the materialized matrix."""
    if num_data <= max_rows:
        return np.arange(num_data)
    rng = np.random.RandomState(rng_seed)
    return np.sort(rng.choice(num_data, max_rows, replace=False))


def sample_rows(X_binned: np.ndarray, max_rows: int = _SAMPLE_ROWS,
                rng_seed: int = 1) -> np.ndarray:
    """Deterministic row sample for conflict estimation. Exposed so the
    pre-partitioned path can sample each LOCAL shard, allgather the samples,
    and hand every rank the identical concatenation (the reference plans
    bundles from the same distributed sample it bins from,
    dataset_loader.cpp:820-899)."""
    N = X_binned.shape[0]
    if N <= max_rows:
        return np.asarray(X_binned)
    return X_binned[sample_row_indices(N, max_rows, rng_seed)]


def plan_bundles(X_binned: Optional[np.ndarray], num_bins: np.ndarray,
                 default_bin: np.ndarray, config,
                 max_group_bins: int = 256,
                 rng_seed: int = 1,
                 sample: Optional[np.ndarray] = None,
                 num_data: Optional[int] = None) -> Optional[BundlePlan]:
    """Plan and materialize EFB bundles; None when bundling cannot help.

    Mirrors FastFeatureBundling (dataset.cpp:141-215): try both original and
    by-nonzero-count order, keep the grouping with fewer groups. The
    small-sparse-group breakup (:186-203) is intentionally absent: there is
    no sparse bin storage here — dense bundled columns are always the win.

    ``sample``/``num_data`` override the local sample and global row count
    for the pre-partitioned case: the plan must be a pure function of the
    (identical) sample so every rank derives the same bundling, while the
    materialized codes come from the LOCAL ``X_binned`` shard.

    ``X_binned=None`` (deferred device ingest) plans WITHOUT a bin matrix
    — ``sample`` and ``num_data`` are then required, and the returned
    plan's ``X_bundled`` is None until :func:`materialize_bundles` fills
    it (only a winning plan pays that host materialization).
    """
    if X_binned is None:
        assert sample is not None and num_data is not None
        N, F = int(num_data), sample.shape[1]
    else:
        N, F = X_binned.shape
    if F < 2:
        return None
    # conflict estimation on a row sample (the reference uses its
    # bin-construction sample; we sample the materialized bin matrix)
    if sample is None:
        sample = sample_rows(X_binned, rng_seed=rng_seed)
    if num_data is None:
        num_data = N
    S = sample.shape[0]

    masks = sample != default_bin[None, :]                   # non-default mask
    counts = np.count_nonzero(masks, axis=0)
    nbins_eff = num_bins - (default_bin == 0).astype(np.int64)

    max_error_cnt = int(S * getattr(config, "max_conflict_rate", 0.0))
    filter_cnt = (0.95 * getattr(config, "min_data_in_leaf", 20)
                  / max(num_data, 1) * S)

    order1 = np.arange(F)
    order2 = np.argsort(-counts, kind="stable")
    g1 = _find_groups(masks, counts, order1, nbins_eff, max_error_cnt,
                      filter_cnt, num_data, max_group_bins)
    g2 = _find_groups(masks, counts, order2, nbins_eff, max_error_cnt,
                      filter_cnt, num_data, max_group_bins)
    groups = g2 if len(g2) < len(g1) else g1
    if len(groups) >= F:
        return None                                           # nothing bundled

    G = len(groups)
    B = int(num_bins.max())
    col = np.zeros(F, np.int32)
    lo = np.zeros(F, np.int32)
    hi = np.zeros(F, np.int32)
    off = np.zeros(F, np.int32)
    unpack_bin = np.full((F, B), -1, np.int32)
    group_total_bins = np.zeros(G, np.int64)

    for g, members in enumerate(groups):
        if len(members) == 1:
            # singleton: keep original codes (no re-encoding); default bin is
            # still reconstructed by subtraction like every other feature
            f = members[0]
            col[f] = g
            lo[f], hi[f], off[f] = 0, int(num_bins[f]), 0
            b = np.arange(int(num_bins[f]))
            unpack_bin[f, b] = b
            unpack_bin[f, int(default_bin[f])] = -1
            group_total_bins[g] = int(num_bins[f])
            continue
        total = 1                                             # code 0 = all-default
        for f in members:
            shift = 1 if default_bin[f] == 0 else 0
            nb = int(num_bins[f])
            col[f] = g
            lo[f] = total
            hi[f] = total + nb - shift
            off[f] = total - shift
            b = np.arange(nb)
            codes = b + off[f]
            valid = (b != default_bin[f]) & (codes >= lo[f]) & (codes < hi[f])
            unpack_bin[f, b[valid]] = codes[valid]
            total += nb - shift
        group_total_bins[g] = total

    plan = BundlePlan(None, groups, group_total_bins, col, lo, hi, off,
                      unpack_bin)
    if X_binned is not None:
        plan.X_bundled = materialize_bundles(plan, X_binned, default_bin)
    return plan


def materialize_bundles(plan: BundlePlan, X_binned: np.ndarray,
                        default_bin: np.ndarray,
                        block_rows: int = 1 << 14) -> np.ndarray:
    """[N, G] bundled codes for an existing plan (FeatureGroup::PushData
    semantics: later member wins on conflict rows), written block of rows
    by block of rows; the only full-size allocation is the result."""
    N = X_binned.shape[0]
    G = len(plan.groups)
    dtype = np.uint8 if plan.group_total_bins.max() <= 255 else np.uint16
    Xb = np.zeros((N, G), dtype=dtype)
    for lo in range(0, N, block_rows):
        rows = slice(lo, min(lo + block_rows, N))
        for g, members in enumerate(plan.groups):
            if len(members) == 1:
                Xb[rows, g] = X_binned[rows, members[0]].astype(dtype)
                continue
            out = Xb[rows, g]
            for f in members:                             # later member wins
                codes = X_binned[rows, f].astype(np.int64)
                nz = codes != default_bin[f]
                out[nz] = (codes[nz] + plan.off[f]).astype(dtype)
    return Xb
