"""Leaf-wise tree growth in waves, as PyTorch on one device.

Port of the serial resident path of ``lightgbm_tpu/grower.py``
(``GrowerSpec``, ``TreeArrays``, ``BundleDecode``, ``decode_bundled_bin``,
``GrowState``, ``_empty_tree``, ``_apply_wave_splits`` :312-503,
``_route_rows`` :507-561, ``grow_tree`` :565-886; reference
SerialTreeLearner::Train,
serial_tree_learner.cpp:152-231). The JAX package runs the wave loop as a
``lax.while_loop`` inside one jit. Here :class:`TreeGrower` holds the
loop's carry in buffers allocated once per shape and grows one tree in
three parts: ``begin`` (the per-tree prologue, in place), ``wave`` (one
wave, which never reads a device value on the host, so that it can be
captured in a CUDA graph and replayed) and ``finish`` (the epilogue). The
leaf count, the ``done`` flag and the count of waves run stay on the device
(``GrowState.flags``); a wave after ``done`` applies nothing and leaves
every real row of the state as it was, so a caller may run more waves than
a tree needs. :func:`grow_tree` is the eager loop: it reads ``done`` after
each wave. Each wave:

1. gives every leaf that needs a histogram a slot, in ascending leaf order;
2. builds the pending slots' histograms in one pass of the hand-written
   kernel (``ops/cuda_histogram.py``) over the pending leaves' segments of
   the carried partition ``perm`` (its plain version on the CPU), sized on
   the device from the slots' row counts; under data-parallel the pass's
   integer sums are reduce-scattered over the ranks before their one
   conversion (``comm.reduce_sums``), at the world's scales;
3. derives each sibling's histogram by parent-minus-smaller-child
   subtraction from the ``[L+1, F, B, 3]`` cache (serial_tree_learner.cpp
   :354-362);
4. scans the 2S touched leaves for their best split (``ops/split_finder``);
5. applies up to ``wave_size`` splits in global gain order — with
   ``wave_size=1`` exactly the reference's leaf-wise order;
6. writes the tree arrays and per-leaf state;
7. routes the rows of split leaves through a ``[L+1, 6]`` split table, and
   the rows of every valid set given to the grower through its first six
   columns (the same decision ``ops/predict.leaves_from_binned`` walks);
8. re-partitions only the split leaves' segments of ``perm``, stably, by
   prefix sums (never a sort): left rows to the front, right rows to the
   back, row order kept (the reference's DataPartition::Split,
   data_partition.hpp:94), as one scatter in which a position outside the
   split leaves maps to itself.

:class:`StreamedGrower` runs the same waves with the code matrix in host
shards (``tpu_residency=stream``): each wave routes and histograms shard by
shard into a carried accumulator, with no partition.

Under EFB (``bundle`` given) ``X`` holds the bundled columns: histograms
are built, cached and subtracted in bundle space ``[.., G, Bb, ..]``, the
split scan runs there (``ops/split_finder.per_feature_best_bundled``), and
the routing table carries the split feature's bundle column and code range,
so that a row's decision compares its bundled code directly. Tree arrays
are always in original feature space.

State tensors are updated in place (the JAX package's carry is immutable
and aliased by XLA; in place here keeps every address fixed, which a
replayed graph needs, and saves one copy of the histogram cache per wave).
A constant is written with ``fill_`` / ``index_fill_``, never as ``t[i] =
0.5``, which copies a host scalar and which a capture refuses.
Rows ``L`` (leaves) and ``M`` (nodes) are scratch: masked writes land
there, in no fixed order on the card, and ``finish`` resets the ones a
tree's consumers read. Each wave's steps 2, 3-6, 7 and 8 run under
``torch.profiler.record_function`` ranges (``wave.histogram``,
``wave.split``, ``wave.route``, ``wave.partition``), which cost nothing
measurable without an active profiler and give ``chip_smoke.py`` its
per-step breakdown of eager waves only: inside a CUDA graph a range fires
at capture, never at a replay. The captured iteration's parts are timed
by ``boosting/gbdt._PartClock`` between the replays. Tie-breaks follow the JAX package exactly: ``lax.top_k`` at
grower.py:390 prefers the lowest leaf index among equal gains, which a
stable descending sort reproduces (``torch.topk`` promises no tie order).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from .ops.cuda_histogram import HistogramAccumulator, build_histograms_cuda
from .analysis.contracts.registry import trace_entry
from .ops.histogram import device_code_dtype, table_lookup, unpack_codes
from .robustness import allowed_host_sync
from .ops.split_finder import SplitCandidates, leaf_output

NEG_INF = float("-inf")


class TreeArrays(NamedTuple):
    """Array-based tree, LightGBM layout (reference tree.h:356-395), the
    JAX package's field for field. Internal node arrays have ``L-1`` real
    rows plus one scratch row; leaf arrays ``L`` plus one. A child ``c >=
    0`` is an internal node; ``c < 0`` encodes leaf ``~c``."""
    split_feature: torch.Tensor    # i32 [M+1] inner feature index
    threshold_bin: torch.Tensor    # i32 [M+1]
    default_left: torch.Tensor     # bool [M+1]
    is_cat: torch.Tensor           # bool [M+1]
    cat_mask: torch.Tensor         # bool [M+1, B]
    left_child: torch.Tensor       # i32 [M+1]
    right_child: torch.Tensor      # i32 [M+1]
    split_gain: torch.Tensor       # f32 [M+1]
    internal_value: torch.Tensor   # f32 [M+1]
    internal_count: torch.Tensor   # f32 [M+1]
    leaf_value: torch.Tensor       # f32 [L+1]
    leaf_count: torch.Tensor       # f32 [L+1]
    leaf_parent: torch.Tensor      # i32 [L+1]
    num_leaves: torch.Tensor       # i32 scalar: leaves grown
    # linear leaves (ops/linear.py), set after growth, None otherwise:
    # inner feature indices (-1 pad; all -1 = constant leaf), coefficients
    # and intercept; leaf_value stays the missing-value / degraded output
    leaf_feat: Optional[torch.Tensor] = None    # i32 [L+1, K]
    leaf_coeff: Optional[torch.Tensor] = None   # f32 [L+1, K]
    leaf_const: Optional[torch.Tensor] = None   # f32 [L+1]


class BundleDecode(NamedTuple):
    """EFB decode tables on the device (``efb.BundlePlan``, per original
    feature f): ``orig_bin = code - off[f]`` for a code of column
    ``col[f]`` in ``[lo[f], hi[f])``, else ``default_bin[f]``.
    ``unpack_bin[f, b]`` is the code holding bin b (-1 for the default
    bin, which is rebuilt by subtraction); ``code_feat[g, c]`` the member
    owning code c of column g (-1: code 0, padding, the default-bin hole)."""
    col: torch.Tensor          # i32 [F]
    lo: torch.Tensor           # i32 [F]
    hi: torch.Tensor           # i32 [F]
    off: torch.Tensor          # i32 [F]
    unpack_bin: torch.Tensor   # i32 [F, B]
    code_feat: torch.Tensor    # i32 [G, Bb]


def decode_bundled_bin(Xb: torch.Tensor, f: torch.Tensor,
                       bundle: BundleDecode,
                       default_bin: torch.Tensor) -> torch.Tensor:
    """Original bin of feature ``f[i]`` for every row ``i`` of the bundled
    matrix (grower.py:105-121 there); the binned walk of a bundled matrix
    decodes through it."""
    fl = f.long()
    c = torch.gather(Xb, 1, bundle.col[fl][:, None].long())[:, 0] \
        .to(torch.int32)
    in_rng = (c >= bundle.lo[fl]) & (c < bundle.hi[fl])
    return torch.where(in_rng, c - bundle.off[fl], default_bin[fl])


@dataclass
class GrowState:
    """Per-tree wave state (the JAX package's while_loop carry), in buffers
    that keep their addresses from tree to tree."""
    tree: TreeArrays
    leaf_id: torch.Tensor          # i32 [N]
    hist: torch.Tensor             # f32 [L+1, F|G, B|Bb, 3] per-leaf cache
    sum_g: torch.Tensor            # f32 [L+1]
    sum_h: torch.Tensor            # f32 [L+1]
    cnt: torch.Tensor              # f32 [L+1]
    leaf_depth: torch.Tensor       # i32 [L+1]
    leaf_is_right: torch.Tensor    # bool [L+1]
    cand: SplitCandidates          # per-leaf best split, arrays [L+1]
    needs_hist: torch.Tensor       # bool [L+1]
    sib_leaf: torch.Tensor         # i64 [L+1] sibling derived by subtraction
    parent_cache: torch.Tensor     # i64 [L+1] cache row of the parent
    # i64 [3]: leaves grown, done (0/1), waves run while not done — read on
    # the host only by the eager loop and once per tree by a replay
    flags: torch.Tensor
    # incremental leaf partition: rows of leaf l sit at positions
    # [seg_start[l], seg_start[l] + seg_rows[l]) of perm, ascending
    perm: torch.Tensor             # i32 [N]
    seg_start: torch.Tensor        # i32 [L+1]
    seg_rows: torch.Tensor         # i32 [L+1] raw row counts
    # leaf of every row of each valid set routed alongside: i32 [Nv]
    valid_leaf: List[torch.Tensor] = field(default_factory=list)


@dataclass(frozen=True)
class GrowerSpec:
    """Static configuration of the grower."""
    num_leaves: int
    num_features: int
    num_bins_padded: int
    hist_slots: int               # leaves histogrammed per pass
    wave_size: int                # splits applied per wave (1 = leaf-wise)
    max_depth: int                # <= 0: unlimited
    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    row_compact: bool = True      # passes over the pending segments (else
                                  # positions derived on the device)
    # categorical split search (reference config.h:230-234)
    cat_features: tuple = ()      # inner indices of categorical features;
                                  # the scan runs on these columns only
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    hist_bins: int = 0            # bin axis of the histograms under EFB
                                  # (Bb_pad); 0 = num_bins_padded

    def hyperparams(self) -> Dict[str, float]:
        return dict(lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
                    min_data_in_leaf=self.min_data_in_leaf,
                    min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
                    min_gain_to_split=self.min_gain_to_split)

    @property
    def use_categorical(self) -> bool:
        return bool(self.cat_features)

    def cat_hyperparams(self) -> Dict[str, float]:
        return dict(cat_smooth=self.cat_smooth, cat_l2=self.cat_l2,
                    max_cat_threshold=self.max_cat_threshold,
                    max_cat_to_onehot=self.max_cat_to_onehot,
                    min_data_per_group=self.min_data_per_group)


def waves_for_tree(num_leaves: int, wave_size: int, hist_slots: int) -> int:
    """Host-side wave-count model of the wave loop, for telemetry
    attribution (``GBDT.publish_telemetry``; ``lightgbm_tpu/grower.py:
    246-257``): a tree that finished with ``num_leaves`` leaves applied
    ``num_leaves - 1`` splits in batches of ``min(wave_size, hist_slots)``.
    Derived from the finished tree alone (no per-wave device traffic); it
    undercounts by the terminal no-split wave when growth stopped on gain
    rather than the leaf budget, which the derived ``wave`` spans say with
    their ``derived`` tag."""
    cap = max(1, min(wave_size, hist_slots) if wave_size > 0 else hist_slots)
    splits = max(0, int(num_leaves) - 1)
    return max(1, -(-splits // cap))


def _empty_tree(L: int, B: int, device) -> TreeArrays:
    M = L - 1
    i32, f32 = torch.int32, torch.float32
    return TreeArrays(
        split_feature=torch.zeros(M + 1, dtype=i32, device=device),
        threshold_bin=torch.zeros(M + 1, dtype=i32, device=device),
        default_left=torch.zeros(M + 1, dtype=torch.bool, device=device),
        is_cat=torch.zeros(M + 1, dtype=torch.bool, device=device),
        cat_mask=torch.zeros((M + 1, B), dtype=torch.bool, device=device),
        left_child=torch.full((M + 1,), -1, dtype=i32, device=device),
        right_child=torch.full((M + 1,), -1, dtype=i32, device=device),
        split_gain=torch.zeros(M + 1, dtype=f32, device=device),
        internal_value=torch.zeros(M + 1, dtype=f32, device=device),
        internal_count=torch.zeros(M + 1, dtype=f32, device=device),
        leaf_value=torch.zeros(L + 1, dtype=f32, device=device),
        leaf_count=torch.zeros(L + 1, dtype=f32, device=device),
        leaf_parent=torch.full((L + 1,), -1, dtype=i32, device=device),
        num_leaves=torch.ones((), dtype=i32, device=device),
    )


def _empty_cand(L: int, B: int, device) -> SplitCandidates:
    f32 = torch.float32
    return SplitCandidates(
        gain=torch.full((L + 1,), NEG_INF, dtype=f32, device=device),
        feature=torch.zeros(L + 1, dtype=torch.int32, device=device),
        threshold=torch.zeros(L + 1, dtype=torch.int32, device=device),
        default_left=torch.zeros(L + 1, dtype=torch.bool, device=device),
        left_g=torch.zeros(L + 1, dtype=f32, device=device),
        left_h=torch.zeros(L + 1, dtype=f32, device=device),
        left_c=torch.zeros(L + 1, dtype=f32, device=device),
        is_cat=torch.zeros(L + 1, dtype=torch.bool, device=device),
        cat_mask=torch.zeros((L + 1, B), dtype=torch.bool, device=device),
    )


def _apply_wave_splits(state: GrowState, new_hist: torch.Tensor,
                       leaf_of_slot: torch.Tensor, live: torch.Tensor,
                       nl: torch.Tensor, bm, spec: GrowerSpec, comm,
                       num_bins: torch.Tensor, missing_code: torch.Tensor,
                       default_bin: torch.Tensor, table0: torch.Tensor,
                       bundle: Optional[BundleDecode] = None,
                       scan_bundle: Optional[BundleDecode] = None):
    """Steps 3-6 of a wave plus the ``[L+1, 6]`` routing table (``[L+1,
    11]`` with ``bundle``), updating ``state`` in place except the per-row
    fields (leaf_id and the partition) and ``flags``, which the caller
    owns. ``live`` (0-d bool) is false once the tree is done: then no split
    is applied and only scratch rows are written. ``nl`` is the leaf count
    before the wave (0-d i64), ``table0`` the table of a wave that splits
    nothing. Returns ``(table, map_mask, p, q, n_apply)`` with ``map_mask``
    the ``[L+1, B]`` categorical left sets of the split leaves (None
    without categorical features), ``p``/``q`` the per-slot split / new
    right leaves (``L`` where no split was applied) and ``n_apply`` a 0-d
    i64 tensor. ``scan_bundle`` (default ``bundle``) is the decode table
    the split scan reads: a rank's block view under the bundled
    distributed strategies (``comm.localize_bundle``); the routing table
    always reads the global ``bundle``. Reads nothing on the host (the
    strategies' collectives aside)."""
    L = spec.num_leaves
    M = L - 1
    S = spec.hist_slots
    dev = new_hist.device
    leaf_iota = torch.arange(L + 1, device=dev)

    # ---- 3. cache write + sibling by subtraction -----------------------
    slot_valid = leaf_of_slot < L
    sibs = state.sib_leaf[leaf_of_slot]                        # [S]
    parent_hist = state.hist[state.parent_cache[leaf_of_slot]]  # [S, F, B, 3]
    sib_hist = parent_hist - new_hist
    sib_rows = torch.where(slot_valid, sibs, L)
    state.hist[torch.where(slot_valid, leaf_of_slot, L)] = new_hist
    state.hist[sib_rows] = sib_hist

    # ---- 4. split scan for the 2S touched leaves -----------------------
    scan_leaves = torch.cat([leaf_of_slot, sib_rows])
    scan_hist = torch.cat([new_hist, sib_hist], dim=0)         # [2S, F, B, 3]
    cand_new = comm.find_splits(
        scan_hist, state.sum_g[scan_leaves], state.sum_h[scan_leaves],
        state.cnt[scan_leaves], bm, spec,
        bundle if scan_bundle is None else scan_bundle)
    for old, new in zip(state.cand, cand_new):
        old[scan_leaves] = new
    cand = state.cand
    cand.gain[L].fill_(NEG_INF)             # keep the scratch row inert
    # every pending leaf was built; once done, nothing was pending
    state.needs_hist.logical_and_(~live)

    # ---- 5. choose the splits to apply this wave ------------------------
    active = leaf_iota < nl
    depth_ok = ((spec.max_depth <= 0) | (state.leaf_depth < spec.max_depth))
    gains = torch.where(active & depth_ok & torch.isfinite(cand.gain),
                        cand.gain, NEG_INF)
    # lax.top_k order: descending gain, lowest leaf index first on a tie;
    # a sort of the [L+1] leaf gains, not of the rows
    top_gain, top_leaf = torch.sort(  # torch-lint: disable=R007
        gains, descending=True, stable=True)
    top_gain, top_leaf = top_gain[:S], top_leaf[:S]
    budget = L - nl
    cap = min(spec.wave_size, S) if spec.wave_size > 0 else S
    srank = torch.arange(S, device=dev)
    apply = (torch.isfinite(top_gain) & (srank < budget) & (srank < cap)
             & live)
    n_apply = apply.sum()

    # ---- 6. apply: tree arrays + leaf state ----------------------------
    p = torch.where(apply, top_leaf, L)                         # split leaf
    nid = torch.where(apply, nl - 1 + srank, M)                 # new node
    q = torch.where(apply, nl + srank, L)                       # new leaf

    lg, lh, lc = cand.left_g[p], cand.left_h[p], cand.left_c[p]
    pg, ph, pc = state.sum_g[p], state.sum_h[p], state.cnt[p]
    rg_, rh_, rc_ = pg - lg, ph - lh, pc - lc
    l1, l2 = spec.lambda_l1, spec.lambda_l2

    t = state.tree
    t.split_feature[nid] = cand.feature[p]
    t.threshold_bin[nid] = cand.threshold[p]
    t.default_left[nid] = cand.default_left[p]
    t.is_cat[nid] = cand.is_cat[p]
    t.cat_mask[nid] = cand.cat_mask[p]
    t.split_gain[nid] = cand.gain[p]
    t.internal_value[nid] = leaf_output(pg, ph, l1, l2)
    t.internal_count[nid] = pc
    t.left_child[nid] = (-p - 1).to(torch.int32)
    t.right_child[nid] = (-q - 1).to(torch.int32)
    # re-wire the parent pointer that used to reach leaf p
    prev_node = t.leaf_parent[p].long()
    was_right = state.leaf_is_right[p]
    wire = apply & (prev_node >= 0)
    wire_left = torch.where(wire & ~was_right, prev_node, M)
    wire_right = torch.where(wire & was_right, prev_node, M)
    nid32 = nid.to(torch.int32)
    t.left_child[wire_left] = torch.where(apply, nid32,
                                          t.left_child[wire_left])
    t.right_child[wire_right] = torch.where(apply, nid32,
                                            t.right_child[wire_right])
    t.leaf_parent[p] = nid32
    t.leaf_parent[q] = nid32
    t.leaf_value[p] = leaf_output(lg, lh, l1, l2)
    t.leaf_value[q] = leaf_output(rg_, rh_, l1, l2)
    t.leaf_count[p] = lc
    t.leaf_count[q] = rc_
    t.num_leaves.copy_(nl + n_apply)
    state.leaf_is_right.index_fill_(0, p, False)
    state.leaf_is_right.index_fill_(0, q, True)

    state.sum_g[p], state.sum_g[q] = lg, rg_
    state.sum_h[p], state.sum_h[q] = lh, rh_
    state.cnt[p], state.cnt[q] = lc, rc_
    new_depth = state.leaf_depth[p] + 1
    state.leaf_depth[p] = new_depth
    state.leaf_depth[q] = new_depth
    cand.gain.index_fill_(0, p, NEG_INF)
    cand.gain.index_fill_(0, q, NEG_INF)

    # next wave: histogram the smaller child, derive the larger
    left_smaller = lc <= rc_
    smaller = torch.where(left_smaller, p, q)
    larger = torch.where(left_smaller, q, p)
    state.needs_hist[smaller] = apply
    state.needs_hist[L].fill_(False)
    state.sib_leaf[smaller] = larger
    state.parent_cache[smaller] = torch.where(apply, p, L)

    # ---- routing table, one row per split leaf -------------------------
    # 0: split feature (-1 = leaf not split this wave)  1: threshold bin
    # 2: missing bin (-1 = none; reference NumericalDecision, tree.h:218)
    # 3: right-child leaf   4: default_left   5: is_cat
    # under EFB, the split feature's bundle coordinates (grower.py:467-490
    # there), resolved here for the chosen splits only:
    # 6: bundled column   7: lo   8: hi   9: off   10: default bin
    sf = cand.feature[p].long()
    sf_safe = torch.clamp(sf, min=0)
    mc_s, nb_s, db_s = (missing_code[sf_safe], num_bins[sf_safe],
                        default_bin[sf_safe])
    miss_bin = torch.where(mc_s == 2, nb_s - 1,
                           torch.where(mc_s == 1, db_s, -1))
    cols = [sf, cand.threshold[p].long(), miss_bin.long(), q,
            cand.default_left[p].long(), cand.is_cat[p].long()]
    if bundle is not None:
        cols += [bundle.col[sf_safe].long(), bundle.lo[sf_safe].long(),
                 bundle.hi[sf_safe].long(), bundle.off[sf_safe].long(),
                 db_s.long()]
    table = table0.clone()
    table[p] = torch.stack(cols, dim=-1).to(torch.int32)
    table[L] = table0[L]                    # the scratch leaf splits nothing

    map_mask = None
    if spec.use_categorical:
        map_mask = torch.zeros((L + 1, cand.cat_mask.shape[1]),
                               dtype=torch.bool, device=dev)
        map_mask[p] = cand.cat_mask[p]
        map_mask[L].fill_(False)
    return table, map_mask, p, q, n_apply


def _route_rows(X: torch.Tensor, lid: torch.Tensor, table: torch.Tensor,
                map_mask: Optional[torch.Tensor] = None):
    """Step 7: apply one wave's routing table to the rows of ``X``; with
    ``map_mask`` a categorical split sends a row left iff its bin is in the
    leaf's left set (reference Tree::CategoricalDecision, tree.h:257-284).
    An 11-column table routes bundled codes: a row reads its split
    feature's bundled column, and a code outside the member's ``[lo, hi)``
    is the member's default bin (the reference's DenseBin::Split
    min_bin/max_bin compare). Returns ``(leaf_id, f_row, go_left,
    right_row)``; the last three feed the partition maintenance (step 8)."""
    packed = table_lookup(lid.long(), table)                    # [N, 6|11]
    f_row = packed[:, 0]
    thr_row = packed[:, 1]
    miss_row = packed[:, 2]
    right_row = packed[:, 3]
    dl_row = packed[:, 4] != 0
    if table.shape[1] > 6:
        c = torch.gather(X, 1, packed[:, 6:7].long())[:, 0].to(torch.int32)
        in_rng = (c >= packed[:, 7]) & (c < packed[:, 8])
        x_bin = torch.where(in_rng, c - packed[:, 9], packed[:, 10])
    else:
        f_safe = torch.clamp(f_row, min=0).long()
        x_bin = torch.gather(X, 1, f_safe[:, None])[:, 0].to(torch.int32)
    go_left = torch.where(x_bin == miss_row, dl_row, x_bin <= thr_row)
    if map_mask is not None:
        # one gather from the flat [L+1, B] mask (the JAX package's
        # one-hot lookup is a TPU idiom)
        B = map_mask.shape[1]
        go_left_cat = map_mask.reshape(-1)[lid.long() * B + x_bin.long()]
        go_left = torch.where(packed[:, 5] != 0, go_left_cat, go_left)
    leaf_id = torch.where(f_row >= 0, torch.where(go_left, lid, right_row),
                          lid)
    return leaf_id, f_row, go_left, right_row


def _partition(state: GrowState, f_row, go_left, right_row, p, q,
               nl_before: torch.Tensor) -> None:
    """Step 8: stable re-partition of the split leaves' segments of
    ``perm`` by prefix sums; leaf p keeps the front of its old segment (its
    go-left rows, original order), new leaf q takes the back. One scatter
    writes the new permutation: a position outside the split leaves maps
    to itself, so every position is written once (no boolean indexing,
    hence no host read)."""
    L = state.seg_rows.shape[0] - 1
    N = state.perm.shape[0]
    i32 = torch.int32
    k_row = torch.where(f_row >= 0, right_row - nl_before, -1)
    code_row = torch.where(f_row >= 0,
                           2 * k_row + (~go_left).to(i32), -1)
    code_pos = code_row[state.perm.long()]                      # by position
    in_split = code_pos >= 0
    left_pos = in_split & ((code_pos & 1) == 0)
    right_pos = in_split & ((code_pos & 1) == 1)
    k_pos = (code_pos >> 1).long()                              # -1 stays -1
    cl = torch.cumsum(left_pos.long(), 0)                       # inclusive
    cr = torch.cumsum(right_pos.long(), 0)
    zero = cl.new_zeros(1)
    cl0 = torch.cat([zero, cl])           # lefts strictly before position j
    cr0 = torch.cat([zero, cr])
    start_k = state.seg_start[p].long()                         # [S]
    n_k = state.seg_rows[p].long()
    clb = cl0[start_k]
    crb = cr0[start_k]
    nL = cl0[start_k + n_k] - clb                               # left rows
    k_safe = torch.clamp(k_pos, min=0)
    base_l = torch.where(k_pos >= 0, (start_k - clb)[k_safe], 0)
    base_r = torch.where(k_pos >= 0, (start_k + nL - crb)[k_safe], 0)
    newpos = torch.where(left_pos, cl - left_pos.long() + base_l,
                         cr - right_pos.long() + base_r)
    newpos = torch.where(in_split, newpos,
                         torch.arange(N, device=newpos.device))
    state.perm.copy_(torch.empty_like(state.perm).scatter_(0, newpos,
                                                           state.perm))
    state.seg_start[q] = (start_k + nL).to(i32)
    state.seg_rows[p] = nL.to(i32)
    state.seg_rows[q] = (n_k - nL).to(i32)
    # the scratch leaf must stay an empty segment
    state.seg_start[L].fill_(0)
    state.seg_rows[L].fill_(0)


class TreeGrower:
    """Grows one tree at a time on buffers allocated once: the histogram
    cache, the candidates, the tree arrays, the partition and the row
    inputs of the tree being grown (``grad``, ``hess``, ``included``,
    ``feature_ok``, ``scales``). ``begin`` resets them in place for a new
    tree, ``wave`` runs one wave and ``finish`` closes the tree; none of
    them reads a device value on the host or moves a tensor to another
    address, so each can be captured in a CUDA graph and replayed.

    ``route`` holds the binned (unbundled) codes of valid sets: every wave
    routes their rows too, into ``state.valid_leaf``, so that a tree's
    valid leaf ids need no walk after it."""

    def __init__(self, X: torch.Tensor, is_cat: torch.Tensor,
                 num_bins: torch.Tensor, missing_code: torch.Tensor,
                 default_bin: torch.Tensor, spec: GrowerSpec, comm=None,
                 bundle: Optional[BundleDecode] = None,
                 route: Sequence[torch.Tensor] = ()):
        if comm is None:
            from .parallel.comm import SerialComm
            comm = SerialComm(spec.num_features)
        self.X = X
        self.X_hist = comm.hist_X(X)
        self._setup(X.shape[0], self.X_hist.shape[1], X.device, is_cat,
                    num_bins, missing_code, default_bin, spec, comm, bundle,
                    route, partition=True)

    def _setup(self, N: int, F_hist: int, dev: torch.device,
               is_cat: torch.Tensor, num_bins: torch.Tensor,
               missing_code: torch.Tensor, default_bin: torch.Tensor,
               spec: GrowerSpec, comm, bundle: Optional[BundleDecode],
               route: Sequence[torch.Tensor], partition: bool) -> None:
        """The buffers of ``N`` rows histogrammed over ``F_hist`` code
        columns; ``partition`` False leaves the partition ``perm`` empty
        (passes over every row)."""
        self.num_rows = N
        self.spec, self.comm, self.bundle = spec, comm, bundle
        self.num_bins, self.missing_code = num_bins, missing_code
        self.default_bin = default_bin
        self.is_cat = is_cat
        self.route = list(route)
        # the scan's decode table: a rank's block view under the bundled
        # distributed strategies
        self.scan_bundle = comm.localize_bundle(bundle) \
            if bundle is not None and comm.bundled_blocks else bundle
        L, S = spec.num_leaves, spec.hist_slots
        B = spec.num_bins_padded
        self.B_hist = spec.hist_bins or B          # Bb_pad under EFB
        i32, f32 = torch.int32, torch.float32
        F_cache = comm.reduced_hist_features(F_hist)
        # the tree being grown: its rows' g/h, count mask and features
        self.grad = torch.zeros(N, dtype=f32, device=dev)
        self.hess = torch.zeros(N, dtype=f32, device=dev)
        self.included = torch.zeros(N, dtype=f32, device=dev)
        self.feature_ok = torch.ones(spec.num_features, dtype=torch.bool,
                                     device=dev)
        # one fixed-point scale per tree for g and one for h (ops/histogram)
        self.scales = torch.ones(2, dtype=torch.float64, device=dev)
        self.cat_idx = torch.tensor(spec.cat_features, dtype=torch.long,
                                    device=dev) \
            if spec.use_categorical else None
        self.bm = comm.block_meta(self.feature_ok, num_bins, missing_code,
                                  default_bin, is_cat, self.cat_idx)
        # row-sharded data-parallel: the pass's integer sums, and this
        # rank's block of the world's sums, reduced before one conversion
        self.acc = self.acc_block = None
        if comm.reduces_sums:
            self.acc = HistogramAccumulator(S, F_hist, self.B_hist, dev)
            self.acc_block = HistogramAccumulator(S, F_cache, self.B_hist,
                                                  dev)
        ncols = 6 if bundle is None else 11
        self.table0 = torch.zeros((L + 1, ncols), dtype=i32, device=dev)
        self.table0[:, 0] = -1
        self.table0[:, 2] = -1
        self.row_iota = torch.arange(N if partition else 0, dtype=i32,
                                     device=dev)
        self.flags0 = torch.tensor([1, 0, 0], dtype=torch.int64, device=dev)
        self.state = GrowState(
            tree=_empty_tree(L, B, dev),
            leaf_id=torch.zeros(N, dtype=i32, device=dev),
            hist=torch.zeros((L + 1, F_cache, self.B_hist, 3), dtype=f32,
                             device=dev),
            sum_g=torch.zeros(L + 1, dtype=f32, device=dev),
            sum_h=torch.zeros(L + 1, dtype=f32, device=dev),
            cnt=torch.zeros(L + 1, dtype=f32, device=dev),
            leaf_depth=torch.zeros(L + 1, dtype=i32, device=dev),
            leaf_is_right=torch.zeros(L + 1, dtype=torch.bool, device=dev),
            cand=_empty_cand(L, B, dev),
            needs_hist=torch.zeros(L + 1, dtype=torch.bool, device=dev),
            sib_leaf=torch.full((L + 1,), L, dtype=torch.int64, device=dev),
            parent_cache=torch.full((L + 1,), L, dtype=torch.int64,
                                    device=dev),
            flags=self.flags0.clone(),
            perm=self.row_iota.clone(),
            seg_start=torch.zeros(L + 1, dtype=i32, device=dev),
            seg_rows=torch.zeros(L + 1, dtype=i32, device=dev),
            valid_leaf=[torch.zeros(Xv.shape[0], dtype=i32, device=dev)
                        for Xv in self.route],
        )

    def begin(self, grad: torch.Tensor, hess: torch.Tensor,
              included: torch.Tensor, feature_ok: torch.Tensor) -> None:
        """The per-tree prologue: take the tree's inputs, its root sums and
        fixed-point scales, and reset the state to a one-leaf tree."""
        st, L = self.state, self.spec.num_leaves
        self.grad.copy_(grad)
        self.hess.copy_(hess)
        self.included.copy_(included)
        self.feature_ok.copy_(feature_ok)
        if self.comm.bundled_blocks:
            # the block mask is a new tensor: take this tree's features
            self.bm = self.comm.block_meta(
                self.feature_ok, self.num_bins, self.missing_code,
                self.default_bin, self.is_cat, self.cat_idx)
        # the world's root sums and fixed-point scales under the row-sharded
        # strategies (parallel/comm.py), this device's otherwise
        rg, rh, rc = self.comm.root_sums(self.grad, self.hess, self.included)
        self.scales.copy_(self.comm.histogram_scales(self.grad, self.hess))
        t = st.tree
        for a in (t.split_feature, t.threshold_bin, t.default_left, t.is_cat,
                  t.cat_mask, t.split_gain, t.internal_value,
                  t.internal_count, t.leaf_value, t.leaf_count,
                  st.leaf_id, st.hist, st.sum_g, st.sum_h, st.cnt,
                  st.leaf_depth, st.leaf_is_right, st.needs_hist,
                  st.seg_start, st.seg_rows, *st.valid_leaf,
                  *[c for c in st.cand if c is not st.cand.gain]):
            a.zero_()
        for a in (t.left_child, t.right_child, t.leaf_parent):
            a.fill_(-1)
        t.num_leaves.fill_(1)
        st.cand.gain.fill_(NEG_INF)
        st.sib_leaf.fill_(L)
        st.parent_cache.fill_(L)
        st.sum_g[0], st.sum_h[0], st.cnt[0] = rg, rh, rc
        st.needs_hist[0].fill_(True)
        st.seg_rows[0].fill_(self.num_rows)
        st.flags.copy_(self.flags0)
        st.perm.copy_(self.row_iota)

    @trace_entry("grower.wave")
    def wave(self) -> None:
        """One wave (steps 1-8 of the module docstring). Reads nothing on
        the host; after ``done`` it applies no split and leaves every real
        row of the state bit-identical."""
        spec, st, comm = self.spec, self.state, self.comm
        L, S = spec.num_leaves, spec.hist_slots
        nl = st.flags[0].clone()                   # leaves before the wave
        live = st.flags[1] == 0
        slot_of_leaf, leaf_of_slot = self._slots(live)

        # ---- 2. one pass builds the S histograms ------------------------
        with record_function("wave.histogram"):
            slot_counts = st.seg_rows[leaf_of_slot]             # [S]
            if self.acc is not None:
                self.acc.zero_()
            compact = dict(row_idx=st.perm, slot_counts=slot_counts,
                           slot_starts=st.seg_start[leaf_of_slot]) \
                if spec.row_compact else {}
            new_hist = build_histograms_cuda(
                self.X_hist, self.grad, self.hess, self.included,
                st.leaf_id, slot_of_leaf, S, self.B_hist,
                scales=self.scales, acc=self.acc, **compact)
            if self.acc is not None:
                # the integer sums, reduced over the ranks, then converted
                new_hist = comm.reduce_sums(self.acc, self.acc_block) \
                    .finalize(self.scales)
            else:
                new_hist = comm.reduce_hist(new_hist)

        # ---- 3-6 + routing table ------------------------------------------
        with record_function("wave.split"):
            table, map_mask, p, q, n_apply = _apply_wave_splits(
                st, new_hist, leaf_of_slot, live, nl, self.bm, spec, comm,
                self.num_bins, self.missing_code, self.default_bin,
                self.table0, self.bundle, self.scan_bundle)

        # ---- 7. route the rows of split leaves ----------------------------
        with record_function("wave.route"):
            leaf_id, f_row, go_left, right_row = _route_rows(
                self.X, st.leaf_id, table, map_mask)
            for Xv, lid in zip(self.route, st.valid_leaf):
                lid.copy_(_route_rows(Xv, lid, table[:, :6], map_mask)[0])

        # ---- 8. incremental partition maintenance -------------------------
        with record_function("wave.partition"):
            _partition(st, f_row, go_left, right_row, p, q, nl)
        st.leaf_id.copy_(leaf_id)
        done = ~live | (n_apply == 0) | (nl + n_apply >= L)
        st.flags.copy_(torch.stack([nl + n_apply, done.long(),
                                    st.flags[2] + live.long()]))

    def _slots(self, live: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step 1: a slot for every leaf needing a histogram, ascending:
        ``(slot_of_leaf [L+1] i32, -1 = none; leaf_of_slot [S] i64, L =
        none)``."""
        L, S = self.spec.num_leaves, self.spec.hist_slots
        dev = self.state.flags.device
        pending = self.state.needs_hist & live
        slot_rank = torch.cumsum(pending.long(), 0) - 1
        slot_of_leaf = torch.where(pending, slot_rank, -1).to(torch.int32)
        leaf_of_slot = torch.full((S + 1,), L, dtype=torch.int64, device=dev)
        leaf_of_slot[torch.where(pending & (slot_rank < S), slot_rank,
                                 S)] = torch.arange(L + 1, device=dev)
        return slot_of_leaf, leaf_of_slot[:S]

    def finish(self) -> Tuple[TreeArrays, torch.Tensor]:
        """The epilogue: returns the state's own tree arrays and leaf ids
        (the next ``begin`` overwrites them). Scratch rows hold masked-split
        garbage; zero the ones consumers read (the JAX package does the same
        so that downstream score updates stay exact). The scratch node's
        children take many writes of one wave at the same index, which the
        card applies in no fixed order: give them the value the ordered
        writes of the CPU (and the JAX package) leave, so that the device
        tree is the same on both and from run to run."""
        L = self.spec.num_leaves
        M = L - 1
        tr = self.state.tree
        tr.leaf_value[L].fill_(0.0)
        tr.internal_value[M].fill_(0.0)
        tr.left_child[M].fill_(-L - 1)
        tr.right_child[M].fill_(-L - 1)
        return tr, self.state.leaf_id

    @allowed_host_sync("the eager wave loop's one flag read per wave")
    def run_waves(self) -> int:
        """The eager loop: waves until the host reads ``done`` (one read
        per wave); returns the waves the tree needed."""
        while True:
            self.wave()
            _, done, waves = self.state.flags.tolist()
            if done:
                return waves

    def grow(self, grad, hess, included, feature_ok
             ) -> Tuple[TreeArrays, torch.Tensor]:
        """``begin``, the eager loop, ``finish``."""
        self.begin(grad, hess, included, feature_ok)
        self.run_waves()
        return self.finish()


@trace_entry("grower.stream_legs")
class StreamedGrower(TreeGrower):
    """:class:`TreeGrower` over host-resident code shards
    (``tpu_residency=stream``; port of ``lightgbm_tpu/grower.py:894-1240``).

    The same ``begin`` / ``wave`` / ``finish`` parts on the same state, so
    the booster's tree prologue and epilogue, the ``nan_policy`` guard and
    valid scoring run unchanged; only the code matrix is not on the card.
    Each wave makes one pass over the shards of ``stream``
    (``ops/stream.ShardPrefetcher``): per shard, the rows are first routed
    by the previous wave's table (one copy of a shard serves both legs),
    then their pending rows are added into the wave's carried histogram
    (``ops/cuda_histogram.HistogramAccumulator``, kernel B11); the
    accumulator is converted once, and ``_apply_wave_splits`` runs as in
    the resident wave. The valid sets stay resident and are routed in the
    wave that splits. Passes are full: there is no partition, and the
    integer sums make the histograms, hence the trees, bit-equal to a
    resident run. ``finish`` runs a trailing route pass when the last wave
    applied splits.

    The host drives the shard loop, so the loop is eager: :meth:`run_waves`
    reads the grower's flags once per wave (``flag_reads``), the JAX
    package's ``_fetch_wave_flags``. A tail shard's padding rows are never
    routed or counted (``HostShardStore.real_rows``). Under data-parallel
    the store holds this rank's row block and the wave reduces the
    accumulator's int64 sums over the ranks before the conversion; under
    voting the local histograms are converted at the world's scale and the
    strategy reduces the voted columns, as in the resident wave."""

    def __init__(self, stream, is_cat: torch.Tensor, num_bins: torch.Tensor,
                 missing_code: torch.Tensor, default_bin: torch.Tensor,
                 spec: GrowerSpec, comm=None,
                 bundle: Optional[BundleDecode] = None,
                 route: Sequence[torch.Tensor] = ()):
        from .ops.cuda_histogram import HistogramAccumulator
        if comm is None:
            from .parallel.comm import SerialComm
            comm = SerialComm(spec.num_features)
        store = stream.store
        self.stream, self.store = stream, store
        dev = stream.device
        self._setup(store.n_rows, store.num_cols, dev, is_cat, num_bins,
                    missing_code, default_bin, spec, comm, bundle, route,
                    partition=False)
        self.acc = HistogramAccumulator(spec.hist_slots, store.num_cols,
                                        self.B_hist, dev)
        # u4 / u6 shards unpack into a uint8 buffer; u16 shards of features
        # past 32,768 bins widen into an int32 one (ROADMAP B1c)
        wide = device_code_dtype(self.B_hist) == torch.int32
        self.unpack_buf = torch.empty(
            (store.shard_rows, store.num_cols),
            dtype=torch.int32 if wide else torch.uint8,
            device=dev) if store.code_mode in ("u4", "u6") or (
                wide and store.code_mode == "u16") else None
        self._table = self.table0
        self._map_mask = None
        self._route_next = False       # the next pass routes by _table
        self._route_pending = False    # finish routes (the last wave split)
        self.flag_reads = 0            # host reads of the flags
        self.waves_run = 0

    def begin(self, grad, hess, included, feature_ok) -> None:
        super().begin(grad, hess, included, feature_ok)
        self._route_next = self._route_pending = False

    def _shard_pass(self, slot_of_leaf: Optional[torch.Tensor]) -> None:
        """One pass over the shards: route each shard's rows by the
        pending table, then (with ``slot_of_leaf``) add its pending rows
        into the accumulator."""
        st, store, stream = self.state, self.store, self.stream
        R = store.shard_rows
        for i in range(store.n_shards):
            codes = unpack_codes(stream.get(i), store.num_cols,
                                 store.code_mode, out=self.unpack_buf)
            r0, n = i * R, store.real_rows(i)
            if self._route_next and n:
                lid = st.leaf_id[r0:r0 + n]
                lid.copy_(_route_rows(codes[:n], lid, self._table,
                                      self._map_mask)[0])
            if slot_of_leaf is not None:
                self.acc.add(codes, self.grad, self.hess, self.included,
                             st.leaf_id, slot_of_leaf, r0, n, self.scales)
            stream.release(i)
            stream.prefetch(i + 1)

    def wave(self) -> None:
        """One wave over the shards (class docstring). Reads nothing on the
        host but the shards' copies."""
        spec, st, comm = self.spec, self.state, self.comm
        nl = st.flags[0].clone()
        live = st.flags[1] == 0
        slot_of_leaf, leaf_of_slot = self._slots(live)
        with record_function("wave.stream"):
            self.acc.zero_()
            self._shard_pass(slot_of_leaf)
            if self.acc_block is not None:
                # data-parallel: the carried integer sums, reduced over the
                # ranks before their one conversion, as the resident wave
                # does (exact, so the text is the serial one on any floats)
                new_hist = comm.reduce_sums(self.acc, self.acc_block) \
                    .finalize(self.scales)
            else:
                new_hist = comm.reduce_hist(self.acc.finalize(self.scales))
        with record_function("wave.split"):
            table, map_mask, p, q, n_apply = _apply_wave_splits(
                st, new_hist, leaf_of_slot, live, nl, self.bm, spec, comm,
                self.num_bins, self.missing_code, self.default_bin,
                self.table0, self.bundle, self.scan_bundle)
        with record_function("wave.route"):
            for Xv, lid in zip(self.route, st.valid_leaf):
                lid.copy_(_route_rows(Xv, lid, table[:, :6], map_mask)[0])
        self._table, self._map_mask = table, map_mask
        self._route_next = True
        done = ~live | (n_apply == 0) | (nl + n_apply >= spec.num_leaves)
        st.flags.copy_(torch.stack([nl + n_apply, done.long(),
                                    st.flags[2] + live.long()]))

    @allowed_host_sync("the streamed wave's one flag read per wave")
    def run_waves(self) -> int:
        """Waves until ``done``, one host read of the flags per wave;
        notes whether the last wave split, for ``finish``."""
        leaves = 1
        while True:
            self.wave()
            self.waves_run += 1
            grown, done, waves = self.state.flags.tolist()
            self.flag_reads += 1
            split, leaves = grown > leaves, grown
            if done:
                self._route_pending = split
                return waves

    def finish(self) -> Tuple[TreeArrays, torch.Tensor]:
        """The trailing route pass (the last wave's splits reach the
        training rows), then :meth:`TreeGrower.finish`."""
        if self._route_pending:
            with record_function("wave.stream"):
                self._shard_pass(None)
            self._route_pending = self._route_next = False
        return super().finish()


def grow_tree(
    X: torch.Tensor,              # [N, F] uint8 codes, or uint16 as int16
    grad: torch.Tensor,           # [N] f32
    hess: torch.Tensor,           # [N] f32
    included: torch.Tensor,       # [N] f32 0/1
    feature_ok: torch.Tensor,     # [F] bool
    is_cat: torch.Tensor,         # [F] bool
    num_bins: torch.Tensor,       # [F] i32
    missing_code: torch.Tensor,   # [F] i32
    default_bin: torch.Tensor,    # [F] i32
    spec: GrowerSpec,
    comm=None,
    bundle: Optional[BundleDecode] = None,
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree; returns (tree arrays, final leaf id per row). With
    ``bundle`` (EFB), ``X`` is the ``[N, G]`` bundled code matrix and the
    histograms have ``spec.hist_bins`` bins."""
    grower = TreeGrower(X, is_cat, num_bins, missing_code, default_bin, spec,
                        comm, bundle)
    return grower.grow(grad, hess, included, feature_ok)
