"""Leaf-wise tree growth in waves, as eager PyTorch on one device.

Port of the serial resident path of ``lightgbm_tpu/grower.py``
(``GrowerSpec``, ``TreeArrays``, ``GrowState``, ``_empty_tree``,
``_apply_wave_splits`` :312-503, ``_route_rows`` :507-561 unbundled,
``grow_tree`` :565-886; reference SerialTreeLearner::Train,
serial_tree_learner.cpp:152-231). The JAX package runs the wave loop as a
``lax.while_loop`` inside one jit; here it is a Python loop over waves
that reads two scalars per wave on the host (the rows a compacted pass
covers, and the splits the wave applied). Each wave:

1. gives every leaf that needs a histogram a slot, in ascending leaf order;
2. builds the pending slots' histograms in one pass of the hand-written
   kernel (``ops/cuda_histogram.py``) over the pending leaves' segments of
   the carried partition ``perm``: on the card on every wave, on the CPU
   (as in the JAX package, which avoids row gathers on a TPU) once fewer
   than ``compact_frac`` of the rows are pending, a full pass before;
3. derives each sibling's histogram by parent-minus-smaller-child
   subtraction from the ``[L+1, F, B, 3]`` cache (serial_tree_learner.cpp
   :354-362);
4. scans the 2S touched leaves for their best split (``ops/split_finder``);
5. applies up to ``wave_size`` splits in global gain order — with
   ``wave_size=1`` exactly the reference's leaf-wise order;
6. writes the tree arrays and per-leaf state;
7. routes the rows of split leaves through a ``[L+1, 6]`` split table;
8. re-partitions only the split leaves' segments of ``perm``, stably, by
   prefix sums (never a sort): left rows to the front, right rows to the
   back, row order kept (the reference's DataPartition::Split,
   data_partition.hpp:94).

State tensors are updated in place (the JAX package's carry is immutable
and aliased by XLA; in place here saves one copy of the histogram cache
per wave). Each wave's steps 2, 3-6, 7 and 8 run under
``torch.profiler.record_function`` ranges (``wave.histogram``,
``wave.split``, ``wave.route``, ``wave.partition``), which cost nothing
measurable without an active profiler and give ``chip_smoke.py`` its
per-step breakdown. Tie-breaks follow the JAX package exactly: ``lax.top_k`` at
grower.py:390 prefers the lowest leaf index among equal gains, which a
stable descending sort reproduces (``torch.topk`` promises no tie order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from .ops.cuda_histogram import build_histograms_cuda
from .ops.histogram import histogram_scales, root_sums, table_lookup
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


@dataclass
class GrowState:
    """Per-tree wave state (the JAX package's while_loop carry)."""
    tree: TreeArrays
    leaf_id: torch.Tensor          # i32 [N]
    hist: torch.Tensor             # f32 [L+1, F, B, 3] per-leaf cache
    sum_g: torch.Tensor            # f32 [L+1]
    sum_h: torch.Tensor            # f32 [L+1]
    cnt: torch.Tensor              # f32 [L+1]
    leaf_depth: torch.Tensor       # i32 [L+1]
    leaf_is_right: torch.Tensor    # bool [L+1]
    cand: SplitCandidates          # per-leaf best split, arrays [L+1]
    needs_hist: torch.Tensor       # bool [L+1]
    sib_leaf: torch.Tensor         # i64 [L+1] sibling derived by subtraction
    parent_cache: torch.Tensor     # i64 [L+1] cache row of the parent
    num_leaves_cur: int
    done: bool
    # incremental leaf partition: rows of leaf l sit at positions
    # [seg_start[l], seg_start[l] + seg_rows[l]) of perm, ascending
    perm: torch.Tensor             # i32 [N]
    seg_start: torch.Tensor        # i32 [L+1]
    seg_rows: torch.Tensor         # i32 [L+1] raw row counts


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
    row_compact: bool = True      # passes over the pending segments
    compact_frac: float = 0.25    # ...on the CPU, when fewer than this
                                  # share is pending (always on the card)
    # categorical split search (reference config.h:230-234)
    cat_features: tuple = ()      # inner indices of categorical features;
                                  # the scan runs on these columns only
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0

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
                       leaf_of_slot: torch.Tensor, bm, spec: GrowerSpec,
                       comm, num_bins: torch.Tensor,
                       missing_code: torch.Tensor, default_bin: torch.Tensor):
    """Steps 3-6 of a wave plus the ``[L+1, 6]`` routing table, updating
    ``state`` in place except the per-row fields (leaf_id and the
    partition), which the caller owns. Returns ``(table, map_mask, p, q,
    n_apply)`` with ``map_mask`` the ``[L+1, B]`` categorical left sets of
    the split leaves (None without categorical features) and ``p``/``q``
    the per-slot split / new right leaves (``L`` where no split was
    applied)."""
    L = spec.num_leaves
    M = L - 1
    S = spec.hist_slots
    dev = new_hist.device
    leaf_iota = torch.arange(L + 1, device=dev)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

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
        state.cnt[scan_leaves], bm, spec)
    for old, new in zip(state.cand, cand_new):
        old[scan_leaves] = new
    cand = state.cand
    cand.gain[L] = NEG_INF                  # keep the scratch row inert
    state.needs_hist.zero_()

    # ---- 5. choose the splits to apply this wave ------------------------
    nl = state.num_leaves_cur
    active = leaf_iota < nl
    depth_ok = ((spec.max_depth <= 0) | (state.leaf_depth < spec.max_depth))
    gains = torch.where(active & depth_ok & torch.isfinite(cand.gain),
                        cand.gain, neg_inf)
    # lax.top_k order: descending gain, lowest leaf index first on a tie
    top_gain, top_leaf = torch.sort(gains, descending=True, stable=True)
    top_gain, top_leaf = top_gain[:S], top_leaf[:S]
    budget = L - nl
    cap = min(spec.wave_size, S) if spec.wave_size > 0 else S
    srank = torch.arange(S, device=dev)
    apply = torch.isfinite(top_gain) & (srank < budget) & (srank < cap)
    n_apply = int(apply.sum())              # host sync: wave bookkeeping

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
    t.num_leaves.fill_(nl + n_apply)
    state.leaf_is_right[p] = False
    state.leaf_is_right[q] = True

    state.sum_g[p], state.sum_g[q] = lg, rg_
    state.sum_h[p], state.sum_h[q] = lh, rh_
    state.cnt[p], state.cnt[q] = lc, rc_
    new_depth = state.leaf_depth[p] + 1
    state.leaf_depth[p] = new_depth
    state.leaf_depth[q] = new_depth
    cand.gain[p] = NEG_INF
    cand.gain[q] = NEG_INF

    # next wave: histogram the smaller child, derive the larger
    left_smaller = lc <= rc_
    smaller = torch.where(left_smaller, p, q)
    larger = torch.where(left_smaller, q, p)
    state.needs_hist[smaller] = apply
    state.needs_hist[L] = False
    state.sib_leaf[smaller] = larger
    state.parent_cache[smaller] = torch.where(apply, p, L)

    # ---- routing table, one row per split leaf -------------------------
    # 0: split feature (-1 = leaf not split this wave)  1: threshold bin
    # 2: missing bin (-1 = none; reference NumericalDecision, tree.h:218)
    # 3: right-child leaf   4: default_left   5: is_cat
    sf = cand.feature[p].long()
    sf_safe = torch.clamp(sf, min=0)
    mc_s, nb_s, db_s = (missing_code[sf_safe], num_bins[sf_safe],
                        default_bin[sf_safe])
    miss_bin = torch.where(mc_s == 2, nb_s - 1,
                           torch.where(mc_s == 1, db_s, -1))
    rows = torch.stack([sf, cand.threshold[p].long(), miss_bin.long(), q,
                        cand.default_left[p].long(), cand.is_cat[p].long()],
                       dim=-1).to(torch.int32)
    table = torch.zeros((L + 1, 6), dtype=torch.int32, device=dev)
    table[:, 0] = -1
    table[:, 2] = -1
    table[p] = rows
    table[L] = torch.tensor([-1, 0, -1, 0, 0, 0], dtype=torch.int32,
                            device=dev)

    map_mask = None
    if spec.use_categorical:
        map_mask = torch.zeros((L + 1, cand.cat_mask.shape[1]),
                               dtype=torch.bool, device=dev)
        map_mask[p] = cand.cat_mask[p]
        map_mask[L] = False

    state.done = n_apply == 0 or nl + n_apply >= L
    state.num_leaves_cur = nl + n_apply
    return table, map_mask, p, q, n_apply


def _route_rows(X: torch.Tensor, lid: torch.Tensor, table: torch.Tensor,
                map_mask: Optional[torch.Tensor] = None):
    """Step 7: apply one wave's routing table to the rows of ``X``; with
    ``map_mask`` a categorical split sends a row left iff its bin is in the
    leaf's left set (reference Tree::CategoricalDecision, tree.h:257-284).
    Returns ``(leaf_id, f_row, go_left, right_row)``; the last three feed
    the partition maintenance (step 8)."""
    packed = table_lookup(lid.long(), table)                    # [N, 6]
    f_row = packed[:, 0]
    thr_row = packed[:, 1]
    miss_row = packed[:, 2]
    right_row = packed[:, 3]
    dl_row = packed[:, 4] != 0
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
               nl_before: int) -> None:
    """Step 8: stable re-partition of the split leaves' segments of
    ``perm`` by prefix sums; leaf p keeps the front of its old segment (its
    go-left rows, original order), new leaf q takes the back."""
    L = state.seg_rows.shape[0] - 1
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
    perm = state.perm.clone()
    perm[newpos[in_split]] = state.perm[in_split]
    state.perm = perm
    state.seg_start[q] = (start_k + nL).to(i32)
    state.seg_rows[p] = nL.to(i32)
    state.seg_rows[q] = (n_k - nL).to(i32)
    # the scratch leaf must stay an empty segment
    state.seg_start[L] = 0
    state.seg_rows[L] = 0


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
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree; returns (tree arrays, final leaf id per row)."""
    if comm is None:
        from .parallel.comm import SerialComm
        comm = SerialComm(spec.num_features)
    L = spec.num_leaves
    M = L - 1
    S = spec.hist_slots
    B = spec.num_bins_padded
    N = X.shape[0]
    dev = X.device
    X_hist = comm.hist_X(X)
    F_cache = comm.reduced_hist_features(X_hist.shape[1])
    cat_idx = torch.tensor(spec.cat_features, dtype=torch.long, device=dev) \
        if spec.use_categorical else None
    bm = comm.block_meta(feature_ok, num_bins, missing_code, default_bin,
                         is_cat, cat_idx)
    rg, rh, rc = comm.reduce_scalars(*root_sums(grad, hess, included))
    # one fixed-point scale per tree for g and one for h (ops/histogram.py)
    scales = histogram_scales(grad, hess)

    i32, f32 = torch.int32, torch.float32
    zeros_l = torch.zeros(L + 1, dtype=f32, device=dev)
    sum_g, sum_h, cnt = zeros_l.clone(), zeros_l.clone(), zeros_l.clone()
    sum_g[0], sum_h[0], cnt[0] = rg, rh, rc
    needs_hist = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    needs_hist[0] = True
    seg_rows = torch.zeros(L + 1, dtype=i32, device=dev)
    seg_rows[0] = N
    state = GrowState(
        tree=_empty_tree(L, B, dev),
        leaf_id=torch.zeros(N, dtype=i32, device=dev),
        hist=torch.zeros((L + 1, F_cache, B, 3), dtype=f32, device=dev),
        sum_g=sum_g, sum_h=sum_h, cnt=cnt,
        leaf_depth=torch.zeros(L + 1, dtype=i32, device=dev),
        leaf_is_right=torch.zeros(L + 1, dtype=torch.bool, device=dev),
        cand=_empty_cand(L, B, dev),
        needs_hist=needs_hist,
        sib_leaf=torch.full((L + 1,), L, dtype=torch.int64, device=dev),
        parent_cache=torch.full((L + 1,), L, dtype=torch.int64, device=dev),
        num_leaves_cur=1,
        done=False,
        perm=torch.arange(N, dtype=i32, device=dev),
        seg_start=torch.zeros(L + 1, dtype=i32, device=dev),
        seg_rows=seg_rows,
    )
    leaf_iota = torch.arange(L + 1, device=dev)
    compact_rows = int(N * spec.compact_frac)

    while not state.done:
        # ---- 1. slots for the leaves needing histograms, ascending ------
        pending = state.needs_hist
        slot_rank = torch.cumsum(pending.long(), 0) - 1
        slot_of_leaf = torch.where(pending, slot_rank, -1).to(i32)
        leaf_of_slot = torch.full((S + 1,), L, dtype=torch.int64,
                                  device=dev)
        leaf_of_slot[torch.where(pending & (slot_rank < S), slot_rank,
                                 S)] = leaf_iota
        leaf_of_slot = leaf_of_slot[:S]

        # ---- 2. one pass builds the S histograms ------------------------
        with record_function("wave.histogram"):
            slot_counts = state.seg_rows[leaf_of_slot]          # [S]
            n_active = int(slot_counts.sum())   # host sync: pass size
            # on the card the partition pass reads only the pending rows and
            # is never more work; on the CPU the JAX package's choice stays
            if spec.row_compact and (dev.type == "cuda"
                                     or n_active < compact_rows):
                new_hist = build_histograms_cuda(
                    X_hist, grad, hess, included, state.leaf_id,
                    slot_of_leaf, S, B, row_idx=state.perm,
                    n_active=n_active, slot_counts=slot_counts,
                    slot_starts=state.seg_start[leaf_of_slot],
                    scales=scales)
            else:
                new_hist = build_histograms_cuda(
                    X_hist, grad, hess, included, state.leaf_id,
                    slot_of_leaf, S, B, scales=scales)
            new_hist = comm.reduce_hist(new_hist)

        # ---- 3-6 + routing table ------------------------------------------
        nl_before = state.num_leaves_cur
        with record_function("wave.split"):
            table, map_mask, p, q, _ = _apply_wave_splits(
                state, new_hist, leaf_of_slot, bm, spec, comm, num_bins,
                missing_code, default_bin)

        # ---- 7. route the rows of split leaves ----------------------------
        with record_function("wave.route"):
            leaf_id, f_row, go_left, right_row = _route_rows(
                X, state.leaf_id, table, map_mask)

        # ---- 8. incremental partition maintenance -------------------------
        with record_function("wave.partition"):
            _partition(state, f_row, go_left, right_row, p, q, nl_before)
        state.leaf_id = leaf_id

    # scratch rows hold masked-split garbage; zero them (the JAX package
    # does the same so that downstream score updates stay exact)
    tr = state.tree
    tr.leaf_value[L] = 0.0
    tr.internal_value[M] = 0.0
    return tr, state.leaf_id
