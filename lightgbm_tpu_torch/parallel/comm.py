"""Tree-learner communication strategies on ``torch.distributed``.

Port of ``lightgbm_tpu/parallel/comm.py``. The JAX package runs every rank
as a device of one mesh inside ``shard_map``; here each rank is a process
(LightGBM's own network layer, one machine per rank) and the strategies
call ``torch.distributed`` collectives on the default process group: NCCL
for CUDA tensors, gloo for CPU tensors. The grower reaches histogram
reduction, scalar reduction and split search only through the strategy
object (``grower.py``), so the serial path runs no collective.

- :class:`DataParallelComm` (reference DataParallelTreeLearner): rows
  sharded by rank; each rank reduce-scatters its pass's integer histogram
  sums over feature blocks (``reduce_sums``), so that rank ``r`` holds the
  global sums of feature block ``r``, finds the best split on it, and the
  global best is an all-gather + argmax (``_gather_argmax``). The sums are
  B1's int64 fixed-point sums, reduced before they are converted to f32,
  at one fixed-point scale for the whole world (``histogram_scales``): the
  reduction is exact, so the trees are bit-identical to the serial
  learner's on any floats (the JAX package sums f32; ROADMAP C25).
- :class:`FeatureParallelComm` (FeatureParallelTreeLearner): rows
  replicated; each rank histograms one contiguous feature block.
- :class:`FeatureParallelBundledComm` / :class:`DataParallelBundledComm`:
  the same with EFB's bundled columns as the partitioned unit.
- :class:`VotingParallelComm` (PV-Tree): rows sharded; local top-k
  proposals under ``min_data / D``, a global vote, the exact rank score
  ``votes * F + gain rank``, and a reduction of the selected columns only.

The host side: :func:`parse_machine_list`, :func:`_local_rank`,
:func:`host_allgather` (setup-time payloads through the process group's
key-value store) and :func:`init_distributed` (a ``TCPStore`` on the
machine list's first entry, then ``init_process_group`` with NCCL on the
card or gloo on the CPU; a default group the caller made is used as it
stands). :class:`ParallelContext` and :func:`make_parallel_context` hold
the group, rank, world size and device a booster trains with. For the
fault-tolerance layer (``robustness/distributed.py``):
:func:`distributed_store` and :func:`world_rank_and_size` (the live
world's store, through the chaos harness's wrapper when installed),
:func:`arrive_and_wait` (a barrier on the store, which has none),
:func:`leave_last` and :func:`store_loss_error`: rank 0 hosts the
``TCPStore``, so it leaves every exchange last (its process ending must
not take the store from a peer still polling), and when it dies every
store call of a survivor fails at once, each such failure becoming
``PeerLostError`` naming rank 0 (exit 145), never a hang.

No fallback: a collective on an NCCL group never stages through the host.
A CUDA tensor under a gloo group (a group the caller chose) is staged
through the host in :meth:`Collectives._staged`, the one function that
does so. A collective a backend cannot run raises.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import pickle
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.categorical import per_feature_best_categorical
from ..ops.histogram import root_sums_f64, scales_from_max
from ..ops.split_finder import (PerFeatureBest, SplitCandidates,
                                per_feature_best_bundled,
                                per_feature_best_numerical, reduce_features,
                                unpack_bundled_hist)
from ..robustness import allowed_host_sync
from ..utils.log import Log


class BlockMeta(NamedTuple):
    """Per-feature metadata of the feature block this device scans; arrays
    are ``[F_block]`` and ``offset`` maps a local feature index to its
    global one."""
    feature_ok: torch.Tensor
    num_bins: torch.Tensor
    missing_code: torch.Tensor
    default_bin: torch.Tensor
    is_cat: torch.Tensor
    offset: int
    # inner indices of the categorical features (None: there are none)
    cat_idx: Optional[torch.Tensor] = None
    # a pair of timing events recorded around the categorical scan (a
    # traced booster's captured wave, ``grower.TreeGrower.time_cat_scan``)
    scan_events: Optional[tuple] = None


def block_per_feature(hist, pg, ph, pc, bm: BlockMeta, spec, bundle=None):
    """Best split per (slot, feature) over this block: the numerical scan
    for numerical features, the one-hot / sorted-prefix scan for
    categorical ones, merged per feature (reference FindBestThreshold
    dispatch, feature_histogram.hpp:72-104; parallel/comm.py:93-143 there).
    Returns ``(PerFeatureBest, cat_mask [S, F, B] or None)``.

    With ``bundle`` (``grower.BundleDecode``) ``hist`` is bundle space
    ``[S, G, Bb, 3]``: the numerical scan runs on it directly, and the
    categorical features are unpacked from their own bundle columns only,
    scanned in their own bins and put back at their feature index."""
    if bundle is not None:
        pf = per_feature_best_bundled(
            hist, pg, ph, pc, bm.num_bins, bm.missing_code, bm.default_bin,
            bm.feature_ok & ~bm.is_cat, bundle.col, bundle.lo, bundle.hi,
            bundle.off, bundle.code_feat, **spec.hyperparams())
        ci = bm.cat_idx
        if ci is None:
            return pf, None
        hist_c = unpack_bundled_hist(
            hist, bundle.col[ci], bundle.unpack_bin[ci], pg, ph, pc,
            bm.default_bin[ci])                         # [S, Fc, B, 3]
        B = spec.num_bins_padded
    else:
        pf = per_feature_best_numerical(
            hist, pg, ph, pc, bm.num_bins, bm.missing_code, bm.default_bin,
            bm.feature_ok & ~bm.is_cat, **spec.hyperparams())
        ci = bm.cat_idx
        if ci is None:
            return pf, None
        # the scan is per feature: run it on the categorical columns only
        hist_c = hist[:, ci]
        B = hist.shape[2]
    if bm.scan_events is not None:
        bm.scan_events[0].record()
    pf_cat, mask_c = per_feature_best_categorical(
        hist_c, pg, ph, pc, bm.num_bins[ci], bm.missing_code[ci],
        (bm.feature_ok & bm.is_cat)[ci], **spec.hyperparams(),
        **spec.cat_hyperparams())
    if bm.scan_events is not None:
        bm.scan_events[1].record()
    merged = PerFeatureBest(*[nv.index_copy(1, ci, cv)
                              for nv, cv in zip(pf, pf_cat)])
    S, F = pf.gain.shape
    mask = torch.zeros((S, F, B), dtype=torch.bool, device=hist.device)
    mask[:, ci] = mask_c
    return merged, mask


def find_block_splits(hist, pg, ph, pc, bm: BlockMeta, spec, bundle=None
                      ) -> SplitCandidates:
    """Best split per slot over this block's features (feature argmax, the
    lowest feature index on a tie). The candidates' left sets stay in the
    features' own bins under EFB too (parallel/comm.py:146-156 there)."""
    pf, mask = block_per_feature(hist, pg, ph, pc, bm, spec, bundle)
    if mask is None:
        nb_pad = spec.num_bins_padded if bundle is not None \
            else hist.shape[2]
        return reduce_features(pf, bm.offset, num_bins_padded=nb_pad)
    return reduce_features(pf, bm.offset, is_cat=bm.is_cat, cat_mask=mask)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def _reduce_op(op: str):
    dist = _dist()
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


class Collectives:
    """The three collectives the strategies use, on one process group,
    with their counts: ``all_reduce`` (in place), ``all_gather`` (a new
    ``[world, ...]`` tensor) and ``reduce_scatter`` (``[world, ...]`` in,
    this rank's part out). NCCL groups take CUDA tensors as they are; under
    a gloo group a CUDA tensor goes through :meth:`_staged`. ``calls``,
    ``bytes`` (of the tensors given) and ``staged_s`` (host seconds inside
    staged collectives, copies included) are read by ``chip_smoke.py``."""

    def __init__(self, group=None, rank: int = 0, world: int = 1):
        self.group, self.rank, self.world = group, int(rank), int(world)
        self.backend = _dist().get_backend(group)
        self.calls = 0
        self.bytes = 0
        self.staged_calls = 0
        self.staged_s = 0.0

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    @allowed_host_sync("gloo takes host tensors: a CUDA tensor's "
                       "collective is staged through the host")
    def _staged(self, fn, out: torch.Tensor, inp: torch.Tensor) -> None:
        """Run ``fn(out, inp)`` (``inp`` may be ``out``) on host copies of
        CUDA tensors and copy the result back: the one place a collective
        goes through the host, and only under a gloo group."""
        t0 = time.perf_counter()
        h_in = inp.cpu()
        h_out = h_in if inp is out else torch.empty(
            out.shape, dtype=out.dtype)
        fn(h_out, h_in)
        out.copy_(h_out)
        self.staged_calls += 1
        self.staged_s += time.perf_counter() - t0

    def _run(self, fn, out: torch.Tensor, inp: torch.Tensor) -> None:
        self._count(inp)
        if inp.device.type == "cuda" and self.backend == "gloo":
            self._staged(fn, out, inp)
        else:
            fn(out, inp)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks, in place (``sum`` or ``max``)."""
        o = _reduce_op(op)
        self._run(lambda out, inp: _dist().all_reduce(out, op=o,
                                                      group=self.group),
                  t, t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t``, in rank order."""
        t = t.contiguous()
        out = torch.empty((self.world, *t.shape), dtype=t.dtype,
                          device=t.device)
        # flat views: gloo wants the output's first dimension to be the
        # world size times the input's
        self._run(lambda o, i: _dist().all_gather_into_tensor(
            o.view(-1), i.view(-1), group=self.group), out, t)
        return out

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor
                       ) -> torch.Tensor:
        """``out`` = the sum over ranks of ``inp[rank]`` (``inp`` is
        ``[world, *out.shape]``, contiguous)."""
        self._run(lambda o, i: _dist().reduce_scatter_tensor(
            o.view(-1), i.view(-1), group=self.group), out, inp)
        return out



# serialized size of one candidate in the all-gather argmax: eight int32
# words (gain, feature, threshold, default_left, left_g, left_h, left_c,
# is_cat) plus the [B] categorical left set as int32 when categorical
# splits are possible (the JAX package counts f32/i32/bool bytes; the
# port packs every field into one int32 tensor, one collective)
def _split_candidate_bytes(num_bins_padded: int,
                           use_categorical: bool = True) -> int:
    return 4 * (8 + (num_bins_padded if use_categorical else 0))


def _pack_candidates(cand: SplitCandidates, with_mask: bool) -> torch.Tensor:
    i32 = torch.int32
    cols = [cand.gain.view(i32), cand.feature.to(i32),
            cand.threshold.to(i32), cand.default_left.to(i32),
            cand.left_g.view(i32), cand.left_h.view(i32),
            cand.left_c.view(i32), cand.is_cat.to(i32)]
    packed = torch.stack(cols, dim=1)
    if with_mask:
        packed = torch.cat([packed, cand.cat_mask.to(i32)], dim=1)
    return packed.contiguous()


def _unpack_candidates(packed: torch.Tensor, num_bins: int
                       ) -> SplitCandidates:
    f32 = torch.float32
    S = packed.shape[0]
    if packed.shape[1] > 8:
        mask = packed[:, 8:] != 0
    else:
        mask = torch.zeros((S, num_bins), dtype=torch.bool,
                           device=packed.device)
    return SplitCandidates(
        gain=packed[:, 0].contiguous().view(f32),
        feature=packed[:, 1].contiguous(),
        threshold=packed[:, 2].contiguous(),
        default_left=packed[:, 3] != 0,
        left_g=packed[:, 4].contiguous().view(f32),
        left_h=packed[:, 5].contiguous().view(f32),
        left_c=packed[:, 6].contiguous().view(f32),
        is_cat=packed[:, 7] != 0,
        cat_mask=mask)


def _gather_argmax(cand: SplitCandidates, coll: Collectives,
                   with_mask: bool) -> SplitCandidates:
    """Global best split across ranks: all-gather the candidates, argmax on
    gain (reference SyncUpGlobalBestSplit, parallel_tree_learner.h:184-207;
    ``comm.py:171`` there). ``torch.argmax`` returns the first maximum, so
    a tie goes to the lowest rank; with features block-partitioned in rank
    order that is the serial learner's lowest-feature-index rule. The
    candidates travel as one int32 tensor, the left sets only when the
    model has categorical features (``with_mask``, the spec's: every rank
    sends the same width)."""
    B = cand.cat_mask.shape[1]
    g = coll.all_gather(_pack_candidates(cand, with_mask))    # [D, S, W]
    gains = g[:, :, 0].contiguous().view(torch.float32)          # [D, S]
    d_idx = torch.argmax(gains, dim=0)                           # [S]
    pick = g[d_idx, torch.arange(g.shape[1], device=g.device)]  # [S, W]
    return _unpack_candidates(pick, B)


def _block_slice(t: torch.Tensor, i: int, b: int) -> torch.Tensor:
    return t[i * b:(i + 1) * b]


@allowed_host_sync("set-up: the block's categorical features, once per "
                   "learner")
def _local_cat_idx(cat_idx: Optional[torch.Tensor], lo: int, b: int
                   ) -> Optional[torch.Tensor]:
    """The categorical features of the block ``[lo, lo + b)``, as block
    indices (None: there are none). Set-up time: reads ``cat_idx``."""
    if cat_idx is None:
        return None
    local = [int(c) - lo for c in cat_idx.tolist() if lo <= int(c) < lo + b]
    if not local:
        return None
    return torch.tensor(local, dtype=torch.long, device=cat_idx.device)


def _reduce_scatter_sums(coll: Collectives, acc, out) -> None:
    """Reduce-scatter every integer tensor of ``acc`` (``[S, F, B]`` sums,
    ``HistogramAccumulator``) over contiguous feature blocks into ``out``
    (``[S, F / D, B]``): rank ``r`` receives block ``r``'s global sums.
    Integer sums: exact, in any order."""
    D = coll.world
    for (t, ax), (o, _) in zip(acc.sums(), out.sums()):
        Fb = o.shape[ax]
        blocks = t.unflatten(ax, (D, Fb)).movedim(ax, 0).contiguous()
        coll.reduce_scatter(o, blocks)


@dataclass(frozen=True)
class SerialComm:
    """Single-device no-op strategy (reference SerialTreeLearner)."""
    num_features: int = 0

    reduces_sums = False          # the grower reduces f32 histograms
    bundled_blocks = False

    def root_sums(self, grad, hess, included):
        """Root (sum_g, sum_h, count): f64 sums rounded once to f32."""
        return tuple(root_sums_f64(grad, hess, included).float())

    def histogram_scales(self, grad, hess):
        """B1's per-tree fixed-point scales over these rows."""
        from ..ops.histogram import histogram_scales
        return histogram_scales(grad, hess)

    def hist_X(self, X):
        """The columns this device histograms (all of them)."""
        return X

    def reduce_hist(self, hist):
        """[S, F_hist, B, 3] partial -> global sums (identity here)."""
        return hist

    def reduced_hist_features(self, F_hist: int) -> int:
        return F_hist

    def block_meta(self, feature_ok, num_bins, missing_code, default_bin,
                   is_cat, cat_idx=None) -> BlockMeta:
        return BlockMeta(feature_ok, num_bins, missing_code, default_bin,
                         is_cat, 0, cat_idx)

    def find_splits(self, hist, pg, ph, pc, bm: BlockMeta, spec,
                    bundle=None) -> SplitCandidates:
        return find_block_splits(hist, pg, ph, pc, bm, spec, bundle)

    def collective_bytes(self, num_slots: int, num_bins_padded: int,
                         use_categorical: bool = True,
                         hist_bins: int = None) -> dict:
        """Per-wave collective payload in bytes, by collective. Serial
        runs none."""
        return {}


class _RowSharded:
    """Scalar reductions of the strategies whose rows are sharded by rank
    (data, voting): root sums and the fixed-point scales are the world's,
    so that every rank's integer histogram sums are commensurable and
    equal to the serial learner's."""

    def root_sums(self, grad, hess, included):
        """f64 partials reduced over the ranks, rounded once to f32."""
        return tuple(self.coll.all_reduce(
            root_sums_f64(grad, hess, included)).float())

    def histogram_scales(self, grad, hess):
        """The serial learner's scales: the world's largest ``|g|`` and
        ``|h|`` (an all-reduce MAX) times the global row count."""
        max_abs = torch.stack([grad.abs().max(), hess.abs().max()]).double()
        return scales_from_max(self.coll.all_reduce(max_abs, "max"),
                               self.num_data)


class _BlockSplits:
    """Feature-block metadata and the all-gather argmax of the strategies
    that partition features (or bundles) into contiguous rank blocks."""

    @property
    def rank(self) -> int:
        return self.coll.rank

    def block_meta(self, feature_ok, num_bins, missing_code, default_bin,
                   is_cat, cat_idx=None) -> BlockMeta:
        i, b = self.rank, self.block
        return BlockMeta(
            _block_slice(feature_ok, i, b), _block_slice(num_bins, i, b),
            _block_slice(missing_code, i, b), _block_slice(default_bin, i, b),
            _block_slice(is_cat, i, b), i * b, _local_cat_idx(cat_idx,
                                                              i * b, b))

    def find_splits(self, hist, pg, ph, pc, bm: BlockMeta, spec,
                    bundle=None) -> SplitCandidates:
        return _gather_argmax(find_block_splits(hist, pg, ph, pc, bm, spec,
                                                bundle), self.coll,
                              spec.use_categorical)


class _BundleBlocks(_BlockSplits):
    """Bundled columns as the partitioned unit (both EFB strategies): the
    metadata stays full width, masked to the member features of this
    rank's bundle block, and the scan reads block-local code tables."""

    bundled_blocks = True

    @property
    def block(self) -> int:
        return self.num_bundles // self.num_devices

    def block_meta(self, feature_ok, num_bins, missing_code, default_bin,
                   is_cat, cat_idx=None) -> BlockMeta:
        owned = torch.div(self.bundle_col, self.block,
                          rounding_mode="floor") == self.rank
        return BlockMeta(feature_ok & owned, num_bins, missing_code,
                         default_bin, is_cat, 0, cat_idx)

    def localize_bundle(self, bundle):
        """Global bundle tables -> this rank's block view: the ``[F]``
        column map shifted into the block (clipped; features outside it
        are masked off by ``block_meta``) and the ``[G, Bb]`` code-owner
        table sliced to the owned columns."""
        i, b = self.rank, self.block
        return bundle._replace(
            col=torch.clamp(bundle.col - i * b, 0, b - 1),
            code_feat=bundle.code_feat[i * b:(i + 1) * b].contiguous())


@dataclass(frozen=True)
class DataParallelComm(_RowSharded, _BlockSplits):
    """Rows sharded by rank; the pass's integer sums reduce-scattered over
    feature blocks (reference ReduceScatter of HistogramBinEntry,
    data_parallel_tree_learner.cpp:148-163)."""
    coll: Collectives
    num_devices: int
    num_features: int                # padded: divisible by num_devices
    num_data: int                    # rows of the world, padding excluded

    reduces_sums = True
    bundled_blocks = False

    @property
    def block(self) -> int:
        return self.num_features // self.num_devices

    def hist_X(self, X):
        return X                      # all features, local rows

    def reduce_sums(self, acc, out):
        """B1's ``[S, F, B]`` integer sums (``acc``) -> this rank's block of
        the world's sums (``out``, ``[S, F/D, B]``), exact."""
        _reduce_scatter_sums(self.coll, acc, out)
        return out

    def reduced_hist_features(self, F_hist: int) -> int:
        return self.block

    def collective_bytes(self, num_slots: int, num_bins_padded: int,
                         use_categorical: bool = True,
                         hist_bins: int = None) -> dict:
        """Per wave: the reduce-scatter of the ``num_slots`` fresh
        histograms' integer sums (the card's accumulator layout, 20 bytes
        a bin: u64 g, u64 h, u32 count; siblings derive locally) and the
        candidate all-gather over the ``2 * num_slots`` scanned leaves; per
        tree the f64 root sums and the scales' MAX."""
        return {
            "psum_root_scalars": 3 * 8 + 2 * 8,
            "psum_scatter_hist": (num_slots * self.num_features
                                  * num_bins_padded * 20),
            "allgather_splits": (self.num_devices * 2 * num_slots
                                 * _split_candidate_bytes(num_bins_padded,
                                                          use_categorical)),
        }


@dataclass(frozen=True)
class FeatureParallelComm(_BlockSplits):
    """Rows replicated; each rank histograms one feature block."""
    coll: Collectives
    num_devices: int
    num_features: int                # padded: divisible by num_devices

    reduces_sums = False
    bundled_blocks = False
    root_sums = SerialComm.root_sums
    histogram_scales = SerialComm.histogram_scales
    reduce_hist = SerialComm.reduce_hist
    reduced_hist_features = SerialComm.reduced_hist_features

    @property
    def block(self) -> int:
        return self.num_features // self.num_devices

    def hist_X(self, X):
        i, b = self.rank, self.block
        return X[:, i * b:(i + 1) * b].contiguous()

    def collective_bytes(self, num_slots: int, num_bins_padded: int,
                         use_categorical: bool = True,
                         hist_bins: int = None) -> dict:
        """Feature-parallel never moves histograms: the only wave
        collective is the candidate all-gather."""
        return {
            "allgather_splits": (self.num_devices * 2 * num_slots
                                 * _split_candidate_bytes(num_bins_padded,
                                                          use_categorical)),
        }


@dataclass(frozen=True)
class FeatureParallelBundledComm(_BundleBlocks):
    """Feature-parallel under EFB: bundled columns are the partitioned unit
    (the reference partitions post-EFB feature groups,
    feature_parallel_tree_learner.cpp:31-50). Each rank histograms and
    caches its block of bundled columns and scans only their members; the
    candidates carry global feature indices."""
    coll: Collectives
    num_devices: int
    num_features: int                # F_pad: original feature space width
    num_bundles: int                 # G_pad: divisible by num_devices
    bundle_col: torch.Tensor         # [F_pad] i32 bundled column of f

    reduces_sums = False
    root_sums = SerialComm.root_sums
    histogram_scales = SerialComm.histogram_scales
    reduce_hist = SerialComm.reduce_hist
    reduced_hist_features = SerialComm.reduced_hist_features

    def hist_X(self, X):
        i, b = self.rank, self.block
        return X[:, i * b:(i + 1) * b].contiguous()

    def collective_bytes(self, num_slots: int, num_bins_padded: int,
                         use_categorical: bool = True,
                         hist_bins: int = None) -> dict:
        return FeatureParallelComm.collective_bytes(
            self, num_slots, num_bins_padded, use_categorical, hist_bins)


@dataclass(frozen=True)
class DataParallelBundledComm(_RowSharded, _BundleBlocks):
    """Data-parallel under EFB: rows sharded, the integer sums
    reduce-scattered over bundle-column blocks (the collective shrinks
    from ``F * B`` to ``G * Bb`` bins); each rank scans the members of its
    bundle block with block-local code tables."""
    coll: Collectives
    num_devices: int
    num_features: int                # F_pad: original feature space width
    num_bundles: int                 # G_pad: divisible by num_devices
    bundle_col: torch.Tensor         # [F_pad] i32 bundled column of f
    num_data: int                    # rows of the world, padding excluded

    reduces_sums = True

    def hist_X(self, X):
        return X                      # all bundled columns, local rows

    reduce_sums = DataParallelComm.reduce_sums

    def reduced_hist_features(self, F_hist: int) -> int:
        return self.block

    def collective_bytes(self, num_slots: int, num_bins_padded: int,
                         use_categorical: bool = True,
                         hist_bins: int = None) -> dict:
        """Like :class:`DataParallelComm`, with the reduce-scatter bundle
        space wide: ``num_bundles * hist_bins`` bins."""
        return {
            "psum_root_scalars": 3 * 8 + 2 * 8,
            "psum_scatter_hist": (num_slots * self.num_bundles
                                  * (hist_bins or num_bins_padded) * 20),
            "allgather_splits": (self.num_devices * 2 * num_slots
                                 * _split_candidate_bytes(num_bins_padded,
                                                          use_categorical)),
        }


def _stable_top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``k`` largest, descending,
    the lower index first among equal values (``torch.topk`` promises no
    order among ties)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


@dataclass(frozen=True)
class VotingParallelComm(_RowSharded):
    """Rows sharded; PV-Tree two-phase split finding with top-k voting
    (voting_parallel_tree_learner.cpp). The grower's histograms and cache
    stay local, converted at the world's fixed-point scale."""
    coll: Collectives
    num_devices: int
    num_features: int
    top_k: int
    num_data: int                    # rows of the world, padding excluded

    reduces_sums = False
    bundled_blocks = False
    reduced_hist_features = SerialComm.reduced_hist_features
    block_meta = SerialComm.block_meta

    def hist_X(self, X):
        return X

    def reduce_hist(self, hist):
        return hist                   # kept local; reduced per vote

    def find_splits(self, hist, pg, ph, pc, bm: BlockMeta, spec,
                    bundle=None) -> SplitCandidates:
        S, B = hist.shape[0], hist.shape[2]
        F = self.num_features
        D = self.num_devices
        dev = hist.device
        k = max(1, min(self.top_k, F))
        k2 = min(2 * k, F)

        # phase 1: local proposals from the local leaf sums (column 0's
        # bins partition the local rows) under min_data / D and
        # min_hessian / D (voting_parallel_tree_learner.cpp:54-56, :286)
        local = hist[:, 0].double().sum(dim=1).float()             # [S, 3]
        local_spec = dataclasses.replace(
            spec, min_data_in_leaf=spec.min_data_in_leaf / D,
            min_sum_hessian_in_leaf=spec.min_sum_hessian_in_leaf / D)
        pf_local, _ = block_per_feature(hist, local[:, 0], local[:, 1],
                                        local[:, 2], bm, local_spec, bundle)
        local_gain = pf_local.gain                                 # [S, F]
        top_gain, top_feat = _stable_top(local_gain, k)            # [S, k]
        finite = torch.isfinite(local_gain)
        # one all-reduce: the votes (GlobalVoting :165) and the summed
        # finite local gains, in f64 (exact for the votes; rounded once)
        both = torch.zeros((2, S, F), dtype=torch.float64, device=dev)
        both[0].scatter_add_(1, top_feat,
                             torch.isfinite(top_gain).double())
        both[1] = torch.where(finite, local_gain, 0.0).double()
        self.coll.all_reduce(both)
        votes = both[0].long()
        sum_gain = both[1].float()

        # phase 2: the exact lexicographic (votes, summed gain) order —
        # each gain is replaced by its rank in the slot (an integer < F),
        # so votes * F + rank is exact at any gain magnitude
        order = torch.sort(sum_gain, dim=1, stable=True).indices   # ascending
        gain_rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(F, device=dev).expand(S, F).contiguous())
        _, sel = _stable_top(votes * F + gain_rank, k2)            # [S, k2]
        rows = torch.arange(S, device=dev)[:, None]
        if bundle is not None:
            # reduce only the winners' bundled columns, and scan each
            # selected member on its own column (a one-member bundle
            # view; the default-bin hole at off + db stays unowned)
            sel_col = bundle.col[sel].long()                       # [S, k2]
            sel_hist = self._reduce_selected(hist[rows, sel_col])
            iota_c = torch.arange(hist.shape[2], dtype=torch.int32,
                                  device=dev)
            jidx = torch.arange(k2, dtype=torch.int32, device=dev)
            ok = bm.feature_ok & ~bm.is_cat
            cands = []
            for s in range(S):
                f = sel[s]
                lo, hi, off = bundle.lo[f], bundle.hi[f], bundle.off[f]
                db = bm.default_bin[f]
                owned = ((iota_c[None, :] >= lo[:, None])
                         & (iota_c[None, :] < hi[:, None])
                         & (iota_c[None, :] != (off + db)[:, None]))
                cf = torch.where(owned, jidx[:, None], -1).to(torch.int32)
                pf = per_feature_best_bundled(
                    sel_hist[s:s + 1], pg[s:s + 1], ph[s:s + 1], pc[s:s + 1],
                    bm.num_bins[f], bm.missing_code[f], db, ok[f], jidx, lo,
                    hi, off, cf, **spec.hyperparams())
                cands.append(reduce_features(
                    pf, num_bins_padded=spec.num_bins_padded))
        elif not spec.use_categorical:
            # every slot's selected columns as the columns of one slot,
            # each with its own slot's parent sums: one numerical scan
            sel_hist = self._reduce_selected(hist[rows, sel])      # [S,k2,B,3]
            f = sel.reshape(-1)
            pf = per_feature_best_numerical(
                sel_hist.reshape(1, S * k2, B, 3),
                *[p.repeat_interleave(k2)[None] for p in (pg, ph, pc)],
                bm.num_bins[f], bm.missing_code[f], bm.default_bin[f],
                (bm.feature_ok & ~bm.is_cat)[f], **spec.hyperparams())
            cands = [reduce_features(PerFeatureBest(
                *[a.reshape(S, k2) for a in pf]), num_bins_padded=B)]
        else:
            sel_hist = self._reduce_selected(hist[rows, sel])      # [S,k2,B,3]
            cands = []
            for s in range(S):
                f = sel[s]
                cat_idx = None
                if spec.use_categorical:
                    ci = torch.nonzero(bm.is_cat[f]).flatten()
                    cat_idx = ci if ci.numel() else None
                bm_slot = BlockMeta(bm.feature_ok[f], bm.num_bins[f],
                                    bm.missing_code[f], bm.default_bin[f],
                                    bm.is_cat[f], 0, cat_idx)
                cands.append(find_block_splits(
                    sel_hist[s:s + 1], pg[s:s + 1], ph[s:s + 1], pc[s:s + 1],
                    bm_slot, spec))
        cand = SplitCandidates(*[torch.cat(c) for c in zip(*cands)])
        # local candidate index -> global feature id
        feat = sel[torch.arange(S, device=dev), cand.feature.long()]
        return cand._replace(feature=feat.to(torch.int32))

    def _reduce_selected(self, sel_hist: torch.Tensor) -> torch.Tensor:
        """The selected columns summed over the ranks in f64, rounded once
        to f32 (CopyLocalHistogram + the reduce, :197)."""
        return self.coll.all_reduce(sel_hist.double()).float()

    def collective_bytes(self, num_slots: int, num_bins_padded: int,
                         use_categorical: bool = True,
                         hist_bins: int = None) -> dict:
        """PV-Tree's O(k/F) trade: the votes and summed gains ``[2, S, F]``
        f64 in one all-reduce, and only the ``2k`` winning columns'
        histograms (f64), over the ``2 * num_slots`` scanned leaves."""
        F = self.num_features
        k2 = min(2 * max(1, min(self.top_k, F)), F)
        scan_slots = 2 * num_slots
        return {
            "psum_root_scalars": 3 * 8 + 2 * 8,
            "psum_votes_gains": 2 * scan_slots * F * 8,
            "psum_selected_hist": (scan_slots * k2
                                   * (hist_bins or num_bins_padded) * 3 * 8),
        }


def choose_tree_learner(num_data: int, num_features: int, n_devices: int,
                        top_k: int = 20, mesh_axis: str = "auto") -> str:
    """Resolve ``tree_learner=auto`` from the shape class (the reference's
    Parallel-Learning-Guide table; ``comm.py:669`` there): few rows and
    many features -> feature-parallel; many rows -> data-parallel; many of
    both -> voting-parallel, only when ``F >= 8 * top_k``. ``mesh_axis``
    (``tpu_mesh_axis``): ``rows`` keeps to data/voting, ``features``
    forces feature-parallel. One rank is serial."""
    if n_devices <= 1:
        return "serial"
    large_data = num_data >= 1_000_000
    large_feature = num_features >= 256
    if mesh_axis == "features":
        return "feature"
    if large_data and large_feature and num_features >= 8 * max(top_k, 1):
        return "voting"
    if not large_data and large_feature and mesh_axis != "rows":
        return "feature"
    return "data"


class ParallelContext:
    """Process group + strategy for one booster (``comm.py:700`` there,
    which holds a mesh): the group, this process's rank, the world size
    and the device it trains on. ``strategy`` follows the reference's
    ``tree_learner`` values; a world of one collapses to ``serial``, as the
    JAX package collapses one device."""

    def __init__(self, strategy: str, group=None, rank: int = 0,
                 world: int = 1, device=None, top_k: int = 20):
        self.strategy = strategy
        self.top_k = top_k
        self.device = device
        if strategy == "serial" or world <= 1:
            self.strategy = "serial"
            group, rank, world = None, 0, 1
        self.group, self.rank, self.num_devices = group, int(rank), int(world)
        self.coll = None if self.strategy == "serial" else \
            Collectives(group, rank, world)

    @property
    def axis_kind(self) -> str:
        """Which dataset dimension the ranks shard: ``rows`` (data/voting),
        ``features`` (feature-parallel), ``none`` (serial)."""
        if self.strategy in ("data", "voting"):
            return "rows"
        if self.strategy == "feature":
            return "features"
        return "none"

    @property
    def multi_process(self) -> bool:
        return self.num_devices > 1

    def describe(self) -> dict:
        """Host-side facts of the world for telemetry."""
        return {"strategy": self.strategy,
                "n_devices": self.num_devices,
                "rank": self.rank,
                "mesh_axis": self.axis_kind,
                "multi_process": self.multi_process,
                "backend": None if self.coll is None else self.coll.backend,
                "platform": None if self.device is None
                else self.device.type}

    def residency_key(self) -> tuple:
        """Hashable fingerprint of everything that decides where a tensor
        lives under this context."""
        return (self.strategy, self.axis_kind, self.num_devices, self.rank,
                str(self.device))

    def pad_features_to(self, F: int) -> int:
        """Feature-block strategies need F divisible by the world size."""
        if self.strategy in ("data", "feature") and self.num_devices > 1:
            D = self.num_devices
            return ((F + D - 1) // D) * D
        return F

    def pad_rows_multiple(self) -> int:
        """Row padding granularity (rows sharded -> a multiple of D)."""
        return self.num_devices if self.strategy in ("data", "voting") \
            else 1

    def make_comm(self, num_features: int, num_data: int,
                  num_bundles: int = 0, bundle_col=None):
        """The strategy object; ``num_bundles > 0`` selects the bundled
        comm of the block strategies (``comm.py:775-799`` there).
        ``num_data`` is the world's row count (the scales')."""
        c, D = self.coll, self.num_devices
        if self.strategy == "data":
            if num_bundles:
                return DataParallelBundledComm(c, D, num_features,
                                               num_bundles, bundle_col,
                                               num_data)
            return DataParallelComm(c, D, num_features, num_data)
        if self.strategy == "feature":
            if num_bundles:
                return FeatureParallelBundledComm(c, D, num_features,
                                                  num_bundles, bundle_col)
            return FeatureParallelComm(c, D, num_features)
        if self.strategy == "voting":
            return VotingParallelComm(c, D, num_features, self.top_k,
                                      num_data)
        return SerialComm(num_features)


# ---------------------------------------------------------------------------
# host side: the machine list, rank discovery, setup-time exchanges
# ---------------------------------------------------------------------------

def parse_machine_list(config) -> list:
    """Machine list as ``[(host, port), ...]`` from ``machines`` (comma- or
    newline-separated ``host:port`` / ``host port``) or
    ``machine_list_file`` (reference NetworkConfig, config.h:264-272).
    A malformed entry raises a ValueError naming it."""
    text = config.machines or ""
    if not text and config.machine_list_file:
        with open(config.machine_list_file) as fh:
            text = fh.read()
    out = []
    for chunk in text.replace(",", "\n").splitlines():
        chunk = chunk.strip()
        if not chunk:
            continue
        if ":" in chunk:
            host, _, port_s = chunk.partition(":")
        else:
            parts = chunk.split()
            host, port_s = (parts[0], parts[1]) if len(parts) == 2 else \
                (chunk, "")
        host, port_s = host.strip(), port_s.strip()
        try:
            port = int(port_s)
        except ValueError:
            port = -1
        if not host or ":" in port_s or not (0 < port < 65536):
            raise ValueError(
                f"malformed machine list entry {chunk!r}: expected "
                f"'host:port' or 'host port' with port in 1..65535 "
                f"(e.g. '10.0.0.1:12400')")
        out.append((host, port))
    return out


def _local_names() -> set:
    import socket
    names = {"localhost", "127.0.0.1", socket.gethostname()}
    try:
        names.update(socket.gethostbyname_ex(socket.gethostname())[2])
    except OSError:
        pass
    return names


def _local_rank(machines, local_listen_port: int) -> int:
    """This process's rank: the machine-list entry whose host is a local
    address and whose port is ``local_listen_port`` (the reference's rank
    discovery, linkers_socket.cpp:20-47); else the one local entry."""
    local_names = _local_names()
    matches = [i for i, (h, p) in enumerate(machines)
               if p == local_listen_port and (h in local_names)]
    if len(matches) == 1:
        return matches[0]
    host_matches = [i for i, (h, _) in enumerate(machines) if h in local_names]
    if len(host_matches) == 1:
        return host_matches[0]
    raise RuntimeError(
        f"cannot determine machine rank: {len(matches)} machine-list entries "
        f"match local addresses {sorted(local_names)} with port "
        f"{local_listen_port}")


def local_device_index(config, rank: int) -> int:
    """Index of ``rank`` among the machine list's entries on this host (the
    card a rank of this host takes, before the modulo by the card count);
    ``rank`` itself without a machine list."""
    machines = parse_machine_list(config) if (
        config.machines or config.machine_list_file) else []
    if not machines:
        return int(rank)
    local = _local_names()
    on_host = [i for i, (h, _) in enumerate(machines) if h in local]
    return on_host.index(rank) if rank in on_host else int(rank)


class _PerThreadSeq:
    """The host_allgather sequence counter, kept per thread (``comm.py:904``
    there). A world has one process per rank, so module state advances in
    lockstep; the thread-per-rank gang tests over one in-process store need
    the same isolation, or concurrent ranks take each other's sequence
    numbers and the exchange keys never meet. Indexable like a list."""

    def __init__(self):
        import threading
        self._local = threading.local()

    def _lst(self):
        lst = getattr(self._local, "lst", None)
        if lst is None:
            lst = self._local.lst = [0]
        return lst

    def __getitem__(self, i):
        return self._lst()[i]

    def __setitem__(self, i, value):
        self._lst()[i] = value


_host_allgather_seq = _PerThreadSeq()
# the key-value store init_distributed created (None: use the default
# group's own store)
_store: dict = {}
# fault injection (robustness/chaos.install_kv_chaos): when set, every store
# this module hands out is wrapped before use
_client_wrapper = None

# rank 0 serves the world's TCPStore (init_distributed); when it dies every
# store call of a survivor fails at once
STORE_HOST_RANK = 0

# what a store call raises when the TCPStore's host is gone: torch's
# DistNetworkError (its class, or in older builds its message on a bare
# RuntimeError). A gloo collective's "connection reset by peer" is not one:
# it names no rank, and the leases attribute it
_STORE_LOSS_SIGNATURES = (
    "connection was likely closed", "did the remote server shutdown")


def distributed_store():
    """The store of the world: the one :func:`init_distributed` made, else
    the default process group's; None without a group. Routed through the
    fault-injection wrapper when one is installed."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return None
    store = _store.get("store") or \
        dist.distributed_c10d._get_default_store()
    return wrap_store(store)


def wrap_store(store):
    """``store`` through the installed fault-injection wrapper, if any."""
    if store is not None and _client_wrapper is not None:
        return _client_wrapper(store)
    return store


def world_rank_and_size():
    """``(rank, world)`` of the live default group; ``(0, 1)`` without one."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_store_loss(exc: BaseException) -> bool:
    """True when ``exc`` (or an exception it was raised from) is the
    store's connection failing: the store's host, rank 0, is gone. A
    timeout waiting on a key is not (the store answered)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if type(exc).__name__ == "DistNetworkError":
            return True
        msg = str(exc).lower()
        if any(sig in msg for sig in _STORE_LOSS_SIGNATURES):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def store_loss_error(exc: BaseException, what: str):
    """The typed error of a store call that failed because the store's
    host is gone: ``PeerLostError`` naming rank 0 (exit 145 at the top),
    never a hang or a bare traceback. None when ``exc`` is not that."""
    if not is_store_loss(exc):
        return None
    from ..robustness.retry import PeerLostError
    from .. import observability as obs
    obs.inc("fault.peer_lost")
    detail = f"{type(exc).__name__}: {exc}".splitlines()[0][:300]
    return PeerLostError(
        f"{what}: the key-value store is unreachable — its host, peer rank "
        f"{STORE_HOST_RANK}, is lost ({detail})", rank=STORE_HOST_RANK)


def host_allgather(obj, tag: str, timeout_ms: int = 600_000, *,
                   client=None, rank: int = None, world: int = None) -> list:
    """Gather one picklable object per process, in rank order
    (``comm.py:938`` there; the reference's Network::Allgather of setup
    payloads: serialized BinMappers, dataset_loader.cpp:889, and the row
    counts of pre-partitioned data). The exchange goes through the world's
    key-value store (``torch.distributed`` ``TCPStore``). The call sequence
    must be the same on every process, which makes the per-tag sequence
    number agree.

    The set and each peer's get + unpickle are retried with backoff
    (``robustness/retry.py``); a peer that never arrives raises
    ``PeerLostError`` (a ``CommTimeoutError``) naming the tag, the sequence
    number and both ranks. Every rank passes a done-barrier before it
    deletes its own key; a failed barrier is logged and leaves the key.
    ``client`` (a store: ``set``, ``get``, ``wait``, ``add``,
    ``delete_key``), ``rank`` and ``world`` are injectable for tests."""
    from ..robustness.retry import PeerLostError, comm_attempts, retry_call
    from .. import observability as obs
    dist = _dist()
    if client is None:
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return [obj]
        client = distributed_store()
    rank = dist.get_rank() if rank is None else int(rank)
    world = dist.get_world_size() if world is None else int(world)
    if world <= 1:
        return [obj]
    seq = _host_allgather_seq[0]
    _host_allgather_seq[0] += 1
    key = f"lgbm_hostgather/{tag}/{seq}"
    payload = pickle.dumps(obj)
    obs.inc("comm.host_allgather")
    with obs.span("comm", op="host_allgather", tag=tag, seq=seq, rank=rank,
                  world=world):
        try:
            retry_call(lambda: client.set(f"{key}/{rank}", payload),
                       what=f"host_allgather set tag={tag!r} seq={seq} "
                            f"rank={rank}")
        except Exception as e:
            typed = store_loss_error(e, f"host_allgather tag={tag!r} "
                                        f"seq={seq} rank={rank}")
            if typed is not None:
                raise typed from e
            raise
        per_attempt = datetime.timedelta(
            milliseconds=max(1, timeout_ms // comm_attempts()))
        out = []
        for r in range(world):
            if r == rank:
                out.append(obj)
                continue

            def _get(r=r):
                client.wait([f"{key}/{r}"], per_attempt)
                return pickle.loads(client.get(f"{key}/{r}"))

            try:
                out.append(retry_call(
                    _get, what=f"host_allgather get tag={tag!r} seq={seq} "
                               f"rank={rank}<-{r}"))
            except Exception as e:
                typed = store_loss_error(e, f"host_allgather tag={tag!r} "
                                            f"seq={seq} rank={rank}<-{r}")
                if typed is not None:
                    raise typed from e
                obs.inc("comm.timeouts")
                obs.inc("fault.peer_lost")
                raise PeerLostError(
                    f"host_allgather tag={tag!r} seq={seq}: rank {rank} "
                    f"could not fetch rank {r}'s shard within "
                    f"~{timeout_ms} ms total — peer rank {r} is the "
                    f"missing/slowest rank in this exchange "
                    f"({e.__class__.__name__}: {e})", rank=r) from e
        # every rank must have read every shard before any key disappears
        done = f"{key}/done"
        what = f"host_allgather tag={tag!r} seq={seq} rank={rank}"
        try:
            cycle = arrive_and_wait(client, done, world, timeout_ms,
                                    what=what)
        except TimeoutError:
            obs.inc("comm.barrier_failures")
            Log.warning("host_allgather tag=%r seq=%d rank=%d: cleanup "
                        "barrier timed out; leaving key %s/%d", tag, seq,
                        rank, key, rank)
            return out
        try:
            client.delete_key(f"{key}/{rank}")
        except Exception as e:
            typed = store_loss_error(e, what)
            if typed is not None:
                raise typed from e
            raise
        leave_last(client, f"{key}/left", rank, world, cycle, timeout_ms,
                   what=what)
        return out


def arrive_and_wait(client, key: str, world: int, timeout_ms: int, *,
                    what: str, probe=None, poll_s: float = 0.001) -> int:
    """A barrier on the store, which has none: ``add(key, 1)``, then poll
    ``add(key, 0)`` until the arrivals reach the next multiple of ``world``
    (a key used again, as thread-per-rank tests do, forms a new barrier).
    ``probe()`` (a heartbeat lease's, rate-limited) runs between polls and
    raises ``PeerLostError`` for a peer that died before arriving. A store
    whose host is gone raises ``PeerLostError`` naming it; past
    ``timeout_ms`` a ``TimeoutError``. Returns the barrier's cycle (1 the
    first time a key is used), for :func:`leave_last`."""
    try:
        n = client.add(key, 1)
        cycle = -(-n // world)
        deadline = time.monotonic() + timeout_ms / 1e3
        while client.add(key, 0) < cycle * world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: barrier {key!r} saw fewer than "
                                   f"{world} arrivals in {timeout_ms} ms")
            if probe is not None:
                probe()
            time.sleep(poll_s)
        return cycle
    except Exception as e:
        typed = store_loss_error(e, what)
        if typed is not None:
            raise typed from e
        raise


def leave_last(client, key: str, rank: int, world: int, cycle: int,
               timeout_ms: int, *, what: str, probe=None,
               poll_s: float = 0.001) -> None:
    """Rank 0 hosts the store and takes it with it when its process ends,
    so it leaves an exchange last: every other rank marks its last use of
    the exchange's keys (``add(key, 1)``) and goes on; rank 0 returns once
    all of them have (the ``cycle``-th time ``key`` is used), so that it
    never ends while a peer still polls a barrier. A peer lost in between
    is not waited for past ``timeout_ms`` (logged)."""
    try:
        if rank != 0:
            client.add(key, 1)
            return
        deadline = time.monotonic() + timeout_ms / 1e3
        while client.add(key, 0) < cycle * (world - 1):
            if time.monotonic() > deadline:
                Log.warning("%s: rank 0 stopped waiting for the other "
                            "ranks to leave %r after %d ms", what, key,
                            timeout_ms)
                return
            if probe is not None:
                probe()
            time.sleep(poll_s)
    except Exception as e:
        typed = store_loss_error(e, what)
        if typed is not None:
            raise typed from e
        raise


def _leave_world_at_exit() -> None:
    """Destroy the gloo world :func:`init_distributed` joined before the
    interpreter finalizes. Left to finalization, the group's threads are
    torn down in no set order, and a rank whose work was all done could
    abort as it exits ("terminate called without an active exception").
    Destroying a gloo group is local to the rank, so a peer that has
    already gone does not hold it up."""
    dist = _dist()
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception as e:          # the process is ending: never raise
        Log.debug("leaving the world at exit: %s: %s", type(e).__name__, e)


def init_distributed(config) -> bool:
    """Join the world the network parameters describe (reference
    Network::Init and rank discovery, application.cpp:167-178,
    linkers_socket.cpp:20-47; ``comm.py:1115`` there): a ``TCPStore`` on
    the machine list's first entry (rank 0 serves it), handed to
    ``init_process_group`` with NCCL when the booster trains on the card
    and gloo on the CPU. A default group the caller already made is used
    as it stands (this is how a caller picks gloo on the card). Returns
    True when a world of more than one process is up."""
    dist = _dist()
    if not dist.is_available():
        if getattr(config, "num_machines", 1) > 1:
            Log.fatal("num_machines=%d needs torch.distributed, which this "
                      "PyTorch build lacks", config.num_machines)
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if getattr(config, "num_machines", 1) <= 1:
        return False
    machines = parse_machine_list(config)
    if len(machines) <= 1:
        return False
    if len(machines) != config.num_machines:
        Log.warning("num_machines=%d but machine list has %d entries; "
                    "using the list", config.num_machines, len(machines))
    world = len(machines)
    rank = _local_rank(machines, config.local_listen_port)
    host, port = machines[0]
    on_card = str(config.device).lower() != "cpu"
    backend = "nccl" if on_card else "gloo"
    if on_card:
        torch.cuda.set_device(local_device_index(config, rank)
                              % max(torch.cuda.device_count(), 1))
    timeout = datetime.timedelta(minutes=config.time_out)
    from ..robustness.retry import CommTimeoutError, retry_call
    from .. import observability as obs

    def _connect():
        return dist.TCPStore(host, port, world, rank == 0, timeout=timeout,
                             wait_for_workers=False)

    try:
        with obs.span("comm", op="init_distributed", coordinator=host,
                      rank=rank, world=world):
            store = retry_call(_connect,
                               what=f"TCPStore {host}:{port} rank="
                                    f"{rank}/{world}")
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world, timeout=timeout)
    except Exception as e:
        obs.inc("comm.timeouts")
        raise CommTimeoutError(
            f"init_distributed: rank {rank} could not join the process "
            f"group at {host}:{port} (world size {world}, backend "
            f"{backend}, timeout {config.time_out} min): "
            f"{type(e).__name__}: {e}") from e
    _store["store"] = store
    if backend == "gloo" and not _store.get("leaves_at_exit"):
        _store["leaves_at_exit"] = True
        atexit.register(_leave_world_at_exit)
    Log.info("joined a world of %d processes as rank %d (%s, store %s:%d)",
             world, rank, backend, host, port)
    return True


def make_parallel_context(config, shape=None, device=None
                          ) -> ParallelContext:
    """The booster's context (``comm.py:1224`` there): joins the world the
    config describes (:func:`init_distributed`), resolves
    ``tree_learner=auto`` against ``shape`` (``(num_data, num_features)``)
    and the world size, and turns ``serial`` into ``data`` across
    processes, as the JAX package does."""
    strategy = getattr(config, "tree_learner", "serial")
    top_k = getattr(config, "top_k", 20)
    group, rank, world = None, 0, 1
    if init_distributed(config):
        dist = _dist()
        group, rank, world = dist.group.WORLD, dist.get_rank(), \
            dist.get_world_size()
        if strategy == "serial":
            Log.warning("tree_learner=serial is not distributed; using "
                        "tree_learner=data across %d processes", world)
            strategy = "data"
    if strategy == "auto":
        if shape is None:
            strategy = "data" if world > 1 else "serial"
            Log.warning("tree_learner=auto without a dataset shape hint; "
                        "using tree_learner=%s", strategy)
        else:
            strategy = choose_tree_learner(
                int(shape[0]), int(shape[1]), world, top_k=top_k,
                mesh_axis=getattr(config, "tpu_mesh_axis", "auto"))
            Log.info("tree_learner=auto resolved to %s (%d rows x %d "
                     "features over %d process(es), tpu_mesh_axis=%s)",
                     strategy, shape[0], shape[1], world,
                     getattr(config, "tpu_mesh_axis", "auto"))
    if device is None:
        from ..config import resolve_device
        device = resolve_device(config)
    return ParallelContext(strategy, group, rank, world, device, top_k)
