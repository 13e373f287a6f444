"""Wrapper of the hand-written Hopper histogram kernel (``csrc/histogram.cu``).

Port of ``lightgbm_tpu/ops/pallas_histogram.py`` (kernel B1). The kernel
reads the slot-grouped positions ``[0, n_active)`` of a partition: the
grower passes its leaf-contiguous partition ``perm`` with the per-slot
segment tables on every wave; a call without a partition (``row_idx`` None)
gets such positions derived on the device by
:func:`ops.histogram.pass_positions`. Every size that changes from pass to
pass stays on the card: ``n_active`` is the sum of ``slot_counts`` (or a
0-d int64 device tensor), the fixed-point scales a ``[2]`` f64 device
tensor, and the grid is sized once per shape for ``n_active = N``
(:func:`grid_blocks`), ``hist_kernel`` spreading the pass's own
``n_active`` over its blocks — as ``hist_pallas`` takes ``n_active`` as a
scalar-prefetch device value over a fixed grid. A pass therefore reads
nothing on the host and replays from a CUDA graph. The source note in
``csrc/histogram.cu`` states the arithmetic, its error bound, the bound at
the slice's shapes and what the design does about each cost.

Build and load: ``ops/native.py`` (library stem ``libgbdt_hist``);
:func:`declare` binds the C entries. Nothing is built or imported when this
module is imported.

Dispatch: for tensors on the CPU the wrapper runs the plain version in
``ops/histogram.py``; for CUDA tensors it launches the kernel or raises —
it never falls back. Each pass puts three operations on the stream: a
memset of the integer accumulators, ``hist_kernel`` and
``finalize_kernel``. The passes are counted on the card:
``finalize_kernel`` adds one to a per-device counter, so a pass replayed
from a CUDA graph counts where it runs and a capture counts nothing.
:func:`launch_count` reads the counters (a host sync) and
:func:`reset_launch_count` zeroes them; plain calls are not counted.

Streamed passes (``tpu_residency=stream``, kernel B11):
:class:`HistogramAccumulator` holds one wave's integer sums on the card and
drives the source's three entries apart — ``zero_`` once per wave, ``add``
once per host shard (``hist_kernel`` over the shard's code buffer, its rows'
g / h / counts read at the shard's row offset, positions derived from its
leaf ids on the card), ``finalize`` once per wave (counted as one pass).

Codes: ``uint8``; ``int16`` holding ``uint16`` codes (``max_bin`` above
255; the dataset stores ``uint16`` on the host as the JAX package does, and
the booster views it as ``int16`` on the card, where PyTorch indexes
``int16`` but not ``uint16``), which reads every code below ``2**15``
unchanged; or ``int32`` where a feature has more than 32,768 bins, so that
codes of ``2**15`` and more keep their unsigned value
(:func:`ops.histogram.device_code_dtype`).

Wide bins (ROADMAP B1c): a feature whose ``[B]`` sub-histogram does not fit
one block's shared memory (``B`` above :data:`MAX_BINS`) is histogrammed in
bin tiles of at most ``MAX_BINS`` bins (:func:`bin_tiles`), each tile a
block of its own on the grid's y axis, flushed into the same integer
accumulators at the tile's offset; a pass with such a feature runs one
feature per block. The sums are the untiled pass's integers.

Malformed input (a bin code at or above ``num_bins_padded``, a slot at or
above ``num_slots``, ``n_active`` past the compacted segments) makes the
plain version raise ``ValueError`` and the kernel fail a device assert,
which PyTorch reports at the next synchronisation, as for its own index
kernels. Neither drops such a row.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import native
from .native import check_tensor
from .histogram import (build_histograms, finalize_histograms,
                        histogram_scales, pass_positions)

SOURCE = native.source_path("histogram.cu")
STEM = "libgbdt_hist"

# Hopper's shared memory: a block may opt into 232,448 bytes; this leaves
# 2 KB of it for the kernel's static segment tables (1 KB). An SM has
# 233,472 bytes and 2048 threads; the runtime reserves 1 KB per block.
SMEM_BLOCK_LIMIT = 232448 - 2048
SMEM_PER_SM = 233472
THREADS_PER_SM = 2048
BLOCK_THREADS = 1024               # kThreads of the source
BYTES_PER_BIN = 20                 # 64-bit g and h, 32-bit count (SubHist)
# the largest padded bin count whose histogram of one feature fits a block:
# wider features are cut into bin tiles of at most this many bins
MAX_BINS = SMEM_BLOCK_LIMIT // BYTES_PER_BIN // 8 * 8
# the code dtypes the kernel reads (``CodeT`` of the source)
CODE_DTYPES = (torch.uint8, torch.int16, torch.int32)
# the fewest positions a block takes: its fixed cost is zeroing and
# flushing its sub-histogram
MIN_ROWS_PER_BLOCK = 2048

_num_sms = {}          # device index -> multiprocessor count
# device index -> [1] int64 count of the passes run there, which
# finalize_kernel adds to; kept for the process's life, since captured
# graphs hold its address
_launches: Dict[int, torch.Tensor] = {}


def declare(lib: ctypes.CDLL) -> None:
    """Bind the C entries of ``csrc/histogram.cu``; raises where its block
    size is not :data:`BLOCK_THREADS`."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gbdt_hist_build.argtypes = [
        p, i, ll, i, p, p, p, p, p, p, p, i, i, i, i, i, ll, p, p, p, p, p]
    lib.gbdt_hist_build.restype = i
    lib.gbdt_hist_acc_zero.argtypes = [p, i, i, i, p]
    lib.gbdt_hist_acc_zero.restype = i
    lib.gbdt_hist_acc_add.argtypes = [
        p, i, ll, i, p, p, p, p, p, p, p, i, i, i, i, i, ll, p, p, p]
    lib.gbdt_hist_acc_add.restype = i
    lib.gbdt_hist_acc_finalize.argtypes = [p, i, i, i, p, p, p, p]
    lib.gbdt_hist_acc_finalize.restype = i
    lib.gbdt_hist_scratch_bytes.argtypes = [i, i, i]
    lib.gbdt_hist_scratch_bytes.restype = ll
    lib.gbdt_hist_max_slots.argtypes = []
    lib.gbdt_hist_max_slots.restype = i
    lib.gbdt_hist_threads.argtypes = []
    lib.gbdt_hist_threads.restype = i
    if lib.gbdt_hist_threads() != BLOCK_THREADS:
        raise RuntimeError("csrc/histogram.cu's block size differs from "
                           "BLOCK_THREADS")


def bin_tiles(num_bins: int) -> Tuple[int, int]:
    """``(tile_bins, tiles)``: the bin tiling of one feature's ``[B]``
    sub-histogram. ``(B, 1)`` where it fits a block's shared memory (``B <=
    MAX_BINS``); beyond, the fewest tiles of at most :data:`MAX_BINS` bins,
    of equal width rounded up to 8 (ROADMAP B1c)."""
    B = int(num_bins)
    if B <= MAX_BINS:
        return B, 1
    tiles = -(-B // MAX_BINS)
    per_tile = -(-B // tiles)
    tile = -(-per_tile // 8) * 8
    return tile, -(-B // tile)


def feature_groups(num_features: int, num_bins: int,
                   code_bytes: int = 1) -> Tuple[int, int]:
    """``(group_features, groups)``: the fewest balanced feature groups
    whose ``[group_features, B]`` sub-histogram fits a block's shared
    memory, a group whole 32-bit words of codes where that costs no group.
    Where one feature does not fit (``B > MAX_BINS``), one feature per
    group, its bins cut into :func:`bin_tiles`."""
    tile, tiles = bin_tiles(num_bins)
    if tiles > 1:
        return 1, int(num_features)
    per_feature = tile * BYTES_PER_BIN
    fg_max = SMEM_BLOCK_LIMIT // per_feature
    groups = -(-num_features // fg_max)
    fg = -(-num_features // groups)
    per_word = max(1, 4 // code_bytes)
    if groups > 1 and -(-fg // per_word) * per_word <= fg_max:
        fg = -(-fg // per_word) * per_word
    return fg, -(-num_features // fg)


def grid_blocks(n_active: int, num_features: int, num_bins: int,
                code_bytes: int, num_sms: int) -> int:
    """``min(ceil(k * num_sms / (groups * tiles)), ceil(n_active /
    MIN_ROWS_PER_BLOCK))``, ``k`` the blocks an SM holds at this shared
    memory size: the x extent of the grid the wrapper launches for
    ``n_active = N`` (the worst case of the shape). ``hist_kernel`` gives
    a pass over ``n_active`` positions to the first ``min(grid,
    ceil(n_active / MIN_ROWS_PER_BLOCK))`` blocks, in equal runs, and the
    rest exit."""
    fg, groups = feature_groups(num_features, num_bins, code_bytes)
    tile, tiles = bin_tiles(num_bins)
    smem = fg * tile * BYTES_PER_BIN
    per_sm = max(1, min(THREADS_PER_SM // BLOCK_THREADS,
                        SMEM_PER_SM // (smem + 2048)))
    cap = max(1, -(-per_sm * num_sms // (groups * tiles)))
    return min(cap, -(-int(n_active) // MIN_ROWS_PER_BLOCK))


def histogram_pass_cost(n_rows: int, num_features: int, num_bins: int,
                        num_slots: int, code_bytes: int = 1,
                        derived_positions: bool = False,
                        total_rows: Optional[int] = None,
                        slot_table: int = 256) -> Dict[str, int]:
    """What one pass over ``n_rows`` rows must move and do, from its shapes
    alone: ``bytes`` reads each input byte the function needs once — the
    codes and g / h / counts of every row of the pass, plus where each row
    goes: its position in the partition (and the ``[S]`` segment tables),
    or with ``derived_positions`` (no partition) every one of the
    ``total_rows`` rows' leaf id and the ``slot_table`` entries of
    ``slot_of_leaf`` — and writes the ``[S, F, B, 3]`` f32 output once;
    ``operations`` are the three adds of each row and feature. The bound
    ``chip_smoke.py`` prints beside the kernel's time, and the
    ``histogram`` cost report (:func:`histogram_cost_report`), both come
    from here."""
    row_bytes = num_features * code_bytes + 3 * 4
    if derived_positions:
        where = (n_rows if total_rows is None else total_rows) * 4 \
            + slot_table * 4
    else:
        where = n_rows * 4 + 2 * num_slots * 4
    out = num_slots * num_features * num_bins * 3 * 4
    return {"bytes": n_rows * row_bytes + where + out,
            "operations": 3 * n_rows * num_features,
            "output_bytes": out}


def histogram_cost_report(n_rows: int, num_features: int,
                          num_bins_padded: int, num_slots: int,
                          code_bytes: int = 1, route: str = "cuda",
                          force: bool = True) -> Optional[Dict]:
    """B1's cost report at one shape class (``lightgbm_tpu/ops/
    histogram.py:476-512`` there), analytic (``observability/costs.py``):
    a pass whose ``num_slots`` pending leaves hold all ``n_rows`` rows,
    read through the grower's partition — the full wave. ``flops`` and
    ``bytes_accessed`` are :func:`histogram_pass_cost`'s; arguments are the
    codes, g / h / counts, leaf ids, partition and segment tables and the
    scales; the output the ``[S, F, B, 3]`` f32 histogram; the temp the
    kernel's integer accumulators. ``route`` names what runs the pass
    (``cuda``, or ``plain`` on the CPU). Published once per site
    (``histogram.full.s<S>``) and shape; an explicit call runs whatever
    ``costs.enabled()`` says (``force``)."""
    from ..observability import costs as obs_costs
    S, F, B, N = int(num_slots), int(num_features), int(num_bins_padded), \
        int(n_rows)
    site = f"histogram.full.s{S}"

    def make():
        c = histogram_pass_cost(N, F, B, S, code_bytes)
        args = N * F * code_bytes + 3 * N * 4 + N * 4 + N * 4 \
            + 2 * S * 4 + 2 * 8
        return obs_costs.analytic_report(
            site, dict(rows=N, features=F, bins=B, slots=S,
                       code_bytes=int(code_bytes), route=route),
            flops=c["operations"], bytes_accessed=c["bytes"],
            argument_bytes=args, output_bytes=c["output_bytes"],
            temp_bytes=S * F * B * BYTES_PER_BIN)
    return obs_costs.capture(site, make,
                             fingerprint=(N, F, B, S, int(code_bytes)),
                             force=force)


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _num_sms:
        _num_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _num_sms[idx]


def _launch_counter(dev: torch.device) -> torch.Tensor:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    counter = _launches.get(idx)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the first histogram pass on a device must run outside a "
                "CUDA graph capture: it allocates the device's launch "
                "counter and raises the kernel's shared memory limit")
        counter = _launches[idx] = torch.zeros(1, dtype=torch.int64,
                                               device=torch.device("cuda",
                                                                   idx))
    return counter


def launch_count() -> int:
    """Passes the kernel has run on the card, on every device, since the
    last :func:`reset_launch_count`: read from the counters
    ``finalize_kernel`` adds to (a host sync). 0 where no pass ran."""
    return sum(int(c.item()) for c in _launches.values())


def reset_launch_count() -> None:
    """Zero every device's launch counter, in stream order."""
    for c in _launches.values():
        c.zero_()


def build_histograms_cuda(
    X: torch.Tensor,            # [N, F] uint8, int16 (uint16) or int32 codes
    grad: torch.Tensor,         # [N] f32
    hess: torch.Tensor,         # [N] f32
    included: torch.Tensor,     # [N] f32 0/1
    leaf_id: torch.Tensor,      # [N] i32
    slot_of_leaf: torch.Tensor,  # [L+1] i32, -1 = not pending
    num_slots: int,
    num_bins_padded: int,
    row_idx: Optional[torch.Tensor] = None,    # [N] i32 partition
    n_active: Optional[torch.Tensor] = None,   # 0-d i64; None: sum of counts
    slot_counts: Optional[torch.Tensor] = None,   # [S] i32
    slot_starts: Optional[torch.Tensor] = None,   # [S] i32
    scales: Optional[torch.Tensor] = None,   # [2] f64 per-tree (g, h)
    acc: Optional["HistogramAccumulator"] = None,
) -> Optional[torch.Tensor]:
    """``[S, F, B, 3]`` f32 (sum_g, sum_h, count) — same signature and
    result as ``ops.histogram.build_histograms``, which it runs for CPU
    tensors (on the positions the card would derive, when no partition
    is given). Bin codes must be below ``num_bins_padded``. The call makes
    no host read and no host-to-device copy, and may be captured in a CUDA
    graph once a pass has run on the device outside a capture.

    With ``acc`` (a :class:`HistogramAccumulator` of the same slots,
    features and bins) the pass adds its integer sums into ``acc`` and
    returns None: the distributed learners reduce those sums over the
    ranks before one conversion (``acc.finalize``, which counts the
    pass)."""
    if X.device.type == "cpu":
        if row_idx is None:
            # the positions the card derives below: both devices run the
            # same operations around the kernel (analysis/contracts)
            row_idx, slot_counts, n_active = pass_positions(
                leaf_id, slot_of_leaf, int(num_slots))
            slot_starts = None
        if acc is not None:
            _add_cpu(acc, X, grad, hess, included, leaf_id, slot_of_leaf,
                     row_idx, n_active, slot_counts, slot_starts, scales)
            return None
        return build_histograms(X, grad, hess, included, leaf_id,
                                slot_of_leaf, num_slots, num_bins_padded,
                                row_idx=row_idx, n_active=n_active,
                                slot_counts=slot_counts,
                                slot_starts=slot_starts, scales=scales)
    N, F = X.shape
    S, B = int(num_slots), int(num_bins_padded)
    dev = X.device
    check_tensor("X", X, CODE_DTYPES)
    for name, t in (("grad", grad), ("hess", hess), ("included", included)):
        check_tensor(name, t, (torch.float32,), (N,))
    check_tensor("leaf_id", leaf_id, (torch.int32,), (N,))
    check_tensor("slot_of_leaf", slot_of_leaf, (torch.int32,))
    lib = native.load(SOURCE, STEM, declare)
    if S > lib.gbdt_hist_max_slots():
        raise ValueError(f"num_slots={S} exceeds the kernel's "
                         f"{lib.gbdt_hist_max_slots()}")
    if row_idx is not None:
        if slot_counts is None:
            raise ValueError("a compacted pass needs slot_counts")
        check_tensor("row_idx", row_idx, (torch.int32,), (N,))
        check_tensor("slot_counts", slot_counts, (torch.int32,), (S,))
        if slot_starts is not None:
            check_tensor("slot_starts", slot_starts, (torch.int32,), (S,))
    else:
        row_idx, slot_counts, n_active = pass_positions(leaf_id,
                                                        slot_of_leaf, S)
        slot_starts = None
    if n_active is not None:
        check_tensor("n_active", n_active, (torch.int64,), ())
    if scales is None:
        scales = histogram_scales(grad, hess)
    check_tensor("scales", scales, (torch.float64,), (2,))
    cb = X.element_size()
    fg, _ = feature_groups(F, B, cb)
    tile, _ = bin_tiles(B)
    blocks = grid_blocks(N, F, B, cb, _sm_count(dev))
    if acc is not None:
        if (acc.S, acc.F, acc.B) != (S, F, B) or acc.device != dev:
            raise ValueError(f"accumulator of shape {(acc.S, acc.F, acc.B)} "
                             f"on {acc.device} cannot take a pass of shape "
                             f"{(S, F, B)} on {dev}")
        native.launch(
            "histogram kernel", lib.gbdt_hist_acc_add, dev, X.data_ptr(), cb,
            N, F, grad.data_ptr(), hess.data_ptr(), included.data_ptr(),
            row_idx.data_ptr(), slot_counts.data_ptr(), _ptr(slot_starts),
            _ptr(n_active), S, B, fg, tile, blocks, MIN_ROWS_PER_BLOCK,
            scales.data_ptr(), acc.buf.data_ptr())
        return None
    # the kernel's integer accumulators; the C entry zeroes them on the stream
    scratch = torch.empty(lib.gbdt_hist_scratch_bytes(S, F, B),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((S, F, B, 3), dtype=torch.float32, device=dev)
    native.launch(
        "histogram kernel", lib.gbdt_hist_build, dev, X.data_ptr(), cb, N, F,
        grad.data_ptr(), hess.data_ptr(), included.data_ptr(),
        row_idx.data_ptr(), slot_counts.data_ptr(), _ptr(slot_starts),
        _ptr(n_active), S, B, fg, tile, blocks, MIN_ROWS_PER_BLOCK,
        scales.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        _launch_counter(dev).data_ptr())
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _add_cpu(acc: "HistogramAccumulator", X, grad, hess, included, leaf_id,
             slot_of_leaf, row_idx, n_active, slot_counts, slot_starts,
             scales) -> None:
    """The plain version's leg of ``build_histograms_cuda(acc=...)``."""
    build_histograms(X, grad, hess, included, leaf_id, slot_of_leaf, acc.S,
                     acc.B, row_idx=row_idx, n_active=n_active,
                     slot_counts=slot_counts, slot_starts=slot_starts,
                     scales=scales, acc=acc.buf, raw_output=True)


class HistogramAccumulator:
    """One wave's histogram folded over host shards (kernel B11): the
    ``[S, F, B]`` integer sums of g, h and counts in a buffer allocated
    once, added to shard by shard and converted to ``[S, F, B, 3]`` f32
    once. On the card the buffer is the kernel's accumulator layout and
    every step launches the kernel's entry (``zero_``: a memset; ``add``:
    ``hist_kernel``; ``finalize``: ``finalize_kernel``, counted as one
    pass) or raises; on the CPU it is the plain version's ``[S, F, B, 3]``
    int64 tensor (``build_histograms(acc=...)``). No step reads a device
    value on the host."""

    def __init__(self, num_slots: int, num_features: int, num_bins: int,
                 device: torch.device):
        self.S, self.F, self.B = int(num_slots), int(num_features), \
            int(num_bins)
        self.device = device
        if device.type == "cpu":
            self.buf = torch.zeros((self.S, self.F, self.B, 3),
                                   dtype=torch.int64)
            return
        self.lib = native.load(SOURCE, STEM, declare)
        if self.S > self.lib.gbdt_hist_max_slots():
            raise ValueError(f"num_slots={self.S} exceeds the kernel's "
                             f"{self.lib.gbdt_hist_max_slots()}")
        self.buf = torch.empty(
            self.lib.gbdt_hist_scratch_bytes(self.S, self.F, self.B),
            dtype=torch.uint8, device=device)

    def sums(self):
        """The integer sums as ``[(tensor, feature axis)]`` views of the
        buffer, contiguous, for a reduction over ranks: on the card the
        kernel's layout, g and h as int64 ``[2, S, F, B]`` (axis 2) and the
        counts as int32 ``[S, F, B]`` (axis 1); on the CPU the plain
        version's int64 ``[S, F, B, 3]`` (axis 1). Adding two
        accumulators' sums element by element adds their passes."""
        if self.device.type == "cpu":
            return [(self.buf, 1)]
        n = self.S * self.F * self.B
        gh = self.buf[:16 * n].view(torch.int64).view(2, self.S, self.F,
                                                      self.B)
        c = self.buf[16 * n:20 * n].view(torch.int32).view(self.S, self.F,
                                                           self.B)
        return [(gh, 2), (c, 1)]

    def zero_(self) -> None:
        """Start a wave: every sum 0."""
        if self.device.type == "cpu":
            self.buf.zero_()
            return
        native.launch("histogram accumulator memset",
                      self.lib.gbdt_hist_acc_zero, self.device,
                      self.buf.data_ptr(), self.S, self.F, self.B)

    def add(self, X: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
            included: torch.Tensor, leaf_id: torch.Tensor,
            slot_of_leaf: torch.Tensor, row0: int, num_rows: int,
            scales: torch.Tensor) -> None:
        """Add the rows ``[row0, row0 + num_rows)`` whose leaf is pending:
        ``X`` is their shard's ``[R, F]`` codes (``R >= num_rows``; rows
        past ``num_rows``, a tail shard's padding, are never read), the
        per-row tensors hold every row of the dataset."""
        n, r1 = int(num_rows), int(row0) + int(num_rows)
        if X.shape[0] < n or r1 > grad.shape[0] or X.shape[1] != self.F:
            raise ValueError(f"shard of shape {tuple(X.shape)} cannot hold "
                             f"rows [{row0}, {r1}) of {grad.shape[0]} with "
                             f"F={self.F}")
        sl = slice(int(row0), r1)
        if X.device.type == "cpu":
            # the shard's positions as the card derives them (below)
            perm, counts, n_active = pass_positions(leaf_id[sl],
                                                    slot_of_leaf, self.S)
            build_histograms(X[:n], grad[sl], hess[sl], included[sl],
                             leaf_id[sl], slot_of_leaf, self.S, self.B,
                             row_idx=perm, n_active=n_active,
                             slot_counts=counts, scales=scales,
                             acc=self.buf, raw_output=True)
            return
        N = grad.shape[0]
        check_tensor("X", X, CODE_DTYPES)
        for name, t in (("grad", grad), ("hess", hess),
                        ("included", included)):
            check_tensor(name, t, (torch.float32,), (N,))
        check_tensor("leaf_id", leaf_id, (torch.int32,), (N,))
        check_tensor("slot_of_leaf", slot_of_leaf, (torch.int32,))
        check_tensor("scales", scales, (torch.float64,), (2,))
        if n == 0:
            return
        # the shard's pending rows, slot-grouped, as positions in the shard
        perm, counts, n_active = pass_positions(leaf_id[sl], slot_of_leaf,
                                                self.S)
        cb = X.element_size()
        fg, _ = feature_groups(self.F, self.B, cb)
        tile, _ = bin_tiles(self.B)
        blocks = grid_blocks(n, self.F, self.B, cb, _sm_count(X.device))
        off = int(row0) * 4                      # f32 rows before the shard
        native.launch(
            "histogram kernel", self.lib.gbdt_hist_acc_add, self.device,
            X.data_ptr(), cb, n, self.F, grad.data_ptr() + off,
            hess.data_ptr() + off, included.data_ptr() + off,
            perm.data_ptr(), counts.data_ptr(), None, n_active.data_ptr(),
            self.S, self.B, fg, tile, blocks, MIN_ROWS_PER_BLOCK,
            scales.data_ptr(), self.buf.data_ptr())

    def finalize(self, scales: torch.Tensor) -> torch.Tensor:
        """The wave's ``[S, F, B, 3]`` f32 histogram."""
        if self.device.type == "cpu":
            return finalize_histograms(self.buf, scales)
        check_tensor("scales", scales, (torch.float64,), (2,))
        out = torch.empty((self.S, self.F, self.B, 3), dtype=torch.float32,
                          device=self.device)
        native.launch("histogram finalize", self.lib.gbdt_hist_acc_finalize,
                      self.device, self.buf.data_ptr(), self.S, self.F,
                      self.B, scales.data_ptr(), out.data_ptr(),
                      _launch_counter(self.device).data_ptr())
        return out
