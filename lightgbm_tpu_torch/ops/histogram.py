"""Gradient/hessian histograms: the plain PyTorch version and its helpers.

Port of ``lightgbm_tpu/ops/histogram.py``. The JAX package builds the
histogram as a chunked one-hot bf16 matmul because a TPU has no fast
scatter; on the card the histogram is a scatter-add, which
``ops/cuda_histogram.py`` runs as a hand-written kernel. This module holds
the plain version of that kernel (a scatter-add with ``index_add_``) — the
CPU tests run it, and ``chip_smoke.py`` holds the kernel against it — plus
the small helpers the grower shares with the kernel's wrapper.

Output layout is the JAX package's: ``[S, F, B, 3]`` f32 holding
(sum_g, sum_h, count) per (slot, feature, bin).

Arithmetic (shared bit for bit with the kernel): g and h are f32, with no
bf16 hi/lo split. They are added as 64-bit fixed-point integers,
``q = round_half_even(x * scale)``, with one power-of-two ``scale`` per
tree for g and one for h (:func:`fixed_point_scale`), so that integer
atomics on the card make the sums independent of the order rows arrive in:
training is bit-identical run to run. A bin's result is ``float32(sum(q) /
scale)``; its error against the exact sum is at most half an f32 ulp of the
result plus ``rows_in_bin / (2 * scale)`` (the quantisation). Counts are
exact integers.

Out-of-core passes (``tpu_residency=stream``, kernel B11): a wave's
histogram is folded shard by shard into a carried ``[S, F, B, 3]`` int64
accumulator (``build_histograms(acc=..., raw_output=True)``) and converted
to f32 once per wave (:func:`finalize_histograms`). The fixed-point sums
are integers, so any split of the rows into shards gives the same bits as
one resident pass; this int64 fold replaces the JAX package's f32 carry
with its Kahan compensation (``acc_init`` / ``comp_init`` /
``raw_output`` of ``lightgbm_tpu/ops/histogram.py:293-460``). Shards
travel packed (:func:`code_mode_for`, :func:`code_bytes_total`, the byte
layouts of ``lightgbm_tpu/ops/histogram.py:112-175``) and are unpacked on
the device by :func:`unpack_codes`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..robustness import allowed_host_sync

# bound on |sum of quantised values| over every row of a pass: 2**62 keeps
# int64 accumulation clear of overflow with a factor two to spare
_FIXED_POINT_BITS = 62
# cap on the scale exponent, so that a tiny max|x| never drives the scale
# past the f64 range
_MAX_SCALE_EXP = 200


# ---------------------------------------------------------------------------
# packed code layouts of the streamed shards (lightgbm_tpu/ops/histogram.py
# :100-183): "u8" one byte a code (codes < 256), "u16" two bytes, little
# endian (max_bin above 255), "u4" two codes a byte, low nibble first
# (codes < 16), "u6" four six-bit codes in three bytes (codes < 64)
# ---------------------------------------------------------------------------

def code_mode_for(max_code: int, code_itemsize: int) -> str:
    """The tightest layout for codes below ``max_code`` stored with
    ``code_itemsize`` bytes (2: ``uint16``)."""
    if code_itemsize == 2 or max_code > 256:
        return "u16"
    if max_code <= 16:
        return "u4"
    if max_code <= 64:
        return "u6"
    return "u8"


def code_bytes_total(F: int, code_mode: str) -> int:
    """Bytes of one packed row of ``F`` codes."""
    return {"u8": F, "u16": 2 * F, "u4": (F + 1) // 2,
            "u6": ((F + 3) // 4) * 3}[code_mode]


# the widest bin count whose uint16 codes read the same as int16
INT16_CODE_BINS = 1 << 15


def device_code_dtype(num_bins: int, code_itemsize: int = 2) -> torch.dtype:
    """The dtype codes of features of at most ``num_bins`` bins take on the
    device: ``uint8`` for one-byte codes; ``int16`` holding ``uint16``
    codes below ``2**15`` (PyTorch indexes ``int16`` but not ``uint16``);
    ``int32`` where a feature has more than 32,768 bins, so that codes of
    ``2**15`` and more keep their unsigned value (ROADMAP B1c)."""
    if code_itemsize == 1:
        return torch.uint8
    return torch.int16 if int(num_bins) <= INT16_CODE_BINS else torch.int32


def unpack_codes(xb: torch.Tensor, F: int, code_mode: str,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[R, code_bytes_total(F)]`` uint8 packed rows -> ``[R, F]`` codes
    in the dtype the grower reads: ``uint8``, or ``int16`` holding
    ``uint16`` codes. ``u8`` and ``u16`` are views of ``xb`` (no copy);
    ``u4`` and ``u6`` are written into ``out`` (``[R, F]`` uint8, e.g. a
    buffer allocated once) when given. ``u16`` with an ``int32`` ``out``
    widens the codes into it, keeping codes of ``2**15`` and more
    (:func:`device_code_dtype`)."""
    R = xb.shape[0]
    if code_mode == "u8":
        return xb
    if code_mode == "u16":
        if out is not None and out.dtype == torch.int32:
            return out.copy_(xb.view(torch.int16)).bitwise_and_(0xFFFF)
        return xb.view(torch.int16)
    if code_mode == "u4":
        codes = torch.stack([xb & 15, xb >> 4], dim=-1).reshape(R, -1)
    elif code_mode == "u6":
        t = xb.reshape(R, -1, 3)
        b0, b1, b2 = t[..., 0], t[..., 1], t[..., 2]
        codes = torch.stack([b0 & 63, (b0 >> 6) | ((b1 & 15) << 2),
                             (b1 >> 4) | ((b2 & 3) << 4), b2 >> 2],
                            dim=-1).reshape(R, -1)
    else:
        raise ValueError(f"unknown code mode {code_mode!r}")
    codes = codes[:, :F]
    if out is None:
        return codes.contiguous()
    return out.copy_(codes)


def fixed_point_scale(max_abs: float, n_rows: int) -> float:
    """Largest power of two ``s`` with ``n_rows * max_abs * s < 2**62``.

    Called once per tree with the largest |g| (or |h|) over its rows, so no
    sum over any subset of them can leave the int64 range."""
    bound = float(max_abs) * max(int(n_rows), 1)
    if not (bound > 0.0 and math.isfinite(bound)):
        return 1.0
    _, e = math.frexp(bound)                     # bound < 2**e
    return math.ldexp(1.0, min(_FIXED_POINT_BITS - e, _MAX_SCALE_EXP))


def histogram_scales(grad: torch.Tensor, hess: torch.Tensor
                     ) -> torch.Tensor:
    """Per-tree fixed-point scales ``[2]`` f64 (g, h) on the rows' device:
    :func:`fixed_point_scale` computed there, bit for bit, with no host
    read. ``frexp`` gives the exponent of ``max|x| * n`` (f32 widened to
    f64, times ``n`` in f64, as on the host); the scale is built from its
    exponent bits, so it is exactly a power of two on every device."""
    n = grad.shape[0]
    if n == 0:
        return torch.ones(2, dtype=torch.float64, device=grad.device)
    max_abs = torch.stack([grad.abs().max(), hess.abs().max()]).double()
    return scales_from_max(max_abs, n)


def scales_from_max(max_abs: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`histogram_scales` from ``max_abs`` ``[2]`` f64 (the largest
    ``|g|`` and ``|h|``) and the row count ``n``; the distributed learners
    give the world's maximum and row count, so that every rank sums at the
    serial learner's scale (``parallel/comm.py``)."""
    bound = max_abs * float(n)
    _, e = torch.frexp(bound)                       # bound < 2**e
    exp = torch.clamp(_FIXED_POINT_BITS - e.long(), max=_MAX_SCALE_EXP)
    scale = ((exp + 1023) << 52).view(torch.float64)   # 2.0 ** exp
    ok = (bound > 0.0) & torch.isfinite(bound)
    return torch.where(ok, scale, 1.0)


def slot_from_position(pos: torch.Tensor, slot_cum: torch.Tensor
                       ) -> torch.Tensor:
    """Slot of each compacted position when rows are slot-grouped: slot s
    spans positions [cum[s-1], cum[s]); positions past the last slot get
    ``S``."""
    return torch.searchsorted(slot_cum, pos, right=True)


def slot_position_base(raw_slot: torch.Tensor, slot_cum: torch.Tensor,
                       slot_starts: torch.Tensor) -> torch.Tensor:
    """Additive base mapping a slot-grouped virtual position into the
    leaf-contiguous permutation: ``src = pos + base[raw_slot]`` (base 0 for
    positions past the last slot, ``raw_slot == S``)."""
    cum_before = torch.cat([slot_cum.new_zeros(1), slot_cum[:-1]])
    base = torch.cat([slot_starts.to(slot_cum.dtype) - cum_before,
                      slot_cum.new_zeros(1)])
    return base[raw_slot]


def table_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` — a plain index gather. (The JAX package's one-hot
    MXU matmul is a TPU workaround for slow gathers.)"""
    return table[idx]


def root_sums_f64(grad: torch.Tensor, hess: torch.Tensor,
                  included: torch.Tensor) -> torch.Tensor:
    """``[3]`` f64 (sum_g, sum_h, count) over included rows, before the
    rounding to f32 of :func:`root_sums`: the partials a distributed
    learner reduces over its ranks before it rounds once."""
    return torch.stack([grad.double().sum(), hess.double().sum(),
                        included.double().sum()])


def root_sums(grad: torch.Tensor, hess: torch.Tensor, included: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Total (sum_g, sum_h, count) over included rows — root LeafSplits
    init (reference src/treelearner/leaf_splits.hpp Init); f64 sums
    rounded once to f32."""
    return (grad.double().sum().float(), hess.double().sum().float(),
            included.double().sum().float())


@allowed_host_sync("the plain version: it runs for CPU tensors only")
def pass_rows(leaf_id: torch.Tensor, slot_of_leaf: torch.Tensor,
              row_idx: Optional[torch.Tensor],
              n_active: Optional[torch.Tensor],
              slot_counts: Optional[torch.Tensor],
              slot_starts: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, slot) of every row a histogram pass adds, in pass order.

    Full pass (``row_idx`` None): every row whose leaf is pending, its slot
    ``slot_of_leaf[leaf_id[r]]``. Compacted pass: positions ``[0,
    n_active)`` read through ``row_idx``, slot-grouped by ``slot_counts``
    (required; ``n_active`` a 0-d int64 tensor, or None meaning
    ``sum(slot_counts)``); with ``slot_starts`` the rows of slot s sit at
    ``row_idx[slot_starts[s]:][:slot_counts[s]]`` (the grower's incremental
    partition)."""
    if row_idx is None:
        slot = slot_of_leaf[leaf_id.long()]
        rows = torch.nonzero(slot >= 0).flatten()
        return rows, slot[rows].long()
    if slot_counts is None:
        raise ValueError("a compacted pass needs slot_counts")
    if n_active is None:
        n_active = slot_counts.long().sum()
    elif not (isinstance(n_active, torch.Tensor) and n_active.dim() == 0
              and n_active.dtype == torch.int64):
        raise TypeError("n_active must be a 0-d int64 tensor or None")
    pos = torch.arange(int(n_active), device=row_idx.device)
    slot_cum = torch.cumsum(slot_counts.long(), 0)
    slot = slot_from_position(pos, slot_cum)
    src = pos
    if slot_starts is not None:
        src = pos + slot_position_base(slot, slot_cum, slot_starts.long())
    return row_idx[src].long(), slot


def pass_positions(leaf_id: torch.Tensor, slot_of_leaf: torch.Tensor,
                   num_slots: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot-grouped positions of a pass given without a partition:
    ``(perm, slot_counts, n_active)``. ``perm`` ``[N]`` holds the pending
    rows slot by slot, ascending inside each slot (what the grower's
    partition gives), then the other rows; ``n_active`` (0-d int64) counts
    the pending rows. Derived on the rows' device by a stable sort and a
    scatter count, with no host read. A slot at or above ``num_slots`` is
    counted in no slot but in ``n_active``, so the pass runs past the last
    segment, where the kernel and :func:`pass_rows` refuse it."""
    slot = slot_of_leaf[leaf_id.long()].long()
    key = torch.where(slot >= 0, torch.clamp(slot, max=num_slots),
                      num_slots + 1)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.zeros(num_slots + 2, dtype=torch.int64,
                         device=leaf_id.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    return (perm, counts[:num_slots].to(torch.int32),
            counts[:num_slots + 1].sum())


@allowed_host_sync("the plain version: it runs for CPU tensors only")
def build_histograms(
    X: torch.Tensor,            # [N, F] uint8, int16 (uint16) or int32 codes
    grad: torch.Tensor,         # [N] f32
    hess: torch.Tensor,         # [N] f32
    included: torch.Tensor,     # [N] f32 0/1: count channel mask
    leaf_id: torch.Tensor,      # [N] i32 current leaf of each row
    slot_of_leaf: torch.Tensor,  # [L+1] i32 leaf -> slot, -1 = not pending
    num_slots: int,
    num_bins_padded: int,
    row_idx: Optional[torch.Tensor] = None,   # [N] i32 compacted pass rows
    n_active: Optional[torch.Tensor] = None,  # 0-d i64 rows of the
                                   # compacted pass; None = sum(slot_counts)
    slot_counts: Optional[torch.Tensor] = None,  # [S] i32 slot-grouped rows
    slot_starts: Optional[torch.Tensor] = None,  # [S] i32 segment starts
    scales: Optional[torch.Tensor] = None,   # [2] f64 per-tree (g, h)
    acc: Optional[torch.Tensor] = None,      # [S, F, B, 3] i64 carried sums
    raw_output: bool = False,
    tile_bins: Optional[int] = None,         # the kernel's bin tiles
) -> torch.Tensor:
    """Plain version of the histogram kernel: ``[S, F, B, 3]`` f32.

    A scatter-add of the fixed-point g/h and the 0/1 counts into
    ``[S, F, B, 3]`` int64 bins, then one conversion to f32
    (:func:`finalize_histograms`) — the kernel's arithmetic exactly (module
    docstring), so the kernel must agree with it bit for bit. With ``acc``
    the pass adds into that carried accumulator, in place (one shard's leg
    of a streamed pass); ``raw_output`` returns the accumulator instead of
    the f32 histogram. ``tile_bins`` adds the bins tile by tile, as the
    kernel does past its shared-memory limit (``ops/cuda_histogram.py``
    :func:`bin_tiles`): each tile takes only its own codes and adds at its
    offset; the integer sums equal the untiled pass's. Codes are
    ``uint8``, ``int16`` (``uint16`` codes below ``2**15``) or ``int32``.
    It reads ``n_active`` on the host: it runs for CPU tensors only."""
    N, F = X.shape
    S, B = num_slots, num_bins_padded
    if scales is None:
        scales = histogram_scales(grad, hess)
    if acc is None:
        acc = torch.zeros((S, F, B, 3), dtype=torch.int64, device=X.device)
    elif acc.dtype != torch.int64 or tuple(acc.shape) != (S, F, B, 3):
        raise ValueError(f"acc must be int64 of shape {(S, F, B, 3)}, got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    sg, sh = float(scales[0]), float(scales[1])
    rows, slot = pass_rows(leaf_id, slot_of_leaf, row_idx, n_active,
                           slot_counts, slot_starts)
    codes = X[rows].long()                                          # [n, F]
    # the kernel device-asserts on the same inputs (ops/cuda_histogram.py)
    if rows.numel() and int(slot.max()) >= S:
        raise ValueError(f"slot {int(slot.max())} >= num_slots={S} (or "
                         f"n_active past the compacted segments)")
    # an int16 code below 0 is a uint16 code of 2**15 or more
    if rows.numel() and (int(codes.max()) >= B or int(codes.min()) < 0):
        raise ValueError(f"bin code {int(codes.max())} >= "
                         f"num_bins_padded={B} (or a uint16 code >= 2**15)")
    feat = torch.arange(F, device=X.device)
    flat = ((slot[:, None] * F + feat[None, :]) * B + codes).reshape(-1)
    qg = torch.round(grad[rows].double() * sg).long()
    qh = torch.round(hess[rows].double() * sh).long()
    qc = (included[rows] != 0).long()
    flat_acc = acc.view(-1)
    weights = [q.repeat_interleave(F) for q in (qg, qh, qc)]
    tile = B if tile_bins is None else int(tile_bins)
    flat_codes = codes.reshape(-1)
    for b0 in range(0, B, tile):
        # one bin tile: its own codes, added at their offset in [S, F, B]
        mine = ((flat_codes >= b0) & (flat_codes < b0 + tile)).nonzero() \
            .flatten() if tile < B else None
        at = flat if mine is None else flat[mine]
        for c, q in enumerate(weights):
            flat_acc.index_add_(0, at * 3 + c, q if mine is None else q[mine])
    if raw_output:
        return acc
    return finalize_histograms(acc, scales)


def finalize_histograms(acc: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """``[S, F, B, 3]`` int64 sums -> f32 (sum_g, sum_h, count): the
    fixed-point sums times ``1 / scale`` in f64, rounded once to f32, as
    the kernel's ``finalize_kernel`` does (the JAX package's
    ``finalize_histograms``, ops/histogram.py:461 there)."""
    return torch.stack([(acc[..., 0].double() * (1.0 / scales[0])).float(),
                        (acc[..., 1].double() * (1.0 / scales[1])).float(),
                        acc[..., 2].float()], dim=-1)
