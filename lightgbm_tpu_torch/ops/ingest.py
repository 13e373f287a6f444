"""Device ingest: binning on the card, double-buffered H2D chunk feeding
(``tpu_ingest=device|auto``); port of ``lightgbm_tpu/ops/ingest.py``
(ROADMAP A13, B7).

Dataset construction finds the bin mappers on the host and defers the
codes (``dataset.DeferredBinning``); the booster then ships raw f32 row
chunks to the card through pinned, double-buffered staging on a side copy
stream (``ChunkFeeder``) and bins each chunk there (``DeviceIngestor``),
writing straight into the code matrix it trains on. The host code matrix
is never built.

Bit-exactness (``tests/test_torch_ingest.py``): the codes equal
``BinMapper.value_to_bin``'s, bit for bit. Numerical columns compare in f32
against per-feature thresholds ``t_k`` = the largest f32 <= each f64 bound
``ub_k`` (``f32_floor_thresholds``), for which ``[t_k < v] == [ub_k < v]``
for every f32 ``v`` (±inf, -0.0 and exact ties included), so ``bin = sum_k
[t_k < v]``; that count is a branchless power-of-two lower bound (rows
padded with +inf to ``Tp = 2^k``; ``k`` steps each gather one pivot and
advance by ``Tp >> step`` on a strict ``<``, so duplicate collapsed
thresholds count as the naive compare-sum does). NaN searches as 0.0 and
goes to the NaN bin only where the mapper has one. Categorical columns are
clamped to ``[-1, max category + 1]`` before the f32 -> int32 cast (which
truncates toward zero, as numpy's ``astype``; the clamp keeps huge values
out of the cast, whose out-of-range result on the card is not numpy's),
then matched one-hot against the column's sorted categories; negative and
unseen categories take the last bin. Inputs must be f32-lossless
(``device_ingest_blocker``).

The JAX package jit-compiles the bin step once per chunk shape. Here the
step is PyTorch operations on fixed chunk buffers, allocated at the first
chunk of a shape and reused for every later one (the tail chunk's rows past
``n_rows`` are masked to code 0): ``compiles`` counts those allocations
and stays 1. Per ROADMAP §B a hand-written kernel replaces these
operations only once a profile on the card names this step.

Overlap: ``ChunkFeeder`` fills chunk ``j+1``'s pinned staging buffer and
enqueues its copy on the side stream while chunk ``j`` is binned; a CUDA
event per buffer keeps a staging buffer from being refilled before its
copy has run and a device buffer from being overwritten before its bin
pass has read it. A ``get`` that finds nothing prefetched is a counted,
timed stall (``LGBM_TPU_INGEST_NO_PREFETCH=1`` or
``tpu_ingest_prefetch=0`` makes every transfer one). Metrics:
``ingest.rows``, ``ingest.chunks``, ``ingest.bytes_h2d``,
``ingest.prefetch_hits``, ``ingest.stalls``, ``ingest.stall_seconds``
(histogram), under an ``ingest`` span.

The module imports numpy and torch only; the eligibility helpers are the
JAX package's, copied.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN, BinMapper
from ..utils.log import Log
from .histogram import device_code_dtype

# f32 represents every integer in [-2^24, 2^24] exactly — categories at or
# beyond this would alias under the f32 raw-value transport
_CAT_EXACT_LIMIT = 1 << 24
# one-hot category matching is O(rows * categories) per feature; past this
# width the host dict map is the better tool
_CAT_TABLE_LIMIT = 1024
# auto-sized chunks target ~4 MiB of raw f32 per H2D transfer: big enough
# to amortize per-chunk dispatch, small enough that several chunks overlap
_CHUNK_BUDGET_BYTES = 4 << 20
_CHUNK_MIN, _CHUNK_MAX = 4096, 131072


# ------------------------------------------------------------- eligibility

def f32_lossless(data: np.ndarray, probe_stride: int = 257) -> bool:
    """True when every value survives the f64 -> f32 -> f64 round trip
    (NaN == NaN). The host oracle reads values through f64
    (``value_to_bin``'s ``asarray(..., float64)``), so f64 is the fidelity
    reference; f32 input is lossless by definition. A strided probe
    rejects most non-representable matrices without paying the full
    two-pass check."""
    if data.dtype == np.float32:
        return True
    if data.dtype != np.float64:
        return False

    def _roundtrips(x: np.ndarray) -> bool:
        return bool(np.array_equal(x.astype(np.float32).astype(np.float64),
                                   x, equal_nan=True))

    if data.shape[0] > probe_stride and not _roundtrips(data[::probe_stride]):
        return False
    return _roundtrips(data)


def device_ingest_blocker(data, mappers: Sequence[BinMapper]) -> Optional[str]:
    """Why device ingest cannot serve this input, or None when it can.
    Numpy-only: runs inside dataset construction before jax is touched."""
    if hasattr(data, "tocsc"):
        return "sparse input (device ingest bins dense raw rows)"
    if data.dtype not in (np.float32, np.float64):
        return (f"raw dtype {data.dtype} (device ingest transports raw "
                f"values as f32; pass float32/float64)")
    for m in mappers:
        if m.bin_type != BIN_CATEGORICAL:
            continue
        cats = [c for c in m.categorical_2_bin if c >= 0]
        if len(cats) > _CAT_TABLE_LIMIT:
            return (f"categorical feature with {len(cats)} categories "
                    f"(> {_CAT_TABLE_LIMIT}: one-hot table match would "
                    f"dominate the bin kernel)")
        if cats and max(cats) >= _CAT_EXACT_LIMIT:
            return (f"categorical value {max(cats)} >= 2^24 "
                    f"(not exactly representable in f32)")
    if not f32_lossless(data):
        return ("float64 values not losslessly f32-representable "
                "(device binning compares in f32)")
    return None


# ------------------------------------------------------------- bin tables

@dataclass
class IngestTables:
    """Host-built per-feature tables the jitted bin kernel closes over.
    All rows are padded to common widths; padded FEATURE columns get
    all-+inf thresholds (every value bins to 0 — the residency layout's
    zero column padding)."""
    thresholds: np.ndarray   # [C, T] f32; t_k = largest f32 <= ub_k
    nan_bin: np.ndarray      # [C] i32; num_bin-1 under has_nan_bin else -1
    is_cat: np.ndarray       # [C] bool
    cat_vals: np.ndarray     # [C, K] i32 category values (pad -2: never hit)
    cat_bins: np.ndarray     # [C, K] i32 bin of each category
    cat_last: np.ndarray     # [C] i32 last bin (negative/unseen categories)
    cat_hi: np.ndarray       # [C] f32 clamp ceiling (max category + 1)

    @property
    def has_categorical(self) -> bool:
        return bool(self.is_cat.any())


def f32_floor_thresholds(ub: np.ndarray) -> np.ndarray:
    """Largest f32 <= each f64 bound: round to nearest, then step down one
    ulp wherever rounding went UP (this is what makes the f32 compare-sum
    agree with the f64 searchsorted — module docstring proof)."""
    t = np.asarray(ub, np.float64).astype(np.float32)
    over = t.astype(np.float64) > ub
    if over.any():
        t[over] = np.nextafter(t[over], np.float32(-np.inf))
    return t


def build_ingest_tables(mappers: Sequence[BinMapper],
                        num_cols: int) -> IngestTables:
    """Pack every mapper's boundaries/categories into fixed-width arrays
    covering ``num_cols`` feature columns (>= len(mappers); the excess is
    residency column padding)."""
    C = max(int(num_cols), 1)
    th_rows: List[np.ndarray] = []
    cat_rows: List[Tuple[np.ndarray, np.ndarray]] = []
    nan_bin = np.full(C, -1, np.int32)
    is_cat = np.zeros(C, bool)
    cat_last = np.zeros(C, np.int32)
    cat_hi = np.zeros(C, np.float32)
    for j, m in enumerate(mappers):
        if m.bin_type == BIN_NUMERICAL:
            r = m.num_bin - 1 - (1 if m.missing_type == MISSING_NAN else 0)
            # the host search range is ub[:r+1], whose LAST bound (+inf, or
            # the NaN sentinel) never compares below a value — the first r
            # bounds are the whole decision surface
            th_rows.append(f32_floor_thresholds(m.bin_upper_bound[:r]))
            cat_rows.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            if m.has_nan_bin:
                nan_bin[j] = m.num_bin - 1
        else:
            pairs = sorted((c, b) for c, b in m.categorical_2_bin.items()
                           if c >= 0)
            cat_rows.append((
                np.array([c for c, _ in pairs], np.int32),
                np.array([b for _, b in pairs], np.int32)))
            th_rows.append(np.zeros(0, np.float32))
            is_cat[j] = True
            cat_last[j] = m.num_bin - 1
            cat_hi[j] = np.float32((pairs[-1][0] + 1) if pairs else 0)
    T = max([len(r) for r in th_rows], default=0)
    K = max([len(v) for v, _ in cat_rows], default=0)
    T, K = max(T, 1), max(K, 1)
    # pad the threshold axis to a POWER OF TWO: the kernel's branchless
    # lower bound advances by halving strides, and +inf padding never
    # compares below a value, so the count of t_k < v is unchanged
    T = 1 << max(1, (T - 1).bit_length())
    thresholds = np.full((C, T), np.inf, np.float32)
    cat_vals = np.full((C, K), -2, np.int32)
    cat_bins = np.zeros((C, K), np.int32)
    for j, row in enumerate(th_rows):
        thresholds[j, :len(row)] = row
    for j, (v, b) in enumerate(cat_rows):
        cat_vals[j, :len(v)] = v
        cat_bins[j, :len(v)] = b
    return IngestTables(thresholds, nan_bin, is_cat, cat_vals, cat_bins,
                        cat_last, cat_hi)


# ------------------------------------------------------------- bin step

# the categorical one-hot match runs on row blocks of at most this many
# (row, category) pairs: a bool match and an int32 select, 20 MiB at most
_CAT_MATCH_ELEMS = 1 << 22


class DeviceIngestor:
    """The bin step (B7) over fixed-shape raw chunks on ``device``:
    ``[R, num_cols]`` f32 in, ``[R, num_cols]`` codes out, in the port's
    residency dtype. The tables go to the device once; the step's
    intermediates are buffers allocated at the first chunk of a shape and
    reused, so every chunk of a dataset, the masked tail included, runs on
    the same buffers (``compiles`` stays 1)."""

    def __init__(self, mappers: Sequence[BinMapper], *, num_cols: int,
                 n_rows: int, out_dtype, device):
        tables = build_ingest_tables(mappers, num_cols)
        self.n_rows = int(n_rows)
        # the residency dtype: uint8, uint16 codes held as int16, or int32
        # past 32,768 bins (boosting/gbdt._codes_tensor)
        self.code_dtype = device_code_dtype(
            max((m.num_bin for m in mappers), default=1),
            np.dtype(out_dtype).itemsize)
        self.device = torch.device(device)
        dev = self.device
        C = max(int(num_cols), 1)
        self.num_cols = C
        Tp = int(tables.thresholds.shape[1])       # a power of two
        self.Tp = Tp
        self.k_steps = Tp.bit_length() - 1
        self.thf = torch.as_tensor(tables.thresholds.ravel(), device=dev)
        self.col_base = torch.as_tensor(
            np.arange(C, dtype=np.int64) * Tp, device=dev)[None, :]
        self.nan_bin = torch.as_tensor(tables.nan_bin.astype(np.int64),
                                       device=dev)[None, :]
        # per categorical column: its sorted categories and their bins (the
        # row's real width, not the table's padded K), last bin and ceiling
        self.cat_cols = []
        for j in np.nonzero(tables.is_cat)[0]:
            n = int((tables.cat_vals[j] != -2).sum())
            self.cat_cols.append((
                int(j),
                torch.as_tensor(tables.cat_vals[j, :max(n, 1)], device=dev),
                torch.as_tensor(tables.cat_bins[j, :max(n, 1)] + 1,
                                device=dev),
                int(tables.cat_last[j]), float(tables.cat_hi[j])))
        self._buf: Optional[Dict[str, torch.Tensor]] = None
        self._buf_shape = None
        self.compiles = 0             # chunk shapes given buffers

    def _buffers(self, R: int) -> Dict[str, torch.Tensor]:
        if self._buf_shape != R:
            dev, C = self.device, self.num_cols

            def empty(dtype):
                return torch.empty((R, C), dtype=dtype, device=dev)
            self._buf = dict(
                nan=empty(torch.bool), sv=empty(torch.float32),
                pos=empty(torch.int64), idx=empty(torch.int64),
                piv=empty(torch.float32), adv=empty(torch.bool),
                codes=empty(self.code_dtype),
                rows=torch.arange(R, dtype=torch.int64, device=dev))
            self._buf_shape = R
            self.compiles += 1
        return self._buf

    def bin_chunk(self, chunk: torch.Tensor, offset: int) -> torch.Tensor:
        """Codes of one raw f32 chunk on the device, the rows at or past
        ``n_rows`` (``offset`` is the chunk's first row) set to 0. The
        result is the ingestor's own buffer: the caller copies it out
        before the next chunk."""
        R = chunk.shape[0]
        b = self._buffers(R)
        nan, sv, pos, idx, piv, adv = (b[k] for k in (
            "nan", "sv", "pos", "idx", "piv", "adv"))
        torch.ne(chunk, chunk, out=nan)                 # NaN
        torch.where(nan, torch.zeros((), dtype=torch.float32,
                                     device=chunk.device), chunk, out=sv)
        # branchless power-of-two lower bound: after the k halving steps
        # ``pos`` counts the thresholds strictly below the value; +inf
        # padding never advances it
        pos.zero_()
        for s in range(self.k_steps):
            half = self.Tp >> (s + 1)
            torch.add(pos, self.col_base, out=idx)
            if half > 1:
                idx.add_(half - 1)
            torch.index_select(self.thf, 0, idx.view(-1), out=piv.view(-1))
            torch.lt(piv, sv, out=adv)
            pos.add_(adv, alpha=half)
        nan.logical_and_(self.nan_bin >= 0)
        torch.where(nan, self.nan_bin, pos, out=pos)
        for j, vals, bins1, last, hi in self.cat_cols:
            pos[:, j] = self._cat_column(chunk[:, j], vals, bins1, last, hi)
        # rows at or past n_rows take code 0
        rows = b["rows"]
        pos.masked_fill_((rows + offset >= self.n_rows)[:, None], 0)
        codes = b["codes"]
        codes.copy_(pos)
        return codes

    @staticmethod
    def _cat_column(v: torch.Tensor, vals: torch.Tensor, bins1: torch.Tensor,
                    last: int, hi: float) -> torch.Tensor:
        """One categorical column's bins: NaN -> -1, clamp to ``[-1, hi]``
        before the truncating cast, one-hot match in row blocks; negative
        and unseen categories take ``last``."""
        vi = torch.where(torch.isnan(v), torch.full_like(v, -1.0),
                         v.clamp(-1.0, hi)).to(torch.int32)
        K = vals.shape[0]
        rb = max(1, _CAT_MATCH_ELEMS // K)
        cb = torch.empty(v.shape[0], dtype=torch.int64, device=v.device)
        for r0 in range(0, v.shape[0], rb):
            blk = vi[r0:r0 + rb]
            match = blk[:, None] == vals[None, :]
            cb[r0:r0 + rb] = torch.where(match, bins1[None, :], 0).sum(1)
        cb.sub_(1)                                    # -1 == unseen
        return torch.where((cb < 0) | (vi < 0), last, cb)


# ------------------------------------------------------------ chunk feeder

class ChunkFeeder:
    """Double-buffered H2D feed of raw row chunks: ``depth + 1`` pinned
    staging buffers and as many device buffers, the copies enqueued on a side
    stream. ``prefetch(j)`` right after chunk ``i``'s bin step is enqueued
    lets chunk ``j``'s copy ride under it; a ``get`` that finds nothing
    prefetched copies synchronously inside a counted, timed stall
    (``ingest.stalls`` / ``ingest.stall_seconds``). A chunk selects the used
    feature columns, casts them to f32 (exact under the losslessness gate)
    and zero-fills the tail. Before a staging buffer is refilled, the host
    waits for the event recorded after its last copy; before a device
    buffer is overwritten, the copy stream waits for the event recorded
    after the bin step that read it (``release``). On the CPU the chunk is
    built in place and nothing is copied."""

    def __init__(self, raw: np.ndarray, real_indices: np.ndarray, *,
                 chunk_rows: int, n_chunks: int, num_cols: int,
                 device=None, prefetch_enabled: Optional[bool] = None,
                 depth: int = 1):
        self.raw = raw
        self.real_indices = np.asarray(real_indices, np.int64)
        self.chunk_rows = int(chunk_rows)
        self.n_chunks = int(n_chunks)
        self.num_cols = int(num_cols)
        self.device = torch.device("cpu" if device is None else device)
        if prefetch_enabled is None:
            prefetch_enabled = os.environ.get(
                "LGBM_TPU_INGEST_NO_PREFETCH", "") not in ("1", "true")
        self.prefetch_enabled = prefetch_enabled and depth > 0
        self.depth = max(1, int(depth))
        self._pending: Dict[int, int] = {}         # chunk -> buffer slot
        self._slot_of_next = 0
        self.stalls = 0
        self.hits = 0
        self.stall_seconds = 0.0
        self.bytes_h2d = 0
        cuda = self.device.type == "cuda"
        self._cuda = cuda
        n_slots = self.depth + 1
        shape = (self.chunk_rows, self.num_cols)
        self._host = [torch.zeros(shape, dtype=torch.float32,
                                  pin_memory=cuda) for _ in range(n_slots)]
        self._dev = [torch.empty(shape, dtype=torch.float32,
                                 device=self.device) if cuda else h
                     for h in self._host]
        if cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._copied = [None] * n_slots     # event after the slot's copy
            self._released = [None] * n_slots   # event after its bin step

    def _obs(self):
        from .. import observability as obs
        return obs

    def _fill(self, slot: int, i: int) -> None:
        R, C = self.chunk_rows, self.num_cols
        a = i * R
        b = min(a + R, self.raw.shape[0])
        block = self._host[slot].numpy()
        if b > a:
            sel = self.raw[a:b][:, self.real_indices]
            block[: b - a, : sel.shape[1]] = sel
            block[: b - a, sel.shape[1]:] = 0.0
            block[b - a:] = 0.0
        else:
            block[:] = 0.0

    def _put(self, i: int) -> int:
        """Fill a free slot with chunk ``i`` and enqueue its copy; returns
        the slot."""
        slot = self._slot_of_next
        self._slot_of_next = (slot + 1) % len(self._host)
        if self._cuda and self._copied[slot] is not None:
            # the staging buffer's last copy must have read it
            self._copied[slot].synchronize()
        self._fill(slot, i)
        nbytes = self._host[slot].numel() * 4
        self.bytes_h2d += nbytes
        self._obs().inc("ingest.bytes_h2d", nbytes)
        if self._cuda:
            with torch.cuda.stream(self._stream):
                if self._released[slot] is not None:
                    # the device buffer's last bin step must have read it
                    self._stream.wait_event(self._released[slot])
                self._dev[slot].copy_(self._host[slot], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
                self._copied[slot] = ev
        return slot

    def prefetch(self, j: int) -> None:
        """Enqueue chunk ``j``'s copy if not already pending; at most
        ``depth`` copies stay ahead of the bin step."""
        if not self.prefetch_enabled or not (0 <= j < self.n_chunks):
            return
        if j not in self._pending and len(self._pending) < self.depth:
            self._pending[j] = self._put(j)

    def get(self, i: int) -> Tuple[torch.Tensor, int]:
        """``(device buffer of chunk i, its slot)``: prefetched if the
        overlap worked, a counted timed stall if not. The compute stream
        waits for the chunk's copy."""
        obs = self._obs()
        slot = self._pending.pop(i, None)
        if slot is not None:
            self.hits += 1
            obs.inc("ingest.prefetch_hits")
        else:
            self.stalls += 1
            obs.inc("ingest.stalls")
            t0 = obs.clock()
            with obs.span("ingest_stall", chunk=i):
                slot = self._put(i)
                if self._cuda:
                    self._copied[slot].synchronize()
            dt = obs.clock() - t0
            self.stall_seconds += dt
            obs.get_registry().histogram("ingest.stall_seconds").observe(dt)
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[slot])
        return self._dev[slot], slot

    def release(self, slot: int) -> None:
        """The bin step that read ``slot``'s device buffer has been enqueued
        on the compute stream: record the event a refill waits for."""
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._released[slot] = ev

    def report(self) -> Dict:
        return {"n_chunks": self.n_chunks, "chunk_rows": self.chunk_rows,
                "stalls": self.stalls, "prefetch_hits": self.hits,
                "stall_seconds": round(self.stall_seconds, 6),
                "bytes_h2d": self.bytes_h2d,
                "prefetch_enabled": self.prefetch_enabled}


# ------------------------------------------------------------ entry point

def resolve_chunk_rows(requested: int, n_rows_padded: int,
                       num_cols: int) -> int:
    """Chunk row count: the config value, or auto-sized so one raw f32
    chunk stays near a fixed byte budget. Chunk size never changes the
    produced codes — only compile shape and overlap granularity."""
    if requested > 0:
        R = int(requested)
    else:
        R = _CHUNK_BUDGET_BYTES // max(1, 4 * num_cols)
        R = max(_CHUNK_MIN, min(_CHUNK_MAX, (R // 256) * 256))
    return max(1, min(R, max(n_rows_padded, 1)))


def device_ingest(raw: np.ndarray, mappers: Sequence[BinMapper],
                  real_indices: np.ndarray, *, n_rows: int,
                  n_rows_padded: int, num_cols: int, out_dtype,
                  device, chunk_rows: int = 0, prefetch_depth: int = 1,
                  ingestor: Optional[DeviceIngestor] = None):
    """Bin ``raw`` on ``device`` into the residency layout.

    Returns ``(codes, report)``: ``codes`` is the ``[n_rows_padded,
    num_cols]`` tensor (``uint8``, ``uint16`` codes as ``int16``, or
    ``int32`` past 32,768 bins)
    bit-identical to host binning with zero row and column padding, and
    ``report`` the JAX package's keys (throughput, chunks, stalls, H2D
    bytes, ``compiles``). A caller-given ``ingestor`` of the same shape
    reuses its buffers."""
    from .. import observability as obs

    device = torch.device(device)
    R = resolve_chunk_rows(chunk_rows, n_rows_padded, num_cols)
    n_chunks = max(1, -(-n_rows_padded // R))
    ing = ingestor if ingestor is not None else DeviceIngestor(
        mappers, num_cols=num_cols, n_rows=n_rows, out_dtype=out_dtype,
        device=device)
    feeder = ChunkFeeder(raw, real_indices, chunk_rows=R, n_chunks=n_chunks,
                         num_cols=num_cols, device=device,
                         prefetch_enabled=None if prefetch_depth > 0
                         else False, depth=prefetch_depth)
    codes = torch.empty((n_rows_padded, num_cols), dtype=ing.code_dtype,
                        device=device)
    t0 = obs.clock()
    with obs.span("ingest", rows=int(n_rows), chunks=int(n_chunks)):
        feeder.prefetch(0)
        for i in range(n_chunks):
            chunk, slot = feeder.get(i)
            out = ing.bin_chunk(chunk, i * R)
            a = i * R
            b = min(a + R, n_rows_padded)
            codes[a:b].copy_(out[: b - a])
            feeder.release(slot)
            for j in range(i + 1, min(i + 1 + feeder.depth, n_chunks)):
                feeder.prefetch(j)       # the copy rides under chunk i
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds = obs.clock() - t0
    obs.inc("ingest.rows", int(n_rows))
    obs.inc("ingest.chunks", int(n_chunks))
    rep = feeder.report()
    rep.update({
        "rows": int(n_rows), "rows_padded": int(n_rows_padded),
        "num_cols": int(num_cols), "seconds": round(seconds, 6),
        "rows_per_s": (float(n_rows) / seconds) if seconds > 0 else None,
        "stall_fraction": (rep["stall_seconds"] / seconds)
        if seconds > 0 else 0.0,
        "compiles": ing.compiles,
    })
    Log.debug("device ingest: %d rows in %d x %d-row chunks (%.3fs, "
              "%d stalls, %.1f MB H2D)", n_rows, n_chunks, R, seconds,
              rep["stalls"], rep["bytes_h2d"] / (1 << 20))
    return codes, rep
