"""Out-of-core shard transport (``tpu_residency=stream``): host-resident
packed bin codes, copied to the card through two fixed device buffers.

Port of ``lightgbm_tpu/ops/stream.py:57-322``. Only the compressed bin
codes stream; gradients, scores and the per-row leaf ids stay on the
device (the design point of arXiv 1806.11248), and the copy of shard
``i + 1`` rides under shard ``i``'s routing and histogram (arXiv
2005.09148). Three pieces:

- :func:`pack_codes_host` — the byte layouts ``u8 | u16 | u4 | u6`` of
  ``ops/histogram.py`` on the host, byte for byte the JAX package's, so a
  shard moves at 0.5-2 bytes a code and ``ops.histogram.unpack_codes``
  restores the integer codes on the card.
- :class:`HostShardStore` — the code matrix cut into shards of
  :func:`shard_geometry` rows (about eight shards by default, the last one
  padded), each with a CRC32 taken when it is packed; at the JAX
  package's geometry its shards and checksums are the JAX package's. On the card every shard lives in pinned host memory allocated
  once, so each copy is a DMA with no staging copy; ``shards`` are numpy
  views of it, which the CRC and the chaos flip
  (``robustness/chaos.corrupt_host_shard``) read and write.
- :class:`ShardPrefetcher` — the double buffer. ``get(i)`` hands out shard
  ``i``'s device buffer; ``release(i)`` marks it free once the work the
  caller has enqueued on it has run; ``prefetch(j)`` copies shard ``j``
  into the other buffer on a side stream. On the card each buffer has an
  event recorded when its copy lands (the consumer's stream waits on it)
  and one recorded when its consumers are enqueued (the next copy into it
  waits on that), as ``ops/ingest.ChunkFeeder`` does for raw rows. A
  ``get`` that finds no prefetched copy is a stall: the copy runs in the
  caller's path, counted (``stream.stalls``) and timed
  (``stream.stall_seconds``). ``LGBM_TPU_STREAM_NO_PREFETCH=1`` turns
  every copy into a stall (the overlap's A/B arm).

Integrity: the CRC32 of a shard is checked before every copy
(``tpu_stream_verify``, on by default); a mismatch raises
:class:`ShardCorruptionError` instead of folding rotten codes into the
histograms, and the command line exits with :data:`EXIT_SHARD_CORRUPT`.
The check runs on the host, in the training thread, at ``zlib.crc32``'s
rate; ``tpu_stream_verify=false`` trades detection for that time.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.log import Log
from .histogram import code_bytes_total

# exit status of the command line on a detected shard corruption
# (lightgbm_tpu/robustness/supervisor.py:41): restartable, since the store
# is rebuilt from the dataset when the booster is built again
EXIT_SHARD_CORRUPT = 144


class ShardCorruptionError(RuntimeError):
    """A host code shard failed its CRC32 check at transfer time: the bytes
    about to be folded into the histograms are not the bytes that were
    packed. Training stops; the command line exits with status 144, and a
    restart (``resume_from=auto``) rebuilds the store from the dataset."""


def pack_codes_host(X: np.ndarray, code_mode: str) -> np.ndarray:
    """``[N, F]`` uint8 / uint16 bin codes -> ``[N, code_bytes_total(F,
    mode)]`` uint8: little-endian ``u16``, low-nibble-first ``u4`` and the
    four-codes-in-three-bytes ``u6``, byte for byte the JAX package's."""
    X = np.ascontiguousarray(X)
    N, F = X.shape
    if code_mode == "u8":
        return X.astype(np.uint8, copy=False)
    if code_mode == "u16":
        return X.astype("<u2", copy=False).view(np.uint8).reshape(N, 2 * F)
    x = X.astype(np.uint8, copy=False)
    if code_mode == "u4":
        if F % 2:
            x = np.pad(x, ((0, 0), (0, 1)))
        return (x[:, 0::2] | (x[:, 1::2] << 4)).astype(np.uint8)
    if code_mode != "u6":
        raise ValueError(f"unknown code mode {code_mode!r}")
    if F % 4:
        x = np.pad(x, ((0, 0), (0, 4 - F % 4)))
    q = x.reshape(N, -1, 4).astype(np.uint8)
    c0, c1, c2, c3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    b0 = c0 | (c1 << 6)
    b1 = (c1 >> 2) | (c2 << 4)
    b2 = (c2 >> 4) | (c3 << 2)
    return np.stack([b0, b1, b2], axis=-1).reshape(N, -1).astype(np.uint8)


def shard_geometry(num_rows: int, requested_rows: int = 0
                   ) -> Tuple[int, int]:
    """``(padded rows, shard rows)`` of a store over ``num_rows`` rows.
    A shard holds ``requested_rows`` rows (config ``tpu_stream_shard_rows``,
    capped at the data), or an eighth of the rows rounded up when 0; the
    last shard holds the rest and pads to a whole shard, and its padding
    is never routed or counted (:meth:`HostShardStore.real_rows`). The
    port has no static shapes to keep, so it does not copy the JAX
    package's padded chunk geometry (a multiple of ``tpu_hist_chunk`` that
    divides the padded rows, which at 2M rows and the default chunk is 31
    shards); given that geometry, the store's shards are the JAX
    package's byte for byte. Shard size never changes the model."""
    n = max(int(num_rows), 1)
    rows = min(int(requested_rows) if requested_rows > 0 else -(-n // 8), n)
    return -(-n // rows) * rows, rows


class HostShardStore:
    """The code matrix as packed host shards of ``shard_rows`` rows.

    ``X`` is the ``[N, F]`` host code matrix (``uint8``, or ``uint16``);
    rows pad with zeros to ``n_rows_padded`` and columns to ``num_cols``
    per shard as it is packed, so no padded copy of the whole matrix is
    made. With ``pin`` the shards live in one pinned host buffer (a copy to
    the card is then a DMA from it). ``shards[i]`` is a numpy view of shard
    ``i`` and ``checksums[i]`` its CRC32 at packing."""

    def __init__(self, X: np.ndarray, *, n_rows_padded: int, num_cols: int,
                 shard_rows: int, code_mode: str, pin: bool = False):
        n_real, f_real = X.shape
        if n_rows_padded < n_real or num_cols < f_real \
                or n_rows_padded % shard_rows:
            raise ValueError(f"a store of {n_rows_padded} x {num_cols} in "
                             f"shards of {shard_rows} rows cannot hold "
                             f"{n_real} x {f_real} codes")
        self.n_rows = n_real
        self.n_rows_padded = n_rows_padded
        self.num_cols = num_cols
        self.shard_rows = R = shard_rows
        self.n_shards = n_rows_padded // shard_rows
        self.code_mode = code_mode
        self.dtype = X.dtype
        self.row_bytes = code_bytes_total(num_cols, code_mode)
        shape = (self.n_shards, R, self.row_bytes)
        if pin:
            self.pinned: Optional[torch.Tensor] = torch.empty(
                shape, dtype=torch.uint8, pin_memory=True)
            buf = self.pinned.numpy()
        else:
            self.pinned = None
            buf = np.empty(shape, np.uint8)
        # one reused staging block; padding rows and columns are zeros
        block = np.zeros((R, num_cols), X.dtype)
        for i in range(self.n_shards):
            a = i * R
            rows = X[a:min(a + R, n_real)]
            if rows.shape[0] < R:
                block[:] = 0
            block[:rows.shape[0], :f_real] = rows
            buf[i] = pack_codes_host(block, code_mode)
        self.shards: List[np.ndarray] = [buf[i] for i in range(self.n_shards)]
        self.shard_bytes = R * self.row_bytes
        self.checksums: List[int] = [self._crc(s) for s in self.shards]

    @staticmethod
    def _crc(shard: np.ndarray) -> int:
        return zlib.crc32(shard) & 0xFFFFFFFF

    def verify_shard(self, i: int) -> bool:
        """Shard ``i``'s CRC32 equals its value at packing (host time at
        ``zlib.crc32``'s rate)."""
        return self._crc(self.shards[i]) == self.checksums[i]

    def real_rows(self, i: int) -> int:
        """Rows of shard ``i`` that are data (the last shard may end in
        padding, which is never routed or counted)."""
        return max(0, min(self.shard_rows, self.n_rows - i * self.shard_rows))

    def host_tensor(self, i: int) -> torch.Tensor:
        """Shard ``i`` as a CPU tensor sharing the store's memory."""
        if self.pinned is not None:
            return self.pinned[i]
        return torch.from_numpy(self.shards[i])

    @property
    def total_bytes(self) -> int:
        return self.shard_bytes * self.n_shards

    def describe(self) -> Dict:
        return {"n_shards": self.n_shards, "shard_rows": self.shard_rows,
                "shard_bytes": self.shard_bytes,
                "code_mode": self.code_mode,
                "total_bytes": self.total_bytes,
                "pinned": self.pinned is not None}


class ShardPrefetcher:
    """Two device buffers fed from a :class:`HostShardStore`.

    Shards are read cyclically ``0 .. n-1`` (one cycle per wave, and one
    for a tree's trailing route): ``get(i)`` returns shard ``i``'s buffer,
    the prefetched copy when there is one; the caller enqueues its work on
    it, then calls ``release(i)`` and ``prefetch(i + 1)``. Every copy
    alternates between the two buffers, so a copy never lands in the
    buffer the caller is reading: on the card it waits (on the side
    stream) for the event ``release`` recorded after that buffer's last
    reader. ``stream.bytes_h2d`` counts every copied byte."""

    def __init__(self, store: HostShardStore, device: torch.device,
                 prefetch_enabled: Optional[bool] = None,
                 verify: bool = True):
        if prefetch_enabled is None:
            prefetch_enabled = os.environ.get(
                "LGBM_TPU_STREAM_NO_PREFETCH", "") not in ("1", "true")
        self.store = store
        self.device = device
        self.prefetch_enabled = prefetch_enabled
        self.verify_enabled = verify
        self.bufs = [torch.empty((store.shard_rows, store.row_bytes),
                                 dtype=torch.uint8, device=device)
                     for _ in range(2)]
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._side = torch.cuda.Stream(device)
            self._landed = [torch.cuda.Event() for _ in range(2)]
            self._freed = [torch.cuda.Event() for _ in range(2)]
            for ev in self._freed:
                ev.record(torch.cuda.current_stream(device))
            for buf in self.bufs:
                # freed only after the side stream's last copy into it
                buf.record_stream(self._side)
        self._pending: Dict[int, int] = {}     # shard -> buffer
        self._reading: Dict[int, int] = {}     # shard handed out -> buffer
        self._turn = 0
        self.stalls = 0
        self.hits = 0
        self.stall_seconds = 0.0
        self.bytes_h2d = 0

    def _put(self, i: int) -> int:
        """Check shard ``i`` and start its copy into the next buffer;
        returns the buffer."""
        from .. import observability as obs
        store = self.store
        if self.verify_enabled and not store.verify_shard(i):
            obs.inc("fault.shard_corrupt")
            obs.event("shard_corrupt", shard=i)
            raise ShardCorruptionError(
                f"host shard {i} failed its CRC32 integrity check "
                f"(expected {store.checksums[i]:#010x}) — the packed codes "
                f"changed in host memory since construction; restart the "
                f"run (resume_from=auto rebuilds the shard store from the "
                f"dataset; tpu_stream_verify=false disables this check)")
        b = self._turn
        self._turn ^= 1
        src = store.host_tensor(i)
        if self._cuda:
            with torch.cuda.stream(self._side):
                self._side.wait_event(self._freed[b])
                self.bufs[b].copy_(src, non_blocking=True)
                self._landed[b].record(self._side)
        else:
            self.bufs[b].copy_(src)
        self.bytes_h2d += store.shard_bytes
        obs.inc("stream.bytes_h2d", store.shard_bytes)
        return b

    def prefetch(self, j: int) -> None:
        """Start shard ``j % n_shards``'s copy unless it is pending (a no-op
        with prefetch off)."""
        if not self.prefetch_enabled or not self.store.n_shards:
            return
        j %= self.store.n_shards
        if j not in self._pending:
            self._pending.clear()          # at most one copy in flight
            self._pending[j] = self._put(j)

    def get(self, i: int) -> torch.Tensor:
        """Shard ``i``'s ``[shard_rows, row_bytes]`` device buffer, ready
        for work enqueued on the current stream."""
        from .. import observability as obs
        b = self._pending.pop(i, None)
        if b is not None:
            self.hits += 1
            obs.inc("stream.prefetch_hits")
        else:
            self.stalls += 1
            obs.inc("stream.stalls")
            self._pending.clear()
            t0 = obs.clock()
            with obs.span("prefetch_stall", shard=i):
                b = self._put(i)
                if self._cuda:
                    self._landed[b].synchronize()
            dt = obs.clock() - t0
            self.stall_seconds += dt
            obs.get_registry().histogram("stream.stall_seconds").observe(dt)
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._landed[b])
        self._reading[i] = b
        return self.bufs[b]

    def release(self, i: int) -> None:
        """The work reading shard ``i``'s buffer is enqueued: a later copy
        into that buffer waits for it."""
        b = self._reading.pop(i)
        if self._cuda:
            self._freed[b].record(torch.cuda.current_stream(self.device))

    def report(self) -> Dict:
        return {"n_shards": self.store.n_shards,
                "shard_bytes": self.store.shard_bytes,
                "stalls": self.stalls, "prefetch_hits": self.hits,
                "stall_seconds": round(self.stall_seconds, 6),
                "bytes_h2d": self.bytes_h2d,
                "prefetch_enabled": self.prefetch_enabled,
                "verify_enabled": self.verify_enabled}


def log_store(store: HostShardStore) -> None:
    """The booster's one info line about its store."""
    d = store.describe()
    Log.info("tpu_residency=stream: codes in %d host shards x %d rows "
             "(%s-packed, %.1f MB/shard, %.2f GB total%s); copied to the "
             "card double-buffered through the wave loop, row compaction "
             "off (full streaming passes)", d["n_shards"], d["shard_rows"],
             d["code_mode"], d["shard_bytes"] / (1 << 20),
             d["total_bytes"] / (1 << 30), ", pinned" if d["pinned"] else "")
