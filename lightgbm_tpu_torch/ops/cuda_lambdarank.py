"""Wrapper of the hand-written LambdaRank gradient kernel
(``csrc/lambdarank.cu``).

``objectives.LambdarankNDCG.gradients`` hands CUDA tensors here: each
document's g and h from its query's scores and labels in row order, as the
plain version ``LambdarankNDCG._query_grads`` computes them over padded
``[Q, M, M]`` pair tensors, without any tensor of pairs. The source note in
``csrc/lambdarank.cu`` states the arithmetic, the bound and the design.

The kernel's blocks are the entries of a table built once on the host
(:func:`query_tiles`): each query cut into tiles of :data:`TILE` documents,
the longest query first. :class:`QueryPlan` holds that table and the
query's constants on the card, placed once outside any capture.

Build and load: ``ops/native.py`` (library stem ``libgbdt_lambdarank``);
:func:`declare` binds the C entries. Nothing is built or imported when this
module is imported.

Dispatch: the objective runs its plain version for CPU tensors and calls
:func:`lambdarank_grads` for CUDA tensors, which launches the kernel or
raises — it never falls back. Calls are counted on the host
(:func:`launch_count`, :func:`reset_launch_count`: one per call, each
putting the kernel's two passes on the stream), and the queries a call
covers in the registry as ``objective.lambdarank.queries_cuda`` (the plain
route counts ``.queries_plain``). A call inside a CUDA-graph capture counts
once; its replays count nothing.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import observability as obs
from . import native
from .native import check_tensor

SOURCE = native.source_path("lambdarank.cu")
STEM = "libgbdt_lambdarank"
TILE = 128             # kTile of the source: documents a block takes
CHUNK = 512            # kChunk of the source: documents staged at once

_launches = 0          # calls since the last reset


def declare(lib: ctypes.CDLL) -> None:
    """Bind the C entries of ``csrc/lambdarank.cu``; raises where its
    tile or chunk is not :data:`TILE`, :data:`CHUNK`."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gbdt_lambdarank_grads.argtypes = [p, p, p, p, i, p, p, p, f, p, p, p,
                                          p, p]
    lib.gbdt_lambdarank_grads.restype = i
    lib.gbdt_lambdarank_tile.argtypes = []
    lib.gbdt_lambdarank_tile.restype = i
    lib.gbdt_lambdarank_chunk.argtypes = []
    lib.gbdt_lambdarank_chunk.restype = i
    if (lib.gbdt_lambdarank_tile(), lib.gbdt_lambdarank_chunk()) != \
            (TILE, CHUNK):
        raise RuntimeError("csrc/lambdarank.cu's tile or chunk differs "
                           "from TILE, CHUNK")


def launch_count() -> int:
    """Calls that launched the kernel since :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def query_tiles(query_boundaries: np.ndarray, tile: int = TILE) -> np.ndarray:
    """The kernel's block table: ``[T, 2]`` int32 rows ``(query, first
    document)``, each query cut into ``ceil(n / tile)`` tiles starting at
    0, tile, 2 tile, ...; queries longest first (ties in query order), a
    query's tiles in document order. An empty query has no tile."""
    qb = np.asarray(query_boundaries, dtype=np.int64)
    sizes = np.diff(qb)
    order = np.argsort(-sizes, kind="stable")
    per = -(-sizes[order] // tile)
    start = np.cumsum(per) - per
    query = np.repeat(order, per)
    first = (np.arange(int(per.sum())) - np.repeat(start, per)) * tile
    return np.stack([query, first], axis=1).astype(np.int32)


class QueryPlan:
    """What the kernel reads of the query structure, on one device: the
    int32 query bounds, the tile table (:func:`query_tiles`), the per-query
    inverse max DCG (f32), the label gains (f32) and the discount table ``1
    / log2(r + 2)`` for every rank below the longest query (the plain
    version's torch expression, so the two read the same discounts)."""

    def __init__(self, query_boundaries: np.ndarray, tiles: np.ndarray,
                 inv_max_dcg: np.ndarray, label_gain: np.ndarray,
                 device: torch.device):
        qb = np.asarray(query_boundaries, dtype=np.int64)
        if qb[-1] >= 2 ** 31:
            raise ValueError(f"{qb[-1]} rows: the kernel indexes rows with "
                             f"32-bit ints")
        longest = int(np.diff(qb).max()) if len(qb) > 1 else 0
        self.device = device
        self.num_queries = len(qb) - 1
        self.num_rows = int(qb[-1])
        self.qb = torch.as_tensor(qb.astype(np.int32), device=device)
        self.tiles = torch.as_tensor(np.asarray(tiles, dtype=np.int32),
                                     device=device)
        self.inv_max_dcg = torch.as_tensor(
            np.asarray(inv_max_dcg, dtype=np.float32), device=device)
        self.label_gain = torch.as_tensor(
            np.asarray(label_gain, dtype=np.float32), device=device)
        self.disc_table = 1.0 / torch.log2(torch.arange(
            max(longest, 1), dtype=torch.float32, device=device) + 2.0)


def lambdarank_grads(s: torch.Tensor, l: torch.Tensor, plan: QueryPlan,
                     sigmoid: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """g, h ``[n]`` f32 of the row-order scores ``s`` and labels ``l``
    (``[n]`` f32 CUDA tensors, ``n`` the plan's rows) through the kernel;
    raises for anything it does not take."""
    global _launches
    n = plan.num_rows
    check_tensor("s", s, (torch.float32,), (n,))
    check_tensor("l", l, (torch.float32,), (n,))
    if s.device != plan.device or l.device != plan.device:
        raise ValueError(f"s on {s.device} and l on {l.device} must be on "
                         f"the plan's {plan.device}")
    lib = native.load(SOURCE, STEM, declare)
    g = torch.empty(n, dtype=torch.float32, device=s.device)
    h = torch.empty(n, dtype=torch.float32, device=s.device)
    disc_rows = torch.empty(n, dtype=torch.float32, device=s.device)
    scaled = torch.empty(plan.num_queries, dtype=torch.uint8,
                         device=s.device)
    native.launch("lambdarank kernel", lib.gbdt_lambdarank_grads, s.device,
                  s.data_ptr(), l.data_ptr(), plan.qb.data_ptr(),
                  plan.tiles.data_ptr(), plan.tiles.shape[0],
                  plan.disc_table.data_ptr(), plan.inv_max_dcg.data_ptr(),
                  plan.label_gain.data_ptr(), 2.0 * sigmoid,
                  disc_rows.data_ptr(), scaled.data_ptr(), g.data_ptr(),
                  h.data_ptr())
    _launches += 1
    obs.inc("objective.lambdarank.queries_cuda", plan.num_queries)
    return g, h
