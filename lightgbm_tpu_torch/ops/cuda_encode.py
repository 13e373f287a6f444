"""Wrapper of the hand-written rank-encode kernel (``csrc/encode.cu``).

``Booster.predict``'s batch route (``ops/predict.forest_predict_raw``)
uploads each chunk's raw f64 rows and encodes them here into what the
forest walk B6 reads: per (row, feature) the rank code ``#{t in grid_f : t
< v}`` (``len(grid_f)`` for NaN; 0 where the grid is empty), the NaN mask
and the zero mask ``is_nan | (|v| <= K_ZERO_RANGE)``, bit-equal to
``StackedForest._encode_loop`` and ``StackedForest.encode_rows``. The
source note in ``csrc/encode.cu`` states the arithmetic, the bound and the
design.

Build and load: ``ops/native.py`` (library stem ``libgbdt_encode``);
:func:`declare` binds the C entries. Nothing is built or imported when this
module is imported.

Dispatch: for tensors on the CPU, :func:`encode_rows` runs the plain
version :func:`encode_rows_plain`; for CUDA tensors it launches the kernel
or raises — it never falls back. Launches are counted on the host
(:func:`launch_count`, :func:`reset_launch_count`); the rows each route
encodes are counted in the registry as ``predict.encode.rows_cuda`` and
``predict.encode.rows_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import observability as obs
from ..binning import K_ZERO_RANGE
from . import native
from .native import check_tensor

SOURCE = native.source_path("encode.cu")
STEM = "libgbdt_encode"

_launches = 0          # kernel launches since the last reset


def declare(lib: ctypes.CDLL) -> None:
    """Bind the C entries of ``csrc/encode.cu``."""
    p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    lib.gbdt_encode_rows.argtypes = [p, ll, i, p, ll, p, d, p, p, p, p]
    lib.gbdt_encode_rows.restype = i
    lib.gbdt_encode_max_shared_bytes.argtypes = []
    lib.gbdt_encode_max_shared_bytes.restype = ll


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def uses_shared_memory(grid_total: int) -> bool:
    """Whether the kernel searches a grid of ``grid_total`` thresholds in
    shared memory (else in device memory, through L2)."""
    lib = native.load(SOURCE, STEM, declare)
    return grid_total * 8 <= lib.gbdt_encode_max_shared_bytes()


def encode_rows_plain(X: torch.Tensor, grids: torch.Tensor,
                      offsets: torch.Tensor, steps: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch ops: the same lower-bound search
    over each element's grid segment, as ``steps`` halving steps over
    gathers (``steps`` at least the bit length of the longest segment;
    a step over an exhausted segment changes nothing)."""
    N, F = X.shape
    is_nan = torch.isnan(X)
    is_zero = is_nan | (X.abs() <= K_ZERO_RANGE)
    start = offsets[:-1]
    size = offsets[1:] - start
    lo = torch.zeros((N, F), dtype=torch.int64, device=X.device)
    length = size.expand(N, F)
    last = max(grids.shape[0] - 1, 0)
    for _ in range(steps):
        half = length >> 1
        t = grids[torch.clamp(start + lo + half, max=last)]
        right = (length > 0) & (t < X)
        lo = torch.where(right, lo + half + 1, lo)
        length = torch.where(right, length - half - 1, half)
    codes = torch.where(is_nan, size, lo).to(torch.int32)
    return codes, is_nan, is_zero


def encode_rows(X: torch.Tensor, grids: torch.Tensor, offsets: torch.Tensor,
                steps: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw ``[N, F]`` f64 rows -> (codes i32, NaN mask, zero mask), each
    ``[N, F]`` on ``X``'s device. ``grids`` is the forest's per-feature
    grids concatenated (f64), ``offsets`` their ``[F + 1]`` int64 bounds
    and ``steps`` the plain version's halving steps
    (``StackedForest.encode_steps``). CPU tensors take the plain version,
    CUDA tensors the kernel."""
    global _launches
    N, F = X.shape
    if X.device.type == "cpu":
        obs.inc("predict.encode.rows_plain", int(N))
        return encode_rows_plain(X, grids, offsets, steps)
    check_tensor("X", X, (torch.float64,))
    check_tensor("grids", grids, (torch.float64,))
    check_tensor("offsets", offsets, (torch.int64,), (F + 1,))
    if grids.device != X.device or offsets.device != X.device:
        raise ValueError(f"grids on {grids.device} and offsets on "
                         f"{offsets.device} must be on {X.device}")
    lib = native.load(SOURCE, STEM, declare)
    G = grids.shape[0]
    codes = torch.empty((N, F), dtype=torch.int32, device=X.device)
    is_nan = torch.empty((N, F), dtype=torch.bool, device=X.device)
    is_zero = torch.empty((N, F), dtype=torch.bool, device=X.device)
    if N == 0:
        return codes, is_nan, is_zero
    native.launch("encode kernel", lib.gbdt_encode_rows, X.device,
                  X.data_ptr(), N, F, grids.data_ptr(), G,
                  offsets.data_ptr(), K_ZERO_RANGE, codes.data_ptr(),
                  is_nan.data_ptr(), is_zero.data_ptr())
    _launches += 1
    obs.inc("predict.encode.rows_cuda", int(N))
    return codes, is_nan, is_zero
