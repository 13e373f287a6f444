"""Wrapper of the hand-written Hopper histogram kernel (``csrc/histogram.cu``).

Port of ``lightgbm_tpu/ops/pallas_histogram.py`` (kernel B1): one kernel
serves the grower's full pass (each row's slot from
``slot_of_leaf[leaf_id[r]]``) and its compacted pass (rows read through the
incremental partition ``perm`` with the per-slot segment tables). The
source note in ``csrc/histogram.cu`` states the arithmetic, its error
bound, the memory bound at the slice's shapes and what the design does
about it.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles the source
into a shared library with a plain C interface at first use, into
``lightgbm_tpu_torch/build/`` (listed in ``.gitignore``), and ``ctypes``
loads it. Nothing is built or imported when this module is imported.

Dispatch: for tensors on the CPU the wrapper runs the plain version in
``ops/histogram.py``; for CUDA tensors it launches the kernel or raises —
it never falls back. ``build_histograms_cuda.launches`` counts passes
launched on the card, one per call (plain calls are not counted); each pass
puts three operations on the stream: a memset of the integer accumulators,
``hist_kernel`` and ``finalize_kernel``.

Malformed input (a bin code at or above ``num_bins_padded``, a slot at or
above ``num_slots``, ``n_active`` past the compacted segments) makes the
plain version raise ``ValueError`` and the kernel fail a device assert,
which PyTorch reports at the next synchronisation, as for its own index
kernels. Neither drops such a row.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

import torch

from .histogram import build_histograms, histogram_scales

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "histogram.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None            # the loaded ctypes library, once built


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the histogram kernel "
                       "is built from csrc/histogram.cu at first use")


def library_path() -> str:
    """Build output path, keyed by the source and flags, so an edited
    source is rebuilt and never loaded stale."""
    h = hashlib.sha256(open(SOURCE, "rb").read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgbdt_hist_{h.hexdigest()[:16]}.so")


def build_library(verbose: bool = False) -> Tuple[str, float, str]:
    """Compile ``csrc/histogram.cu`` if its library is missing. Returns
    ``(path, seconds, compiler output)``; ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel) to the output."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build_library()
        lib = ctypes.CDLL(path)
        p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_double)
        lib.gbdt_hist_build.argtypes = [
            p, i, p, p, p, p, p, p, p, p, ll, i, i, d, d, p, p, p]
        lib.gbdt_hist_build.restype = i
        lib.gbdt_hist_smem_bytes.argtypes = [i, i]
        lib.gbdt_hist_smem_bytes.restype = ll
        lib.gbdt_hist_scratch_bytes.argtypes = [i, i, i]
        lib.gbdt_hist_scratch_bytes.restype = ll
        lib.gbdt_hist_max_slots.argtypes = []
        lib.gbdt_hist_max_slots.restype = i
        _lib = lib
    return _lib


# shared memory one block may use on Hopper (232,448 bytes, less the
# kernel's static segment tables)
_SMEM_LIMIT = 232448 - 1024


def _check(name: str, t: torch.Tensor, dtype, shape=None,
           dtype_hint: str = "") -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}{dtype_hint}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def build_histograms_cuda(
    X: torch.Tensor,            # [N, F] uint8 bin codes
    grad: torch.Tensor,         # [N] f32
    hess: torch.Tensor,         # [N] f32
    included: torch.Tensor,     # [N] f32 0/1
    leaf_id: torch.Tensor,      # [N] i32
    slot_of_leaf: torch.Tensor,  # [L+1] i32, -1 = not pending
    num_slots: int,
    num_bins_padded: int,
    row_idx: Optional[torch.Tensor] = None,    # [N] i32 partition (compacted)
    n_active: Optional[int] = None,
    slot_counts: Optional[torch.Tensor] = None,   # [S] i32
    slot_starts: Optional[torch.Tensor] = None,   # [S] i32
    scales: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """``[S, F, B, 3]`` f32 (sum_g, sum_h, count) — same signature and
    result as ``ops.histogram.build_histograms``, which it runs for CPU
    tensors. Bin codes must be below ``num_bins_padded``."""
    if X.device.type == "cpu":
        return build_histograms(X, grad, hess, included, leaf_id,
                                slot_of_leaf, num_slots, num_bins_padded,
                                row_idx=row_idx, n_active=n_active,
                                slot_counts=slot_counts,
                                slot_starts=slot_starts, scales=scales)
    N, F = X.shape
    S, B = int(num_slots), int(num_bins_padded)
    _check("X", X, torch.uint8, dtype_hint=" (uint16 bin codes are not "
           "ported to the histogram kernel yet: ROADMAP B1)")
    for name, t in (("grad", grad), ("hess", hess), ("included", included)):
        _check(name, t, torch.float32, (N,))
    _check("leaf_id", leaf_id, torch.int32, (N,))
    _check("slot_of_leaf", slot_of_leaf, torch.int32)
    lib = _library()
    if S > lib.gbdt_hist_max_slots():
        raise ValueError(f"num_slots={S} exceeds the kernel's "
                         f"{lib.gbdt_hist_max_slots()}")
    smem = lib.gbdt_hist_smem_bytes(S, B)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={S} x B={B} needs {smem} bytes of shared "
                         f"memory per block, above {_SMEM_LIMIT}")
    compact = row_idx is not None
    if compact:
        if slot_counts is None or n_active is None:
            raise ValueError("a compacted pass needs slot_counts and n_active")
        _check("row_idx", row_idx, torch.int32, (N,))
        _check("slot_counts", slot_counts, torch.int32, (S,))
        if slot_starts is not None:
            _check("slot_starts", slot_starts, torch.int32, (S,))
        n_work = int(n_active)
    else:
        n_work = N
    if scales is None:
        scales = histogram_scales(grad, hess)
    dev = X.device
    # the kernel's integer accumulators; the C entry zeroes them on the stream
    scratch = torch.empty(lib.gbdt_hist_scratch_bytes(S, F, B),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((S, F, B, 3), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gbdt_hist_build(
            ptr(X), F, ptr(grad), ptr(hess), ptr(included),
            ptr(leaf_id), ptr(slot_of_leaf),
            ptr(row_idx) if compact else None,
            ptr(slot_counts) if compact else None,
            ptr(slot_starts) if compact else None,
            n_work, S, B, float(scales[0]), float(scales[1]),
            ptr(scratch), ptr(out), stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {err}")
    build_histograms_cuda.launches += 1
    return out


build_histograms_cuda.launches = 0
