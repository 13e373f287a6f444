"""How the port builds, loads and launches its compiled libraries.

Every source under ``csrc/`` becomes a shared library with a plain C
interface at first use, through :func:`build`: the kernels (``csrc/*.cu``)
with nvcc (:func:`build_cuda`), the C API shim with ``cc``
(``capi_shim.py``). The library is ``build/<stem>_<key>.so`` in the package
(listed in ``.gitignore``), the key the first 16 hex digits of the SHA-256
of the source's bytes and the build's key words (nvcc's flags; the shim's
whole compile command), so an edited source or another flag is built anew
and never loaded stale. A build writes a file of its own process and
renames it into place, so no process loads a half-written library.

:func:`load` builds a library if it is missing, loads it with ``ctypes``
once per process and hands it to the wrapper's ``declare(lib)``, which
binds each C function's ``argtypes`` and ``restype`` (held to ``csrc/`` by
torch-lint's R004) and checks the constants the wrapper shares with its
source. Nothing is built or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# (source, stem) -> the loaded library, declared
_loaded: Dict[Tuple[str, str], ctypes.CDLL] = {}
_load_lock = threading.Lock()


def source_path(name: str) -> str:
    """Path of ``csrc/<name>`` in the package."""
    return os.path.join(PKG, "csrc", name)


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
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels are "
                       "built from csrc/ at first use")


def library_path(source: str, stem: str, key: Sequence[str],
                 build_dir: str = BUILD_DIR) -> str:
    """The library of ``source``, keyed by its bytes and ``key``."""
    with open(source, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(key).encode())
    return os.path.join(build_dir, f"{stem}_{h.hexdigest()[:16]}.so")


def build(source: str, stem: str, key: Sequence[str],
          command: Callable[[str], List[str]],
          build_dir: str = BUILD_DIR) -> Tuple[str, float, str]:
    """Compile ``source`` unless its library (:func:`library_path`)
    exists: ``command(output)`` is the compiler's argument list writing
    ``output``. Returns ``(path, seconds, compiler output)``, ``(path,
    0.0, "")`` when nothing was built; a failed compile raises with the
    compiler's output and leaves no file behind."""
    path = library_path(source, stem, key, build_dir)
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


def build_cuda(source: str, stem: str,
               verbose: bool = False) -> Tuple[str, float, str]:
    """:func:`build` with nvcc and :data:`NVCC_FLAGS`; ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) to the
    output, not to the key."""
    ptxas = ["-Xptxas", "-v"] if verbose else []
    return build(source, stem, NVCC_FLAGS,
                 lambda out: [find_nvcc(), *NVCC_FLAGS, *ptxas, "-o", out,
                              source])


def load(source: str, stem: str, declare: Callable[[ctypes.CDLL], None],
         build_fn: Callable[[str, str], tuple] = build_cuda) -> ctypes.CDLL:
    """The library of ``source``: built by ``build_fn(source, stem)`` (its
    result's first item the path) if missing, loaded and passed to
    ``declare`` once per process. A ``declare`` that raises leaves nothing
    loaded."""
    with _load_lock:
        lib = _loaded.get((source, stem))
        if lib is None:
            lib = ctypes.CDLL(build_fn(source, stem)[0])
            declare(lib)
            _loaded[(source, stem)] = lib
    return lib


def check_tensor(name: str, t: torch.Tensor, dtypes, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    (and of ``shape``, where given): what a kernel reads through a bare
    pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def check_launch(kernel: str, err: int) -> None:
    """Raise where a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``device`` current and its current
    stream's handle last, as every C entry of ``csrc/*.cu`` takes it;
    raises naming ``kernel`` on an error code."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(kernel, err)
