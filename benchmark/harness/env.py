"""The run's surroundings: where the checkout is, where caches go, which
modules may be loaded, and which device the run has.

Nothing here imports torch: :func:`set_cache_dirs` must run before it is
imported.
"""
from __future__ import annotations

import os
import sys
from typing import Iterable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")
PACKAGE = "lightgbm_tpu_torch"
# top-level module names the port must never load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


class RunRefused(RuntimeError):
    """The run cannot measure here; it prints no result."""


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only the first run of a cell there builds. The histogram kernel's
    library is built into ``lightgbm_tpu_torch/build/`` by the port."""
    cache = os.path.join(root, ".benchmark_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def use_checkout_package(root: str = ROOT) -> None:
    """Put the checkout first on ``sys.path`` and load the port from it;
    a port found anywhere else is refused."""
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        mod = __import__(PACKAGE)
    except ImportError as e:
        raise RunRefused(f"{PACKAGE} is not in the checkout {root}: {e}")
    where = os.path.realpath(os.path.dirname(mod.__file__))
    if os.path.dirname(where) != os.path.realpath(root):
        raise RunRefused(f"{PACKAGE} was loaded from {where}, not from the "
                         f"checkout {root}")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN`, compared whole."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def require_devices(count: int) -> str:
    """The card's name; refuses a run without ``count`` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        raise RunRefused("torch.cuda.is_available() is false: this "
                         "benchmark measures the port on a CUDA card")
    if torch.cuda.device_count() < count:
        raise RunRefused(f"the cell needs {count} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")
    return torch.cuda.get_device_name(0)
