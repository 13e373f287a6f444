"""Build and load the C API shim ``csrc/lgbm_capi.c``.

The shim exports the reference's ``LGBM_*`` symbols (c_api.h) and forwards
each call to :mod:`lightgbm_tpu_torch.capi_impl`. It is compiled at first
use with ``cc`` and the flags of ``python3-config --includes`` and
``--ldflags --embed`` (those of ``capi/Makefile``) by ``ops/native.build``
into ``lightgbm_tpu_torch/build/lib_lightgbm_tpu_torch_<key>.so``, the key
hashing the source and the whole compile command (so a library built
against another Python installation is never reused), and serves both
hosting modes: a C program linked against it (embedded: the first call
starts an interpreter, which finds the package through ``PYTHONPATH``), or
``ctypes`` inside a Python process (hosted: :func:`load_shim`).

``python3-config`` is looked up beside the running interpreter's base
installation first, so the flags name the libpython this process runs on.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sysconfig
from typing import List, Tuple

from .ops import native

SOURCE = native.source_path("lgbm_capi.c")
STEM = "lib_lightgbm_tpu_torch"
CFLAGS = ["-shared", "-fPIC", "-O2", "-fvisibility=hidden"]


def python_config() -> str:
    """The ``python3-config`` of the running interpreter's installation."""
    bindir = sysconfig.get_config_var("BINDIR") or ""
    version = sysconfig.get_config_var("VERSION") or ""
    for name in (f"python{version}-config", "python3-config"):
        cand = os.path.join(bindir, name)
        if os.access(cand, os.X_OK):
            return cand
    found = shutil.which("python3-config")
    if found is None:
        raise RuntimeError("python3-config not found: the C API shim needs "
                           "the Python development files")
    return found


def _config_flags(*args: str) -> List[str]:
    proc = subprocess.run([python_config(), *args], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"python3-config {' '.join(args)} failed: "
                           f"{proc.stderr.strip()}")
    return proc.stdout.split()


def _compile_command(output: str, source: str = SOURCE) -> List[str]:
    includes = _config_flags("--includes")
    ldflags = _config_flags("--ldflags", "--embed")
    return ["cc", *CFLAGS, *includes, source, "-o", output, *ldflags]


def build_shim() -> Tuple[str, float]:
    """Compile the shim unless its library exists (``ops/native.build``,
    keyed by the source and the whole compile command). Returns ``(path,
    seconds)`` (0.0 when nothing was built)."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h is not in {include}: the C API shim "
                           f"needs the Python development headers")
    path, seconds, _ = native.build(SOURCE, STEM, _compile_command(""),
                                    _compile_command)
    return path, seconds


def declare(lib: ctypes.CDLL) -> None:
    """Bind what the hosted mode reads of the shim's C interface."""
    lib.LGBM_GetLastError.restype = ctypes.c_char_p


def load_shim() -> ctypes.CDLL:
    """The shim, built if needed, loaded into this process (hosted mode)."""
    return native.load(SOURCE, STEM, declare, lambda *_: build_shim())
