"""Build and load the C API shim ``csrc/lgbm_capi.c``.

The shim exports the reference's ``LGBM_*`` symbols (c_api.h) and forwards
each call to :mod:`lightgbm_tpu_torch.capi_impl`. It is compiled at first
use with ``cc`` and the flags of ``python3-config --includes`` and
``--ldflags --embed`` (those of ``capi/Makefile``) into
``lightgbm_tpu_torch/build/lib_lightgbm_tpu_torch_<key>.so``, where the key
hashes the source and the flags (so a library built against another
Python installation is never reused), and serves both
hosting modes: a C program linked against it (embedded: the first call
starts an interpreter, which finds the package through ``PYTHONPATH``), or
``ctypes`` inside a Python process (hosted: :func:`load_shim`).

``python3-config`` is looked up beside the running interpreter's base
installation first, so the flags name the libpython this process runs on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import time
from typing import List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "csrc", "lgbm_capi.c")
BUILD_DIR = os.path.join(HERE, "build")
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


def library_path() -> str:
    """The shim's library for this source and this Python's flags."""
    with open(SOURCE, "rb") as fh:
        key = hashlib.sha256(fh.read())
    key.update(" ".join(_compile_command("")).encode())
    return os.path.join(BUILD_DIR,
                        f"lib_lightgbm_tpu_torch_{key.hexdigest()[:16]}.so")


def build_shim() -> Tuple[str, float]:
    """Compile the shim unless its library exists. Returns ``(path,
    seconds)`` (0.0 when nothing was built)."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h is not in {include}: the C API shim "
                           f"needs the Python development headers")
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = _compile_command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds


def load_shim() -> ctypes.CDLL:
    """The shim, built if needed, loaded into this process (hosted mode)."""
    path, _ = build_shim()
    lib = ctypes.CDLL(path)
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    return lib

