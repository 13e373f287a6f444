"""The port's counterpart of a jaxpr: the aten operations a function
dispatches, recorded with a ``TorchDispatchMode``.

The JAX tier traced each shipped entry point to a jaxpr and read its
primitives (``lightgbm_tpu/analysis/contracts/jaxpr_utils.py``). PyTorch
runs eagerly, so the port records what one call of the entry actually
dispatches: for each aten operation its name, its input shapes, dtypes and
devices, its output dtypes, and the innermost frame of the port that
issued it (``ops/split_finder.py:prefix_sums``), which the dtype allowlist
names.

Host transfers, each a record with ``host`` set:

- ``aten._local_scalar_dense``: what ``.item()``, ``int(t)``,
  ``float(t)`` and ``bool(t)`` (an ``if`` on a tensor) lower to;
- ``_to_copy`` / ``copy_`` onto the CPU from a CUDA tensor;
- operations whose output shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``): the host reads the size;
- ``lift_fresh`` of one element: a Python scalar made a tensor (``t[i] =
  0.5``; a larger one wraps host memory, as ``torch.from_numpy`` of a
  streamed shard does before its copy to the card);
- ``Tensor.tolist()`` / ``Tensor.numpy()``, which read without
  dispatching on the CPU, counted at the Python surface while recording.

The histogram kernel (B1) is launched through ``ctypes`` and invisible to
the dispatcher; on the card its passes are counted with
``ops/cuda_histogram.launch_count()``. On the CPU the wrapper runs the
kernel's plain version instead, and the recorder keeps that opaque as the
kernel is: each plain pass is one ``kernel:histogram`` record (its inputs'
shapes and dtypes), and the plain version's own operations are not
recorded — so a recording on the CPU and one on the card see the same
program around the kernel.
"""
from __future__ import annotations

import contextlib
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

HOST_OPS = {"_local_scalar_dense", "lift_fresh", "lift_fresh_copy"}
DATA_DEPENDENT_OPS = {"nonzero", "masked_select", "unique", "_unique",
                      "_unique2", "unique_dim", "unique_consecutive",
                      "unique_dim_consecutive"}
COPY_OPS = {"_to_copy", "copy_", "copy"}
KERNEL_OP = "kernel:histogram"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SKIP_DIRS = (os.path.join(_PKG_DIR, "analysis"),)


@dataclass
class OpRecord:
    """One dispatched operation."""
    name: str                                   # "sort", "kernel:histogram"
    overload: str
    shapes: Tuple[Tuple[int, ...], ...]         # tensor inputs' shapes
    dtypes: Tuple[str, ...]                     # tensor inputs' dtypes
    devices: Tuple[str, ...]                    # tensor inputs' devices
    out_dtypes: Tuple[str, ...]
    site: str                                   # "ops/histogram.py:fn"
    host: str = ""                              # host-transfer kind, or ""

    @property
    def numel(self) -> int:
        """The largest input's element count."""
        best = 0
        for s in self.shapes:
            n = 1
            for d in s:
                n *= int(d)
            best = max(best, n)
        return best


@dataclass
class OpTrace:
    """What one recorded region dispatched."""
    ops: List[OpRecord] = field(default_factory=list)
    kernel_passes: int = 0          # B1's plain passes (CPU) in the region
    waves: int = 0                  # waves recorded (set by the builders)

    def host_transfers(self) -> List[OpRecord]:
        return [r for r in self.ops if r.host]

    def count(self, name: str) -> int:
        return sum(r.name == name for r in self.ops)


def _site() -> str:
    """The innermost frame of the port (outside this package) on the
    stack: ``relpath:function``."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG_DIR) and not fn.startswith(_SKIP_DIRS):
            rel = os.path.relpath(fn, _PKG_DIR).replace(os.sep, "/")
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "<outside>"


def _tensors(obj, out):
    import torch
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


def _host_kind(name: str, ins, outs) -> str:
    if name == "_local_scalar_dense":
        return "scalar read"
    if name in HOST_OPS:
        return "host scalar" if all(t.numel() <= 1 for t in ins) else ""
    if name in DATA_DEPENDENT_OPS:
        return "data-dependent shape"
    if name in COPY_OPS:
        to_cpu = any(o.device.type == "cpu" for o in outs)
        from_cuda = any(i.device.type == "cuda" for i in ins)
        if to_cpu and from_cuda:
            return "device to host copy"
    return ""


_ACTIVE: List["_Recorder"] = []      # the recorders of open regions


@contextlib.contextmanager
def unrecorded():
    """Run the block without recording it in the open regions (a leg that
    another target records on its own)."""
    for r in _ACTIVE:
        r.paused += 1
    try:
        yield
    finally:
        for r in _ACTIVE:
            r.paused -= 1


class _Recorder:
    """The dispatch mode and the Python-surface counters of one region."""

    def __init__(self, trace: OpTrace):
        from torch.utils._python_dispatch import TorchDispatchMode
        recorder = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if recorder.paused == 0:
                    recorder.record(func, args, kwargs or {}, out)
                return out

        self.trace = trace
        self.mode = Mode()
        self.paused = 0

    def record(self, func, args, kwargs, out) -> None:
        ins = _tensors(args, []) + _tensors(kwargs, [])
        outs = _tensors(out, [])
        name = func.overloadpacket.__name__
        self.trace.ops.append(OpRecord(
            name=name, overload=str(func._overloadname),
            shapes=tuple(tuple(t.shape) for t in ins),
            dtypes=tuple(str(t.dtype).replace("torch.", "") for t in ins),
            devices=tuple(t.device.type for t in ins),
            out_dtypes=tuple(str(t.dtype).replace("torch.", "")
                             for t in outs),
            site=_site(), host=_host_kind(name, ins, outs)))

    def opaque(self, label: str, inputs) -> None:
        ins = _tensors(inputs, [])
        self.trace.ops.append(OpRecord(
            name=label, overload="", shapes=tuple(tuple(t.shape)
                                                  for t in ins),
            dtypes=tuple(str(t.dtype).replace("torch.", "") for t in ins),
            devices=tuple(t.device.type for t in ins), out_dtypes=(),
            site=_site()))


@contextlib.contextmanager
def record(trace: Optional[OpTrace] = None, kernels_opaque: bool = True):
    """Record the aten operations dispatched inside the block into an
    :class:`OpTrace` (yielded). ``kernels_opaque``: B1's plain version
    (the CPU stand-in for the kernel) is one ``kernel:histogram`` record,
    its own operations unrecorded."""
    import torch
    from ...ops import cuda_histogram as ch
    trace = trace if trace is not None else OpTrace()
    rec = _Recorder(trace)
    saved = {}

    def opaque(fn, counts):
        def wrapper(*args, **kwargs):
            if counts(kwargs):
                trace.kernel_passes += 1
                rec.opaque(KERNEL_OP, args)
            rec.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                rec.paused -= 1
        return wrapper

    def host_read(meth, kind):
        def wrapper(self, *a, **kw):
            if rec.paused == 0:
                rec.trace.ops.append(OpRecord(
                    name=f"Tensor.{meth.__name__}", overload="",
                    shapes=(tuple(self.shape),),
                    dtypes=(str(self.dtype).replace("torch.", ""),),
                    devices=(self.device.type,), out_dtypes=(),
                    site=_site(), host=kind))
            return meth(self, *a, **kw)
        return wrapper

    if kernels_opaque:
        # a resident pass is one build_histograms call; a folded one its
        # shards' raw adds and one finalize (ops/cuda_histogram.py)
        saved["build_histograms"] = ch.build_histograms
        saved["finalize_histograms"] = ch.finalize_histograms
        ch.build_histograms = opaque(
            ch.build_histograms, lambda kw: not kw.get("raw_output"))
        ch.finalize_histograms = opaque(ch.finalize_histograms,
                                        lambda kw: True)
    methods = {"tolist": torch.Tensor.tolist, "numpy": torch.Tensor.numpy}
    torch.Tensor.tolist = host_read(methods["tolist"], "host read")
    torch.Tensor.numpy = host_read(methods["numpy"], "host read")
    _ACTIVE.append(rec)
    try:
        with rec.mode:
            yield trace
    finally:
        _ACTIVE.remove(rec)
        torch.Tensor.tolist = methods["tolist"]
        torch.Tensor.numpy = methods["numpy"]
        for k, v in saved.items():
            setattr(ch, k, v)
