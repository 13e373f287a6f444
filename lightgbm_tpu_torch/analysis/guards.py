"""Runtime capture and host-sync guard — the enforced twin of torch-lint.

The port's counterpart of the JAX package's ``RecompileGuard``
(``lightgbm_tpu/analysis/guards.py``). There a steady training loop must
dispatch the same compiled executable every iteration; here it must
replay the CUDA graphs it captured: a capture after warm-up means a part
changed shape or a graph was dropped, and costs a capture's seconds (and
a pool's memory) per occurrence. A capture counts as the JAX guard's
cache miss, so the report has its keys and
``observability.phases.PhaseBreakdown.attach_guard`` takes it unchanged.

What it counts, inside the ``with`` block:

- **captures** of the registered capturers after :meth:`mark_warm` —
  anything exposing ``captures`` (an int, or a method returning one):
  ``boosting/gbdt._IterationGraphs``, ``serving.engine.ServingEngine``;
- **host syncs**: on the card, the calls
  ``torch.cuda.set_sync_debug_mode("warn")`` flags (with the frame of the
  port that made each, in :attr:`sync_sites`), plus the explicit reads
  the registered objects count in a ``syncs`` attribute (the captured
  iteration's one flag read per tree, a pinned copy and an event wait the
  debug mode does not flag). Turning the mode on warns once itself, and
  the syncs before :meth:`mark_warm` (the capture iteration's) are
  warm-up: neither is counted. On the CPU, the host transfers the op-trace
  recorder sees (``contracts/op_trace.py``: ``.item()``, ``int(t)``,
  ``.tolist()``, data-dependent shapes, host scalars written into
  tensors).

``fail=True`` raises :class:`GuardViolation` on exit when a capture
happened after warm-up; ``disallow_transfers=True`` makes a host sync
raise where it happens (the debug mode's ``"error"`` on the card). The
guard never swallows a violation.

    guard = CaptureGuard("train")
    bst.update()                                  # warm-up: the capture
    guard.register(bst._gbdt._graphs, "iteration")
    with guard:
        guard.mark_warm()
        for _ in range(9):
            bst.update()
    phases.attach_guard(guard.report())

torch is imported when the guard is entered, so the lint CLI that imports
this package stays torch-free.
"""
from __future__ import annotations

import contextlib
import os
import traceback
import warnings
from typing import Dict, List, Optional

_PKG = "lightgbm_tpu_torch"


class GuardViolation(RuntimeError):
    """A guarded invariant (no capture after warm-up / no host sync) was
    broken."""


def _read(obj, name: str) -> int:
    v = getattr(obj, name, 0)
    return int(v() if callable(v) else v)


class CaptureGuard:
    """Counts CUDA graph captures after warm-up per registered capturer
    and host syncs; optionally fails on either.

    Parameters
    ----------
    label: tag used in violation messages ("train", "serve", ...).
    fail: raise GuardViolation on exit when post-warm-up captures > 0.
    disallow_transfers: raise where a host sync happens inside the block.
    device: ``"cuda"`` counts syncs with the sync debug mode, ``"cpu"``
        with the op-trace recorder; None picks the card when CUDA is
        available.
    """

    def __init__(self, label: str = "train", fail: bool = True,
                 disallow_transfers: bool = False,
                 device: Optional[str] = None):
        self.label = label
        self.fail = fail
        self.disallow_transfers = disallow_transfers
        self.device = device
        self._entry: Dict[str, object] = {}
        self._start: Dict[str, int] = {}
        self._warm: Optional[Dict[str, int]] = None
        self._start_syncs: Dict[str, int] = {}
        self._warm_syncs: Optional[Dict[str, int]] = None
        self._flagged = 0              # syncs the debug mode flagged
        self._flagged_base = 0         # ... before counting starts
        self._trace = None             # the CPU recorder's trace
        self._trace_base = 0
        self._stack: Optional[contextlib.ExitStack] = None
        self._surface: Optional[bool] = None
        self._on_card = False
        # the frames of the counted syncs the debug mode flagged
        self.sync_sites: List[str] = []

    # ------------------------------------------------------------- tracking

    def register(self, capturer, name: Optional[str] = None) -> None:
        """Track an object exposing ``captures`` (an int or a method); its
        ``syncs`` attribute, if any, adds to :attr:`host_syncs`."""
        if capturer is None:
            return
        if not hasattr(capturer, "captures"):
            raise TypeError(
                f"CaptureGuard.register: {capturer!r} has no `captures`; "
                f"pass the object that captures the CUDA graphs")
        key = name or type(capturer).__name__
        self._entry[key] = capturer
        self._start[key] = _read(capturer, "captures")
        self._start_syncs[key] = _read(capturer, "syncs")
        if self._warm is not None:
            self._warm[key] = self._start[key]
            self._warm_syncs[key] = self._start_syncs[key]

    def mark_warm(self) -> None:
        """Snapshot the captures and syncs: captures after this point are
        violations, and syncs before it are warm-up."""
        self._warm = {k: _read(c, "captures")
                      for k, c in self._entry.items()}
        self._warm_syncs = {k: _read(c, "syncs")
                            for k, c in self._entry.items()}
        self._flagged_base = self._flagged
        self.sync_sites = []
        if self._trace is not None:
            self._trace_base = len(self._trace.host_transfers())

    def captures_since_warm(self) -> Dict[str, int]:
        base = self._warm if self._warm is not None else self._start
        return {k: _read(c, "captures") - base.get(k, 0)
                for k, c in self._entry.items()}

    @property
    def active(self) -> bool:
        """Inside the guarded block (entered and not yet left)."""
        return self._stack is not None

    @property
    def host_syncs(self) -> int:
        """Host syncs counted since :meth:`mark_warm` (else since the block
        was entered)."""
        base = self._warm_syncs if self._warm_syncs is not None \
            else self._start_syncs
        explicit = sum(_read(c, "syncs") - base.get(k, 0)
                       for k, c in self._entry.items())
        if self._trace is not None:
            return explicit + len(self._trace.host_transfers()) \
                - self._trace_base
        return explicit + self._flagged - self._flagged_base

    def report(self) -> dict:
        """The JAX guard's report keys; a capture is a cache miss."""
        misses = self.captures_since_warm()
        return {"label": self.label,
                "post_warmup_cache_misses": sum(misses.values()),
                "misses_by_entrypoint": misses,
                "host_syncs": self.host_syncs,
                "transfer_counting": self._surface,
                "warm_marked": self._warm is not None}

    # -------------------------------------------------------- sync counting

    def _arm_card(self, stack: contextlib.ExitStack) -> None:
        import torch
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("always")
        guard = self

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return
            guard._flagged += 1
            frames = [f for f in traceback.extract_stack()[:-1]
                      if _PKG in f.filename
                      and "analysis" not in f.filename]
            if frames:
                f = frames[-1]
                guard.sync_sites.append(
                    f"{os.path.basename(f.filename)}:{f.lineno} {f.name}")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode(
            "error" if self.disallow_transfers else "warn")
        stack.callback(torch.cuda.set_sync_debug_mode, 0)
        # turning the mode on warns once itself: not the block's
        self._flagged_base = self._flagged
        self.sync_sites = []

    def _arm_cpu(self, stack: contextlib.ExitStack) -> None:
        from .contracts import op_trace
        self._trace = stack.enter_context(op_trace.record())
        if self.disallow_transfers:
            trace, label = self._trace, self.label

            class Strict(list):
                def append(self, rec):
                    super().append(rec)
                    if rec.host:
                        raise GuardViolation(
                            f"[{label}] host sync ({rec.name}, {rec.host}) "
                            f"at {rec.site} inside a transfer-guarded "
                            f"block")
            trace.ops = Strict(trace.ops)

    # ------------------------------------------------------ context manager

    def __enter__(self) -> "CaptureGuard":
        import torch
        dev = self.device or ("cuda" if torch.cuda.is_available()
                              else "cpu")
        self._on_card = dev.startswith("cuda")
        self._stack = contextlib.ExitStack()
        self._flagged = self._flagged_base = 0
        self.sync_sites = []
        try:
            (self._arm_card if self._on_card else self._arm_cpu)(self._stack)
            self._surface = True
        except Exception:
            self._stack.close()
            raise
        return self

    def _publish_report(self) -> None:
        """Feed the guard's totals into the process-wide registry
        (``observability``): ``captures.post_warmup``, ``host_syncs``,
        ``guard.windows``."""
        from ..observability import get_registry
        reg = get_registry()
        misses = sum(self.captures_since_warm().values()) \
            if self._warm is not None else 0
        if misses > 0:
            reg.counter("captures.post_warmup").inc(misses)
        if self.host_syncs:
            reg.counter("host_syncs").inc(self.host_syncs)
        reg.counter("guard.windows").inc()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._stack.close()
        self._stack = None
        self._publish_report()
        if exc_type is not None:
            return False
        if self.fail and self._warm is not None:
            misses = self.captures_since_warm()
            total = sum(misses.values())
            if total > 0:
                detail = ", ".join(f"{k}: +{v}" for k, v in misses.items()
                                   if v)
                raise GuardViolation(
                    f"[{self.label}] {total} CUDA graph capture(s) after "
                    f"warm-up ({detail}) — the steady loop re-captured; a "
                    f"shape, a variant or a dropped graph changed between "
                    f"iterations")
        return False


@contextlib.contextmanager
def capture_guard(capturers=(), label: str = "train", fail: bool = True,
                  warm: bool = True, disallow_transfers: bool = False,
                  device: Optional[str] = None):
    """Functional wrapper: capturers pre-registered, warm-marked on entry.

        with capture_guard([engine]) as g:
            for _ in range(n):
                engine.predict(X)
        assert g.report()["post_warmup_cache_misses"] == 0
    """
    g = CaptureGuard(label=label, fail=fail,
                     disallow_transfers=disallow_transfers, device=device)
    for c in capturers:
        g.register(c)
    with g:
        if warm:
            g.mark_warm()
        yield g
