"""Attributable per-phase timing (``PhaseBreakdown``).

A copy of ``lightgbm_tpu/observability/phases.py`` with the same
``to_dict()`` schema (pinned by ``tests/test_torch_observability.py``):
warm-up wall-clock against steady-state wall-clock, and the host-sync and
recompile counts of a guard report. Every breakdown also lands in the
process-wide registry as ``phase.<name>.*`` gauges, so a live
``snapshot()`` sees the numbers a bench prints.

    pb = PhaseBreakdown("headline")
    with pb.compile_window():      # warm-up: the first iteration, captures
        ...
    with pb.steady_window(iters=12):
        ...
    pb.attach_guard(report)        # {"host_syncs": .., "post_warmup_cache_misses": ..}
    json["phase_timings"]["headline"] = pb.to_dict()

``attach_guard`` takes ``analysis.guards.CaptureGuard.report()`` as it is:
the port's counterpart of the JAX package's ``RecompileGuard`` counts CUDA
graph captures after warm-up as its cache misses
(``post_warmup_cache_misses``) and the host syncs that
``torch.cuda.set_sync_debug_mode`` flags (the op-trace recorder's host
transfers on the CPU), under the JAX report's keys.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseBreakdown:
    """Warm-up vs steady-state wall-clock and host-sync / recompile counts
    of one named phase."""

    def __init__(self, name: str):
        self.name = name
        self.compile_s = 0.0
        self.steady_s = 0.0
        self.steady_iters = 0
        self.guard_report: Dict = {}

    @contextlib.contextmanager
    def compile_window(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.compile_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def steady_window(self, iters: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.steady_s += time.perf_counter() - t0
            self.steady_iters += iters

    def attach_guard(self, report: Dict) -> None:
        """Fold in a guard report (``CaptureGuard.report()``: host_syncs /
        post-warm-up captures as misses)."""
        self.guard_report = report or {}

    def to_dict(self) -> Dict:
        out = {"compile_s": round(self.compile_s, 3),
               "steady_s": round(self.steady_s, 3),
               "steady_iters": self.steady_iters}
        if self.steady_iters and self.steady_s:
            out["steady_s_per_iter"] = round(
                self.steady_s / self.steady_iters, 4)
        if self.guard_report:
            out["host_syncs"] = self.guard_report.get("host_syncs")
            out["post_warmup_cache_misses"] = self.guard_report.get(
                "post_warmup_cache_misses")
        self._publish(out)
        return out

    def _publish(self, d: Dict) -> None:
        """Mirror this phase into the registry (gauges keyed by phase name:
        idempotent, so repeated ``to_dict()`` calls skew nothing)."""
        from . import get_registry
        reg = get_registry()
        for key in ("compile_s", "steady_s", "steady_iters",
                    "steady_s_per_iter"):
            if d.get(key) is not None:
                reg.gauge(f"phase.{self.name}.{key}").set(d[key])
