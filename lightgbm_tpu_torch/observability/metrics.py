"""Process-wide metrics registry: counters, gauges, histograms, summaries.

A copy of ``lightgbm_tpu/observability/metrics.py`` (this package imports
nothing of the JAX package; ``tests/test_torch_serving.py`` pins the copy
to the original). One registry per process
(``observability.get_registry()``) takes the serving subsystem's
per-request traffic: ``serve.*`` counters and gauges, and the
quantile-capable ``Summary`` latency metrics whose p50/p99 a load balancer
or a bench reads from ``observability.snapshot()``.

Dependency-free. All mutation happens under one lock; metrics are touched
at host-side dispatch boundaries (a handful of times per request), never
per row.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional


class Counter:
    """Monotonic event count (e.g. ``comm.retries``)."""
    __slots__ = ("name", "_lock", "value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)


class Gauge:
    """Last-written value (e.g. ``booster.tree_batch``)."""
    __slots__ = ("name", "_lock", "value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value: Optional[float] = None

    def set(self, v) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming summary (count/sum/min/max) of an observed distribution
    (e.g. ``tree.waves``). No buckets: the consumers here want the shape of
    a per-run distribution in a snapshot, not a full HDR histogram."""
    __slots__ = ("name", "_lock", "count", "sum", "min", "max")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)


class Summary:
    """Windowed quantile summary: lifetime count/sum/min/max plus a bounded
    ring of the most recent ``window`` observations from which ``snapshot``
    computes p50/p90/p99 (nearest-rank over the window). The serving
    subsystem's per-request latency metrics (``serve.latency_ms``,
    ``serve.dispatch_ms``) are the consumers — a plain Histogram's
    count/sum/min/max cannot answer the p99 question a latency SLO asks.
    The window bounds memory (one float per slot) and biases the quantiles
    toward RECENT traffic, which is what a live probe wants."""
    __slots__ = ("name", "_lock", "count", "sum", "min", "max",
                 "window", "_ring", "_next")

    def __init__(self, name: str, lock: threading.Lock, window: int = 8192):
        self.name = name
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.window = int(window)
        self._ring: list = []
        self._next = 0

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._ring) < self.window:
                self._ring.append(v)
            else:
                self._ring[self._next] = v
            self._next = (self._next + 1) % self.window

    @staticmethod
    def _quantiles_of(data: list, qs=(0.5, 0.9, 0.99)
                      ) -> Dict[str, Optional[float]]:
        """Nearest-rank quantiles of an already-sorted sample (caller holds
        whatever lock protects the sample)."""
        out: Dict[str, Optional[float]] = {}
        n = len(data)
        for q in qs:
            key = f"p{int(q * 100)}"
            out[key] = None if n == 0 else \
                data[min(n - 1, max(0, math.ceil(q * n) - 1))]
        return out

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> Dict[str, Optional[float]]:
        with self._lock:
            data = sorted(self._ring)
        return self._quantiles_of(data, qs)


class MetricsRegistry:
    """Named metric store; metrics are created on first use so producers
    never need registration order coordination."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._summaries: Dict[str, Summary] = {}

    # ------------------------------------------------------------- accessors

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name,
                                                Histogram(name, self._lock))
        return h

    def summary(self, name: str, window: int = 8192) -> Summary:
        s = self._summaries.get(name)
        if s is None:
            with self._lock:
                s = self._summaries.setdefault(
                    name, Summary(name, self._lock, window=window))
        return s

    def inc(self, name: str, n: int = 1) -> None:
        """Convenience: ``registry.inc("comm.retries")``."""
        self.counter(name).inc(n)

    # -------------------------------------------------------------- snapshot

    def snapshot(self) -> Dict:
        """Point-in-time view of every metric — the serving-side API
        (docs/Observability.md): cheap, lock-consistent, JSON-serializable."""
        with self._lock:
            counters = {k: c.value for k, c in sorted(self._counters.items())}
            gauges = {k: g.value for k, g in sorted(self._gauges.items())}
            hists = {}
            for k, h in sorted(self._histograms.items()):
                hists[k] = {
                    "count": h.count, "sum": round(h.sum, 6),
                    "min": h.min, "max": h.max,
                    "mean": round(h.sum / h.count, 6) if h.count else None,
                }
            sums = {}
            for k, s in sorted(self._summaries.items()):
                q = Summary._quantiles_of(sorted(s._ring))
                sums[k] = {
                    "count": s.count, "min": s.min, "max": s.max,
                    "mean": round(s.sum / s.count, 6) if s.count else None,
                    "p50": q["p50"], "p90": q["p90"], "p99": q["p99"],
                    "window": len(s._ring),
                }
        out = {"time_unix": round(time.time(), 3), "counters": counters,
               "gauges": gauges, "histograms": hists}
        if sums:
            # additive key: older snapshot consumers (bench telemetry block,
            # JSONL counters records) ignore it; serving probes read p50/p99
            out["summaries"] = sums
        return out

    def reset(self) -> None:
        """Drop every metric (tests; a fresh serving epoch)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._summaries.clear()
