"""Runtime telemetry: the metrics registry and the span tracer.

The part of ``lightgbm_tpu/observability/__init__.py`` (:54-201) that the
serving subsystem and its tests call: ``clock``, the process-wide
``MetricsRegistry`` (metrics.py) and ``SpanTracer`` (tracer.py),
``configure``, ``span`` / ``event`` / ``inc``, ``snapshot``,
``write_snapshot``, ``flush``, ``telemetry_dir`` and ``reset_for_tests``
(the hang watchdog dumps the snapshot too). The JAX package's
cost reports, device-memory accounting, perf ledger, profiler window and
phase breakdown are not ported yet (ROADMAP A17b), so ``snapshot()`` holds
the registry and the tracer's bookkeeping only.

The module singletons are process-wide on purpose: a serving engine, its
micro-batcher and a bench read the same registry. With no telemetry
directory configured the tracer is disabled — ``span()`` returns a shared
no-op and the registry costs one dict lookup and an int add per event.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from .metrics import MetricsRegistry
from .tracer import SpanTracer


def clock() -> float:
    """Monotonic wall clock for the measurements that feed the registry
    and the trace (the serving engine's dispatch and request latencies,
    the load generators)."""
    return time.perf_counter()


_registry = MetricsRegistry()
_tracer = SpanTracer()
_state: Dict = {"dir": None, "jsonl_cursor": 0}


# ------------------------------------------------------------- configuration

def get_registry() -> MetricsRegistry:
    return _registry


def get_tracer() -> SpanTracer:
    return _tracer


def enabled() -> bool:
    """True when spans are being recorded (a telemetry dir is configured or
    the tracer was force-enabled)."""
    return _tracer.enabled


def configure(telemetry_dir: Optional[str] = None,
              enabled: Optional[bool] = None) -> None:
    """Point the exporters at ``telemetry_dir`` (created if missing) and/or
    force the tracer on/off. Setting a directory enables the tracer unless
    ``enabled=False`` is passed explicitly."""
    if telemetry_dir:
        os.makedirs(telemetry_dir, exist_ok=True)
        _state["dir"] = telemetry_dir
        if enabled is None:
            enabled = True
    if enabled is not None:
        _tracer.enabled = bool(enabled)


# ----------------------------------------------------------------- recording

def span(name: str, **args):
    """``with observability.span("serve.warmup", buckets=13): ...`` — no-op
    when telemetry is disabled."""
    return _tracer.span(name, **args)


def event(name: str, **args) -> None:
    _tracer.event(name, **args)


def inc(name: str, n: int = 1) -> None:
    _registry.inc(name, n)


# ------------------------------------------------------------------- export

def telemetry_dir() -> Optional[str]:
    """The configured telemetry directory (None: not configured)."""
    return _state["dir"]


def trace_path() -> Optional[str]:
    d = _state["dir"]
    return os.path.join(d, f"trace_{os.getpid()}.json") if d else None


def jsonl_path() -> Optional[str]:
    d = _state["dir"]
    return os.path.join(d, f"events_{os.getpid()}.jsonl") if d else None


def snapshot() -> Dict:
    """Point-in-time metrics snapshot (the serving API): registry contents
    plus the tracer's bookkeeping."""
    snap = _registry.snapshot()
    snap["spans_recorded"] = len(_tracer.events())
    snap["spans_dropped"] = _tracer.dropped
    return snap


def _atomic_write_json(path: str, doc, **dump_kw) -> str:
    """tmp + ``os.replace``: a crash mid-write never leaves a truncated
    file behind (pid-suffixed temp, so two writers never share one)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, **dump_kw)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def write_snapshot(path: str) -> str:
    """Write ``snapshot()`` to ``path`` as JSON, atomically."""
    return _atomic_write_json(path, snapshot(), indent=1, sort_keys=True)


def flush() -> Optional[str]:
    """Write pending telemetry to disk: append the new events and a
    counters record to ``events_<pid>.jsonl``, rewrite the Chrome trace
    ``trace_<pid>.json`` (Perfetto-loadable). Returns the trace path (None
    when no directory is configured). Never called inside a hot loop."""
    d = _state["dir"]
    if not d:
        return None
    new, _state["jsonl_cursor"] = _tracer.events_since(_state["jsonl_cursor"])
    records = [dict(ev, type="span" if ev.get("ph") == "X" else "event")
               for ev in new]
    records.append(dict(snapshot(), type="counters"))
    with open(jsonl_path(), "a") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    return _atomic_write_json(trace_path(), {
        "traceEvents": _tracer.events(), "displayTimeUnit": "ms",
        "otherData": {"epoch_unix": _tracer.epoch_unix(),
                      "producer": "lightgbm_tpu_torch"}})


def reset_for_tests() -> None:
    """Full reset of the process-wide singletons (test isolation)."""
    _registry.reset()
    _tracer.reset()
    _tracer.enabled = False
    _state["dir"] = None
    _state["jsonl_cursor"] = 0
