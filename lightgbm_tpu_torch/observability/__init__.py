"""Runtime telemetry of the port (``lightgbm_tpu/observability`` there).

One subsystem for the runtime signals of training and serving:

- ``SpanTracer`` (tracer.py)      — nested host spans (``train`` ->
  ``tree_batch`` -> ``iteration`` -> ``iteration.flags`` and derived
  ``wave``; ``eval`` -> ``eval.fetch`` / ``eval.metric``; ``construct``
  -> ``construct.find_bins`` / ``.defer`` / ``.bin``;
  ``construct.place``; ``predict`` -> ``predict.upload`` / ``.encode``
  / ``.walk`` / ``.fetch`` / ``.convert``; ``checkpoint``), opened at
  host boundaries between the replays of a captured iteration, never
  inside a captured part. Each is also a ``torch.profiler`` range while
  a profiler records, and its ``ts`` is on the profiler's clock. While
  spans are recorded the captured iteration's parts are timed on the
  device with CUDA events (``boosting/gbdt._PartClock``): the
  ``iteration.device_ms.*`` histograms and the ``iteration.timed``
  counter. The span tree, the shared clock and these counters, with
  their overhead: docs/Observability-torch.md.
- ``MetricsRegistry`` (metrics.py) — process-wide counters, gauges,
  histograms and quantile summaries: the booster's kernel route and
  shape, ``trees.trained`` / ``rows.routed``, ``tree.waves`` /
  ``tree.leaves``, ``nan_policy``, checkpoint and comm events, and the
  serving subsystem's ``serve.*`` traffic and p50/p99.
- exporters (export.py)           — ``events_<pid>.jsonl`` and the Chrome
  trace ``trace_<pid>.json`` under ``LGBM_TPU_TELEMETRY_DIR`` / config
  ``telemetry_dir``; ``snapshot()`` is the point-in-time serving API.
- ``ProfileWindow`` (profiler.py) — optional ``torch.profiler`` capture of
  an iteration range (``tpu_profile_iters=start:stop``).
- cost reports (costs.py)         — analytic per-site reports (FLOPs,
  bytes, argument/output/temp device bytes; ``tpu_cost_analysis`` /
  ``LGBM_TPU_COST_ANALYSIS``) as ``cost.<site>.*`` gauges, in
  ``snapshot()`` and as trace metadata.
- device memory (memory.py)       — ``device_memory()`` stats and the
  analytic pre-flight residency estimate ``engine.train`` budgets
  against.
- ``PhaseBreakdown`` (phases.py)  — warm-up vs steady wall-clock of a
  named phase, as ``phase.<name>.*`` gauges.
- perf ledger (ledger.py)         — the port's normalized result history
  and regression compare.

The module singletons are process-wide on purpose: a training run, a
serving engine and a bench read the same registry. With no telemetry
directory configured the tracer is disabled — ``span()`` returns a shared
no-op unless a profiler records, and the registry costs one dict lookup
and an int add per event.
Nothing here imports ``torch`` at import time.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from .metrics import MetricsRegistry
from .phases import PhaseBreakdown  # noqa: F401  (public: phase timing)
from .tracer import SpanTracer, _Span

ENV_TELEMETRY_DIR = "LGBM_TPU_TELEMETRY_DIR"


def clock() -> float:
    """Monotonic wall clock for the measurements that feed the registry
    and the trace (the serving engine's dispatch and request latencies,
    the load generators)."""
    return time.perf_counter()


_registry = MetricsRegistry()
_tracer = SpanTracer()
_state: Dict = {"dir": None, "jsonl_cursor": 0, "env_checked": False}


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


def maybe_configure_from_env() -> None:
    """Honor ``LGBM_TPU_TELEMETRY_DIR`` once per process (called from the
    training entry points; explicit ``configure()`` calls always win)."""
    if _state["env_checked"]:
        return
    _state["env_checked"] = True
    env = os.environ.get(ENV_TELEMETRY_DIR)
    if env and _state["dir"] is None:
        configure(telemetry_dir=env)


# ----------------------------------------------------------------- recording

def span(name: str, **args):
    """``with observability.span("serve.warmup", buckets=13): ...`` — no-op
    when telemetry is disabled."""
    return _tracer.span(name, **args)


def annotate(span_handle, **args) -> None:
    """Add ``args`` to a span while it is open (``with span(...) as sp:
    annotate(sp, bundles=G)``), for what is known only inside it; a no-op
    where the span is not recorded."""
    if isinstance(span_handle, _Span):
        span_handle.args.update(args)


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
    """Point-in-time metrics snapshot (the serving API): registry contents,
    the tracer's bookkeeping, the cost reports (costs.py) and the card's
    memory stats (memory.py; absent while CUDA is not initialized, so
    this never initializes it)."""
    snap = _registry.snapshot()
    snap["spans_recorded"] = len(_tracer.events())
    snap["spans_dropped"] = _tracer.dropped
    from . import costs as _costs
    cost_reports = _costs.reports()
    if cost_reports:
        snap["cost_reports"] = cost_reports
    from .memory import device_memory
    dm = device_memory()
    if dm:
        snap["device_memory"] = dm
    return snap


def write_snapshot(path: str) -> str:
    """Write ``snapshot()`` to ``path`` as JSON, atomically."""
    from .export import atomic_write_json
    return atomic_write_json(path, snapshot(), indent=1, sort_keys=True,
                             trailing_newline=True)


def flush() -> Optional[str]:
    """Write pending telemetry to disk: append the new events and a
    counters record to ``events_<pid>.jsonl``, rewrite the Chrome trace
    ``trace_<pid>.json`` (Perfetto-loadable, with the cost reports as
    ``otherData.cost_reports``). Returns the trace path (None when no
    directory is configured). Never called inside a hot loop."""
    d = _state["dir"]
    if not d:
        return None
    from .export import JsonlWriter, write_chrome_trace
    new, _state["jsonl_cursor"] = _tracer.events_since(_state["jsonl_cursor"])
    records = [dict(ev, type="span" if ev.get("ph") == "X" else "event")
               for ev in new]
    records.append(dict(snapshot(), type="counters"))
    JsonlWriter(jsonl_path()).append(records)
    from . import costs as _costs
    metadata = {"epoch_unix": _tracer.epoch_unix()}
    cost_reports = _costs.reports()
    if cost_reports:
        metadata["cost_reports"] = cost_reports
    return write_chrome_trace(_tracer.events(), trace_path(),
                              metadata=metadata)


def reset_for_tests() -> None:
    """Full reset of the process-wide singletons (test isolation)."""
    from . import costs as _costs
    _registry.reset()
    _tracer.reset()
    _tracer.enabled = False
    _state["dir"] = None
    _state["jsonl_cursor"] = 0
    _state["env_checked"] = False
    _costs.reset_for_tests()
