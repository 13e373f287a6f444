"""Host-side span tracer: nested wall-clock spans at dispatch boundaries.

Started from ``lightgbm_tpu/observability/tracer.py``
(``tests/test_torch_serving.py`` pins the records both make). Spans are
recorded only at host boundaries (``serve.warmup``, ``predict.encode`` and
the like): entering and leaving one costs two ``time.perf_counter_ns()``
calls and one list append, and no device tensor is touched. Work inside a
CUDA graph has no host boundary; its timing comes from CUDA events
(``boosting/gbdt._PartClock``) or ``torch.profiler``.

While a ``torch.profiler`` records, every span also opens a profiler range
of its name, whether or not the tracer is enabled, so that the profiler's
trace (and the benchmark's idle-gap labels) names the host work of each
span. The profiler's state is read through ``sys.modules``: this module
imports no torch. A span's ``ts`` is on the profiler's clock, unix-epoch
microseconds (a kineto event's ``start_ns() / 1000``); durations come
from ``perf_counter``, with the offset to the epoch fixed at ``reset()``.

When neither the tracer nor a profiler is on (the default), ``span()``
returns a shared no-op context manager: a hot loop pays two flag checks
per span and nothing else.

Events use the Chrome trace-event schema directly (``ph: "X"`` complete
events, microsecond timestamps), so the JSONL stream and the Perfetto
export are the same records. ``derive_children`` slices a recorded span
into equal ``"derived": true`` children, for callers whose inner steps run
on the device without a host boundary.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager for the disabled tracer."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _recording_profiler():
    """``torch.autograd.profiler`` while a ``torch.profiler`` records, else
    None. Its ``_is_profiler_enabled`` is a plain module flag; a process
    that never imported torch has no profiler to feed."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return prof
    return None


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_range")

    def __init__(self, tracer: "SpanTracer", name: str, args: Dict,
                 prof=None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._range = None if prof is None else prof.record_function(name)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._finish(self, self._t0, exc_type)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


class SpanTracer:
    """Bounded in-memory recorder of finished spans and instant events."""

    def __init__(self, max_events: int = 200_000):
        self.enabled = False
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Dict] = []
        self._lock = threading.Lock()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()

    # --------------------------------------------------------------- recording

    def _now_us(self) -> int:
        """Unix-epoch microseconds, the profiler's clock, advanced by
        ``perf_counter``."""
        return (time.perf_counter_ns() + self._offset_ns) // 1000

    def span(self, name: str, **args):
        """Context manager recording one complete ("X") span on exit, and
        a profiler range of ``name`` while a ``torch.profiler`` records."""
        prof = _recording_profiler()
        if not self.enabled:
            return _NULL_SPAN if prof is None else prof.record_function(name)
        return _Span(self, name, args, prof)

    def _finish(self, span: _Span, t0: int, exc_type) -> None:
        args = span.args
        if exc_type is not None:
            args = dict(args, error=exc_type.__name__)
        self._record({"name": span.name, "ph": "X", "ts": t0,
                      "dur": max(self._now_us() - t0, 0),
                      "pid": os.getpid(), "tid": threading.get_ident(),
                      "cat": "lightgbm_tpu", "args": args})

    def event(self, name: str, **args) -> None:
        """Instant ("i") event — e.g. a nan_policy trip, a booster init."""
        if not self.enabled:
            return
        self._record({"name": name, "ph": "i", "ts": self._now_us(), "s": "p",
                      "pid": os.getpid(), "tid": threading.get_ident(),
                      "cat": "lightgbm_tpu", "args": args})

    def _record(self, ev: Dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # ------------------------------------------------------- derived children

    def derive_children(self, parent_name: str, child_name: str,
                        counts: List[int]) -> None:
        """Attach ``counts[i]`` derived children to the LAST ``len(counts)``
        not-yet-derived ``parent_name`` spans, in order (telemetry publish:
        wave spans from per-tree leaf counts — the publishing run's
        iteration spans are the most recently recorded, so tail alignment
        pairs each count with its own iteration even when earlier
        direct-loop spans exist). Parents are marked so repeated publishes
        (multiple train() calls per process) never double-derive."""
        if not self.enabled or not counts:
            return
        with self._lock:
            parents = [e for e in self._events
                       if e["name"] == parent_name and e["ph"] == "X"
                       and not e["args"].get(f"{child_name}s_derived")]
        # tail-align both sides: a resumed booster's counts include restored
        # iterations that never recorded a span in this process
        n = min(len(parents), len(counts))
        parents, counts = parents[-n:], list(counts)[-n:]
        for parent, cnt in zip(parents, counts):
            parent["args"][f"{child_name}s_derived"] = True
            if cnt > 0:
                self._slice(parent, child_name, int(cnt),
                            [{child_name: i} for i in range(int(cnt))])

    def _slice(self, parent: Dict, child_name: str, n: int,
               args_list: List[Dict]) -> None:
        dur = parent["dur"] / n
        for i in range(n):
            args = dict(args_list[i], derived=True)
            self._record({"name": child_name, "ph": "X",
                          "ts": int(parent["ts"] + i * dur),
                          "dur": max(int(dur), 1),
                          "pid": parent["pid"], "tid": parent["tid"],
                          "cat": "lightgbm_tpu.derived", "args": args})

    # ----------------------------------------------------------------- export

    def events(self) -> List[Dict]:
        """Copy of every recorded event (chronological by record order)."""
        with self._lock:
            return list(self._events)

    def events_since(self, cursor: int):
        """(new_events, new_cursor) — incremental drain for the JSONL sink."""
        with self._lock:
            return list(self._events[cursor:]), len(self._events)

    def epoch_unix(self) -> float:
        """Wall-clock time of ``ts == 0``: the unix epoch itself, since
        ``ts`` is on the profiler's clock."""
        return 0.0

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
