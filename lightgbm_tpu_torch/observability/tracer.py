"""Host-side span tracer: nested wall-clock spans at dispatch boundaries.

A copy of ``lightgbm_tpu/observability/tracer.py`` (pinned to it by
``tests/test_torch_serving.py``). Spans are recorded only at host
boundaries (``serve.warmup`` and the like): entering and leaving one costs
two ``time.perf_counter()`` calls and one list append, and no device
tensor is touched. Work inside a CUDA graph has no host boundary; its
timing comes from ``torch.profiler`` or CUDA events.

When disabled (the default), ``span()`` returns a shared no-op context
manager: a hot loop pays one attribute check per span and nothing else.

Events use the Chrome trace-event schema directly (``ph: "X"`` complete
events, microsecond timestamps), so the JSONL stream and the Perfetto
export are the same records. ``subdivide_last`` and ``derive_children``
slice a recorded span into equal ``"derived": true`` children, for
callers whose inner steps run on the device without a host boundary.
"""
from __future__ import annotations

import os
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


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._finish(self, self._t0, exc_type)
        return False


class SpanTracer:
    """Bounded in-memory recorder of finished spans and instant events."""

    def __init__(self, max_events: int = 200_000):
        self.enabled = False
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Dict] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()

    # --------------------------------------------------------------- recording

    def _now_us(self) -> int:
        return int((time.perf_counter() - self._epoch) * 1e6)

    def span(self, name: str, **args):
        """Context manager recording one complete ("X") span on exit."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

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

    def subdivide_last(self, parent_name: str, child_name: str, n: int,
                       base_iteration: int = 0) -> None:
        """Slice the most recent ``parent_name`` span into ``n`` equal
        ``child_name`` children (the fused-batch iteration attribution: the
        scan body is one dispatch, so per-iteration timing inside it is an
        even split by construction — marked ``derived``)."""
        if not self.enabled or n <= 0:
            return
        with self._lock:
            parent = next((e for e in reversed(self._events)
                           if e["name"] == parent_name and e["ph"] == "X"),
                          None)
        if parent is None:
            return
        self._slice(parent, child_name, n,
                    [{"iteration": base_iteration + i} for i in range(n)])

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
        """Wall-clock time of ``ts == 0`` (for correlating JSONL streams)."""
        return self._epoch_unix

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._epoch = time.perf_counter()
            self._epoch_unix = time.time()
