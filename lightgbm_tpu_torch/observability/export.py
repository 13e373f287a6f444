"""Telemetry exporters: JSONL event stream + Chrome trace-event JSON.

A copy of ``lightgbm_tpu/observability/export.py`` (pinned to it by
``tests/test_torch_observability.py``); the trace's producer is
``lightgbm_tpu_torch``. Two products per process under the telemetry
directory (``LGBM_TPU_TELEMETRY_DIR`` / config ``telemetry_dir``):

- ``events_<pid>.jsonl`` — append-only stream of span/instant events plus
  registry snapshots (``{"type": "counters", ...}``), one JSON object per
  line, for log shippers and the tests' assertions.
- ``trace_<pid>.json``   — Chrome trace-event JSON (``{"traceEvents":
  [...]}``) loadable in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``; rewritten atomically on every flush, so a reader
  never sees a torn file.

Writes happen only at flush sites (the end of ``engine.train``, the CLI's
exit), never inside the training loop.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

PRODUCER = "lightgbm_tpu_torch"


def atomic_write_json(path: str, doc, *, indent=None,
                      sort_keys: bool = False,
                      trailing_newline: bool = False, default=None) -> str:
    """The one tmp + ``os.replace`` atomic JSON write (pid-suffixed temp, so
    two writers in one directory never clobber each other's in-flight
    file): a crash mid-write never leaves a truncated file behind. Used by
    the trace and snapshot exporters, the perf ledger, the JSON model
    writer and the hang watchdog's dump (``default`` as ``json.dump``'s)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=indent, sort_keys=sort_keys,
                  default=default)
        if trailing_newline:
            fh.write("\n")
    os.replace(tmp, path)
    return path


def write_chrome_trace(events: List[Dict], path: str,
                       metadata: Dict = None) -> str:
    """Write ``events`` (already in trace-event schema, tracer.py) as a
    Perfetto-loadable JSON object, atomically."""
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": dict(metadata or {}, producer=PRODUCER),
    }
    return atomic_write_json(path, doc)


def trace_file_name(prefix: str) -> str:
    """``<prefix>_<pid>.json``, with the rank in a world of more than one
    process (``_r<rank>``), so that the ranks' files never collide."""
    name = f"{prefix}_{os.getpid()}"
    import sys
    dist = getattr(sys.modules.get("torch"), "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        name += f"_r{dist.get_rank()}"
    return name + ".json"


class JsonlWriter:
    """Append-only JSONL sink; one record per line, flushed per batch."""

    def __init__(self, path: str):
        self.path = path

    def append(self, records: List[Dict]) -> None:
        if not records:
            return
        with open(self.path, "a") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")


def read_jsonl(path: str) -> List[Dict]:
    """Parse a JSONL stream, skipping torn lines (a reader racing the
    writer must not crash on the in-flight record)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
