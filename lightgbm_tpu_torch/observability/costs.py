"""Cost reports per dispatch site: the port's counterpart of the JAX
package's ``cost_analysis()`` / ``memory_analysis()`` capture
(``lightgbm_tpu/observability/costs.py``).

PyTorch has no compile-time cost model for eager code or CUDA graphs, so a
report here is **analytic from the dispatch's shapes**: computed on the
host once per site and shape class, with no device traffic, under the JAX
package's field names and ``cost.<site>.<field>`` gauges:

- ``flops`` and ``bytes_accessed``: the operations the site does and the
  bytes it must move (each input read once, each output written once),
  from its own formula — B1's in ``ops/cuda_histogram.histogram_pass_cost``
  (the formula ``chip_smoke.py`` computes the kernel's bound from, so the
  bound and the report cannot part), the forest walk's in
  ``ops/predict.py``, the linear fit's in ``ops/linear.py``;
- ``argument_bytes`` / ``output_bytes``: the sizes of the site's input and
  output tensors;
- ``temp_bytes``: the site's scratch (B1's integer accumulators); for the
  captured iteration (``train_step.k<K>``) the bytes the caching allocator
  reserved across the capture of its CUDA graphs (``torch.cuda
  .memory_stats``, a host read with no device sync); None where nothing is
  known (the CPU);
- ``peak_hbm_bytes``: arguments + outputs + temps;
- ``transcendentals`` and ``generated_code_bytes`` have no counterpart and
  stay None, as the JAX package's graceful fallback leaves a field its
  backend does not report.

The JAX package's ``hlo_collectives`` / ``collective_wire_bytes`` scan
XLA's optimized HLO text and have no counterpart here; the collective
bytes of a wave come from ``parallel/comm.collective_bytes`` (the booster
publishes them as ``comm.bytes_per_wave.*`` gauges and a ``comm_cost``
event).

Capture is off by default: enable with ``configure(enabled=True)``, config
``tpu_cost_analysis=true`` (scoped to one ``engine.train`` run) or env
``LGBM_TPU_COST_ANALYSIS=1``. Reports land in the report table
(``reports()``, folded into ``observability.snapshot()``), the registry's
``cost.<site>.*`` gauges, one ``cost_report`` trace event, and the Chrome
trace's ``otherData.cost_reports`` at flush time. A failing report records
its error under the site and never takes training down. ``drift`` is the
JAX package's band check, copied.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional

ENV_COST_ANALYSIS = "LGBM_TPU_COST_ANALYSIS"

# numeric report fields mirrored into the registry as cost.<site>.<field>
_GAUGE_FIELDS = ("flops", "bytes_accessed", "transcendentals",
                 "argument_bytes", "output_bytes", "temp_bytes",
                 "generated_code_bytes", "peak_hbm_bytes")

_lock = threading.Lock()
_state: Dict = {"enabled": None}          # None = consult the env once
_reports: Dict[str, Dict] = {}            # site -> report
_captured: Dict[str, object] = {}         # site -> fingerprint reported


# ------------------------------------------------------------- configuration

def enabled() -> bool:
    if _state["enabled"] is None:
        _state["enabled"] = os.environ.get(ENV_COST_ANALYSIS, "").lower() \
            not in ("", "0", "false", "off")
    return bool(_state["enabled"])


def configure(enabled: Optional[bool] = None) -> None:
    """Force cost capture on/off (explicit calls beat the env knob)."""
    if enabled is not None:
        _state["enabled"] = bool(enabled)


def reset_for_tests() -> None:
    with _lock:
        _state["enabled"] = None
        _reports.clear()
        _captured.clear()


# ------------------------------------------------------------------ reports

def analytic_report(site: str, dims: Optional[Dict] = None, *,
                    flops=None, bytes_accessed=None, argument_bytes=None,
                    output_bytes=None, temp_bytes=None) -> Dict:
    """One report in the JAX package's schema: every field present, None
    where the port knows nothing; ``peak_hbm_bytes`` sums the known
    arguments, outputs and temps."""
    out: Dict = {"site": site}
    if dims:
        out.update(dims)
    out.update({"flops": None if flops is None else float(flops),
                "bytes_accessed": None if bytes_accessed is None
                else float(bytes_accessed),
                "transcendentals": None})
    parts = {"argument_bytes": argument_bytes, "output_bytes": output_bytes,
             "temp_bytes": temp_bytes, "generated_code_bytes": None}
    out.update({k: None if v is None else int(v) for k, v in parts.items()})
    known = [v for v in parts.values() if v is not None]
    out["peak_hbm_bytes"] = int(sum(known)) if known else None
    return out


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (None entries count nothing)."""
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if t is not None))


def publish(report: Dict) -> None:
    """Record a report: the site table (-> ``snapshot()`` / trace
    metadata), ``cost.<site>.*`` gauges, and one instant trace event."""
    site = report["site"]
    with _lock:
        _reports[site] = dict(report)
    from . import event, get_registry
    reg = get_registry()
    for field in _GAUGE_FIELDS:
        v = report.get(field)
        if v is not None:
            reg.gauge(f"cost.{site}.{field}").set(v)
    ev = {k: v for k, v in report.items() if v is not None and k != "site"}
    event("cost_report", site=site, **ev)


def capture(site: str, make_report: Callable[[], Dict],
            fingerprint=None, force: bool = False) -> Optional[Dict]:
    """The report of ``site`` from ``make_report()`` — computed once per
    (site, fingerprint): an unchanged pair returns the recorded report
    without calling ``make_report``, a new fingerprint (another shape
    class at the site) replaces it. Gated on :func:`enabled` unless
    ``force`` (an explicit call is intent, as the JAX package's
    ``histogram_cost_report``). Never raises into the caller: a failure is
    recorded as the site's report, with its ``error``."""
    if not (force or enabled()):
        return None
    with _lock:
        if site in _captured and _captured[site] == fingerprint \
                and site in _reports:
            return dict(_reports[site])
        _captured[site] = fingerprint
    try:
        report = make_report()
    except Exception as e:                                   # noqa: BLE001
        report = dict(site=site, error=f"{type(e).__name__}: {e}"[:300])
    try:
        publish(report)
    except Exception as e:                                   # noqa: BLE001
        from ..utils.log import Log
        Log.debug("cost report publish failed for %s: %s: %s",
                  site, type(e).__name__, e)
    return report


# ------------------------------------------------------------------ access

def reports() -> Dict[str, Dict]:
    """Copy of every recorded report, keyed by site (sorted)."""
    with _lock:
        return {k: dict(v) for k, v in sorted(_reports.items())}


def report(site: str) -> Optional[Dict]:
    with _lock:
        r = _reports.get(site)
        return dict(r) if r else None


# ------------------------------------------------------------- golden pins

def drift(report: Dict, golden: Dict, fields=("flops", "bytes_accessed"),
          rel_tol: float = 0.35) -> Dict[str, Dict]:
    """Compare a report against golden values; returns the out-of-band
    fields as ``{field: {value, golden, ratio}}`` (empty = within band).

    The band is relative (default +/-35%). A ``None`` value against a
    numeric golden IS drift — losing the measurement entirely must not
    pass the pin."""
    tol = float(golden.get("rel_tol", rel_tol))
    out = {}
    for f in fields:
        g = golden.get(f)
        if g is None:
            continue
        v = report.get(f)
        if v is None:
            out[f] = {"value": None, "golden": g, "ratio": None}
            continue
        ratio = float(v) / float(g) if g else float("inf")
        if not (1.0 - tol) <= ratio <= (1.0 + tol):
            out[f] = {"value": float(v), "golden": float(g),
                      "ratio": round(ratio, 4)}
    return out
