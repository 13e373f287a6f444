"""One run of one cell, from the command line to the result line.

``run_cell`` loads the cell by name, hands its job to the traffic mix's
driver, reads the metrics, holds the numbers the reference compared
against the cell's limits, and returns the result object. ``main`` is the
command: it refuses a run without the card or with a JAX module loaded,
and prints the compared numbers as the last lines of standard error and
the result as the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from . import env, manifest


@dataclass
class Job:
    """What a driver needs for one run."""
    cell: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False
    param_overrides: Dict = field(default_factory=dict)
    data_overrides: Dict = field(default_factory=dict)
    bench_dir: str = env.BENCH_DIR


def _e2e(record: Dict, entries) -> Dict:
    out = {}
    for m in entries:
        v = record.get(m["name"])
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _per_layer(record: Dict, entries, ctx: Dict, bench_dir: str) -> Dict:
    out = {}
    for m in entries:
        reader = manifest.metric_reader(m["name"], bench_dir)
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def checks(record: Dict, limits: Dict) -> Dict:
    """Every compared number beside its limit; a number with no limit is
    a fault of the cell's files."""
    out = {}
    for name, value in record["numbers"].items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        out[name] = {"value": value, "limit": limits[name]}
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False,
             root: str = env.ROOT, overrides: Optional[Dict] = None) -> Dict:
    """The result object of one run (``device`` a ``torch.device``; the
    command passes the card, tests may pass the CPU)."""
    bench_dir = f"{root}/benchmark"
    man = manifest.load_manifest(root)
    cell = manifest.cell(man, cell_name)
    cfg = manifest.config(cell["config"], bench_dir)
    mix = manifest.traffic(cell["traffic"], bench_dir)
    limits = manifest.limits(cell_name, bench_dir)["limits"]
    overrides = overrides or {}
    job = Job(cell_name, cfg, mix, seed, seconds, trace, device, t_start,
              control, overrides.get("params", {}),
              overrides.get("data", {}), bench_dir)
    record = manifest.driver(mix["driver"], bench_dir).run(job)
    ctx = {"record": record, "config": cfg, "traffic": mix, "cell": cell}
    if trace:
        metrics = _per_layer(record, manifest.metrics_of(
            man, cell_name, "per_layer"), ctx, bench_dir)
    else:
        metrics = _e2e(record, manifest.metrics_of(man, cell_name,
                                                   "end_to_end"))
    compared = checks(record, limits)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": int(record["attempted"]),
        "failed": int(record["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda"
                   else device.type,
                   "kind": _device_name(device), "count": int(cell["chips"]),
                   "memory_peak_bytes": int(record["memory_peak_bytes"])},
    }
    prof = record.get("profile")
    if trace and prof is not None:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    # what the check looked at, so that a reading can be traced to its
    # tree, node or call
    result["detail"] = {
        "checked": record.get("checked_trees", record.get("checked_calls")),
        "judge_detail": record.get("judge_detail"),
        "valid": record.get("valid"), "check_s": record.get("check_s")}
    if control:
        result["control"] = record.get("control")
        result["calibration"] = {
            "end_to_end": {m["name"]: record.get(m["name"]) for m in
                           manifest.metrics_of(man, cell_name,
                                               "end_to_end")},
            "window_s": record.get("window_s")}
    result["checks"] = compared
    return result


def _device_name(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch
    return torch.cuda.get_device_name(device)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control and the planted faults "
                         "(calibration of the limits; not a measured run)")
    args = ap.parse_args(argv)
    try:
        man = manifest.load_manifest()
        cell = manifest.cell(man, args.workload)
        env.use_checkout_package()
        env.require_devices(int(cell["chips"]))
    except (env.RunRefused, OSError, KeyError, ValueError) as e:
        print(f"benchmark: refused: {e}", file=sys.stderr)
        return 3
    import torch
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start,
                      control=bool(args.control))
    loaded = env.forbidden_modules()
    if loaded:
        print("benchmark: refused: JAX or the JAX package was loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
