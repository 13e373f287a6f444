"""Run cells of the benchmark several times, each run in a process of its
own, and summarise the spread of each metric.

    python3 benchmark/calibrate.py --cell higgs.train --seeds 11,12,13 \\
        --seconds 30 [--trace 1] [--control 1] [--out DIR]

Each run's result line, exit code, wall time and the end of its standard
error go to ``<out>/runs.jsonl``. The summary gives, per cell and metric,
the median and the spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) over the median.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def run_one(cell, seed, seconds, trace, control, timeout):
    cmd = [sys.executable, os.path.join("benchmark", "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    if control:
        cmd += ["--control", "1"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.strip().splitlines() if ln.strip()]
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
            "control": control, "rc": rc, "wall_s": wall, "result": result,
            "stderr_tail": err[-3000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", default=os.path.join(".benchmark_cache",
                                                 "calibration"))
    args = ap.parse_args(argv)
    out_dir = os.path.join(ROOT, args.out)
    os.makedirs(out_dir, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    records = []
    for cell in args.cell:
        for seed in seeds:
            rec = run_one(cell, seed, args.seconds, args.trace,
                          args.control, args.timeout)
            records.append(rec)
            with open(os.path.join(out_dir, "runs.jsonl"), "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            res = rec["result"] or {}
            print(json.dumps({"cell": cell, "seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 2),
                              "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()},
                              "checks": {k: v["value"] for k, v in
                                         res.get("checks", {}).items()},
                              "control": res.get("control"),
                              "detail": res.get("detail"),
                              "peak": res.get("device", {}).get(
                                  "memory_peak_bytes")}), flush=True)
            if rec["rc"] != 0:
                print(rec["stderr_tail"][-1500:], flush=True)
    for cell in args.cell:
        rs = [r["result"] for r in records
              if r["cell"] == cell and r["result"]]
        names = sorted({k for r in rs for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in rs
                    if name in r["metrics"]]
            print(f"summary {cell} {name}: n={len(vals)} median="
                  f"{statistics.median(vals)!r} spread={spread(vals)!r} "
                  f"values={vals!r}", flush=True)


if __name__ == "__main__":
    main()
