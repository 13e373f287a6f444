"""Load generators for the serving path (``chip_smoke.py`` phase 14).

A copy of ``lightgbm_tpu/serving/loadgen.py`` (pinned to it by
``tests/test_torch_serving.py``).

Two canonical load shapes (the inference-serving literature's pair):

- **closed loop** — ``concurrency`` workers each issue the next request the
  moment the previous one returns. Measures the engine's capacity frontier:
  rows/s at a fixed concurrency x batch-size shape, with per-request
  latency distributions.
- **open loop** — requests arrive on a seeded Poisson process at
  ``rate_rps`` regardless of completions (the million-user shape: arrival
  rate is set by the users, not by the server). Latency here includes queue
  delay, which is what an SLO actually experiences; a saturated server
  shows unbounded p99 here long before the closed loop does.

Both return plain dicts of latencies + throughput; ``latency_stats``
reduces a latency list to p50/p90/p99/mean/max (nearest-rank, matching the
registry's Summary). Wall-clock comes from ``observability.clock()``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import observability as obs


def latency_stats(lats_ms: List[float]) -> Dict:
    """Nearest-rank latency stats of a per-request latency list (ms) —
    the quantile selection IS ``Summary._quantiles_of`` (one
    implementation: bench p99 and snapshot p99 cannot disagree on
    semantics)."""
    from ..observability.metrics import Summary
    if not lats_ms:
        return {"n": 0, "p50_ms": None, "p90_ms": None, "p99_ms": None,
                "mean_ms": None, "max_ms": None}
    data = sorted(lats_ms)
    n = len(data)
    q = Summary._quantiles_of(data)
    return {"n": n, "p50_ms": round(q["p50"], 3),
            "p90_ms": round(q["p90"], 3), "p99_ms": round(q["p99"], 3),
            "mean_ms": round(sum(data) / n, 3), "max_ms": round(data[-1], 3)}


def _request_slices(X: np.ndarray, batch_rows: int):
    """Rotating request batches over a pool matrix (wraps around)."""
    N = X.shape[0]
    lo = 0
    while True:
        if lo + batch_rows <= N:
            yield X[lo:lo + batch_rows]
            lo = (lo + batch_rows) % N
        else:
            yield X[:batch_rows] if batch_rows <= N else X
            lo = batch_rows % max(N, 1)


def run_closed_loop(predict: Callable, X: np.ndarray, batch_rows: int,
                    concurrency: int, requests_per_worker: int,
                    stop_on_error: bool = True) -> Dict:
    """``concurrency`` workers, back-to-back requests of ``batch_rows``
    rows each; returns latencies + aggregate rows/s.
    ``stop_on_error=False`` records the error and keeps the worker going —
    the chaos-harness mode, where typed per-request errors (sheds,
    deadline misses) are the measurement, not a failure."""
    lats: List[List[float]] = [[] for _ in range(concurrency)]
    errors: List[str] = []
    err_lock = threading.Lock()
    start_gate = threading.Barrier(concurrency + 1)

    def worker(w: int):
        gen = _request_slices(X, batch_rows)
        start_gate.wait()
        for _ in range(requests_per_worker):
            Xr = next(gen)
            t0 = obs.clock()
            try:
                predict(Xr)
            except Exception as e:                            # noqa: BLE001
                with err_lock:
                    errors.append(repr(e))
                if stop_on_error:
                    return
                continue
            lats[w].append((obs.clock() - t0) * 1e3)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    for t in threads:
        t.start()
    start_gate.wait()
    t0 = obs.clock()
    for t in threads:
        t.join()
    wall = obs.clock() - t0
    all_lats = [v for per in lats for v in per]
    # _request_slices caps a request at the pool size: rows/s must count
    # what was actually served, not the requested batch_rows
    eff = min(batch_rows, X.shape[0])
    rows = len(all_lats) * eff
    out = {"mode": "closed", "batch_rows": batch_rows,
           "concurrency": concurrency, "requests": len(all_lats),
           "wall_s": round(wall, 4),
           "rows_per_s": round(rows / wall, 1) if wall > 0 else None,
           "errors": errors, **latency_stats(all_lats)}
    if eff != batch_rows:
        out["batch_rows_effective"] = eff
    return out


def run_open_loop(predict: Callable, X: np.ndarray, batch_rows: int,
                  rate_rps: float, duration_s: float, seed: int = 0,
                  workers: Optional[int] = None,
                  stop_on_error: bool = True) -> Dict:
    """Poisson arrivals at ``rate_rps`` for ``duration_s`` seconds; a
    worker pool large enough to not throttle arrivals issues the requests.
    Latency includes any queue delay (open-loop semantics). The arrival
    schedule is a seeded RNG — reruns replay the same offered load.
    ``stop_on_error=False`` keeps the worker issuing after a per-request
    error (recorded in ``errors``) — the overload-chaos mode, where sheds
    and deadline misses are expected outcomes of the offered load."""
    import time as _time   # sleep only; wall-clock stays observability.clock

    rng = np.random.RandomState(seed)
    n_req = max(1, int(rate_rps * duration_s))
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_req))
    workers = workers or max(4, min(32, int(rate_rps * 0.25) + 4))
    lats: List[float] = []
    lat_lock = threading.Lock()
    errors: List[str] = []
    next_idx = [0]
    idx_lock = threading.Lock()
    t_start = [0.0]
    start_gate = threading.Barrier(workers + 1)

    def worker(w: int):
        gen = _request_slices(X, batch_rows)
        start_gate.wait()
        while True:
            with idx_lock:
                i = next_idx[0]
                if i >= n_req:
                    return
                next_idx[0] += 1
            Xr = next(gen)
            # latency is measured from the SCHEDULED arrival, not from
            # dispatch: when the server falls behind, the arrival->issue
            # backlog is part of what the user waits for — measuring from
            # dispatch is the classic coordinated-omission bug and would
            # pin p99 at ~service time exactly when the server saturates
            t_sched = t_start[0] + arrivals[i]
            delay = t_sched - obs.clock()
            if delay > 0:
                _time.sleep(delay)
            try:
                predict(Xr)
            except Exception as e:                            # noqa: BLE001
                with lat_lock:
                    errors.append(repr(e))
                if stop_on_error:
                    return
                continue
            with lat_lock:
                lats.append((obs.clock() - t_sched) * 1e3)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    for t in threads:
        t.start()
    t_start[0] = obs.clock()
    start_gate.wait()
    for t in threads:
        t.join()
    wall = obs.clock() - t_start[0]
    eff = min(batch_rows, X.shape[0])
    out = {"mode": "open", "batch_rows": batch_rows,
           "offered_rps": round(rate_rps, 1),
           "achieved_rps": round(len(lats) / wall, 1) if wall > 0 else None,
           "requests": len(lats),
           "rows_per_s": round(len(lats) * eff / wall, 1)
           if wall > 0 else None,
           "wall_s": round(wall, 4), "seed": seed,
           "errors": errors, **latency_stats(lats)}
    if eff != batch_rows:
        out["batch_rows_effective"] = eff
    return out
