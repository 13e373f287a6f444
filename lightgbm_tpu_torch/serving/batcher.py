"""MicroBatcher: coalesce concurrent small predict() calls into one dispatch.

A copy of ``lightgbm_tpu/serving/batcher.py`` (its guarantees are pinned
for the port by ``tests/test_torch_serving.py``).

Million-user traffic is many SMALL concurrent requests; dispatching each
alone wastes the device on 1-row walks and pays per-dispatch overhead N
times. The micro-batcher is the classic serving answer (the dynamic
batching of every production inference server): callers enqueue requests
from any thread, ONE worker thread coalesces whatever is queued — up to
``serve_max_batch_rows`` rows, waiting at most ``serve_max_wait_ms`` past
the oldest request's arrival — into a single engine dispatch, then
de-interleaves the result rows back to each caller's Future.

Guarantees (pinned by the ordering fuzz and the resilience cases of
tests/test_torch_serving.py):
- every caller receives exactly its own rows' predictions, bit-identical
  to a direct ``engine.predict`` of the same rows (per-row math is
  independent of what the request was batched with), computed by exactly
  ONE model version (the worker snapshots the engine's model state per
  batch, so a concurrent hot reload never splits a request);
- requests are served FIFO — a request is never passed over by a later
  one (whole requests are taken from the queue head until the row budget
  is hit);
- a worker-side failure is delivered to every affected caller's Future,
  never swallowed.

Resilience (docs/Serving.md "Resilience"):
- **admission control** — the queue is bounded at
  ``serve_max_queue_rows`` rows; a request that would overflow it is
  REFUSED with ``ServerOverloadedError`` before it is ever queued
  (``serve.shed`` counter) — shed load retries elsewhere instead of
  camping on a saturated replica. The live backlog is the
  ``serve.queue_rows`` gauge.
- **deadlines** — each request carries ``serve_deadline_ms`` (or a
  per-call ``deadline_ms`` override; 0 = none). An expired request is
  dropped at DEQUEUE without wasting a dispatch, and a caller's wait is
  bounded by its own deadline even when the dispatch under it hangs —
  both paths raise ``DeadlineExceededError``
  (``serve.deadline_exceeded`` counter, counted once per request).
- **typed shutdown** — ``predict()`` after ``close()`` raises
  ``ServingClosedError`` immediately (it must never enqueue into a dead
  worker and hang the caller), and ``close()`` fails every still-queued
  Future with the same error.

Latency accounting: per-request wall-clock (enqueue -> result ready,
queueing included) feeds the ``serve.latency_ms`` summary; queue depth and
batch fill fraction land in ``serve.queue_depth`` / ``serve.queue_peak``
gauges and the ``serve.batch_fill_frac`` histogram.
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Optional

import numpy as np

from .. import observability as obs
from .resilience import (DeadlineExceededError, ServerOverloadedError,
                         ServingClosedError)


class _Request:
    __slots__ = ("X", "raw_score", "future", "t_enq", "deadline")

    def __init__(self, X, raw_score, t_enq, deadline):
        self.X = X
        self.raw_score = raw_score
        self.future: Future = Future()
        self.t_enq = t_enq
        self.deadline = deadline          # absolute obs.clock() time or None


class MicroBatcher:
    """Thread-safe request queue in front of a ``ServingEngine``."""

    def __init__(self, engine, max_batch_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        self.engine = engine
        cfg = engine.config
        self.max_batch_rows = int(max_batch_rows
                                  if max_batch_rows is not None
                                  else cfg.serve_max_batch_rows)
        self.max_wait_s = (max_wait_ms if max_wait_ms is not None
                           else cfg.serve_max_wait_ms) / 1e3
        # admission bound: rows the queue may hold; 0 = unbounded
        self.max_queue_rows = int(max_queue_rows
                                  if max_queue_rows is not None
                                  else cfg.serve_max_queue_rows)
        self.deadline_ms = float(deadline_ms if deadline_ms is not None
                                 else cfg.serve_deadline_ms)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._rows_queued = 0
        # earliest queued deadline, maintained incrementally so the
        # coalescing wait never rescans the queue (O(Q) per wakeup under
        # a small-request flood is exactly the overload path admission
        # control protects); recomputed only when requests leave the queue
        self._min_deadline: Optional[float] = None
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="lgbm-serve-batcher")
        self._worker.start()

    # -------------------------------------------------------------- client

    def _resolve_deadline(self, deadline_ms, now: float) -> Optional[float]:
        dl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        return (now + dl / 1e3) if dl > 0 else None

    def predict(self, X, raw_score: bool = False,
                deadline_ms: Optional[float] = None) -> np.ndarray:
        """Enqueue one request and block until its rows come back (at most
        until its deadline). Raises ``ServingClosedError`` after
        ``close()``, ``ServerOverloadedError`` when admission would
        overflow ``serve_max_queue_rows`` (the request is NOT queued),
        and ``DeadlineExceededError`` when the deadline passes first."""
        now = obs.clock()
        req = _Request(self.engine._as_matrix(X), raw_score, now,
                       self._resolve_deadline(deadline_ms, now))
        n = req.X.shape[0]
        reg = obs.get_registry()
        with self._cv:
            if self._stop:
                raise ServingClosedError(
                    "predict() on a closed MicroBatcher")
            # admission control: shed rather than queue unboundedly. A
            # request bigger than the whole bound still admits onto an
            # EMPTY queue (the engine chunks it) — otherwise it could
            # never be served at all.
            if self.max_queue_rows > 0 and self._queue \
                    and self._rows_queued + n > self.max_queue_rows:
                reg.counter("serve.shed").inc()
                raise ServerOverloadedError(
                    f"queue full: {self._rows_queued} rows queued "
                    f"(+{n} would exceed serve_max_queue_rows="
                    f"{self.max_queue_rows}) — request shed, not queued")
            self._queue.append(req)
            self._rows_queued += n
            if req.deadline is not None and (
                    self._min_deadline is None
                    or req.deadline < self._min_deadline):
                self._min_deadline = req.deadline
            depth = len(self._queue)
            reg.gauge("serve.queue_depth").set(depth)
            reg.gauge("serve.queue_rows").set(self._rows_queued)
            peak = reg.gauge("serve.queue_peak")
            if peak.value is None or depth > peak.value:
                peak.set(depth)
            self._cv.notify_all()
        try:
            if req.deadline is None:
                out = req.future.result()
            else:
                # the caller's wait is bounded by ITS deadline even when
                # the dispatch under it hangs — a wedged device must not
                # wedge every caller thread with it
                out = req.future.result(
                    timeout=max(req.deadline - obs.clock(), 0.0) + 1e-3)
        except _FutureTimeout:
            # cancel claims the future so the dequeue-side expiry check
            # cannot double-count this request; when the worker won the
            # race instead, the result landed — fall through so it is
            # accounted like any other served request
            if req.future.cancel():
                reg.counter("serve.deadline_exceeded").inc()
                raise DeadlineExceededError(
                    f"request deadline passed after "
                    f"{(obs.clock() - req.t_enq) * 1e3:.1f} ms waiting on "
                    f"the batcher") from None
            out = req.future.result(timeout=0)
        reg.counter("serve.requests").inc()
        reg.summary("serve.latency_ms").observe(
            (obs.clock() - req.t_enq) * 1e3)
        return out

    def close(self) -> None:
        """Stop the worker; every still-queued request's Future fails with
        ``ServingClosedError`` (a queued caller unblocks immediately —
        never hangs on a dead worker). Idempotent."""
        with self._cv:
            self._stop = True
            dropped = list(self._queue)
            self._queue.clear()
            self._rows_queued = 0
            self._min_deadline = None
            reg = obs.get_registry()
            reg.gauge("serve.queue_depth").set(0)
            reg.gauge("serve.queue_rows").set(0)
            self._cv.notify_all()
        for r in dropped:
            if not r.future.done():
                r.future.set_exception(ServingClosedError(
                    "MicroBatcher closed with the request still queued"))
        self._worker.join(timeout=10.0)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- worker

    def _recompute_min_deadline(self) -> None:
        """Under the lock: rebuild the earliest-deadline cache after
        requests left the queue (batch pop or expiry sweep)."""
        self._min_deadline = min(
            (r.deadline for r in self._queue if r.deadline is not None),
            default=None)

    def _fail_expired(self, now: float) -> None:
        """Under the lock: drop every queued request whose deadline has
        passed — it gets ``DeadlineExceededError`` WITHOUT costing a
        dispatch. (Counted here unless the caller's own bounded wait
        already counted it.)"""
        if self._min_deadline is None or now <= self._min_deadline:
            return
        keep, reg = deque(), obs.get_registry()
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                self._rows_queued -= r.X.shape[0]
                try:
                    r.future.set_exception(DeadlineExceededError(
                        f"deadline passed after "
                        f"{(now - r.t_enq) * 1e3:.1f} ms in the queue — "
                        f"request dropped at dequeue, no dispatch spent"))
                    reg.counter("serve.deadline_exceeded").inc()
                except InvalidStateError:
                    pass    # the caller's bounded wait already claimed it
            else:
                keep.append(r)
        self._queue = keep
        self._recompute_min_deadline()
        reg.gauge("serve.queue_rows").set(self._rows_queued)

    def _take_batch(self):
        """Under the lock: wait for work, hold the coalescing window, pop
        whole requests FIFO up to the row budget. Expired requests are
        failed in place, never dispatched. Returns [] on shutdown."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(0.1)
            if not self._queue:
                return []
            deadline = self._queue[0].t_enq + self.max_wait_s
            while self._rows_queued < self.max_batch_rows and not self._stop:
                now = obs.clock()
                # never coalesce past a queued request's own deadline
                wait_until = deadline
                if self._min_deadline is not None \
                        and self._min_deadline < wait_until:
                    wait_until = self._min_deadline
                remaining = wait_until - now
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            self._fail_expired(obs.clock())
            batch, rows = [], 0
            while self._queue:
                n = self._queue[0].X.shape[0]
                if batch and rows + n > self.max_batch_rows:
                    break
                req = self._queue.popleft()
                batch.append(req)
                rows += n
            self._rows_queued -= rows
            self._recompute_min_deadline()
            reg = obs.get_registry()
            reg.gauge("serve.queue_depth").set(len(self._queue))
            reg.gauge("serve.queue_rows").set(self._rows_queued)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            try:
                if len(batch) == 1:
                    Xc = batch[0].X
                else:
                    Xc = np.concatenate([r.X for r in batch], axis=0)
                # ONE model snapshot per batch: a hot reload mid-batch
                # cannot split a request across model versions
                m = self.engine.model_snapshot()
                raw = self.engine._predict_raw_for(m, Xc)     # [K, N_total]
                lo = 0
                for r in batch:
                    n = r.X.shape[0]
                    try:
                        r.future.set_result(self.engine._finish_for(
                            m, raw[:, lo:lo + n].copy(), r.raw_score))
                    except InvalidStateError:
                        pass     # caller abandoned it at its deadline
                    lo += n
            except BaseException as e:                        # noqa: BLE001
                # a dispatch failure belongs to the CALLERS — deliver it to
                # every waiting Future (never swallowed)
                for r in batch:
                    try:
                        r.future.set_exception(e)
                    except InvalidStateError:
                        pass     # caller abandoned it at its deadline
