"""Serving resilience primitives: typed errors, circuit breaker, chaos.

A copy of ``lightgbm_tpu/serving/resilience.py`` (pinned to it by
``tests/test_torch_serving.py``).

Serving a heavy-traffic inference path is judged on tail behavior under
overload, not peak throughput: an unbounded queue turns a burst into an
OOM, a caller with no deadline turns a hung dispatch into a wedged
thread pool, and a bad model swap with no rollback turns a deploy into
an outage. This module holds the pieces the engine and micro-batcher
compose into the detect -> degrade -> recover loop (docs/Serving.md
"Resilience"; the serving twin of the training-side self-healing in
docs/Fault-Tolerance.md):

- **Typed errors** — ``ServerOverloadedError`` (load shed at admission),
  ``DeadlineExceededError`` (per-request deadline missed),
  ``ServingClosedError`` (request against a closed batcher/engine),
  ``ReloadError`` (hot reload failed verification and rolled back),
  ``DeviceDispatchError`` (the device walk itself raised). All subclass
  ``ServingError(RuntimeError)`` so a load balancer's handler can treat
  "serving said no" uniformly while retry policy keys on the subclass:
  sheds are retryable-elsewhere, deadline misses are not.
- **CircuitBreaker** — counts device-dispatch failures in a sliding
  window; ``serve_breaker_failures`` failures inside
  ``serve_breaker_window_s`` trip it open (the engine then serves via
  the host predictor — degraded, never down) until a background probe
  re-warms the device path and resets it.
- **DispatchChaos** — deterministic fault injection for the dispatch
  path (one-shot exception bursts, slow-dispatch hangs, per-dispatch
  slowdowns), driven by the resilience tests. A hook, not a
  monkeypatch: the engine calls it at the top of every device dispatch
  when installed, so injected faults travel the exact production error
  path.

Everything here is host Python and lock-cheap: the breaker takes one lock
per *failure* (successes touch a plain bool), and the error types cost
nothing until raised.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from .. import observability as obs


# ------------------------------------------------------------- typed errors

class ServingError(RuntimeError):
    """Base of every typed serving-resilience error (docs/Serving.md)."""


class ServerOverloadedError(ServingError):
    """Admission refused: the micro-batcher queue is at
    ``serve_max_queue_rows``. The request was NEVER queued — shed load
    retries on another replica, it does not camp on this one."""


class DeadlineExceededError(ServingError):
    """The request's deadline (``serve_deadline_ms`` or the per-call
    override) passed before a result was produced. Raised at dequeue
    (expired requests never waste a dispatch) and to a caller whose
    wait outlived its deadline."""


class ServingClosedError(ServingError):
    """``predict()`` against a closed ``MicroBatcher``/``ServingEngine``.
    Raised immediately at admission — a request must never enqueue into
    a dead worker and hang its caller."""


class ReloadError(ServingError):
    """Hot model reload failed (feature-shape mismatch, warmup failure,
    or bit-identity verification mismatch) and was ROLLED BACK — the old
    model is still serving when this reaches the caller."""


class DeviceDispatchError(ServingError):
    """The device forest walk raised. Internal signal: the engine
    records it on the circuit breaker and serves the request via the
    host predictor instead — callers only ever see it from a
    verification path that forbids fallback."""


# ---------------------------------------------------------- circuit breaker

class CircuitBreaker:
    """Sliding-window failure counter gating the device dispatch path.

    States (``state`` property): ``closed`` (device path live) and
    ``open`` (tripped — the engine serves degraded via the host
    predictor while a probe re-warms the device). ``failures``
    consecutive-or-not device failures inside ``window_s`` seconds trip
    it; ``reset()`` (the probe's success) closes it again.
    ``failures <= 0`` disables the breaker entirely — ``record_failure``
    never trips and ``is_open`` stays False.

    Thread-safe: dispatch workers, the micro-batcher worker, and the
    probe thread all touch it. The hot path (``is_open`` on every
    request) is a plain attribute read."""

    def __init__(self, failures: int = 5, window_s: float = 30.0,
                 clock=None):
        self.failures = int(failures)
        self.window_s = float(window_s)
        self._clock = clock or obs.clock
        self._lock = threading.Lock()
        self._fail_times: List[float] = []
        self._open = False
        self.trips = 0

    @property
    def is_open(self) -> bool:
        return self._open

    @property
    def state(self) -> str:
        return "open" if self._open else "closed"

    def record_failure(self, err: Optional[BaseException] = None) -> bool:
        """Record one device-dispatch failure; returns True iff THIS
        failure tripped the breaker open (the caller starts the probe
        exactly once per trip)."""
        if self.failures <= 0:
            return False
        now = self._clock()
        with self._lock:
            self._fail_times.append(now)
            lo = now - self.window_s
            self._fail_times = [t for t in self._fail_times if t >= lo]
            if not self._open and len(self._fail_times) >= self.failures:
                self._open = True
                self.trips += 1
                obs.inc("serve.breaker_trips")
                return True
        return False

    def record_success(self) -> None:
        """A device dispatch completed — age the window out lazily (only
        when there is something to forget; the steady state costs one
        bool read)."""
        if not self._fail_times:
            return
        lo = self._clock() - self.window_s
        with self._lock:
            self._fail_times = [t for t in self._fail_times if t >= lo]

    def reset(self) -> None:
        """Close the breaker (the probe's device dispatch succeeded)."""
        with self._lock:
            self._fail_times = []
            if self._open:
                self._open = False
                obs.inc("serve.breaker_recoveries")


# ----------------------------------------------------------- fault injection

class ChaosDispatchError(RuntimeError):
    """The injected dispatch failure (NOT a ServingError on purpose: it
    stands in for whatever the runtime would really raise — a CUDA
    error, a lost device — and must travel the generic handler)."""


class DispatchChaos:
    """Deterministic dispatch-path fault injector
    (tests/test_torch_serving.py, ``chip_smoke.py``).

    Installed as ``engine.chaos = DispatchChaos()``; the engine invokes
    it at the top of every device dispatch (requests, probes, and
    reload verification alike — injected faults see the same path real
    ones do). Modes compose:

    - ``arm_failures(n)``    — the next ``n`` dispatches raise
      ``ChaosDispatchError``;
    - ``arm_hang(seconds, n=1)`` — the next ``n`` dispatches sleep
      ``seconds`` first (the slow-dispatch / wedged-device shape that
      deadlines exist for);
    - ``slowdown_s`` attribute — EVERY dispatch sleeps this long (an
      artificial capacity cap so an open-loop bench can drive a CPU
      harness into genuine overload).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._fail_next = 0
        self._hang_next = 0
        self._hang_s = 0.0
        self.slowdown_s = 0.0
        self.dispatches = 0
        self.injected_failures = 0
        self.injected_hangs = 0

    def arm_failures(self, n: int) -> None:
        with self._lock:
            self._fail_next = int(n)

    def arm_hang(self, seconds: float, n: int = 1) -> None:
        with self._lock:
            self._hang_s = float(seconds)
            self._hang_next = int(n)

    def __call__(self) -> None:
        with self._lock:
            self.dispatches += 1
            hang = 0.0
            if self._hang_next > 0:
                self._hang_next -= 1
                self.injected_hangs += 1
                hang = self._hang_s
            fail = False
            if self._fail_next > 0:
                self._fail_next -= 1
                self.injected_failures += 1
                fail = True
        delay = hang + self.slowdown_s
        if delay > 0:
            time.sleep(delay)
        if fail:
            raise ChaosDispatchError("injected dispatch failure "
                                     f"#{self.injected_failures}")
