"""Inference serving on the card: the port of ``lightgbm_tpu/serving``.

- ``ServingEngine`` (engine.py) — load a model (a ``Booster`` or a text
  model file), stack it once, capture the rank-encoded forest walk into one
  CUDA graph per (class, batch-size bucket), and dispatch padded requests
  with no capture after ``warmup()``. Served predictions are bit-identical
  to ``Booster.predict``. Resilience: circuit-breaker degradation to the
  host predictor with a background device probe, ``health()``
  (``ready|degraded|down``), and hot ``reload()`` with bit-identity
  verification and rollback.
- ``MicroBatcher`` (batcher.py) — thread-safe coalescing of concurrent
  small ``predict()`` calls into one dispatch under a max-wait deadline,
  bounded-queue admission control (``ServerOverloadedError``),
  per-request deadlines (``DeadlineExceededError``) and typed shutdown
  (``ServingClosedError``).
- resilience primitives (resilience.py) — the typed error family,
  ``CircuitBreaker`` and the ``DispatchChaos`` fault injector.
- load generators (loadgen.py) — closed-loop and open-loop (Poisson)
  drivers and latency stats.

Every request feeds the process-wide metrics registry
(``lightgbm_tpu_torch.observability``): ``serve.requests`` /
``serve.rows`` counters, queue gauges, ``serve.batch_fill_frac``, the
``serve.latency_ms`` / ``serve.dispatch_ms`` summaries (p50/p99 in
``observability.snapshot()``) and the resilience series.
"""
from .batcher import MicroBatcher                                # noqa: F401
from .engine import ServingEngine, bucket_ladder                 # noqa: F401
from .resilience import (CircuitBreaker, DeadlineExceededError,  # noqa: F401
                         DeviceDispatchError, DispatchChaos, ReloadError,
                         ServerOverloadedError, ServingClosedError,
                         ServingError)
