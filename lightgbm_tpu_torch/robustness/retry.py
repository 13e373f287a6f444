"""Bounded retry with exponential backoff + jitter for host-side comm ops.

A copy of ``lightgbm_tpu/robustness/retry.py`` (the JAX package's module
imports no JAX; ``tests/test_torch_parallel.py`` pins the copy to it).
The key-value exchanges of ``parallel/comm.py`` (``host_allgather``,
``init_distributed``) on the ``torch.distributed`` store make each attempt
through :func:`retry_call`: a transient store hiccup — routine while the
ranks of a world start — re-tries instead of killing the run. Every attempt
is logged (never swallowed), the final failure carries the operation
description, and the backoff schedule is tunable through environment
variables:

- ``LGBM_TPU_COMM_RETRIES``        total attempts (default 3)
- ``LGBM_TPU_COMM_BACKOFF_BASE``   first delay, seconds (default 0.5)
- ``LGBM_TPU_COMM_BACKOFF_MAX``    delay ceiling, seconds (default 30)
- ``LGBM_TPU_COMM_BACKOFF_JITTER`` jitter fraction on top (default 0.25)
- ``LGBM_TPU_COMM_JITTER_SEED``    seed the jitter RNG (unset =
                                   process-global randomness)

The terminal failure names the operation and the cost of trying: the
attempt count and the cumulative backoff wall-clock ride in both the final
warning and the raised ``CommRetryError``. ``CommTimeoutError`` (a peer
never answered; the message names the tag, the sequence number and both
ranks) and its ``PeerLostError`` are what the command line turns into its
comm-loss exit (``cli.py``).
"""
from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional, Tuple, Type

from ..utils.log import Log


class CommRetryError(RuntimeError):
    """All retry attempts of a communication operation failed."""


class CommTimeoutError(CommRetryError):
    """A communication operation timed out waiting on a peer; the message
    names the tag/sequence and both ranks involved."""


class PeerLostError(CommTimeoutError):
    """A specific peer rank is gone — its heartbeat lease expired or it
    never answered inside the collective deadline. ``rank`` names the lost
    peer so fleet restart policy can attribute the failure (exit code 145
    at the top level, vs the generic hang's 142)."""

    def __init__(self, message: str, *, rank: int):
        super().__init__(message)
        self.rank = int(rank)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        Log.warning("%s is not an integer; using default %d", name, default)
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        Log.warning("%s is not a number; using default %g", name, default)
        return default


def comm_attempts() -> int:
    """Total attempts the ``LGBM_TPU_COMM_RETRIES`` knob currently specifies
    — callers splitting a fixed timeout budget across attempts (the
    ``host_allgather`` gets) read it through this."""
    return max(1, _env_int("LGBM_TPU_COMM_RETRIES", 3))


def retry_call(fn: Callable, *, what: str,
               attempts: Optional[int] = None,
               base_delay: Optional[float] = None,
               max_delay: Optional[float] = None,
               jitter: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None):
    """Call ``fn()`` with bounded retries; backoff doubles per attempt.

    ``what`` names the operation in log lines and the terminal error
    (e.g. ``"host_allgather get tag='efb_sample' seq=3 rank=0<-2"``).
    Defaults come from the ``LGBM_TPU_COMM_*`` env knobs, read at call
    time so tests and operators can adjust a live process.
    """
    attempts = attempts if attempts is not None else comm_attempts()
    base = base_delay if base_delay is not None else \
        _env_float("LGBM_TPU_COMM_BACKOFF_BASE", 0.5)
    ceil = max_delay if max_delay is not None else \
        _env_float("LGBM_TPU_COMM_BACKOFF_MAX", 30.0)
    jit = jitter if jitter is not None else \
        _env_float("LGBM_TPU_COMM_BACKOFF_JITTER", 0.25)
    if rng is None:
        # seedable jitter: with LGBM_TPU_COMM_JITTER_SEED set (the chaos
        # harness pins it) every retry_call draws the identical backoff
        # schedule, so a failing chaos run replays bit-for-bit. A
        # malformed seed is WARNED about, never silently ignored — the
        # operator asked for replayability and would not get it
        seed = os.environ.get("LGBM_TPU_COMM_JITTER_SEED")
        rng = random
        if seed:
            try:
                rng = random.Random(int(seed))
            except ValueError:
                Log.warning("LGBM_TPU_COMM_JITTER_SEED=%r is not an "
                            "integer; backoff jitter is UNSEEDED (this "
                            "run will not replay exactly)", seed)
    from ..observability import get_registry
    reg = get_registry()
    last: Optional[BaseException] = None
    total_wait = 0.0
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:                                # noqa: PERF203
            last = e
            if attempt == attempts - 1:
                break
            delay = min(base * (2.0 ** attempt), ceil)
            delay *= 1.0 + jit * rng.random()
            total_wait += delay
            # telemetry: every retry is counted (the JSONL stream carries
            # the counter snapshot; the warning below carries the story)
            reg.counter("comm.retries").inc()
            Log.warning("%s failed (attempt %d/%d: %s: %s) — retrying in "
                        "%.3fs", what, attempt + 1, attempts,
                        type(last).__name__, last, delay)
            sleep(delay)
    reg.counter("comm.failures").inc()
    reg.histogram("comm.retry_wait_seconds").observe(total_wait)
    # the terminal failure must not hide what the retrying COST: the
    # attempt count and cumulative backoff ride in the log and the error
    Log.warning("%s failed permanently: %d attempt(s), %.3fs cumulative "
                "backoff (%s: %s)", what, attempts, total_wait,
                type(last).__name__, last)
    raise CommRetryError(
        f"{what} failed after {attempts} attempt(s) and {total_wait:.3f}s "
        f"of backoff: {type(last).__name__}: {last}") from last
