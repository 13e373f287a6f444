"""ServingEngine: bucket-padded forest inference, one CUDA graph per bucket.

The port of ``lightgbm_tpu/serving/engine.py``. A model (a ``Booster`` or a
text model file) is stacked once into the rank-encoded ``StackedForest``
arrays (``ops/predict.py``) and placed on the device once. Every request is
padded up to the smallest bucket of a fixed batch-size ladder that holds
it, so traffic meets a finite set of shapes. On the card ``warmup()``
captures the forest walk (``forest_walk_leaves``: ``max_depth`` fixed
steps, no host read) into one ``torch.cuda.CUDAGraph`` per (class,
bucket), all of a model's graphs in one private memory pool, with fixed
device buffers for the bucket's input and output and pinned host staging
for both directions. Where the JAX package compiles one XLA executable
per bucket (engine.py:124, :244-271), the port captures one graph.

One dispatch copies the padded request into the pinned staging buffer,
makes one host-to-device copy, replays the graph, makes one device-to-host
copy of the leaf indices and waits once for the model's stream: the one
host read per dispatch (the result) that the JAX engine's contract allows
(engine.py:306-309). On the CPU (``device=cpu``, the tests) the same
dispatch runs the eager walk.

Numerics contract: traversal is integer-exact on the device (rank
compares); leaf values are added on the HOST in f64, in tree order, so
served predictions are bit-identical to ``Booster.predict``'s host route
(``force_host_predict=True``). A linear-leaf forest goes through
``Tree.leaf_outputs`` per tree, as the JAX engine does.

Resilience: the model lives in an immutable ``_ModelState`` read once per
request, so a hot ``reload()`` — stack and capture the candidate off to
the side, verify it bit-identical to its own booster on a held sample,
swap atomically, roll back on any failure — never mixes versions inside a
request. Device-dispatch failures land on a ``CircuitBreaker``: after
``serve_breaker_failures`` failures in ``serve_breaker_window_s`` the
engine degrades to the host predictor (correct answers, host throughput,
``serve.host_fallback`` counted, said at warning level) while a daemon
probe retries the device path; ``health()`` reports
``ready|degraded|down``.

Threads and fixed buffers: the batcher's worker, the breaker's probe and
``reload()``'s verification all dispatch, and a graph replays fixed
addresses. Each model state's ``lock`` serialises the staging write,
copy-in, replay, copy-out and read of every graph of that model (they
share one memory pool and one stream, so they never run concurrently).
``reload()`` captures the candidate's graphs on the candidate's own stream
with ``capture_error_mode="thread_local"`` while the live model goes on
serving on its stream: the live dispatch allocates nothing, and the
thread-local mode lets its copies and its wait run during the capture.

Categorical forests cannot take the rank-encoded walk and serve through
the host predictor (said once, as the JAX package does).

Observability: ``serve.requests`` / ``serve.rows`` counters, the
``serve.batch_fill_frac`` histogram, ``serve.latency_ms`` /
``serve.dispatch_ms`` quantile summaries (p50/p99 in
``observability.snapshot()``), ``serve.bucket_captures`` and
``serve.bucket.<B>``, and the resilience series:
``serve.host_fallback`` / ``serve.breaker_trips`` /
``serve.breaker_recoveries`` / ``serve.reloads`` /
``serve.reload_rollbacks`` counters and the ``serve.health`` /
``serve.model_version`` gauges.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import observability as obs
from ..config import Config, resolve_device
from ..ops import predict as _predict
from ..robustness import allowed_host_sync
from ..utils.log import Log
from .resilience import (CircuitBreaker, DeadlineExceededError,
                         DeviceDispatchError, ReloadError, ServingClosedError)

_HEALTH_CODE = {"ready": 0, "degraded": 1, "down": 2}


def bucket_ladder(config) -> List[int]:
    """Resolve the batch-size bucket ladder from config.

    ``serve_buckets`` (comma list, strictly ascending) wins; empty = the
    powers-of-two ladder 1, 2, 4, ... up to ``serve_max_batch_rows`` —
    dense enough that padding never exceeds 2x (the batch_fill_frac floor
    is 0.5)."""
    if config.serve_buckets:
        return [int(v) for v in str(config.serve_buckets).split(",") if v]
    out, b = [], 1
    while b < config.serve_max_batch_rows:
        out.append(b)
        b *= 2
    out.append(int(config.serve_max_batch_rows))
    return out


class _BucketGraph:
    """The walk of one (class, bucket ``B``) captured into a CUDA graph,
    with the fixed buffers it reads and writes. The input is one pinned
    host buffer and one device buffer of ``6 * B * F`` bytes, viewed as
    rank codes ``[B, F]`` int32 and the NaN and zero masks ``[B, F]``
    bool, so a dispatch makes one copy each way."""

    __slots__ = ("rows", "h_in", "d_in", "h_codes", "h_nan", "h_zero",
                 "d_out", "h_out", "graph")

    def __init__(self, B: int, F: int, T: int, device):
        self.rows = B
        nb = B * F
        self.h_in = torch.zeros(6 * nb, dtype=torch.uint8, pin_memory=True)
        self.d_in = torch.zeros(6 * nb, dtype=torch.uint8, device=device)
        self.h_codes, self.h_nan, self.h_zero = (
            t.numpy() for t in _input_views(self.h_in, B, F))
        self.d_out = torch.zeros((B, T), dtype=torch.int32, device=device)
        self.h_out = torch.zeros((B, T), dtype=torch.int32, pin_memory=True)
        self.graph = None

    def inputs(self):
        """The device views the graph reads: (codes, is_nan, is_zero)."""
        return _input_views(self.d_in, self.rows,
                            self.h_codes.shape[1])


def _input_views(buf: torch.Tensor, B: int, F: int):
    nb = B * F
    return (buf[:4 * nb].view(torch.int32).view(B, F),
            buf[4 * nb:5 * nb].view(torch.bool).view(B, F),
            buf[5 * nb:].view(torch.bool).view(B, F))


class _ModelState:
    """One immutable serving model: booster, stacked forests, their device
    tensors, and the walks prepared per (class, bucket). Requests snapshot
    the engine's current state ONCE and use only it, so an atomic swap
    (``reload``) can never mix two model versions inside one request.

    ``lock`` serialises every dispatch of this model (the graphs share
    their buffers' pool and ``stream``); ``captures`` counts the walks
    prepared (CUDA graphs captured on the card; on the CPU, buckets
    recorded) and ``capture_s`` the seconds each (class, bucket) took."""

    __slots__ = ("booster", "config", "trees", "num_class_models",
                 "num_iteration", "num_features", "forests",
                 "has_categorical", "device", "dev", "walk", "version",
                 "warmed", "graphs", "captures", "capture_s", "pool",
                 "stream", "lock")

    def __init__(self, booster, num_iteration: Optional[int], version: int,
                 device):
        self.booster = booster
        self.config = booster.config
        K = max(booster.num_model_per_iteration, 1)
        self.num_class_models = K
        if num_iteration is None or num_iteration <= 0:
            num_iteration = booster.best_iteration \
                if booster.best_iteration > 0 else len(booster.trees) // K
        self.num_iteration = num_iteration
        self.trees = booster.trees[: num_iteration * K]
        self.num_features = booster.num_total_features
        self.forests = [_predict.StackedForest(self.trees[k::K],
                                              self.num_features)
                        for k in range(K)]
        self.has_categorical = any(f.has_categorical for f in self.forests)
        self.device = device
        # the stacked arrays go to the device once here, and every dispatch
        # reads them; the walk is bound now, so a later rebinding of the
        # module's name reaches only states built after it
        self.dev = [] if self.has_categorical else \
            [f.to(device) for f in self.forests]
        self.walk = None if self.has_categorical else \
            _predict.forest_walk_leaves
        self.version = version
        self.warmed = False
        self.graphs: Dict = {}
        self.captures = 0
        self.capture_s: Dict = {}
        self.lock = threading.Lock()
        on_card = device.type == "cuda" and not self.has_categorical
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self.stream = torch.cuda.Stream(device) if on_card else None

    @allowed_host_sync("warm-up: a bucket's eager walk completes before "
                       "its capture")
    def prepare(self, k: int, B: int) -> None:
        """Prepare the walk of class ``k`` at bucket ``B``: on the card,
        one eager walk on the bucket's buffers (it loads every kernel the
        capture records) and the capture into a CUDA graph; on the CPU,
        where the walk runs eagerly, nothing but the record."""
        f = self.forests[k]
        t0 = obs.clock()
        if self.stream is None:
            self.graphs[(k, B)] = None
        else:
            bg = _BucketGraph(B, self.num_features, f.num_trees, self.device)
            codes, is_nan, is_zero = bg.inputs()
            with torch.cuda.stream(self.stream):
                bg.d_out.copy_(self.walk(*self.dev[k], codes, is_nan,
                                         is_zero, f.max_depth))
            self.stream.synchronize()
            g = torch.cuda.CUDAGraph()
            # thread-local error mode: a live model's dispatch on another
            # thread (its copies, its stream wait) may run during a reload's
            # capture
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                bg.d_out.copy_(self.walk(*self.dev[k], codes, is_nan,
                                         is_zero, f.max_depth))
            bg.graph = g
            self.graphs[(k, B)] = bg
        self.captures += 1
        self.capture_s[(k, B)] = obs.clock() - t0
        obs.inc("serve.bucket_captures")

    @allowed_host_sync("the dispatch's one result wait")
    def walk_bucket(self, k: int, B: int, codes: np.ndarray,
                    is_nan: np.ndarray, is_zero: np.ndarray) -> np.ndarray:
        """Leaf indices ``[n, T]`` int32 of ``n <= B`` encoded rows. Under
        ``lock``: on the card the staging write (padded to ``B`` with zero
        rows), one copy in, the replay, one copy out and the one wait; on
        the CPU the eager walk of the ``n`` rows."""
        n = codes.shape[0]
        with self.lock:
            if (k, B) not in self.graphs:
                self.prepare(k, B)
            if self.stream is None:
                return self.walk(
                    *self.dev[k], torch.from_numpy(codes),
                    torch.from_numpy(is_nan), torch.from_numpy(is_zero),
                    self.forests[k].max_depth).numpy()
            bg = self.graphs[(k, B)]
            bg.h_codes[:n] = codes
            bg.h_codes[n:] = 0
            bg.h_nan[:n] = is_nan
            bg.h_nan[n:] = False
            bg.h_zero[:n] = is_zero
            bg.h_zero[n:] = False
            with torch.cuda.stream(self.stream):
                bg.d_in.copy_(bg.h_in, non_blocking=True)
                bg.graph.replay()
                bg.h_out.copy_(bg.d_out, non_blocking=True)
            self.stream.synchronize()
            return bg.h_out.numpy()[:n].copy()


class ServingEngine:
    """Load-once, capture-ahead, replay-forever forest inference."""

    def __init__(self, model, params: Optional[Dict] = None,
                 num_iteration: Optional[int] = None, warmup: bool = True):
        booster = self._load_booster(model, params)
        self.config = booster.config
        self.device = resolve_device(self.config)
        self.buckets = sorted(bucket_ladder(self.config))
        self.max_bucket = self.buckets[-1]
        self._model = _ModelState(booster, num_iteration, 1, self.device)
        self._reload_lock = threading.Lock()
        self._closed = False
        # fault-injection hook (serving/resilience.py DispatchChaos):
        # invoked at the top of every device dispatch when installed
        self.chaos = None
        self._breaker = CircuitBreaker(
            failures=self.config.serve_breaker_failures,
            window_s=self.config.serve_breaker_window_s)
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_lock = threading.Lock()   # owns _probe_running
        self._probe_running = False
        reg = obs.get_registry()
        reg.gauge("serve.buckets").set(len(self.buckets))
        reg.gauge("serve.max_batch_rows").set(self.max_bucket)
        reg.gauge("serve.num_trees").set(len(self._model.trees))
        reg.gauge("serve.model_version").set(self._model.version)
        reg.gauge("serve.health").set(_HEALTH_CODE["ready"])
        if warmup:
            self.warmup()

    @staticmethod
    def _load_booster(model, params: Optional[Dict]):
        """A ``Booster`` (``params`` merged into its config) or a model
        file: text, proto or JSON, through the one format dispatcher
        ``io/model_text.load_model_file`` (the JAX engine's,
        ``lightgbm_tpu/serving/engine.py:179-182``)."""
        from ..basic import Booster
        if isinstance(model, Booster):
            booster = model
            if params:
                booster.config = Config.from_params(
                    dict(booster.params, **params))
        else:
            # serve_* knobs ride in as Booster params; the loader merges
            # the file's header (objective, sigmoid, num_class) on top
            booster = Booster(params=dict(params or {}))
            from ..io.model_text import load_model_file
            load_model_file(booster, str(model))
        booster._ensure_finalized()
        return booster

    # -------------------------------------------------- model-state access

    def model_snapshot(self) -> _ModelState:
        """The current model state, read once — callers that span several
        internal calls (the micro-batcher worker, verification) hold the
        SAME snapshot across all of them so a concurrent ``reload`` can
        never mix versions inside one request."""
        return self._model

    @property
    def booster(self):
        return self._model.booster

    @property
    def num_class_models(self) -> int:
        return self._model.num_class_models

    @property
    def num_iteration(self) -> int:
        return self._model.num_iteration

    @property
    def num_features(self) -> int:
        return self._model.num_features

    @property
    def has_categorical(self) -> bool:
        return self._model.has_categorical

    @property
    def model_version(self) -> int:
        return self._model.version

    @property
    def _trees(self):
        return self._model.trees

    @property
    def _forests(self):
        return self._model.forests

    # ------------------------------------------------------------- capture

    def captures(self) -> int:
        """Walks the CURRENT model prepared: one CUDA graph per (class,
        bucket) on the card (the bucket recorded on the CPU). It stays at
        ``warmup()``'s count whatever the request sizes: the serving
        counterpart of the JAX engine's zero-recompile contract."""
        return self._model.captures

    def warmup(self) -> int:
        """Prepare the walk for every (class, bucket) so the first real
        request — and every one after — replays a captured graph. Returns
        the number prepared."""
        return self._warm_state(self._model)

    def _warm_state(self, m: _ModelState) -> int:
        if m.walk is None or m.warmed:
            return 0
        n = 0
        with obs.span("serve.warmup", buckets=len(self.buckets),
                      model_version=m.version):
            with m.lock:
                for k in range(m.num_class_models):
                    for B in self.buckets:
                        if (k, B) not in m.graphs:
                            m.prepare(k, B)
                            n += 1
        m.warmed = True
        return n

    # ------------------------------------------------------------ dispatch

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket holding ``n`` rows (requests beyond the
        top bucket are chunked by the caller)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_bucket

    def _dispatch(self, m: _ModelState, k: int, codes: np.ndarray,
                  is_nan: np.ndarray, is_zero: np.ndarray,
                  record: bool = True) -> np.ndarray:
        """One device dispatch of <= max_bucket rows for class ``k``,
        padded to the bucket: returns leaf indices [n, T]. A failure of
        the walk itself surfaces as ``DeviceDispatchError`` after landing
        on the circuit breaker (``record=False`` — probe / reload
        verification — keeps injected or candidate failures off the live
        breaker's books)."""
        n = codes.shape[0]
        B = self.bucket_for(n)
        t0 = obs.clock()
        reg = obs.get_registry()
        try:
            if self.chaos is not None:
                self.chaos()
            leaves = m.walk_bucket(k, B, codes, is_nan, is_zero)
        except Exception as e:                                # noqa: BLE001
            if record:
                self._on_dispatch_failure(e)
            raise DeviceDispatchError(
                f"device forest walk failed for bucket {B}: "
                f"{type(e).__name__}: {e}") from e
        if record:
            self._breaker.record_success()
            reg.summary("serve.dispatch_ms").observe((obs.clock() - t0) * 1e3)
            reg.histogram("serve.batch_fill_frac").observe(n / B)
            reg.counter(f"serve.bucket.{B}").inc()
        return leaves

    # --------------------------------------------- degrade / probe / health

    def _on_dispatch_failure(self, err: BaseException) -> None:
        Log.warning("serve: device dispatch failed (%s: %s) — serving this "
                    "request via the host predictor",
                    type(err).__name__, err)
        if self._breaker.record_failure(err):
            Log.warning(
                "serve: circuit breaker OPEN after %d failure(s) in %.1fs — "
                "engine is DEGRADED (host predictor, bit-identical answers "
                "at host throughput) until the device probe succeeds",
                self._breaker.failures, self._breaker.window_s)
            obs.get_registry().gauge("serve.health").set(
                _HEALTH_CODE["degraded"])
            self._start_probe()

    def _start_probe(self) -> None:
        # _probe_running (not Thread.is_alive) gates the start: the probe
        # thread clears it under the same lock as its exit decision, so a
        # breaker re-trip can never observe a probe that has already
        # decided to die and skip starting a fresh one
        with self._probe_lock:
            if self._probe_running or self._closed:
                return
            self._probe_running = True
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="lgbm-serve-probe", daemon=True)
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        """Background device retry: while the breaker is open, try one
        real (smallest-bucket) dispatch every ``serve_probe_interval_s``;
        the first success closes the breaker and restores ``ready``."""
        interval = self.config.serve_probe_interval_s
        while True:
            stopped = self._probe_stop.wait(interval)
            if not stopped and not self._closed and self._breaker.is_open:
                try:
                    self._probe_once()
                except Exception as e:                        # noqa: BLE001
                    obs.inc("serve.probe_failures")
                    Log.debug("serve: device probe failed (%s: %s) — still "
                              "degraded", type(e).__name__, e)
                    continue
                self._breaker.reset()
                obs.get_registry().gauge("serve.health").set(
                    _HEALTH_CODE["ready"])
                Log.warning("serve: device probe succeeded — circuit "
                            "breaker closed, engine READY on the device "
                            "path again")
            # exit decision, atomic with _start_probe: a re-trip lands
            # either before this check (breaker open again -> keep
            # probing) or after _probe_running clears (-> fresh thread)
            with self._probe_lock:
                if stopped or self._closed or not self._breaker.is_open:
                    self._probe_running = False
                    return

    def _probe_once(self) -> None:
        m = self._model
        if m.walk is None:
            return
        B = self.buckets[0]
        codes = np.zeros((B, m.num_features), np.int32)
        mask = np.zeros((B, m.num_features), bool)
        self._dispatch(m, 0, codes, mask, mask, record=False)

    def health(self) -> str:
        """``ready`` | ``degraded`` | ``down`` — the load-balancer probe.
        ``degraded`` = the circuit breaker is open and requests serve
        via the host predictor (correct, slower); ``down`` = the engine
        was closed and admits nothing."""
        if self._closed:
            return "down"
        if self._breaker.is_open:
            return "degraded"
        return "ready"

    def close(self) -> None:
        """Stop the probe thread and refuse further requests
        (``health()`` -> ``down``). Idempotent."""
        # flags flip under _probe_lock so a concurrent _start_probe either
        # ran first (then t below is its thread and gets joined) or sees
        # _closed and refuses. The join happens OUTSIDE the lock: the
        # probe's exit decision needs the same lock.
        with self._probe_lock:
            self._closed = True
            self._probe_stop.set()
            t = self._probe_thread
            self._probe_thread = None
        if t is not None:
            t.join(timeout=5.0)
        obs.get_registry().gauge("serve.health").set(_HEALTH_CODE["down"])

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- hot reload

    def reload(self, model, params: Optional[Dict] = None,
               num_iteration: Optional[int] = None,
               verify_rows: int = 256) -> int:
        """Hot-swap the served model with verified rollback.

        The candidate is stacked and its walks captured OFF TO THE SIDE
        (its own stream and memory pool; the live model keeps serving),
        verified **bit-identical** against its own booster's host
        ``predict()`` on ``verify_rows`` held rows (NaN and zero cells
        included), then swapped in atomically — requests hold a state
        snapshot, so in-flight batches finish on the old forest and every
        response matches exactly one model version. ANY failure (shape
        mismatch, capture error, verification mismatch) rolls back: the
        old model is still serving when the raised ``ReloadError``
        reaches the caller. Returns the new model version. Counters:
        ``serve.reloads`` / ``serve.reload_rollbacks``."""
        if self._closed:
            raise ServingClosedError("reload() on a closed ServingEngine")
        with self._reload_lock:
            old = self._model
            try:
                booster = self._load_booster(model, params)
                cand = _ModelState(booster, num_iteration, old.version + 1,
                                   self.device)
                if cand.num_features != old.num_features:
                    raise ReloadError(
                        f"candidate expects {cand.num_features} features, "
                        f"live model serves {old.num_features} — a reload "
                        f"must stay request-compatible")
                if cand.num_class_models != old.num_class_models:
                    raise ReloadError(
                        f"candidate has {cand.num_class_models} class "
                        f"model(s), live model {old.num_class_models} — "
                        f"the response shape would change under callers")
                self._warm_state(cand)
                self._verify_state(cand, verify_rows)
            except Exception as e:
                obs.inc("serve.reload_rollbacks")
                Log.warning("serve: reload ROLLED BACK (still serving "
                            "model_version=%d): %s: %s",
                            old.version, type(e).__name__, e)
                if isinstance(e, ReloadError):
                    raise
                raise ReloadError(f"reload failed and rolled back: "
                                  f"{type(e).__name__}: {e}") from e
            # atomic swap: a plain attribute rebind — concurrent requests
            # already hold their snapshot and finish on the old forest
            self._model = cand
            obs.inc("serve.reloads")
            reg = obs.get_registry()
            reg.gauge("serve.model_version").set(cand.version)
            reg.gauge("serve.num_trees").set(len(cand.trees))
            Log.info("serve: hot reload -> model_version=%d (%d trees, "
                     "verified bit-identical on %d rows)",
                     cand.version, len(cand.trees), verify_rows)
            return cand.version

    def _verify_state(self, m: _ModelState, verify_rows: int) -> None:
        """Bit-identity gate: the candidate's DEVICE path (no fallback, no
        breaker accounting) must reproduce its own booster's host
        ``predict()`` exactly on a held sample with NaN and zero cells."""
        if verify_rows <= 0:
            return
        rng = np.random.RandomState(0x5EED)
        X = np.asarray(rng.randn(verify_rows, m.num_features) * 2.0,
                       np.float64)
        X[rng.rand(verify_rows, m.num_features) < 0.05] = np.nan
        X[rng.rand(verify_rows, m.num_features) < 0.05] = 0.0
        want = m.booster.predict(X, num_iteration=m.num_iteration,
                                 force_host_predict=True)
        raw = self._predict_raw_for(m, X, allow_fallback=False, record=False)
        got = self._finish_for(m, raw, raw_score=False)
        if not np.array_equal(want, got, equal_nan=True):
            diff = float(np.max(np.abs(np.nan_to_num(want)
                                       - np.nan_to_num(got))))
            raise ReloadError(
                f"candidate verification FAILED: device path differs from "
                f"its own Booster.predict on {verify_rows} held rows "
                f"(max abs diff {diff:g})")

    # ----------------------------------------------------------- prediction

    def _predict_host(self, m: _ModelState, X: np.ndarray,
                      record: bool = True, degraded: bool = False
                      ) -> np.ndarray:
        """Host predictor path: per-tree f64 accumulation in tree order —
        the categorical route and the circuit-breaker fallback (identical
        numbers to the device path by the bit-identity contract)."""
        K = m.num_class_models
        raw = np.zeros((K, X.shape[0]), np.float64)
        for i, t in enumerate(m.trees):
            raw[i % K] += t.predict(X)
        if record:
            obs.get_registry().counter("serve.rows").inc(X.shape[0])
            if degraded:
                obs.inc("serve.host_fallback")
        return raw

    def _predict_raw_for(self, m: _ModelState, X: np.ndarray,
                         deadline: Optional[float] = None,
                         allow_fallback: bool = True,
                         record: bool = True) -> np.ndarray:
        """Raw scores [K, N] f64 for a prepared f64 matrix — traversal on
        the device (bucketed), leaf accumulation on the host in f64 tree
        order (bit-identical to the host predictor). Degraded state or a
        device-dispatch failure reroutes the WHOLE request to the host
        predictor (same numbers); ``allow_fallback=False`` (verification)
        lets the failure surface instead."""
        N = X.shape[0]
        K = m.num_class_models
        if m.has_categorical or (allow_fallback and self._breaker.is_open):
            return self._predict_host(
                m, X, record=record, degraded=not m.has_categorical)
        raw = np.zeros((K, N), np.float64)
        try:
            for k, forest in enumerate(m.forests):
                if forest.num_trees == 0:
                    continue
                codes, is_nan, is_zero = forest.encode_rows(X)
                lo = 0
                while lo < N:
                    if deadline is not None and obs.clock() > deadline:
                        obs.inc("serve.deadline_exceeded")
                        raise DeadlineExceededError(
                            f"deadline passed after {lo} of {N} rows — "
                            f"dropping the dispatch")
                    n = min(N - lo, self.max_bucket)
                    leaves = self._dispatch(
                        m, k, codes[lo:lo + n], is_nan[lo:lo + n],
                        is_zero[lo:lo + n], record=record)
                    raw[k, lo:lo + n] = accumulate_leaves(
                        forest, leaves, X[lo:lo + n])
                    lo += n
        except DeviceDispatchError:
            if not allow_fallback:
                raise
            # graceful degradation: the device path failed mid-request;
            # the host predictor serves the same bits at host throughput
            return self._predict_host(m, X, record=record, degraded=True)
        if record:
            obs.get_registry().counter("serve.rows").inc(N)
        return raw

    def _finish_for(self, m: _ModelState, raw: np.ndarray,
                    raw_score: bool) -> np.ndarray:
        """Output transform — Booster.predict's tail, verbatim semantics."""
        K = m.num_class_models
        if m.config.boosting_normalized == "rf":
            raw = raw / max(len(m.trees) // K, 1)
        elif not raw_score:
            raw = m.booster._convert_output(raw)
        return raw[0] if K == 1 else raw.T

    def predict(self, X, raw_score: bool = False,
                deadline_ms: Optional[float] = None) -> np.ndarray:
        """Serve one request: [N, F] (or a single row) -> predictions,
        bit-identical to ``Booster.predict`` on the same rows.
        ``deadline_ms`` (default ``serve_deadline_ms``; 0 = none) bounds
        the request — between chunk dispatches an expired deadline raises
        ``DeadlineExceededError`` instead of wasting further device
        time."""
        if self._closed:
            raise ServingClosedError("predict() on a closed ServingEngine")
        t0 = obs.clock()
        m = self._model
        dl = self.config.serve_deadline_ms if deadline_ms is None \
            else deadline_ms
        deadline = (t0 + dl / 1e3) if dl and dl > 0 else None
        X = self._as_matrix(X, m)
        out = self._finish_for(
            m, self._predict_raw_for(m, X, deadline=deadline), raw_score)
        reg = obs.get_registry()
        reg.counter("serve.requests").inc()
        reg.summary("serve.latency_ms").observe((obs.clock() - t0) * 1e3)
        return out

    def _as_matrix(self, X, m: Optional[_ModelState] = None) -> np.ndarray:
        m = m or self._model
        mat = np.asarray(X, np.float64)
        if mat.ndim == 1:
            mat = mat.reshape(1, -1)
        if mat.shape[1] != m.num_features:
            raise ValueError(
                f"request has {mat.shape[1]} features, model expects "
                f"{m.num_features}")
        return mat

    def describe(self) -> Dict:
        m = self._model
        return {"buckets": list(self.buckets),
                "num_trees": len(m.trees),
                "num_class_models": m.num_class_models,
                "num_features": m.num_features,
                "categorical_host_path": m.has_categorical,
                "warmed": m.warmed,
                "captures": m.captures,
                "device": str(self.device),
                "model_version": m.version,
                "health": self.health(),
                "breaker": self._breaker.state}


def accumulate_leaves(forest, leaves: np.ndarray, X: np.ndarray
                      ) -> np.ndarray:
    """Raw f64 scores ``[n]`` of walked ``leaves`` ``[n, T]``: the leaf
    values added on the host in tree order, starting from 0.0 — the
    operation order of ``Booster.predict``'s host loop, so the bits are
    its bits. A linear forest adds each tree's ``Tree.leaf_outputs``."""
    if forest.has_linear:
        out = np.zeros(leaves.shape[0], np.float64)
        for t, tr in enumerate(forest._trees):
            out += tr.leaf_outputs(X, leaves[:, t])
        return out
    vals = forest.leaf_value64[np.arange(forest.num_trees)[None, :], leaves]
    # 0.0 + v is v but for v = -0.0; cumsum adds left to right, one tree
    # after another, as the host loop does
    vals[:, 0] += 0.0
    return np.cumsum(vals, axis=1)[:, -1]
