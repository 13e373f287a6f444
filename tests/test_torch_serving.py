"""Port parity for serving (``lightgbm_tpu_torch/serving``), the copied
observability modules, the walk without host reads (B6) and the predict
fixes of ROADMAP C17, against the JAX package on the CPU.

Models are trained by the port (``device=cpu``) and their model text is
loaded into the JAX package, so the JAX side compiles only its serving
walks (``serve_buckets="4,32"`` on both sides). Bars:
- ``StackedForest.encode_rows``: codes bit-equal to the JAX package's on
  both branches (NaN, +-inf, 0.0, -0.0 and threshold ties);
- ``forest_walk_leaves`` (``max_depth`` steps, no host read): leaves equal
  to the JAX ``while_loop``'s for each missing type, root-is-leaf trees, a
  depth-1 and a deep forest;
- ``ServingEngine.predict``: byte-equal to the JAX package's engine and to
  the port's own ``Booster.predict(force_host_predict=True)`` for binary,
  3-class, regression, linear-leaf and categorical models at request sizes
  1, 3, 32, 33 and 100;
- ``pred_early_stop``: equal to the JAX package's on one model text
  (binary and 3-class); the device route within the JAX package's bar of
  ``rtol=atol=2e-6`` (``tests/test_batch_predict.py:36``);
- the micro-batcher, breaker and reload cases of ``tests/test_serving.py``
  and ``tests/test_serving_resilience.py``, on the port.
"""
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import observability as jobs
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.serving import ServingEngine as JaxEngine
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.serving import (CircuitBreaker, DeadlineExceededError,
                                        DispatchChaos, MicroBatcher,
                                        ReloadError, ServerOverloadedError,
                                        ServingClosedError, ServingEngine,
                                        ServingError, bucket_ladder)
from lightgbm_tpu_torch.utils.log import LightGBMError

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

SERVE = {"serve_buckets": "4,32", "verbose": -1}
SIZES = (1, 3, 32, 33, 100)


@pytest.fixture(autouse=True)
def _fresh_registries():
    obs.reset_for_tests()
    jobs.reset_for_tests()
    yield
    obs.reset_for_tests()
    jobs.reset_for_tests()


def _data(kind, n=1500, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f) * 4 - 2
    X[rng.rand(n, f) < 0.08] = np.nan
    X[rng.rand(n, f) < 0.08] = 0.0
    s = np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) ** 2
    if kind == "binary":
        y = (s > np.median(s)).astype(np.float64)
    elif kind == "multiclass":
        y = np.digitize(s, np.quantile(s, [0.33, 0.66])).astype(np.float64)
    elif kind == "categorical":
        X[:, 0] = rng.randint(0, 6, n)
        y = (X[:, 0] % 2 == 0) * 2.0 + np.nan_to_num(X[:, 1])
    else:
        y = s + 0.1 * rng.randn(n)
    return X, y


PARAMS = {
    "binary": dict(objective="binary"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "regression": dict(objective="regression", zero_as_missing=True),
    "linear": dict(objective="regression", linear_tree=True,
                   linear_lambda=0.01, linear_max_features=3),
    "categorical": dict(objective="regression", max_cat_to_onehot=2),
    "stumps": dict(objective="regression", num_leaves=2),
    "no_missing": dict(objective="regression", use_missing=False),
}


def _train(kind, rounds=10, seed=0):
    X, y = _data("categorical" if kind == "categorical" else
                 "multiclass" if kind == "multiclass" else
                 "binary" if kind == "binary" else "regression", seed=seed)
    p = dict(dict(num_leaves=15, min_data_in_leaf=10, device="cpu",
                  verbose=-1, seed=seed), **PARAMS[kind])
    ds = lgt.Dataset(X, label=y, params=p,
                     categorical_feature=[0] if kind == "categorical"
                     else "auto")
    return lgt.train(p, ds, num_boost_round=rounds), X


@pytest.fixture(scope="module")
def models():
    """One port model per kind, trained once, with its model text loaded
    into the JAX package."""
    out = {}
    for kind in PARAMS:
        if kind == "no_missing":
            continue
        bst, X = _train(kind)
        out[kind] = (bst, lgb.Booster(model_str=bst.model_to_string()), X)
    return out


def _probe(X, n=100, seed=3):
    """Request rows: NaN, zero, -0.0, +-inf cells and exact ties."""
    rng = np.random.RandomState(seed)
    P = np.array(X[:n], np.float64)
    P[rng.rand(*P.shape) < 0.05] = np.inf
    P[rng.rand(*P.shape) < 0.05] = -np.inf
    P[rng.rand(*P.shape) < 0.05] = -0.0
    return P


# ------------------------------------------------------ no JAX in the port

def test_serving_and_observability_import_no_jax():
    code = ("import sys, lightgbm_tpu_torch.serving, "
            "lightgbm_tpu_torch.serving.loadgen, "
            "lightgbm_tpu_torch.observability, lightgbm_tpu_torch.utils.cache;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------- copies pinned to originals

def _metric_ops(reg):
    reg.counter("a").inc(3)
    reg.inc("a")
    reg.gauge("g").set(2.5)
    for v in (5.0, 1.0, 3.0):
        reg.histogram("h").observe(v)
    s = reg.summary("s", window=7)
    for v in range(1, 20):
        s.observe(float(v * 3 % 11))
    snap = reg.snapshot()
    snap.pop("time_unix")
    return snap, s.quantiles()


def test_copied_host_modules_match_the_jax_package():
    from lightgbm_tpu.observability.metrics import MetricsRegistry as JReg
    from lightgbm_tpu.serving import CircuitBreaker as JBreaker
    from lightgbm_tpu.serving.loadgen import latency_stats as jstats
    from lightgbm_tpu_torch.observability.metrics import MetricsRegistry
    from lightgbm_tpu_torch.observability.tracer import SpanTracer
    from lightgbm_tpu_torch.serving.loadgen import latency_stats
    from lightgbm_tpu_torch.utils.cache import LRUCache
    from lightgbm_tpu.observability.tracer import SpanTracer as JTracer
    from lightgbm_tpu.utils.cache import LRUCache as JLRU
    assert _metric_ops(MetricsRegistry()) == _metric_ops(JReg())
    lats = list(np.random.RandomState(1).exponential(3.0, 501))
    assert latency_stats(lats) == jstats(lats)
    for make in (CircuitBreaker, JBreaker):
        t = [0.0]
        br = make(failures=3, window_s=10.0, clock=lambda: t[0])
        trace = []
        for now in (0.0, 1.0, 12.0, 12.5, 13.0):
            t[0] = now
            trace.append(br.record_failure())
        trace += [br.is_open, br.state, br.trips]
        br.reset()
        trace.append(br.state)
        if make is CircuitBreaker:
            ours = trace
    assert ours == trace
    for make in (SpanTracer, JTracer):
        tr = make()
        tr.enabled = True
        with tr.span("p", k=1):
            pass
        tr.event("e", x=2)
        got = [(e["name"], e["ph"], e["args"]) for e in tr.events()]
        if make is SpanTracer:
            ours = got
    assert ours == got
    for make in (LRUCache, JLRU):
        c = make(2)
        c.put("a", 1)
        c.put("b", 2)
        c.get("a")
        c.put("c", 3)
        got = (c.keys(), c.get("b"), c.stats())
        if make is LRUCache:
            ours = got
    assert ours == got


def test_loadgen_and_observability_exports(tmp_path):
    """The load generators count the rows they served (capped at the pool,
    as the JAX package's do), and the telemetry exports write the snapshot
    and the Chrome trace."""
    import json
    import os
    from lightgbm_tpu_torch.serving.loadgen import (run_closed_loop,
                                                    run_open_loop)
    X = np.zeros((10, 3))
    served = []

    def _serve(Xr):
        served.append(Xr.shape[0])
        time.sleep(0.002)

    r = run_closed_loop(_serve, X, batch_rows=512, concurrency=2,
                        requests_per_worker=3)
    assert set(served) == {10} and r["batch_rows_effective"] == 10
    assert r["requests"] == 6 and r["errors"] == []
    r = run_open_loop(lambda Xr: None, X, batch_rows=4, rate_rps=200.0,
                      duration_s=0.05, seed=0)
    assert r["requests"] == 10 and "batch_rows_effective" not in r
    obs.configure(telemetry_dir=str(tmp_path))
    assert obs.enabled()
    with obs.span("serve.warmup", buckets=2):
        obs.inc("serve.requests", 3)
    trace = obs.flush()
    assert json.load(open(trace))["traceEvents"][0]["name"] == "serve.warmup"
    snap = json.load(open(obs.write_snapshot(str(tmp_path / "s.json"))))
    assert snap["counters"]["serve.requests"] == 3
    assert snap["spans_recorded"] == 1
    assert os.path.exists(obs.jsonl_path())


def test_bucket_ladder_bucket_for_and_config_validation(models, tmp_path):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.serving import bucket_ladder as jladder
    for params in ({"serve_max_batch_rows": 4096},
                   {"serve_max_batch_rows": 100}, {"serve_buckets": "1,8,64"}):
        assert bucket_ladder(lgt.Config.from_params(params)) == \
            jladder(JConfig.from_params(params))
    ladder = bucket_ladder(lgt.Config.from_params({}))
    assert ladder[0] == 1 and ladder[-1] == 4096 and len(ladder) == 13
    for bad in ({"serve_max_batch_rows": 0}, {"serve_max_wait_ms": -1},
                {"serve_buckets": "8,4"},
                {"serve_buckets": "1,8192", "serve_max_batch_rows": 4096},
                {"serve_max_queue_rows": -1}, {"serve_deadline_ms": -2},
                {"serve_breaker_failures": -1},
                {"serve_breaker_window_s": 0},
                {"serve_probe_interval_s": 0}):
        with pytest.raises(LightGBMError):
            lgt.Config.from_params(bad)
    bst, _jb, X = models["regression"]
    eng = ServingEngine(bst, params=dict(SERVE, serve_buckets="4,16"))
    assert [eng.bucket_for(n) for n in (1, 4, 5, 16, 999)] == \
        [4, 4, 16, 16, 16]
    # a proto model file is served (it raised naming ROADMAP A7 before
    # the model formats were ported)
    proto = str(tmp_path / "m.proto")
    bst.save_model(proto)
    served = ServingEngine(proto, params=dict(SERVE, device="cpu",
                                              serve_buckets="4,16"))
    assert served.predict(X[:20]).tobytes() == eng.predict(X[:20]).tobytes()
    served.close()
    with pytest.raises(LightGBMError, match="CUDA"):
        ServingEngine(bst, params=dict(SERVE, device="cuda"))


# ------------------------------------------------ encode and walk (B6)

def _ties(forest, X):
    X = np.array(X, np.float64)
    for f, g in enumerate(forest.grids):
        if len(g):
            X[1, f], X[2, f], X[3, f] = g[0], g[-1], g[len(g) // 2]
    X[0, 0] = -0.0
    return X


@pytest.mark.parametrize("branch", ["loop", "vectorized", "by_size"])
def test_encode_rows_bit_equal_to_jax(models, branch):
    bst, jb, X = models["binary"]
    ours = tpredict.StackedForest(bst.trees, bst.num_total_features)
    ref = jpredict.StackedForest(jb.trees, jb.num_total_features)
    for g, jg in zip(ours.grids, ref.grids):
        np.testing.assert_array_equal(g, jg)
    P = _ties(ours, _probe(X, 400))
    if branch == "loop":
        np.testing.assert_array_equal(ours._encode_loop(P),
                                      ref._encode_loop(P))
    elif branch == "vectorized":
        nan = np.isnan(P)
        np.testing.assert_array_equal(ours._encode_vectorized(P, nan),
                                      ref._encode_vectorized(P, nan))
        np.testing.assert_array_equal(ours._encode_vectorized(P, nan),
                                      ours._encode_loop(P))
    else:
        for n in (1, 13, 400):     # both sides of VEC_ENCODE_MAX_ELEMS
            for a, b in zip(ours.encode_rows(P[:n]), ref.encode_rows(P[:n])):
                np.testing.assert_array_equal(a, b)


def _const_trees(bst, jb):
    """A one-leaf tree of each package (the root is a leaf)."""
    from lightgbm_tpu.tree import Tree as JTree
    from lightgbm_tpu_torch.tree import Tree
    out = []
    for make in (Tree, JTree):
        out.append(make(
            num_leaves=1, split_feature=np.zeros(0, np.int32),
            threshold_bin=np.zeros(0, np.int32),
            threshold=np.zeros(0, np.float64),
            decision_type=np.zeros(0, np.uint8),
            left_child=np.zeros(0, np.int32),
            right_child=np.zeros(0, np.int32),
            split_gain=np.zeros(0, np.float64),
            internal_value=np.zeros(0, np.float64),
            internal_count=np.zeros(0, np.int64),
            leaf_value=np.array([3.25]), leaf_count=np.array([5], np.int64),
            leaf_parent=np.full(1, -1, np.int32)))
    return out


def _jax_walk(forest, codes, is_nan, is_zero):
    return np.asarray(jpredict.forest_walk_leaves(*(jnp.asarray(a) for a in (
        forest.split_feature, forest.thr_rank, forest.decision, forest.left,
        forest.right, forest.root_is_leaf, forest.zero_rank, codes, is_nan,
        is_zero))))


@pytest.mark.parametrize("case", ["binary", "zero_missing", "no_missing",
                                  "root_is_leaf", "stumps", "all_leaves",
                                  "deep"])
def test_walk_leaves_equal_to_jax(models, case):
    kind = {"zero_missing": "regression", "root_is_leaf": "binary",
            "all_leaves": "binary"}.get(case, case)
    if case in ("deep", "no_missing"):
        bst, X = _train("regression", rounds=3, seed=5) if case == "deep" \
            else _train("no_missing", rounds=5)
        jb = lgb.Booster(model_str=bst.model_to_string())
        trees, jtrees = bst.trees, jb.trees
    else:
        bst, jb, X = models[kind]
        trees, jtrees = bst.trees, jb.trees
    if case in ("root_is_leaf", "all_leaves"):
        c, jc = _const_trees(bst, jb)
        trees, jtrees = ([c, c], [jc, jc]) if case == "all_leaves" else \
            (trees[:3] + [c] + trees[3:], jtrees[:3] + [jc] + jtrees[3:])
    missing = {int(d >> 2) & 3 for t in trees
               for d in t.decision_type[:t.num_internal]}
    want = {"binary": 2, "zero_missing": 1, "no_missing": 0}.get(case)
    if want is not None:      # the missing type the case is about
        assert want in missing and (want or missing == {0})
    ours = tpredict.StackedForest(trees, bst.num_total_features)
    ref = jpredict.StackedForest(jtrees, jb.num_total_features)
    assert ours.max_depth == max(t.max_depth() for t in trees)
    if case == "stumps":
        assert ours.max_depth == 1
    if case == "all_leaves":
        assert ours.max_depth == 0
    P = _ties(ours, _probe(X, 300)) if ours.grids[0].size else _probe(X)
    codes, is_nan, is_zero = ours.encode_rows(P)
    got = tpredict.forest_walk_leaves(
        *ours.to("cpu"), torch.from_numpy(codes), torch.from_numpy(is_nan),
        torch.from_numpy(is_zero), ours.max_depth)
    assert got.dtype == torch.int32
    want = _jax_walk(ref, codes, is_nan, is_zero)
    np.testing.assert_array_equal(got.numpy(), want)
    # the leaves are the host predictor's too
    for t, tree in enumerate(trees):
        np.testing.assert_array_equal(got[:, t].numpy(),
                                      tree.predict_leaf(P))


_HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique", "_unique2", "unique_consecutive", "bincount",
               "item", "is_nonzero", "equal", "lift_fresh"}


class _HostReadCheck(TorchDispatchMode):
    """Records every op that reads a tensor on the host or sizes its output
    from tensor data (a sync on the card, and a capture error), and any
    tensor made from host data (a host-to-device copy)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if name in _HOST_READS:
            port = [f for f in traceback.extract_stack()
                    if "lightgbm_tpu_torch" in f.filename]
            self.hits.append(f"{name} at {port[-1].filename}:"
                             f"{port[-1].lineno}" if port else name)
        if name.startswith(("index", "_index_put")) and len(args) > 1 \
                and isinstance(args[1], (list, tuple)) and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in args[1]):
            self.hits.append(name + "[bool mask]")
        return func(*args, **(kwargs or {}))


def test_walk_reads_nothing_on_the_host(models):
    """The walk from its launch to the caller's result copy: no op that
    reads the host or copies host data (what a CUDA-graph capture
    refuses), for the serving engine's buckets and ``Booster.predict``."""
    bst, _jb, X = models["multiclass"]
    ours = tpredict.StackedForest(bst.trees[::3], bst.num_total_features)
    dev = ours.to("cpu")
    codes, is_nan, is_zero = (torch.from_numpy(a)
                              for a in ours.encode_rows(_probe(X, 64)))
    with _HostReadCheck() as check:
        leaves = tpredict.forest_walk_leaves(*dev, codes, is_nan, is_zero,
                                             ours.max_depth)
    assert check.hits == []
    assert leaves.shape == (64, ours.num_trees)


# ------------------------------------------------------ served predictions

@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression",
                                  "linear", "categorical"])
def test_engine_predict_byte_equal_to_jax_and_host(models, kind):
    bst, jb, X = models[kind]
    eng = ServingEngine(bst, params=dict(SERVE, device="cpu"))
    jeng = JaxEngine(jb, params=SERVE)
    assert eng.has_categorical == (kind == "categorical") == \
        jeng.has_categorical
    P = _probe(X)
    for n in SIZES:
        got = eng.predict(P[:n])
        assert got.tobytes() == jeng.predict(P[:n]).tobytes(), (kind, n)
        assert got.tobytes() == bst.predict(
            P[:n], force_host_predict=True).tobytes(), (kind, n)
        raw = eng.predict(P[:n], raw_score=True)
        assert raw.tobytes() == jeng.predict(P[:n], raw_score=True).tobytes()
    assert np.array_equal(eng.predict(P[0]), bst.predict(P[:1]))
    eng.close()
    jeng.close()


def test_no_capture_after_warmup_across_sizes(models):
    bst, _jb, X = models["binary"]
    eng = ServingEngine(bst, params=dict(SERVE, device="cpu"))
    assert eng.captures() == 2
    for n in range(1, 65):
        eng.predict(X[:n])
    assert eng.captures() == 2
    lazy = ServingEngine(bst, params=dict(SERVE, device="cpu"),
                         warmup=False)
    assert lazy.captures() == 0
    lazy.predict(X[:3])
    assert lazy.captures() == 1           # bucket 4, prepared at first use
    assert np.array_equal(lazy.predict(X[:40]), eng.predict(X[:40]))
    assert lazy.captures() == 2


def test_serve_metrics_and_snapshot_p50_p99(models):
    bst, _jb, X = models["binary"]
    eng = ServingEngine(bst, params=dict(SERVE, serve_buckets="4,16",
                                         device="cpu"))
    for n in (1, 3, 9, 16, 5):
        eng.predict(X[:n])
    snap = obs.snapshot()
    c = snap["counters"]
    assert c["serve.requests"] == 5 and c["serve.rows"] == 34
    assert c["serve.bucket_captures"] == 2
    assert c["serve.bucket.4"] >= 2 and c["serve.bucket.16"] >= 3
    lat = snap["summaries"]["serve.latency_ms"]
    assert lat["count"] == 5 and lat["p99"] >= lat["p50"] is not None
    fill = snap["histograms"]["serve.batch_fill_frac"]
    assert fill["count"] >= 5 and 0 < fill["mean"] <= 1.0
    assert snap["summaries"]["serve.dispatch_ms"]["count"] >= 5
    assert snap["gauges"]["serve.health"] == 0
    assert snap["gauges"]["serve.model_version"] == 1
    eng.close()
    assert eng.health() == "down"
    assert obs.snapshot()["gauges"]["serve.health"] == 2


# ----------------------------------------------------------- micro-batcher

def _engine(bst, **params):
    base = dict(SERVE, device="cpu", serve_breaker_failures=3,
                serve_breaker_window_s=30.0, serve_probe_interval_s=0.05)
    base.update(params)
    return ServingEngine(bst, params=base)


def test_microbatcher_ordering_fuzz(models):
    bst, _jb, X = models["binary"]
    eng = _engine(bst, serve_buckets="4,32,128")
    rng = np.random.RandomState(0)
    jobs_ = [(int(rng.randint(0, 1400)), int(rng.randint(1, 40)))
             for _ in range(48)]
    outs = {}
    with MicroBatcher(eng, max_batch_rows=128, max_wait_ms=2.0) as mb:
        def call(i, lo, n):
            outs[i] = mb.predict(X[lo:lo + n])
        threads = [threading.Thread(target=call, args=(i, lo, n))
                   for i, (lo, n) in enumerate(jobs_)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    for i, (lo, n) in enumerate(jobs_):
        assert np.array_equal(outs[i], bst.predict(X[lo:lo + n])), i


def test_microbatcher_deadline_flush_shedding_and_shutdown(models):
    bst, _jb, X = models["regression"]
    eng = _engine(bst)
    with MicroBatcher(eng, max_batch_rows=1 << 14, max_wait_ms=5.0) as mb:
        # a lone request is flushed at the wait deadline
        assert np.array_equal(mb.predict(X[:3]), eng.predict(X[:3]))
        with pytest.raises(ValueError):
            mb.predict(np.zeros((2, X.shape[1] + 5)))
    with pytest.raises(ServingClosedError):
        mb.predict(X[:1])
    # a hung dispatch: the queue fills, the next request is shed
    chaos = DispatchChaos()
    eng.chaos = chaos
    chaos.arm_hang(0.8, n=1)
    results, errors = {}, {}
    with MicroBatcher(eng, max_batch_rows=4, max_wait_ms=1.0,
                      max_queue_rows=4) as mb:
        def call(i, lo, n):
            try:
                results[i] = mb.predict(X[lo:lo + n])
            except ServingError as e:
                errors[i] = e
        threads = []
        for i, n in enumerate((2, 2, 2, 1)):
            t = threading.Thread(target=call, args=(i, 10 * i, n),
                                 daemon=True)
            threads.append(t)
            t.start()
            time.sleep(0.12)
        for t in threads:
            t.join(timeout=15)
    assert isinstance(errors.get(3), ServerOverloadedError), errors
    for i in (0, 1, 2):
        np.testing.assert_array_equal(results[i],
                                      eng.predict(X[10 * i:10 * i + 2]))
    assert obs.snapshot()["counters"]["serve.shed"] == 1
    # requests expired behind a hung dispatch are dropped at dequeue
    chaos.arm_hang(0.8, n=1)
    outcomes = {}
    with MicroBatcher(eng, max_batch_rows=4, max_wait_ms=1.0,
                      deadline_ms=150.0) as mb:
        def late(i):
            try:
                mb.predict(X[:2])
                outcomes[i] = "ok"
            except DeadlineExceededError:
                outcomes[i] = "deadline"
        before = chaos.dispatches
        threads = [threading.Thread(target=late, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=15)
        assert set(outcomes.values()) == {"deadline"}, outcomes
        assert chaos.dispatches - before == 1
        assert np.array_equal(mb.predict(X[:3], deadline_ms=0),
                              eng.predict(X[:3]))
    eng.close()
    with pytest.raises(ServingClosedError):
        eng.predict(X[:1])
    with pytest.raises(ServingClosedError):
        eng.reload(bst)


# --------------------------------------------------- breaker and reload

def test_breaker_degrades_loudly_and_probe_recovers(models, caplog):
    bst, _jb, X = models["binary"]
    eng = _engine(bst)
    want = bst.predict(X[:80])
    chaos = DispatchChaos()
    eng.chaos = chaos
    chaos.arm_failures(3)
    for _ in range(3):
        np.testing.assert_array_equal(eng.predict(X[:80]), want)
    assert eng.health() == "degraded"
    assert eng.describe()["breaker"] == "open"
    np.testing.assert_array_equal(eng.predict(X[:80]), want)
    t0 = time.monotonic()
    while eng.health() != "ready" and time.monotonic() - t0 < 10:
        time.sleep(0.02)
    assert eng.health() == "ready"
    np.testing.assert_array_equal(eng.predict(X[:80]), want)
    c = obs.snapshot()["counters"]
    assert c["serve.breaker_trips"] == 1
    assert c["serve.breaker_recoveries"] == 1
    assert c["serve.host_fallback"] >= 3
    eng.close()


def test_reload_swaps_verified_and_rolls_back(models, monkeypatch):
    bst1, _jb, X = models["binary"]
    bst2, _ = _train("binary", rounds=6, seed=7)
    eng = _engine(bst1)
    first = eng.model_snapshot()
    assert eng.reload(bst2) == 2 and eng.model_version == 2
    np.testing.assert_array_equal(eng.predict(X[:60]), bst2.predict(X[:60]))
    assert first.captures == 2 and eng.captures() == 2
    assert eng.reload(bst2, num_iteration=3) == 3
    np.testing.assert_array_equal(eng.predict(X[:60]),
                                  bst2.predict(X[:60], num_iteration=3))
    # a candidate whose walk disagrees with its own booster rolls back
    orig = tpredict.forest_walk_leaves
    monkeypatch.setattr(tpredict, "forest_walk_leaves",
                        lambda *a: orig(*a) * 0)
    with pytest.raises(ReloadError, match="verification FAILED"):
        eng.reload(bst1, verify_rows=128)
    monkeypatch.setattr(tpredict, "forest_walk_leaves", orig)
    # a feature mismatch rolls back
    wrong, _ = _train("binary", rounds=3, seed=1)
    Xw = np.random.RandomState(2).rand(300, 5)
    wrong = lgt.train(dict(objective="binary", device="cpu", verbose=-1,
                           num_leaves=7), lgt.Dataset(Xw, label=Xw[:, 0] > .5),
                      num_boost_round=3)
    with pytest.raises(ReloadError, match="features"):
        eng.reload(wrong)
    assert eng.model_version == 3
    np.testing.assert_array_equal(eng.predict(X[:60]),
                                  bst2.predict(X[:60], num_iteration=3))
    snap = obs.snapshot()
    assert snap["counters"]["serve.reloads"] == 2
    assert snap["counters"]["serve.reload_rollbacks"] == 2
    assert snap["gauges"]["serve.model_version"] == 3
    eng.close()


def test_reload_from_a_text_file_under_traffic(models, tmp_path):
    """Every response of traffic through the batcher matches exactly one
    of the two model versions while ``reload()`` swaps them."""
    bst1, _jb, X = models["binary"]
    path = str(tmp_path / "m.txt")
    bst1.save_model(path)
    eng = ServingEngine(path, params=dict(SERVE, device="cpu"))
    pool = X[:40]
    exp = [{n: bst1.predict(pool[:n], num_iteration=it)
            for n in (2, 3, 5)} for it in (10, 4)]
    stop = threading.Event()
    seen, errors = set(), []
    with MicroBatcher(eng, max_batch_rows=16, max_wait_ms=1.0) as mb:
        def worker(w):
            i = 0
            while not stop.is_set():
                n = (2, 3, 5)[(w + i) % 3]
                i += 1
                out = mb.predict(pool[:n])
                hit = [v for v in (0, 1) if np.array_equal(out, exp[v][n])]
                if len(hit) != 1:
                    errors.append(n)
                    return
                seen.add(hit[0])
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        assert eng.reload(path, params=dict(SERVE, device="cpu"),
                          num_iteration=4) == 2
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=15)
    assert errors == [] and seen == {0, 1}
    eng.close()


# ------------------------------------------------ C17 and predict parity

@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_early_stop_equal_to_jax(kind):
    X, y = _data(kind, n=500, f=5)
    p = dict(objective=kind, num_leaves=15, device="cpu", verbose=-1)
    if kind == "multiclass":
        p["num_class"] = 3
    bst = lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=40)
    jb = lgb.Booster(model_str=bst.model_to_string())
    es = dict(pred_early_stop=True, pred_early_stop_freq=5,
              pred_early_stop_margin=1.0)
    got = bst.predict(X, **es)
    want = jb.predict(X, **es)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, bst.predict(X))   # the stop engaged
    np.testing.assert_array_equal(bst.predict(X), jb.predict(X))


def test_pred_early_stop_refused_for_regression(models):
    bst, _jb, X = models["regression"]
    with pytest.raises(LightGBMError, match="binary and multiclass"):
        bst.predict(X[:5], pred_early_stop=True)


def test_device_route_force_host_and_forest_cache(models):
    """``Booster.predict``'s device route (rows x trees >= 1,000,000, on the
    CPU) within the JAX package's bar of its own device route; with
    ``force_host_predict`` the host loop, bit for bit; the stacked forests
    built once and taken from the cache on the second call."""
    bst, jb, X = models["multiclass"]
    big = np.tile(_probe(X, 500), (70, 1))        # 35,000 rows x 30 trees
    dev = bst.predict(big)
    np.testing.assert_allclose(dev, jb.predict(big), rtol=2e-6, atol=2e-6)
    cache = bst._stacked_cache
    before = cache.stats()
    np.testing.assert_array_equal(bst.predict(big), dev)
    assert cache.stats()["hits"] == before["hits"] + 1
    assert cache.stats()["misses"] == before["misses"]
    host = np.zeros((3, 500))
    for i, t in enumerate(bst.trees):
        host[i % 3] += t.predict(big[:500])
    forced = bst.predict(big[:500], raw_score=True, force_host_predict=True)
    assert forced.tobytes() == np.ascontiguousarray(host.T).tobytes()
