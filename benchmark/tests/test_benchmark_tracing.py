"""The readers of the program's spans and counters, on a hand-made
registry, tracer and profile record (CPU); and, on the card, that the
captured iteration's part clock times every replayed iteration without a
host sync of its own:

    python3 -m pytest benchmark/tests/test_benchmark_tracing.py -m card -s
"""
import time

import pytest

from benchmark.harness import manifest


@pytest.fixture
def fresh_obs():
    from lightgbm_tpu_torch import observability as obs
    obs.reset_for_tests()
    yield obs
    obs.reset_for_tests()


def _timed(obs, part, per_iter, n=4):
    reg = obs.get_registry()
    for _ in range(n):
        reg.histogram(f"iteration.device_ms.{part}").observe(per_iter)
    reg.counter("iteration.timed").inc(n)


def _waves(obs, run, needed):
    reg = obs.get_registry()
    reg.counter("iteration.waves_run").inc(run)
    reg.counter("iteration.waves_needed").inc(needed)


def _construct(obs, span, seconds):
    obs.configure(enabled=True)
    with obs.span("construct"):
        with obs.span(span):
            time.sleep(seconds)


def _profile(gaps, calls=2):
    return {"record": {"profile": {"idle_gaps": gaps, "calls": calls}}}


READINGS = {
    "objective_ms_per_iter": (lambda o: _timed(o, "start", 1.5), 1.5),
    "wave_loop_ms_per_iter": (lambda o: _timed(o, "waves", 60.0), 60.0),
    "wave_yield_pct": (lambda o: _waves(o, 40, 30), 75.0),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_counter_readers_read_the_registry(name, fresh_obs):
    fill, want = READINGS[name]
    reader = manifest.metric_reader(name)
    assert reader.read({"record": {}}) is None        # nothing counted
    fill(fresh_obs)
    assert reader.read({"record": {}}) == pytest.approx(want)


@pytest.mark.parametrize("name,fill", [
    ("objective_ms_per_iter", lambda o: _timed(o, "waves", 60.0)),
    ("wave_loop_ms_per_iter", lambda o: _timed(o, "start", 1.5)),
    ("wave_yield_pct",
     lambda o: o.get_registry().counter("iteration.waves_needed").inc(3)),
])
def test_a_missing_counter_reads_none_not_zero(name, fill, fresh_obs):
    fill(fresh_obs)
    assert manifest.metric_reader(name).read({"record": {}}) is None


def _reads_its_span(obs, name, span):
    reader = manifest.metric_reader(name)
    assert reader.read({"record": {}}) is None
    with obs.span(span):                        # tracer off: no record
        pass
    _construct(obs, "construct.bin", 0.01)      # another span
    assert reader.read({"record": {}}) is None
    _construct(obs, span, 0.02)
    got = reader.read({"record": {}})
    assert 0.02 <= got < 1.0


def test_find_bins_reads_the_spans(fresh_obs):
    _reads_its_span(fresh_obs, "find_bins_s", "construct.find_bins")


def test_ingest_check_reads_the_spans(fresh_obs):
    _reads_its_span(fresh_obs, "ingest_check_s", "construct.defer")


def test_encode_idle_reads_the_labelled_gaps():
    reader = manifest.metric_reader("encode_idle_ms_per_call")
    assert reader.read({"record": {"profile": None}}) is None
    assert reader.read(_profile([["host outside any profiled op", 3.8]])) \
        is None
    got = reader.read(_profile([["predict.encode", 3.0],
                                ["predict.fetch", 0.1]], calls=2))
    assert got == pytest.approx(1500.0)


@pytest.mark.card
def test_captured_iterations_are_timed_without_a_sync(card, fresh_obs):
    """A few captured batches with the tracer on and no eval: every part
    reads positive device time, every replayed iteration after the
    capture is timed, and the guarded batches sync once a tree."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.analysis import CaptureGuard
    from lightgbm_tpu_torch.callback import EarlyStopException
    fresh_obs.configure(enabled=True)
    rng = np.random.default_rng(7)
    X = rng.random((500_000, 28), dtype=np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.1 * rng.standard_normal(500_000)
         > 0.75).astype(np.float32)
    state = {}

    def window(env):
        graphs = env.model._gbdt._graphs
        if env.iteration + 1 == 8:          # after the capture's batch
            guard = state["guard"] = CaptureGuard("tracing", fail=True,
                                                  device="cuda")
            guard.register(graphs, "iteration")
            guard.__enter__()
            guard.mark_warm()
            state["trees"], state["reads"] = graphs.trees, graphs.syncs
        elif env.iteration + 1 == 24:
            state["guard"].__exit__(None, None, None)
            state["trees"] = graphs.trees - state["trees"]
            state["reads"] = graphs.syncs - state["reads"]
            raise EarlyStopException(env.iteration, None)
    window.order = 5
    params = dict(objective="binary", num_leaves=63, verbose=-1,
                  metric="none", tree_batch=4)
    bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=100,
                    callbacks=[window], keep_training_booster=True)
    snap = fresh_obs.get_registry().snapshot()
    graphs = bst._gbdt._graphs
    guard = state["guard"]
    print("tracing card:", {k: v for k, v in snap["counters"].items()
                            if k.startswith("iteration.")},
          {k: v["mean"] for k, v in snap["histograms"].items()
           if k.startswith("iteration.")},
          "host syncs", guard.host_syncs, "flag reads", state["reads"],
          "trees", state["trees"], guard.sync_sites, flush=True)
    # 24 iterations: the eager first, the capture's (untimed), 22 timed
    assert snap["counters"]["iteration.timed"] == 22
    for part in ("start", "prologue", "waves", "epilogue"):
        h = snap["histograms"][f"iteration.device_ms.{part}"]
        assert h["count"] == 22 and h["min"] > 0
    # the guarded batches sync only at the flag reads, one a tree where
    # the speculative waves sufficed
    assert state["trees"] == 16
    assert guard.host_syncs == state["reads"]
    assert state["trees"] <= state["reads"] <= 2 * state["trees"]
    for name in ("trees", "waves_run", "waves_needed"):
        assert snap["counters"][f"iteration.{name}"] == getattr(graphs, name)
