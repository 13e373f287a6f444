"""Training telemetry of ``lightgbm_tpu_torch`` (``observability/``,
``utils/timer.py``) on the CPU, against the JAX package: the counterparts
of ``tests/test_observability.py`` and ``tests/test_timer.py``.

Pins:

- parity with the JAX package: ``parse_profile_iters`` (values and error
  types), ``waves_for_tree`` on a grid, ``PhaseBreakdown.to_dict()``'s
  schema, ``read_jsonl`` on a torn line, the ``Timers`` summary text;
- training parity: JAX ``train`` and the port's on the same data with
  ``telemetry_dir`` record the same span names and counts (``train``,
  ``tree_batch``, ``iteration``, ``eval``, derived ``wave``), the same
  ``trees.trained`` / ``rows.routed``, the same ``tree.waves`` /
  ``tree.leaves`` histograms and the same ``booster_init`` keys (the
  kernel route is ``plain`` here where the JAX package says ``xla``);
- the port's own behaviour: the profiler window ticks batch-aligned under
  ``tree_batch`` (``torch.profiler`` replaced by a recorder), is skipped
  when resumed past it, needs an output dir, and covers the CUDA graph
  capture where it overlaps it; the env var configures telemetry;
  the registry stays live without a dir; resume counts only new
  iterations; the flush happens on a failed run; none of the four
  observability keys logs "ignored"; the timers record the phases.

The JAX configuration trains once per module.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import observability as jobs
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.observability.export import (read_jsonl,
                                                     write_chrome_trace)
from lightgbm_tpu_torch.observability.phases import PhaseBreakdown
from lightgbm_tpu_torch.observability.profiler import (ProfileWindow,
                                                       parse_profile_iters)
from lightgbm_tpu_torch.observability.tracer import SpanTracer
from lightgbm_tpu_torch.utils.log import LightGBMError
from lightgbm_tpu_torch.utils.timer import TIMERS, Timers

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)


@pytest.fixture
def telemetry(tmp_path):
    """Fresh process-wide singletons pointed at a temp dir; reset after."""
    obs.reset_for_tests()
    obs.configure(telemetry_dir=str(tmp_path))
    yield obs
    obs.reset_for_tests()


@pytest.fixture
def clean_registry():
    obs.reset_for_tests()
    yield obs
    obs.reset_for_tests()


def _data(n=400, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0.65).astype(np.float32)
    return X, y


PARAMS = dict(objective="binary", num_leaves=7, max_bin=15,
              min_data_in_leaf=5, verbose=-1, metric="none", device="cpu")


def _train(params, rounds, **kw):
    X, y = _data()
    return lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=rounds,
                     **kw)


# ------------------------------------------------------------ parity: host

SPECS = ["", "2:5", "0:1", "5", "a:b", "3:3", "-1:2", "1:2:3", "4:2"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_profile_iters_matches_jax(spec):
    from lightgbm_tpu.observability.profiler import \
        parse_profile_iters as jparse

    def run(fn):
        try:
            return ("ok", fn(spec))
        except Exception as e:                               # noqa: BLE001
            return (type(e).__name__, str(e))
    assert run(parse_profile_iters) == run(jparse)


def test_config_validates_profile_iters():
    with pytest.raises(LightGBMError, match="tpu_profile_iters"):
        lgt.Config.from_params({"tpu_profile_iters": "7"})
    assert lgt.Config.from_params(
        {"tpu_profile_iters": "2:5"}).tpu_profile_iters == "2:5"


def test_waves_for_tree_matches_jax_on_a_grid():
    from lightgbm_tpu.grower import waves_for_tree as jwaves
    from lightgbm_tpu_torch.grower import waves_for_tree
    grid = [(nl, w, s) for nl in (1, 2, 7, 26, 31, 255, 256)
            for w in (0, 1, 2, 6, 25, 40) for s in (1, 6, 25)]
    assert [waves_for_tree(*g) for g in grid] == [jwaves(*g) for g in grid]
    assert waves_for_tree(255, 0, 25) == 11


def test_phase_breakdown_schema_matches_jax(clean_registry):
    from lightgbm_tpu.observability.phases import PhaseBreakdown as JPB
    dicts = []
    for make in (PhaseBreakdown, JPB):
        pb = make("unit")
        with pb.compile_window():
            pass
        with pb.steady_window(iters=4):
            pass
        pb.attach_guard({"host_syncs": 1, "post_warmup_cache_misses": 0})
        dicts.append(pb.to_dict())
    assert set(dicts[0]) == set(dicts[1]) == {
        "compile_s", "steady_s", "steady_iters", "steady_s_per_iter",
        "host_syncs", "post_warmup_cache_misses"}
    assert dicts[0]["steady_iters"] == dicts[1]["steady_iters"] == 4
    gauges = obs.get_registry().snapshot()["gauges"]
    assert gauges["phase.unit.steady_iters"] == 4
    jobs.reset_for_tests()


def test_phase_breakdown_reexported():
    from lightgbm_tpu_torch.utils.timer import PhaseBreakdown as FromTimer
    assert FromTimer is PhaseBreakdown is obs.PhaseBreakdown


def test_read_jsonl_torn_line_matches_jax(tmp_path):
    from lightgbm_tpu.observability.export import read_jsonl as jread
    path = tmp_path / "e.jsonl"
    path.write_text('{"a": 1}\n\n{"b": [1, 2]}\n{"c": 3, "d"')
    assert read_jsonl(str(path)) == jread(str(path)) == [{"a": 1},
                                                          {"b": [1, 2]}]
    assert read_jsonl(str(tmp_path / "missing.jsonl")) == []


def test_timers_summary_matches_jax():
    from lightgbm_tpu.utils.timer import Timers as JTimers
    texts = []
    for make in (Timers, JTimers):
        t = make()
        t.acc.update({"train_step": 1.25, "metric_eval": 0.5})
        t.cnt.update({"train_step": 4, "metric_eval": 2})
        texts.append(t.summary())
        t.reset()
        texts.append(t.summary())
    assert texts[0] == texts[2] and texts[1] == texts[3]


def test_timers_accumulate_and_summarize():
    t = Timers()
    t.enabled = True
    with t("phase_a"):
        pass
    with t("phase_a"):
        pass
    with t("phase_b"):
        pass
    assert t.cnt["phase_a"] == 2 and t.cnt["phase_b"] == 1
    s = t.summary()
    assert "phase_a" in s and "x2" in s
    t.reset()
    assert t.summary().startswith("TIMETAG: (no phases")


def test_train_records_phases():
    TIMERS.reset()
    prev = TIMERS.enabled
    try:
        X, y = _data(300, 4)
        lgt.train(dict(PARAMS, tpu_time_tag=True, metric="binary_logloss"),
                  lgt.Dataset(X, label=y), num_boost_round=2,
                  valid_sets=[lgt.Dataset(X[:50], label=y[:50])],
                  verbose_eval=False)
        assert TIMERS.cnt["train_step"] == 2
        assert TIMERS.cnt["dataset_construct"] >= 1
        assert TIMERS.cnt["finalize_fetch"] >= 1
        assert TIMERS.cnt["metric_eval"] == 2
    finally:
        TIMERS.enabled = prev
        TIMERS.reset()


# --------------------------------------------------------- tracer, export

def test_tracer_disabled_is_a_noop():
    t = SpanTracer()
    with t.span("a", k=1):
        pass
    t.event("e")
    t.derive_children("a", "b", [1])
    assert t.events() == []


def test_tracer_subdivide_and_derive():
    """``derive_children`` slices each parent into its count of derived
    children, inside the parent, once per parent."""
    t = SpanTracer()
    t.enabled = True
    for it in range(8, 12):
        with t.span("iteration", iteration=it):
            pass
    t.derive_children("iteration", "wave", [2, 1, 1, 3])
    waves = [e for e in t.events() if e["name"] == "wave"]
    assert [e["args"]["wave"] for e in waves] == [0, 1, 0, 0, 0, 1, 2]
    assert all(e["args"]["derived"] for e in waves)
    parents = [e for e in t.events() if e["name"] == "iteration"]
    assert all(p["ts"] <= w["ts"] <= p["ts"] + p["dur"]
               for p, w in zip([parents[0]] * 2 + parents[1:3]
                               + [parents[3]] * 3, waves))
    t.derive_children("iteration", "wave", [2, 1, 1, 3])
    assert len([e for e in t.events() if e["name"] == "wave"]) == 7


@pytest.mark.parametrize("tracer_on", [True, False])
def test_span_is_a_profiler_range_on_the_profilers_clock(tracer_on):
    """While a torch.profiler records, a span opens a range of its name,
    with the tracer off too; the tracer's ``ts`` is the range's start on
    the same clock (unix-epoch microseconds)."""
    from torch.profiler import ProfilerActivity, profile
    t = SpanTracer()
    t.enabled = tracer_on
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first range pays a one-time set-up of about a
        # millisecond between the range's start and the tracer's
        with t.span("unit.first"):
            pass
        with t.span("unit.span", k=1):
            torch.zeros(4).add_(1)
    ranges = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name() == "unit.span"]
    assert len(ranges) == 1
    if tracer_on:
        rec = t.events()[-1]
        assert rec["name"] == "unit.span"
        assert abs(rec["ts"] - ranges[0].start_ns() / 1e3) < 1e3
        assert abs(rec["dur"] - ranges[0].duration_ns() / 1e3) < 1e3
    else:
        assert t.events() == []


def test_span_is_the_shared_noop_without_tracer_or_profiler():
    from lightgbm_tpu_torch.observability.tracer import _NULL_SPAN
    t = SpanTracer()
    assert t.span("a", k=1) is _NULL_SPAN
    assert obs.span("a") is _NULL_SPAN or obs.enabled()


def _contains(outer, inner):
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1)


def test_predict_records_a_span_set_per_chunk(clean_registry):
    """``Booster.predict`` on the device route (the CPU here) records
    ``predict`` holding, per chunk of 65,536 rows, one upload / encode /
    walk / fetch, and one ``predict.convert``."""
    from lightgbm_tpu_torch.basic import DEVICE_PREDICT_MIN_WORK
    bst = _train(dict(PARAMS), 16)
    rows = 70_000
    assert rows * bst.num_trees() >= DEVICE_PREDICT_MIN_WORK
    X = np.random.RandomState(3).rand(rows, 5)
    obs.configure(enabled=True)
    out = bst.predict(X)
    np.testing.assert_array_equal(out, bst.predict(X,
                                                   force_host_predict=True))
    ev = [e for e in obs.get_tracer().events() if e["ph"] == "X"]
    top = [e for e in ev if e["name"] == "predict"]
    assert [e["args"] for e in top] == [
        {"rows": rows, "trees": 16, "route": "device"},
        {"rows": rows, "trees": 16, "route": "host"}]
    call = top[0]
    inner = [e for e in ev if _contains(call, e) and e is not call]
    names = [e["name"] for e in inner]
    assert names == ["predict.upload", "predict.encode", "predict.walk",
                     "predict.fetch"] * 2 + ["predict.convert"]
    assert [e["args"]["rows"] for e in inner
            if e["name"] == "predict.encode"] == [65_536, rows - 65_536]


@pytest.fixture(scope="module")
def batch_of_four(tmp_path_factory):
    obs.reset_for_tests()
    try:
        obs.configure(enabled=True)
        X, y = _data()
        lgt.train(dict(PARAMS, tree_batch=4), lgt.Dataset(X, label=y),
                  num_boost_round=4)
        return [e for e in obs.get_tracer().events() if e["ph"] == "X"]
    finally:
        obs.reset_for_tests()


def test_construct_records_find_bins_inside_it(batch_of_four):
    (construct,) = [e for e in batch_of_four if e["name"] == "construct"]
    (find,) = [e for e in batch_of_four
               if e["name"] == "construct.find_bins"]
    (binning,) = [e for e in batch_of_four if e["name"] == "construct.bin"]
    assert _contains(construct, find) and _contains(construct, binning)
    assert find["args"] == {"features": 5}
    (place,) = [e for e in batch_of_four if e["name"] == "construct.place"]
    assert place["ts"] >= construct["ts"] + construct["dur"]


def test_batch_records_real_iteration_spans(batch_of_four):
    (batch,) = [e for e in batch_of_four if e["name"] == "tree_batch"]
    iters = [e for e in batch_of_four if e["name"] == "iteration"]
    assert batch["args"]["k"] == 4
    # real spans: no "derived" mark (publish marks the waves derived)
    assert [e["args"] for e in iters] == [
        {"iteration": i, "waves_derived": True} for i in range(4)]
    assert all(_contains(batch, e) for e in iters)
    assert all(e["cat"] == "lightgbm_tpu" for e in iters)
    starts = [e["ts"] for e in iters]
    assert starts == sorted(starts)
    assert all(a["ts"] + a["dur"] <= b["ts"] + 1
               for a, b in zip(iters, iters[1:]))


class _FakeEvent:
    """A CUDA timing event on a hand-set clock (``now``, ms)."""
    now = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = _FakeEvent.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_part_clock_times_segments_between_marks(clean_registry,
                                                 monkeypatch):
    """The captured iteration's clock: each mark closes the segment from
    the previous one into its part; ``None`` segments (the host's time
    past a flag read) count nowhere; the flag read's own event is adopted
    and never pooled; an iteration is published at its ``end`` mark, and
    an untimed one, which only drains, adds nothing; events are reused."""
    from lightgbm_tpu_torch.boosting.gbdt import _PartClock
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    clock = _PartClock()
    ready = _FakeEvent(enable_timing=True)

    def at(t, part=None, end=False):
        _FakeEvent.now = t
        clock.mark(part, end)

    def flag_read(t):
        _FakeEvent.now = t
        ready.record()
        clock.mark("waves", event=ready)
        clock.drain()

    for base, timed in ((0.0, True), (100.0, True), (200.0, False),
                        (300.0, True)):
        if not timed:
            clock.drain()                               # its flag read
            continue
        at(base)                                        # before start
        at(base + 1, "start")
        at(base + 3, "prologue")
        at(base + 4)                                    # round 1
        flag_read(base + 10)
        at(base + 12)                                   # round 2
        flag_read(base + 15)
        at(base + 17)                                   # past the wait
        at(base + 18, "epilogue", True)
    clock.finish()
    snap = obs.get_registry().snapshot()
    assert snap["counters"]["iteration.timed"] == 3
    hist = snap["histograms"]
    for part, ms in (("start", 1), ("prologue", 2), ("waves", 9),
                     ("epilogue", 1)):
        assert hist[f"iteration.device_ms.{part}"]["count"] == 3
        assert hist[f"iteration.device_ms.{part}"]["sum"] == 3 * ms
    # the most in flight between two flag reads: an iteration's two last
    # marks and the next one's four before its read; ``ready`` is apart
    assert _FakeEvent.made == 1 + 6
    assert ready not in clock._free


def test_chrome_trace_write_is_valid_and_atomic(tmp_path):
    t = SpanTracer()
    t.enabled = True
    with t.span("a"):
        pass
    path = write_chrome_trace(t.events(), str(tmp_path / "trace.json"),
                              metadata={"x": 1})
    doc = json.load(open(path))
    assert doc["traceEvents"] and doc["otherData"] == {
        "x": 1, "producer": "lightgbm_tpu_torch"}
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_flush_appends_jsonl_incrementally(telemetry):
    with obs.span("s"):
        pass
    obs.inc("c")
    trace = obs.flush()
    assert os.path.exists(trace)
    recs = read_jsonl(obs.jsonl_path())
    assert any(r.get("type") == "span" and r["name"] == "s" for r in recs)
    assert [r for r in recs
            if r.get("type") == "counters"][-1]["counters"]["c"] == 1
    obs.flush()                         # no new events -> no duplicate spans
    recs2 = read_jsonl(obs.jsonl_path())
    assert len([r for r in recs2 if r.get("type") == "span"]) == 1
    assert len([r for r in recs2 if r.get("type") == "counters"]) == 2


# ------------------------------------------------------------------ profiler

class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: records start / stop /
    export calls."""
    calls = []

    def __init__(self, activities=None, **kw):
        self.activities = activities

    def start(self):
        _FakeProfile.calls.append("start")

    def stop(self):
        _FakeProfile.calls.append("stop")

    def export_chrome_trace(self, path):
        _FakeProfile.calls.append(("export", os.path.basename(path)))
        with open(path, "w") as fh:
            fh.write('{"traceEvents": []}')


@pytest.fixture
def fake_profiler(monkeypatch):
    import torch.profiler
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile.calls


def _edges(calls):
    return [c for c in calls if c in ("start", "stop")]


def test_profile_window_needs_an_output_dir():
    assert not ProfileWindow("2:4", "").enabled
    assert ProfileWindow("2:4", "d").enabled
    assert not ProfileWindow("", "d").enabled


def test_profile_window_ticks(fake_profiler, tmp_path):
    pw = ProfileWindow("2:4", str(tmp_path))
    for it in range(6):
        pw.before_step(it)
        pw.after_step(it + 1)
    pw.close()
    assert _edges(fake_profiler) == ["start", "stop"]
    assert (pw.started_at, pw.stopped_at) == (2, 4)
    assert fake_profiler[-1] == ("export",
                                 f"torch_profile_{os.getpid()}.json")
    assert os.path.exists(pw.trace_path)


def test_profile_window_inside_one_batch(fake_profiler, tmp_path):
    pw = ProfileWindow("2:6", str(tmp_path))
    pw.before_step(0, batch=8)          # [0,8) overlaps [2,6)
    pw.after_step(8)
    pw.close()
    assert _edges(fake_profiler) == ["start", "stop"]
    fake_profiler.clear()
    pw2 = ProfileWindow("3:20", str(tmp_path))
    pw2.before_step(0, batch=8)
    pw2.after_step(8)
    pw2.before_step(8, batch=8)
    pw2.after_step(16)
    pw2.close()                         # started at batch 0, closed at exit
    assert _edges(fake_profiler) == ["start", "stop"]
    assert pw2.stopped_at == -1


def test_profile_window_resumed_past_window(fake_profiler, tmp_path):
    pw = ProfileWindow("2:4", str(tmp_path))
    for it in range(10, 12):            # resume landed past the window
        pw.before_step(it)
        pw.after_step(it + 1)
    pw.close()
    assert fake_profiler == []


def test_profile_window_covers_the_graph_capture(fake_profiler, tmp_path):
    """The window starts where it overlaps, the capture's iteration
    included: the profiler may be active across a CUDA graph capture (the
    card's check is chip_smoke.py phase 20's 0:3 arm)."""
    import inspect
    pw = ProfileWindow("0:3", str(tmp_path))
    for it in range(4):
        pw.before_step(it, 1)
        pw.after_step(it + 1)
    assert (pw.started_at, pw.stopped_at) == (0, 3)
    assert "capture" not in inspect.signature(pw.before_step).parameters


def test_train_profile_window_batch_aligned(fake_profiler, tmp_path,
                                            clean_registry):
    """tpu_profile_iters under tree_batch: the profiler starts at the first
    overlapping batch and stops at the first boundary at or past stop —
    one start/stop pair, never a split batch; the window's trace lands in
    tpu_profile_dir and its edges in the span trace."""
    out = tmp_path / "prof"
    p = dict(PARAMS, tree_batch=2, tpu_profile_iters="3:5",
             tpu_profile_dir=str(out), telemetry_dir=str(tmp_path / "tel"))
    _train(p, 8)
    assert _edges(fake_profiler) == ["start", "stop"]
    assert os.listdir(out) == [f"torch_profile_{os.getpid()}.json"]
    edges = {e["name"]: e["args"]["iteration"]
             for e in obs.get_tracer().events()
             if e["name"].startswith("profiler_window")}
    assert edges == {"profiler_window_start": 2, "profiler_window_stop": 6}


def test_profile_window_defaults_under_telemetry_dir(fake_profiler,
                                                     tmp_path,
                                                     clean_registry):
    p = dict(PARAMS, tpu_profile_iters="0:1",
             telemetry_dir=str(tmp_path / "tel"))
    _train(p, 2)
    assert _edges(fake_profiler) == ["start", "stop"]
    assert os.listdir(tmp_path / "tel" / "xprof") == [
        f"torch_profile_{os.getpid()}.json"]


def test_whole_run_trace_under_tpu_profile_dir(tmp_path, clean_registry):
    """tpu_profile_dir alone: one torch.profiler trace of the whole run."""
    _train(dict(PARAMS, tpu_profile_dir=str(tmp_path)), 2)
    name = f"torch_trace_{os.getpid()}.json"
    assert os.listdir(tmp_path) == [name]
    assert "traceEvents" in json.load(open(tmp_path / name))


# ---------------------------------------------------- training parity (JAX)

PARITY = dict(objective="binary", num_leaves=7, max_bin=15,
              min_data_in_leaf=5, verbose=-1, metric="binary_logloss",
              tree_batch=2, tpu_wave_size=2)
PARITY_ROUNDS = 6


def _recorded(events, snap):
    names = {}
    for e in events:
        if e.get("ph") == "X":
            names[e["name"]] = names.get(e["name"], 0) + 1
    init = next(e["args"] for e in events if e["name"] == "booster_init")
    return dict(spans=names, trained=snap["counters"]["trees.trained"],
                routed=snap["counters"]["rows.routed"],
                waves=snap["histograms"]["tree.waves"],
                leaves=snap["histograms"]["tree.leaves"], init=init)


@pytest.fixture(scope="module")
def jax_recording(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_tel"))
    X, y = _data()
    jobs.reset_for_tests()
    try:
        p = dict(PARITY, telemetry_dir=d)
        ds = lgb.Dataset(X, label=y, params=p)
        lgb.train(p, ds, num_boost_round=PARITY_ROUNDS,
                  valid_sets=[lgb.Dataset(X[:100], label=y[:100],
                                          reference=ds)],
                  verbose_eval=False)
        events = json.load(open(jobs.trace_path()))["traceEvents"]
        return _recorded(events, jobs.snapshot())
    finally:
        jobs.reset_for_tests()


@pytest.fixture(scope="module")
def port_recording(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_tel"))
    X, y = _data()
    obs.reset_for_tests()
    try:
        p = dict(PARITY, telemetry_dir=d, device="cpu")
        ds = lgt.Dataset(X, label=y)
        lgt.train(p, ds, num_boost_round=PARITY_ROUNDS,
                  valid_sets=[lgt.Dataset(X[:100], label=y[:100],
                                          reference=ds)],
                  verbose_eval=False)
        events = json.load(open(obs.trace_path()))["traceEvents"]
        rec = _recorded(events, obs.snapshot())
        rec["events"] = events
        rec["files"] = sorted(os.listdir(d))
        return rec
    finally:
        obs.reset_for_tests()


def test_train_spans_match_jax(jax_recording, port_recording):
    """The spans of the JAX package's names match it; the port's own
    (``construct*``, ``eval.*``) are held apart."""
    spans = {k: v for k, v in port_recording["spans"].items()
             if k in jax_recording["spans"]}
    assert spans == jax_recording["spans"]
    assert spans["train"] == 1 and spans["tree_batch"] == 3
    assert spans["iteration"] == PARITY_ROUNDS and spans["eval"] == 3
    assert spans["wave"] == sum(
        [3] * PARITY_ROUNDS)             # waves_for_tree(7, 2, 6)
    own = {k: v for k, v in port_recording["spans"].items()
           if k not in jax_recording["spans"]}
    # two constructs (train, valid), one mapper finding and ingest
    # decision, both binned and placed; the booster's EFB plan (which
    # bundles nothing here); binary_logloss reduces on the device: one
    # fetch an eval
    assert own == {"construct": 2,
                   "construct.find_bins": 1, "construct.defer": 1,
                   "construct.bin": 2, "construct.plan_bundles": 1,
                   "construct.place": 2, "eval.fetch": 3}


def test_train_counters_and_histograms_match_jax(jax_recording,
                                                 port_recording):
    for key in ("trained", "routed", "waves", "leaves"):
        assert port_recording[key] == jax_recording[key], key
    assert port_recording["trained"] == PARITY_ROUNDS
    assert port_recording["routed"] == PARITY_ROUNDS * 400


def test_booster_init_matches_jax(jax_recording, port_recording):
    ours, theirs = port_recording["init"], jax_recording["init"]
    assert set(ours) == set(theirs)
    assert ours["kernel"] == "plain" and theirs["kernel"] == "xla"
    for key in ("tree_batch", "rows", "features", "num_leaves", "strategy",
                "nan_policy", "residency"):
        assert ours[key] == theirs[key], key


def test_train_spans_nest(port_recording):
    ev = port_recording["events"]

    def contains(outer, inner):
        return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"] + 1)
    spans = [e for e in ev if e.get("ph") == "X"]
    train = next(e for e in spans if e["name"] == "train")
    batches = [e for e in spans if e["name"] == "tree_batch"]
    iters = [e for e in spans if e["name"] == "iteration"]
    waves = [e for e in spans if e["name"] == "wave"]
    assert all(contains(train, b) for b in batches)
    assert all(any(contains(b, i) for b in batches) for i in iters)
    assert all(any(contains(i, w) for i in iters) for w in waves)
    assert all(w["args"]["derived"] for w in waves)
    assert port_recording["files"] == sorted(
        f"{k}_{os.getpid()}.{x}" for k, x in
        (("events", "jsonl"), ("snapshot", "json"), ("trace", "json")))


# ------------------------------------------------ the port's own behaviour

def test_telemetry_dir_param_configures(clean_registry, tmp_path):
    _train(dict(PARAMS, telemetry_dir=str(tmp_path / "tel")), 2)
    assert obs.enabled() and obs.telemetry_dir() == str(tmp_path / "tel")
    assert os.path.exists(obs.trace_path())
    snap = json.load(open(tmp_path / "tel" / f"snapshot_{os.getpid()}.json"))
    assert snap["counters"]["trees.trained"] == 2


def test_env_var_configures(clean_registry, tmp_path, monkeypatch):
    monkeypatch.setenv(obs.ENV_TELEMETRY_DIR, str(tmp_path / "envtel"))
    _train(dict(PARAMS), 2)
    assert obs.telemetry_dir() == str(tmp_path / "envtel")
    assert os.path.exists(obs.trace_path())
    assert obs.ENV_TELEMETRY_DIR == jobs.ENV_TELEMETRY_DIR


def test_registry_live_without_telemetry_dir(clean_registry):
    """The serving snapshot works with span recording off — and no trace or
    JSONL files are implied; no leaf counts are fetched."""
    _train(dict(PARAMS), 3)
    assert not obs.enabled()
    assert obs.trace_path() is None and obs.flush() is None
    snap = obs.snapshot()
    assert snap["counters"]["trees.trained"] == 3
    assert snap["counters"]["rows.routed"] == 3 * 400
    assert snap["counters"]["booster.kernel.plain"] == 1
    assert snap["spans_recorded"] == 0
    assert "tree.waves" not in snap["histograms"]


def test_resume_counts_only_new_iterations(clean_registry, tmp_path):
    params = dict(PARAMS, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_interval=2)
    _train(params, 4)
    assert obs.snapshot()["counters"]["trees.trained"] == 4
    _train(params, 8, resume_from="auto")
    snap = obs.snapshot()["counters"]
    assert snap["trees.trained"] == 8            # 4 first run + 4 NEW
    assert snap["rows.routed"] == 8 * 400


def test_flush_on_failed_training(telemetry):
    """nan_policy=raise aborts the run: the finally-path flush still leaves
    a readable trace with the train span and the nan counters."""
    from lightgbm_tpu_torch.robustness.chaos import nan_gradient_fobj
    from lightgbm_tpu_torch.robustness.numeric import NonFiniteError
    params = dict(objective="none", verbose=-1, metric="none",
                  boost_from_average=False, nan_policy="raise",
                  num_leaves=7, min_data_in_leaf=5, device="cpu")
    with pytest.raises(NonFiniteError):
        _train(params, 6, fobj=nan_gradient_fobj(bad_iters=[2]))
    events = json.load(open(obs.trace_path()))["traceEvents"]
    assert any(e["name"] == "train" for e in events)
    assert any(e["name"] == "nan_policy" for e in events)
    assert any(e["name"] == "tree_batch" and e["args"].get("custom_fobj")
               for e in events)
    assert obs.snapshot()["counters"]["nan.raised"] == 1
    assert os.path.exists(os.path.join(obs.telemetry_dir(),
                                       f"snapshot_{os.getpid()}.json"))


def test_observability_keys_are_not_ignored(clean_registry, tmp_path,
                                            caplog):
    """tpu_time_tag, tpu_profile_dir, tpu_profile_iters and
    tpu_cost_analysis are honoured: none logs "ignored" any longer (a
    TPU-only key still does)."""
    from lightgbm_tpu_torch.config import TPU_ONLY_KEYS
    keys = ("tpu_time_tag", "tpu_profile_dir", "tpu_profile_iters",
            "tpu_cost_analysis")
    assert not set(keys) & set(TPU_ONLY_KEYS)
    prev = TIMERS.enabled
    try:
        with caplog.at_level(logging.INFO, logger="lightgbm_tpu_torch"):
            _train(dict(PARAMS, verbose=1, tpu_time_tag=True,
                        tpu_profile_dir=str(tmp_path / "p"),
                        tpu_profile_iters="0:1", tpu_cost_analysis=True,
                        tpu_hist_f64=True), 1)
    finally:
        TIMERS.enabled = prev
        TIMERS.reset()
    ignored = [r.getMessage() for r in caplog.records
               if "ignored" in r.getMessage()]
    assert ignored == ["tpu_hist_f64=True has no meaning on the card; "
                       "ignored"]
    assert any("TIMETAG phase summary" in r.getMessage()
               for r in caplog.records)


def test_cli_passes_the_observability_keys():
    from lightgbm_tpu_torch.cli import parse_args
    params = parse_args(["--tpu-profile-iters=1:3", "tpu_time_tag=true",
                         "--tpu-cost-analysis=true",
                         "--tpu-profile-dir=/data/run-1"])
    cfg = lgt.Config.from_params(params)
    assert (cfg.tpu_profile_iters, cfg.tpu_time_tag, cfg.tpu_cost_analysis,
            cfg.tpu_profile_dir) == ("1:3", True, True, "/data/run-1")


def test_snapshot_does_not_initialise_cuda(clean_registry):
    from lightgbm_tpu_torch.observability.memory import device_memory
    assert device_memory() == {}
    assert "device_memory" not in obs.snapshot()
    assert not torch.cuda.is_initialized()


def test_observability_modules_import_no_jax():
    import subprocess
    import sys
    code = ("import sys, lightgbm_tpu_torch.observability.export, "
            "lightgbm_tpu_torch.observability.phases, "
            "lightgbm_tpu_torch.observability.costs, "
            "lightgbm_tpu_torch.observability.profiler, "
            "lightgbm_tpu_torch.observability.ledger, "
            "lightgbm_tpu_torch.observability.memory, "
            "lightgbm_tpu_torch.utils.timer\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
