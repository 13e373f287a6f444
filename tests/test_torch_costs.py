"""Cost reports and device memory of ``lightgbm_tpu_torch``
(``observability/costs.py``, ``memory.py``; the reports' formulas in
``ops/cuda_histogram.py``, ``ops/predict.py``, ``ops/linear.py``) on the
CPU: the counterparts of the parts of ``tests/test_costs.py`` that are not
XLA goldens.

Pins:

- parity with the JAX package: ``costs.drift`` on the same dicts, and a
  report's field set (the schema ``report_from_compiled`` gives);
- the analytic reports: B1's pass cost at phase 3's ``full`` shape (the
  90,150,600 bytes ``chip_smoke.py``'s bound is computed from), each site
  computed once per shape class, gated on ``costs.enabled()`` unless
  called explicitly, a failure recorded, never raised;
- the booster's reports (``histogram.full.s<S>``, ``train_step.k<K>``,
  ``linear.fit.k<K>``, ``predict.forest_walk``) under
  ``tpu_cost_analysis``, scoped to the run;
- the pre-flight with valid sets priced, its gauges and budget line, the
  budget's fallbacks, ``device_memory()`` empty on the CPU;
- the snapshot plumbing: ``dump_snapshot``, the telemetry dir's snapshot,
  the trace's ``otherData.cost_reports``.

The JAX package is imported for its pure-host functions only: nothing
here compiles a JAX step.
"""
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.observability import costs as jcosts
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.observability import costs
from lightgbm_tpu_torch.observability.memory import (device_memory,
                                                     estimate_residency,
                                                     hbm_budget_bytes,
                                                     hbm_preflight,
                                                     log_budget)
from lightgbm_tpu_torch.ops.cuda_histogram import (BYTES_PER_BIN,
                                                   histogram_cost_report,
                                                   histogram_pass_cost)

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)


@pytest.fixture
def cost_capture():
    """Fresh observability singletons with cost capture forced on."""
    obs.reset_for_tests()
    costs.configure(enabled=True)
    yield costs
    obs.reset_for_tests()


def _data(n=2048, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0.65).astype(np.float32)
    return X, y


PARAMS = dict(objective="binary", num_leaves=15, max_bin=31,
              min_data_in_leaf=5, verbose=-1, metric="none", tree_batch=2,
              device="cpu")


def _booster(n=2048, f=8, params=None):
    X, y = _data(n, f)
    p = dict(PARAMS, **(params or {}))
    return lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y))


# ---------------------------------------------------------- parity (JAX)

DRIFT_CASES = [
    ({"flops": 100.0, "bytes_accessed": None}, {"flops": 100.0}),
    ({"flops": 100.0}, {"flops": 120.0}),
    ({"flops": 100.0}, {"flops": 300.0}),
    ({"flops": 100.0, "bytes_accessed": None}, {"bytes_accessed": 50.0}),
    ({"flops": 100.0}, {"flops": 120.0, "rel_tol": 0.1}),
    ({"flops": 0.0}, {"flops": 0.0}),
    ({"flops": 5.0, "bytes_accessed": 9.0},
     {"flops": 4.0, "bytes_accessed": 20.0}),
]


@pytest.mark.parametrize("rep,golden", DRIFT_CASES)
def test_drift_matches_jax(rep, golden):
    assert costs.drift(rep, golden) == jcosts.drift(rep, golden)


def test_drift_bands():
    rep = {"flops": 100.0, "bytes_accessed": None}
    assert costs.drift(rep, {"flops": 120.0}) == {}          # within 35%
    assert "flops" in costs.drift(rep, {"flops": 300.0})
    assert "bytes_accessed" in costs.drift(rep, {"bytes_accessed": 50.0})


def test_report_schema_matches_jax():
    class _NoAnalyses:
        def cost_analysis(self):
            return None

        def memory_analysis(self):
            return None
    theirs = jcosts.report_from_compiled(_NoAnalyses(), "s", {"rows": 4})
    ours = costs.analytic_report("s", {"rows": 4})
    assert ours == theirs               # every field present, None here
    full = costs.analytic_report("s", flops=10, bytes_accessed=20,
                                 argument_bytes=3, output_bytes=4,
                                 temp_bytes=5)
    assert set(full) == set(theirs) - {"rows"}
    assert full["peak_hbm_bytes"] == 12
    assert full["transcendentals"] is None
    assert full["generated_code_bytes"] is None


# ------------------------------------------------------- analytic reports

def test_histogram_pass_cost_at_phase_3_full():
    """The formula chip_smoke.py's bound comes from: 90.2 MB and 0.02691 ms
    at 3.35 TB/s for the full wave at 2M x 28, B = 256, S = 25."""
    c = histogram_pass_cost(2_000_000, 28, 256, 25)
    assert c == {"bytes": 90_150_600, "operations": 168_000_000,
                 "output_bytes": 2_150_400}
    assert abs(c["bytes"] / 3.35e12 * 1e3 - 0.02691) < 5e-6
    wrapper = histogram_pass_cost(2_000_000, 28, 256, 25,
                                  derived_positions=True,
                                  total_rows=2_000_000, slot_table=256)
    assert wrapper["bytes"] == c["bytes"] - 2 * 25 * 4 + 256 * 4
    assert histogram_pass_cost(2_000_000, 28, 512, 25, 2)["bytes"] == \
        2_000_000 * (56 + 12) + 8_000_000 + 200 + 25 * 28 * 512 * 12


def test_histogram_report_explicit_and_once(cost_capture):
    costs.configure(enabled=False)
    rep = histogram_cost_report(4096, 8, 32, 14)      # explicit: runs
    assert rep["site"] == "histogram.full.s14"
    assert rep["bytes_accessed"] == histogram_pass_cost(
        4096, 8, 32, 14)["bytes"]
    assert rep["flops"] == 3 * 4096 * 8
    assert rep["temp_bytes"] == 14 * 8 * 32 * BYTES_PER_BIN
    assert rep["output_bytes"] == 14 * 8 * 32 * 3 * 4
    assert costs.report("histogram.full.s14") == rep
    assert histogram_cost_report(4096, 8, 32, 14, force=False) is None
    gauges = obs.snapshot()["gauges"]
    assert gauges["cost.histogram.full.s14.bytes_accessed"] == \
        rep["bytes_accessed"]


def test_capture_happens_once_per_shape_class(cost_capture):
    obs.configure(enabled=True)            # record the trace events
    calls = []

    def make():
        calls.append(1)
        return costs.analytic_report("site.a", flops=len(calls))
    first = costs.capture("site.a", make, fingerprint=(1, 2))
    again = costs.capture("site.a", make, fingerprint=(1, 2))
    assert len(calls) == 1 and first == again
    other = costs.capture("site.a", make, fingerprint=(3, 4))
    assert len(calls) == 2 and other["flops"] == 2
    names = [e["name"] for e in obs.get_tracer().events()]
    assert costs.report("site.a")["flops"] == 2
    assert obs.snapshot()["gauges"]["cost.site.a.flops"] == 2
    assert names.count("cost_report") == 2      # one per report made


def test_capture_disabled_is_noop():
    obs.reset_for_tests()
    try:
        assert not costs.enabled()
        bst = _booster()
        bst._gbdt.train_batch(2)
        assert costs.reports() == {}
        assert costs.capture("x", lambda: {"site": "x"}) is None
    finally:
        obs.reset_for_tests()


def test_capture_failure_records_error(cost_capture):
    def broken():
        raise TypeError("no report for you")
    rep = costs.capture("broken.site", broken)
    assert "no report for you" in rep["error"]
    assert costs.report("broken.site")["error"]


def test_env_knob_enables_capture(monkeypatch):
    obs.reset_for_tests()
    try:
        monkeypatch.setenv(costs.ENV_COST_ANALYSIS, "1")
        assert costs.enabled()
        costs.configure(enabled=False)
        assert not costs.enabled()
    finally:
        obs.reset_for_tests()


def test_booster_reports(cost_capture):
    bst = _booster()
    g = bst._gbdt
    g.train_batch(2)
    hist = costs.report(f"histogram.full.s{g.spec.hist_slots}")
    assert hist["rows"] == 2048 and hist["route"] == "plain"
    assert hist["bytes_accessed"] == histogram_pass_cost(
        2048, g._grower.X_hist.shape[1], g._grower.B_hist,
        g.spec.hist_slots)["bytes"]
    step = costs.report("train_step.k2")
    assert step["tree_batch"] == 2 and step["kernel"] == "plain"
    assert step["argument_bytes"] > 2048 * 8 and step["output_bytes"] > 0
    assert step["temp_bytes"] is None          # nothing captured on the CPU
    assert step["flops"] is None
    assert step["peak_hbm_bytes"] == step["argument_bytes"] + \
        step["output_bytes"]
    n_events = len([e for e in obs.get_tracer().events()
                    if e["name"] == "cost_report"])
    g.train_batch(2)                           # the same shape: no report
    assert len([e for e in obs.get_tracer().events()
                if e["name"] == "cost_report"]) == n_events


def test_cost_capture_scoped_to_the_run():
    """tpu_cost_analysis=true must not leak capture into later fits."""
    obs.reset_for_tests()
    try:
        X, y = _data()
        p = dict(PARAMS, tpu_cost_analysis=True)
        lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=2)
        assert costs.report("train_step.k2") is not None
        assert not costs.enabled()      # restored after the run
    finally:
        obs.reset_for_tests()


def test_predict_walk_report(cost_capture):
    from lightgbm_tpu_torch.ops.predict import (StackedForest,
                                                forest_cost_report,
                                                forest_predict_raw)
    bst = _booster()
    bst._gbdt.train_batch(2)
    bst._finalize()
    X, _ = _data(3000)
    forest = StackedForest(bst.trees, X.shape[1])
    forest_predict_raw(bst.trees, X, X.shape[1], torch.device("cpu"),
                       chunk_rows=1024, forest=forest)
    rep = costs.report("predict.forest_walk")
    T = len(bst.trees)
    assert rep["rows"] == 1024 and rep["trees"] == T
    assert rep["flops"] == 1024 * T * (forest.max_depth + 1)
    assert rep["output_bytes"] == 1024 * 8
    assert rep["bytes_accessed"] == rep["argument_bytes"] + \
        rep["output_bytes"]
    assert forest_cost_report(forest, 1024, "plain") == rep      # once


def test_linear_fit_report(cost_capture):
    from lightgbm_tpu_torch.ops.linear import linear_cost_report
    X, y = _data(1024, 4)
    p = dict(PARAMS, linear_tree=True, linear_max_features=3, tree_batch=1,
             objective="regression")
    bst = lgt.train(p, lgt.Dataset(X, label=X[:, 0] * 2.0 + y),
                    num_boost_round=1, keep_training_booster=True)
    rep = costs.report("linear.fit.k3")
    assert rep["rows"] == 1024 and rep["num_leaves"] == 15
    assert rep["flops"] > 2 * 16 * 1024 and rep["temp_bytes"] > 0
    assert bst._gbdt.linear_tree
    again = linear_cost_report(1024, 4, 15, 3, route="plain")
    assert again == rep


# ---------------------------------------------------------------- memory

def test_preflight_components_and_gauges(cost_capture):
    bst = _booster()
    g = bst._gbdt
    est = hbm_preflight(g)
    comp = est["components"]
    for key in ("codes", "per_row", "hist", "scan", "wave_rows"):
        assert comp[key] > 0, (key, comp)
    assert comp["valid"] == 0
    assert est["total_bytes"] == sum(comp.values())
    assert est["dims"]["rows"] == g.num_rows
    assert est["residency"] == "device"
    assert obs.snapshot()["gauges"]["memory.preflight.total_bytes"] == \
        est["total_bytes"]
    # the resident estimate the residency decision made, before any valid
    # set: the same numbers
    assert est["total_bytes"] == \
        g.residency_estimates["device"]["total_bytes"]
    X, y = _data(512)
    bst.add_valid(lgt.Dataset(X, label=y, reference=bst.train_dataset), "v")
    est2 = hbm_preflight(g)
    assert est2["components"]["valid"] == 512 * 8 + 512 * 4 * (3 + 2)
    assert est2["total_bytes"] == est["total_bytes"] + \
        est2["components"]["valid"]


def test_preflight_streamed(cost_capture):
    bst = _booster(params=dict(tpu_residency="stream",
                               tpu_stream_shard_rows=512, tree_batch=1))
    est = hbm_preflight(bst._gbdt)
    assert est["residency"] == "stream" and est["stream"]["n_shards"] == 4
    assert est["components"]["codes"] == \
        bst._gbdt.residency_estimates["stream"]["components"]["codes"]


def test_estimate_scales_linearly_in_rows():
    base = dict(cols=28, code_itemsize=1, num_models=1, num_leaves=255,
                hist_bins=256, slots=25)
    small = estimate_residency(rows=1_000_000, **base)
    big = estimate_residency(rows=10_000_000, **base)
    assert big["components"]["codes"] == 10 * small["components"]["codes"]
    assert big["components"]["hist"] == small["components"]["hist"]
    assert big["total_bytes"] > 5 * small["total_bytes"]


def test_budget_line_warns_over_capacity(caplog):
    est = {"components": {"codes": 2 << 30}, "total_bytes": 2 << 30}
    assert log_budget(est, {"capacity_bytes": 1 << 30,
                            "platform": "test"}) is False
    assert log_budget(est, {"capacity_bytes": 4 << 30,
                            "platform": "test"}) is True
    assert log_budget(est, {}) is True          # unknown capacity: no warn
    assert log_budget(est, {}, budget=1 << 30) is False


def test_budget_fallbacks(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_HBM_BUDGET", raising=False)
    assert hbm_budget_bytes(None) is None                 # CPU, no knob
    cfg = lgt.Config.from_params({"tpu_hbm_budget_bytes": 12345})
    assert hbm_budget_bytes(cfg) == 12345
    monkeypatch.setenv("LGBM_TPU_HBM_BUDGET", "2e9")
    assert hbm_budget_bytes(cfg) == 2_000_000_000


def test_device_memory_empty_on_the_cpu():
    assert device_memory() == {}
    assert device_memory("cpu") == {}
    assert not torch.cuda.is_initialized()


def test_train_logs_the_preflight(caplog):
    import logging
    obs.reset_for_tests()
    try:
        X, y = _data(512)
        with caplog.at_level(logging.INFO, logger="lightgbm_tpu_torch"):
            lgt.train(dict(PARAMS, verbose=1), lgt.Dataset(X, label=y),
                      num_boost_round=1)
        assert any(r.getMessage().startswith("HBM pre-flight:")
                   for r in caplog.records)
        assert obs.snapshot()["gauges"]["memory.preflight.total_bytes"] > 0
    finally:
        obs.reset_for_tests()


# ------------------------------------------------------- snapshot plumbing

def test_train_end_snapshot_dump(tmp_path):
    obs.reset_for_tests()
    try:
        X, y = _data()
        out = tmp_path / "snap.json"
        p = dict(PARAMS, dump_snapshot=str(out), tpu_cost_analysis=True)
        lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=2)
        snap = json.load(open(out))
        assert snap["counters"]["trees.trained"] == 2
        assert "train_step.k2" in snap["cost_reports"]
        assert "histogram.full.s14" in snap["cost_reports"]
        assert snap["gauges"]["memory.preflight.total_bytes"] > 0
        assert "device_memory" not in snap
    finally:
        obs.reset_for_tests()


def test_perfetto_metadata_carries_cost_reports(tmp_path, cost_capture):
    obs.configure(telemetry_dir=str(tmp_path))
    bst = _booster()
    bst._gbdt.train_batch(2)
    doc = json.load(open(obs.flush()))
    assert "train_step.k2" in doc["otherData"]["cost_reports"]
    assert doc["otherData"]["producer"] == "lightgbm_tpu_torch"
    snaps = [f for f in os.listdir(tmp_path) if f.startswith("events_")]
    assert snaps


def test_cli_bare_dump_snapshot_flag():
    from lightgbm_tpu.cli import parse_args as jparse
    from lightgbm_tpu_torch.cli import parse_args
    for argv in (["train", "--dump-snapshot"],
                 ["--dump-snapshot=/tmp/x.json"]):
        assert parse_args(argv) == jparse(argv)
