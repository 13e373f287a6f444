"""``lightgbm_tpu_torch.analysis.CaptureGuard`` on the CPU: the port's
counterpart of the JAX package's ``RecompileGuard``
(``lightgbm_tpu/analysis/guards.py``), counting CUDA graph captures after
warm-up as its cache misses and host syncs — on the CPU the op-trace
recorder's host transfers (on the card the calls
``torch.cuda.set_sync_debug_mode`` flags: ``chip_smoke.py`` phase 22).

- the report's schema is ``RecompileGuard``'s;
- a capture after ``mark_warm`` on a fake capturer raises
  ``GuardViolation`` (or is recorded with ``fail=False``);
- the recorder counts ``.item()`` / ``int(t)`` / ``.tolist()`` in a
  planted loop, warm-up excluded, and ``disallow_transfers`` raises where
  the read happens;
- ``PhaseBreakdown.attach_guard(guard.report())`` round-trips, in the
  port's and in the JAX package's breakdown alike;
- the serving engine and the captured iteration expose the counts the
  guard reads.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.analysis.guards import RecompileGuard
from lightgbm_tpu.observability.phases import PhaseBreakdown as JaxBreakdown
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.analysis import (CaptureGuard, GuardViolation,
                                         capture_guard)
from lightgbm_tpu_torch.observability.phases import PhaseBreakdown

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


class FakeCapturer:
    """Anything with a ``captures`` count (and optionally ``syncs``)."""

    def __init__(self):
        self.captures = 0
        self.syncs = 0

    def capture(self):
        self.captures += 1


class MethodCapturer:
    """``captures()`` as a method, as ``ServingEngine`` exposes it."""

    def __init__(self):
        self.n = 0

    def captures(self):
        return self.n


def test_report_schema_equals_recompile_guards():
    ours = CaptureGuard("train", device="cpu")
    ours.register(FakeCapturer(), "iteration")
    with ours:
        ours.mark_warm()
    theirs = RecompileGuard("train").report()
    mine = ours.report()
    assert set(mine) == set(theirs)
    assert {k: type(v) for k, v in mine.items() if v is not None} == \
        {k: type(v) for k, v in theirs.items() if v is not None} | \
        {"transfer_counting": bool}
    assert mine["misses_by_entrypoint"] == {"iteration": 0}
    assert mine["warm_marked"] is True and mine["transfer_counting"] is True


def test_post_warm_capture_raises():
    cap = FakeCapturer()
    guard = CaptureGuard("train", device="cpu")
    guard.register(cap, "iteration")
    with pytest.raises(GuardViolation, match="1 CUDA graph capture"):
        with guard:
            cap.capture()               # warm-up: allowed
            guard.mark_warm()
            cap.capture()
    assert guard.report()["post_warmup_cache_misses"] == 1
    assert guard.report()["misses_by_entrypoint"] == {"iteration": 1}


def test_warm_up_captures_pass_and_fail_false_records():
    cap, meth = FakeCapturer(), MethodCapturer()
    with capture_guard([cap], warm=False, device="cpu") as g:
        g.register(meth, "engine")
        cap.capture()
        meth.n += 2
    assert g.report()["warm_marked"] is False
    guard = CaptureGuard("soft", fail=False, device="cpu")
    guard.register(meth, "engine")
    with guard:
        guard.mark_warm()
        meth.n += 1
    assert guard.report()["misses_by_entrypoint"] == {"engine": 1}


def test_a_guard_never_swallows_the_blocks_exception():
    with pytest.raises(KeyError):
        with CaptureGuard(device="cpu"):
            raise KeyError("inside")


def test_register_rejects_objects_without_captures():
    with pytest.raises(TypeError, match="captures"):
        CaptureGuard(device="cpu").register(object())
    CaptureGuard(device="cpu").register(None)       # ignored


def test_recorder_counts_host_syncs_in_a_planted_loop():
    t = torch.arange(8.0)
    cap = FakeCapturer()
    guard = CaptureGuard("loop", device="cpu")
    guard.register(cap, "fake")
    with guard:
        t.sum().item()                  # warm-up: not counted
        guard.mark_warm()
        for i in range(5):
            t[i].item()
        for i in range(3):
            int(t[i])
        t.tolist()
        (t * 2).sum()                   # no sync
        cap.syncs += 2                  # explicit reads the owner counts
    assert guard.report()["host_syncs"] == 5 + 3 + 1 + 2
    assert guard.host_syncs == 11


def test_disallow_transfers_raises_where_the_read_happens():
    t = torch.arange(4.0)
    with pytest.raises(GuardViolation, match="host sync"):
        with CaptureGuard("strict", disallow_transfers=True, device="cpu"):
            t.sum()
            t.sum().item()


def test_attach_guard_round_trips_in_both_breakdowns():
    cap = FakeCapturer()
    guard = CaptureGuard("headline", fail=False, device="cpu")
    guard.register(cap, "iteration")
    with guard:
        guard.mark_warm()
        cap.capture()
        torch.ones(2).sum().item()
    report = guard.report()
    for pb in (PhaseBreakdown("headline"), JaxBreakdown("headline")):
        pb.attach_guard(report)
        assert pb.guard_report is report
        d = pb.to_dict()
        assert d["host_syncs"] == report["host_syncs"] == 1
        assert d["post_warmup_cache_misses"] == 1


def test_guard_publishes_into_the_registry():
    obs.reset_for_tests()
    cap = FakeCapturer()
    guard = CaptureGuard("pub", fail=False, device="cpu")
    guard.register(cap)
    with guard:
        guard.mark_warm()
        cap.capture()
        torch.ones(2).sum().item()
    snap = obs.snapshot()["counters"]
    assert snap["captures.post_warmup"] == 1
    assert snap["host_syncs"] == 1 and snap["guard.windows"] == 1
    obs.reset_for_tests()


def _small_booster():
    rng = np.random.RandomState(3)
    X = rng.rand(600, 5).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(600) > 0.6).astype(np.float32)
    return lgt.train({"objective": "binary", "device": "cpu",
                      "num_leaves": 7, "verbose": -1}, lgt.Dataset(X, label=y),
                     num_boost_round=3, keep_training_booster=True), X


def test_serving_engine_holds_no_capture_after_warmup():
    from lightgbm_tpu_torch.serving import ServingEngine
    bst, X = _small_booster()
    eng = ServingEngine(bst, params={"device": "cpu", "verbose": -1,
                                     "serve_buckets": "4,32"})
    guard = CaptureGuard("serve", device="cpu")
    guard.register(eng, "engine")
    with guard:
        guard.mark_warm()
        for n in (1, 3, 17, 32, 5):
            eng.predict(X[:n])
    rep = guard.report()
    assert rep["post_warmup_cache_misses"] == 0
    assert rep["host_syncs"] >= 5           # the walk's result, per request
    eng.close()


def test_the_captured_iteration_counts_its_captures():
    from lightgbm_tpu_torch.boosting.gbdt import _IterationGraphs
    bst, _ = _small_booster()
    graphs = _IterationGraphs(bst._gbdt)
    assert graphs.captures == 0 and graphs.syncs == 0
    guard = CaptureGuard(device="cpu")
    guard.register(graphs, "iteration")
    assert guard.report()["misses_by_entrypoint"] == {"iteration": 0}
