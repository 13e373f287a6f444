"""EFB's spans and registry entries in the PyTorch port (CPU): the
``construct.plan_bundles`` span and the ``efb.*`` gauges carry the plan
the booster trains on, an unbundled booster counts ``efb.unbundled`` and
sets no gauge, and ``construct.bin`` marks ``scipy.sparse`` input with the
values it stores (docs/Observability-torch.md)."""
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability as obs

torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
              device="cpu", verbose=-1, metric="none")


def _exclusive(n=1500, groups=4, per_group=6, seed=11):
    """Groups of mutually exclusive columns: a row holds one value (1-4)
    in one column of each group, and 0 in the rest."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, groups * per_group), np.float32)
    for g in range(groups):
        cols = g * per_group + rng.randint(0, per_group, n)
        X[np.arange(n), cols] = rng.randint(1, 5, n)
    y = (X[:, 0] + X[:, per_group + 1] > 2).astype(np.float32)
    return X, y


@pytest.fixture
def recorded():
    obs.reset_for_tests()
    obs.configure(enabled=True)
    yield obs
    obs.reset_for_tests()


def _spans(name):
    return [e for e in obs.get_tracer().events()
            if e["name"] == name and e["ph"] == "X"]


def test_a_bundled_csr_run_records_its_plan(recorded):
    X, y = _exclusive()
    train = lgt.Dataset(sp.csr_matrix(X[:1200]), label=y[:1200])
    valid = lgt.Dataset(sp.csr_matrix(X[1200:]), label=y[1200:],
                        reference=train)
    bst = lgt.train(dict(PARAMS, enable_bundle="true"), train,
                    num_boost_round=2, valid_sets=[valid],
                    keep_training_booster=True)
    plan = bst._gbdt.efb_plan
    assert plan is not None
    F, G = X.shape[1], plan.num_groups
    assert G < F
    (span,) = _spans("construct.plan_bundles")
    assert span["args"] == {"features": F, "bundles": G}
    snap = obs.get_registry().snapshot()
    assert {k: v for k, v in snap["gauges"].items()
            if k.startswith("efb.")} == {
        "efb.features": F, "efb.bundles": G,
        "efb.hist_bins": bst._gbdt.spec.hist_bins, "efb.code_bytes": 1,
        "efb.bundled_features": sum(len(g) for g in plan.groups
                                    if len(g) > 1)}
    assert "efb.unbundled" not in snap["counters"]


def test_construct_bin_marks_sparse_input_and_its_stored_values(recorded):
    X, y = _exclusive()
    train = lgt.Dataset(sp.csr_matrix(X[:1200]), label=y[:1200])
    train.construct(lgt.Config.from_params(PARAMS))
    lgt.Dataset(sp.csc_matrix(X[1200:]), label=y[1200:],
                reference=train).construct()
    lgt.Dataset(X[1200:], label=y[1200:], reference=train).construct()
    args = [e["args"] for e in _spans("construct.bin")]
    assert args == [
        {"rows": 1200, "sparse": True, "stored": int((X[:1200] != 0).sum())},
        {"rows": 300, "sparse": True, "stored": int((X[1200:] != 0).sum())},
        {"rows": 300}]


def test_a_dense_run_that_does_not_bundle_counts_unbundled(recorded):
    rng = np.random.RandomState(4)
    X = rng.rand(600, 28).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    bst = lgt.train(PARAMS, lgt.Dataset(X, label=y), num_boost_round=2,
                    keep_training_booster=True)
    assert bst._gbdt.bundle is None
    snap = obs.get_registry().snapshot()
    assert snap["counters"]["efb.unbundled"] == 1
    assert not [k for k in snap["gauges"] if k.startswith("efb.")]
    (span,) = _spans("construct.plan_bundles")
    assert span["args"] == {"features": 28, "bundles": 28}


def test_enable_bundle_false_plans_nothing(recorded):
    X, y = _exclusive()
    lgt.train(dict(PARAMS, enable_bundle="false"),
              lgt.Dataset(sp.csr_matrix(X), label=y), num_boost_round=1)
    snap = obs.get_registry().snapshot()
    assert not _spans("construct.plan_bundles")
    assert "efb.unbundled" not in snap["counters"]
    assert not [k for k in snap["gauges"] if k.startswith("efb.")]


def test_annotate_adds_to_an_open_span_and_is_a_no_op_off():
    obs.reset_for_tests()
    try:
        with obs.span("off") as handle:
            obs.annotate(handle, bundles=3)        # tracer off: no record
        assert obs.get_tracer().events() == []
        obs.configure(enabled=True)
        with obs.span("on", features=5) as handle:
            obs.annotate(handle, bundles=3)
        (ev,) = obs.get_tracer().events()
        assert ev["args"] == {"features": 5, "bundles": 3}
    finally:
        obs.reset_for_tests()
