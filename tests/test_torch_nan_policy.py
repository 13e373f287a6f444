"""``nan_policy`` in ``lightgbm_tpu_torch`` (``robustness/numeric.py`` and
the boosting step's guard), on the CPU, against the JAX package.

The four ``nan_policy`` cases of ``tests/test_chaos.py`` (a custom ``fobj``
poisoning gradients with NaN or +Inf at chosen iterations, through
``train``) and the batch cases of ``tests/test_tree_batch.py`` (an infinite
weight, ``tree_batch=4``), each held to the JAX package's tree count,
error and warnings on the same input, and the predictions within 1e-5 (the
packages' f32 histogram sums differ in order, ROADMAP C3). ``clip`` trains
the JAX package's trees on every input here: ROADMAP C19 records why the
concern about B1's fixed-point scale did not show. The guard's flags ride
on the captured runner's one read per tree (``test_torch_tree_batch.py``
emulates the replays).
"""
import logging

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.robustness.chaos import nan_gradient_fobj
from lightgbm_tpu.robustness.numeric import NonFiniteError as JaxNonFinite
from lightgbm_tpu_torch.robustness.numeric import (CLIP_CAP, FLAG_NAMES,
                                                   NAN_POLICIES,
                                                   NonFiniteError,
                                                   clip_nonfinite,
                                                   nonfinite_flag)

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)


def _data(n=600, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 3) + 0.1 * rng.randn(n)).astype(
        np.float64)
    return X, y


def _nan_params(policy, **extra):
    out = dict(objective="none", verbose=-1, metric="none",
               boost_from_average=False, nan_policy=policy)
    out.update(extra)
    return out


def _both(params, X, y, rounds, fobj_kw=None, weight=None):
    """The same training in both packages: ``(booster or exception)`` per
    package, port first, with a fresh chaos fobj of one seed each."""
    out = []
    for pkg, extra in ((lgt, {"device": "cpu"}), (lgb, {})):
        kw = {}
        if fobj_kw is not None:
            kw["fobj"] = nan_gradient_fobj(seed=5, **fobj_kw)
        try:
            out.append(pkg.train(dict(params, **extra),
                                 pkg.Dataset(X, label=y, weight=weight),
                                 num_boost_round=rounds,
                                 keep_training_booster=True, **kw))
        except (NonFiniteError, JaxNonFinite) as e:
            out.append(e)
    return out


def test_numeric_helpers_match_jax():
    from lightgbm_tpu.robustness import numeric as jnum
    assert NAN_POLICIES == jnum.NAN_POLICIES
    assert FLAG_NAMES == jnum.FLAG_NAMES and CLIP_CAP == jnum.CLIP_CAP
    x = np.array([1.5, np.nan, np.inf, -np.inf, -2e38, 3e38], np.float32)
    np.testing.assert_array_equal(
        clip_nonfinite(torch.as_tensor(x)).numpy(),
        np.asarray(jnum.clip_nonfinite(x)))
    assert bool(nonfinite_flag(torch.as_tensor(x)))
    assert not bool(nonfinite_flag(torch.as_tensor(x[[0, 4, 5]])))


def test_nan_policy_raise_fails_loudly_with_clean_state():
    X, y = _data()
    ours, ref = _both(_nan_params("raise"), X, y, 6,
                      fobj_kw=dict(bad_iters=[2]))
    assert isinstance(ours, NonFiniteError) and isinstance(ref, JaxNonFinite)
    assert "gradients" in str(ours) and str(ours) == str(ref)


def test_nan_policy_raise_leaves_a_checkpointable_booster():
    X, y = _data()
    fobj = nan_gradient_fobj(seed=5, bad_iters=[2])
    bst = lgt.Booster(params=dict(_nan_params("raise"), device="cpu"),
                      train_set=lgt.Dataset(X, label=y))
    gb = bst._gbdt
    for _ in range(2):
        bst.update(fobj=fobj)
    before = gb.score.clone()
    with pytest.raises(NonFiniteError, match="rolled back"):
        bst.update(fobj=fobj)
    assert gb.iter_ == 2 and len(gb.models) == 2
    assert torch.equal(gb.score, before)        # the gated no-op
    assert gb.checkpoint_state()["iter"] == 2


def test_nan_policy_skip_iter_drops_poisoned_iterations(caplog):
    X, y = _data()
    with caplog.at_level(logging.WARNING):
        ours, ref = _both(_nan_params("skip_iter", verbose=0), X, y, 6,
                          fobj_kw=dict(bad_iters=[1, 3], mode="inf"))
    assert ours.num_trees() == ref.num_trees() == 4
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)
    skips = [r for r in caplog.records if r.name == "lightgbm_tpu_torch"
             and "skip_iter: dropped iteration" in r.getMessage()]
    assert len(skips) == 2


def test_nan_policy_skip_iter_aborts_on_deterministic_poison():
    X, y = _data(n=300)
    ours, ref = _both(_nan_params("skip_iter"), X, y, 30,
                      fobj_kw=dict(bad_iters=range(100)))
    assert isinstance(ours, NonFiniteError) and "consecutive" in str(ours)
    assert str(ours) == str(ref)


def test_nan_policy_clip_sanitizes_and_continues(caplog):
    X, y = _data()
    with caplog.at_level(logging.WARNING):
        ours, ref = _both(_nan_params("clip", verbose=0), X, y, 6,
                          fobj_kw=dict(bad_iters=[1], frac=0.02))
    assert ours.num_trees() == ref.num_trees() == 6
    assert np.isfinite(ours.predict(X)).all()
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)
    assert any(r.name == "lightgbm_tpu_torch"
               and "nan_policy=clip" in r.getMessage()
               for r in caplog.records)


def test_nan_policy_none_is_the_default_and_unguarded():
    X, y = _data(n=300)
    bst = lgt.train(dict(objective="regression", verbose=-1, device="cpu"),
                    lgt.Dataset(X, label=y), num_boost_round=2,
                    keep_training_booster=True)
    assert bst._gbdt.nan_policy == "none" and not bst._gbdt._guarded


def test_nan_policy_clip_on_infinite_labels_matches_jax(caplog):
    """L2 with +inf labels (``chip_smoke.py`` phase 15's input, cut): the
    clipped gradients' squares overflow the gain in both packages, so
    neither splits; the same trees, the clip warning logged."""
    rng = np.random.RandomState(0)
    X = rng.randn(4000, 6).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1]).astype(np.float64)
    y[rng.choice(4000, 2, replace=False)] = np.inf
    params = dict(objective="regression", num_leaves=15, verbose=0,
                  nan_policy="clip", metric="none", boost_from_average=False)
    with caplog.at_level(logging.WARNING):
        ours, ref = _both(params, X, y, 3)
    ref._ensure_finalized()
    assert len(ours.trees) == len(ref.trees) == 3
    for a, b in zip(ref.trees, ours.trees):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert any(r.name == "lightgbm_tpu_torch"
               and "nan_policy=clip" in r.getMessage()
               for r in caplog.records)


# --------------------------------------------------- batches of iterations

def _make_binary(n, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 10).astype(np.float32)
    logit = X[:, 0] - 0.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.randn(n).astype(np.float32) * 0.2 > 0.3).astype(
        np.float32)
    return X, y


BATCH = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
             verbose=-1, tree_batch=4, metric="none")


def _boosters(params, X, y, weight=None):
    out = []
    for pkg, extra in ((lgt, {"device": "cpu"}), (lgb, {})):
        p = dict(params, **extra)
        out.append(pkg.Booster(params=p, train_set=pkg.Dataset(
            X, label=y, weight=weight, params=p))._gbdt)
    return out


def test_tree_batch_nan_policy_clean_run_keeps_every_iteration():
    X, y = _make_binary(1500)
    ours, ref = _boosters(dict(BATCH, nan_policy="skip_iter"), X, y)
    for g in (ours, ref):
        for _ in range(5):
            g.train_batch(4)
    assert len(ours.models) == len(ref.models) == 20
    assert ours.iter_ == ref.iter_ == 20 and ours._consecutive_skips == 0


def test_tree_batch_skip_iter_drops_poisoned_iterations():
    """An infinite weight poisons every iteration: each batch's iterations
    are gated no-ops, their entries dropped, and the consecutive-skip abort
    fires after the JAX package's count."""
    X, y = _make_binary(400)
    w = np.ones(400, np.float32)
    w[7] = np.inf
    ours, ref = _boosters(dict(BATCH, nan_policy="skip_iter"), X, y, w)
    before = ours.score.clone()
    errors = []
    for g in (ours, ref):
        with pytest.raises((NonFiniteError, JaxNonFinite),
                           match="consecutive") as exc:
            for _ in range(4):
                g.train_batch(4)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert len(ours.models) == len(ref.models) == 0
    assert ours.iter_ == ref.iter_ == 12
    assert torch.equal(ours.score, before)      # bit-identical: gated


def test_tree_batch_raise_mid_batch_rollback_bookkeeping():
    X, y = _make_binary(600)
    ours, ref = _boosters(dict(BATCH, nan_policy="raise"), X, y)
    flags = np.zeros((4, 3), bool)
    flags[1, 0] = True                     # first poison at i=1
    flags[3, 1] = True                     # trailing poison at i=3
    for g in (ours, ref):
        g.train_batch(4)
        assert len(g.models) == 4
        with pytest.raises((NonFiniteError, JaxNonFinite),
                           match="rolled back"):
            g._apply_nan_policy_batch(flags, base_iter=0, base_len=0, n=4)
        assert len(g.models) == 1
    assert torch.isfinite(ours.score).all()
    np.testing.assert_allclose(ours.score.numpy()[0],
                               np.asarray(ref.score)[0, :600], rtol=0,
                               atol=1e-5)


def test_tree_batch_rf_skip_iter_falls_back():
    X, y = _make_binary(600)
    params = dict(BATCH, objective="regression", boosting="rf",
                  bagging_fraction=0.6, bagging_freq=1,
                  nan_policy="skip_iter")
    ours, ref = _boosters(params, X, y)
    assert ours.tree_batch == ref.tree_batch == 1


def test_tree_batch_clip_policy_trains():
    X, y = _make_binary(400)
    w = np.ones(400, np.float32)
    w[7] = np.inf
    ours, ref = _boosters(dict(BATCH, nan_policy="clip"), X, y, w)
    for g in (ours, ref):
        for _ in range(2):
            g.train_batch(4)
    assert len(ours.models) == len(ref.models) == 8
    assert torch.isfinite(ours.score).all()
    np.testing.assert_allclose(ours.score.numpy()[0],
                               np.asarray(ref.score)[0, :400], rtol=0,
                               atol=1e-5)
