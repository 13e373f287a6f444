"""Port parity of the sampled boosting modes: bagging, feature_fraction,
GOSS, RF and DART, against ``lightgbm_tpu`` (``tpu_hist_f64=true``) on the
CPU (``device=cpu``), on ``tests/fixtures/nan_det.train`` and a synthetic
set with NaN and repeated labels.

Bars:
- the per-iteration bagging mask and per-tree feature mask, drawn from the
  step's key (``fold_in(base, it)``, then ``split(fold_in(key, 0))``), are
  bit-equal to the JAX package's ``_bag_mask_for_iter`` and
  ``_feature_mask`` on its first N rows and F features;
- in every tree: split features and thresholds equal, leaf values within
  1e-6 absolute (1e-5 for DART and RF, whose scores pass through tree
  walks and renormalised trees), predictions within 1e-5; decision types
  differ only by the NaN-empty tie of ROADMAP §C1 (the port sets the
  default-left bit 2 where JAX's f32 forward scan did not), with the count
  each case observes pinned;
- GOSS: the same trees on L2 (bit-equal gradients) and, on these inputs,
  on binary too, although binary gradients may differ from JAX's by the
  1-ulp ``exp`` of ROADMAP §C2, which could move a row across GOSS's
  ``top_k`` boundary (ROADMAP §C6);
- DART: the drop set of every iteration equal to JAX's.
"""
import os

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting.dart import DART as JaxDART
from lightgbm_tpu_torch.boosting.dart import DART as PortDART
from lightgbm_tpu_torch.interop import prng_key_from_jax, to_numpy
from lightgbm_tpu_torch.utils import prng

HERE = os.path.dirname(__file__)
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
        "min_data_in_leaf": 50, "min_sum_hessian_in_leaf": 5.0,
        "verbose": -1, "tpu_wave_size": 1}

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

ROUNDS = 8

_DATA = {}


def _data(name, objective):
    """(X, label): ``nan`` is the fixture, ``syn`` 3000 x 8 with 10% NaN in
    one column; its L2 label is a logit rounded to quarters (many equal
    |g|, so GOSS's top_k meets ties)."""
    if not _DATA:
        d = np.genfromtxt(os.path.join(HERE, "fixtures", "nan_det.train"))
        _DATA["nan"] = (d[:, 1:], d[:, 0], d[:, 0])
        rng = np.random.RandomState(7)
        X = rng.rand(3000, 8)
        X[rng.rand(3000) < 0.1, 3] = np.nan
        logit = 3 * X[:, 0] - 2 * X[:, 1] + np.nan_to_num(X[:, 3]) * 1.5 - 1
        yb = (rng.rand(3000) < 1 / (1 + np.exp(-logit))).astype(float)
        _DATA["syn"] = (X, yb, np.round(logit * 4) / 4)
    X, yb, yr = _DATA[name]
    return X, (yb if objective == "binary" else yr)


def _compare(data, objective, params, dtype_flips, leaf_atol=1e-6):
    X, y = _data(data, objective)
    p = dict(BASE, objective=objective, **params)
    ref = lgb.train(dict(p, tpu_hist_f64=True), lgb.Dataset(X, label=y),
                    num_boost_round=ROUNDS)
    ours = lgt.train(dict(p, device="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=ROUNDS)
    assert len(ours.trees) == len(ref.trees) == ROUNDS
    flips = 0
    for a, b in zip(ref.trees, ours.trees):
        assert a.num_leaves == b.num_leaves > 1
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=leaf_atol)
        diff = b.decision_type != a.decision_type
        np.testing.assert_array_equal(b.decision_type[diff],
                                      a.decision_type[diff] | 2)
        flips += int(diff.sum())
    assert flips == dtype_flips
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("freq", [1, 5])
def test_masks_bit_equal_to_jax(freq, seed):
    X, y = _data("syn", "binary")
    params = dict(BASE, objective="binary", bagging_fraction=0.7,
                  bagging_freq=freq, feature_fraction=0.6, seed=seed)
    jg = lgb.Booster(params=dict(params, tpu_hist_f64=True),
                     train_set=lgb.Dataset(X, label=y))._gbdt
    pg = lgt.Booster(params=dict(params, device="cpu"),
                     train_set=lgt.Dataset(X, label=y))._gbdt
    N, F = X.shape
    assert pg._rng_key == prng_key_from_jax(np.asarray(jg._rng_key))
    assert pg.n_feature_sample == jg.n_feature_sample == round(0.6 * F)
    jmask, pmask = jg.bag_mask, pg.bag_mask
    for it in range(11):
        jb, jf = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(jg._rng_key, it), 0))
        pb, pf = prng.split(prng.fold_in(prng.fold_in(pg._rng_key, it), 0))
        assert (pb, pf) == (prng_key_from_jax(np.asarray(jb)),
                            prng_key_from_jax(np.asarray(jf)))
        jmask = jg._bag_mask_for_iter(jb, it, jmask)
        pmask = pg._bag_mask_for_iter(pb, it, pmask)
        np.testing.assert_array_equal(to_numpy(pmask),
                                      np.asarray(jmask)[:N])
        for k in range(2):
            jf_mask = np.asarray(jg._feature_mask(jf, k))
            assert not jf_mask[F:].any()
            np.testing.assert_array_equal(to_numpy(pg._feature_mask(pf, k)),
                                          jf_mask[:F])
    # the booster keeps the mask it drew: after `last + 1` rounds it holds
    # the draw of the last resampling iteration
    bst = lgt.train(dict(params, device="cpu"), lgt.Dataset(X, label=y),
                    num_boost_round=7, keep_training_booster=True)
    last = 6 - 6 % freq
    pb, _ = prng.split(prng.fold_in(prng.fold_in(pg._rng_key, last), 0))
    np.testing.assert_array_equal(to_numpy(bst._gbdt.bag_mask),
                                  to_numpy(pg._bag_mask_for_iter(
                                      pb, last, pg.pad_mask)))


@pytest.mark.parametrize("data,objective,params,flips", [
    ("nan", "binary", dict(bagging_fraction=0.7, bagging_freq=1), 7),
    ("nan", "regression", dict(bagging_fraction=0.7, bagging_freq=5,
                               feature_fraction=0.7), 15),
    ("syn", "binary", dict(bagging_fraction=0.7, bagging_freq=5,
                           feature_fraction=0.7), 0),
    ("syn", "regression", dict(bagging_fraction=0.7, bagging_freq=1), 0),
    ("syn", "regression", dict(feature_fraction=0.5, seed=11), 2),
])
def test_bagging_and_feature_fraction_trees_match_jax(data, objective, params,
                                                      flips):
    _compare(data, objective, params, flips)


@pytest.mark.parametrize("data,objective,flips", [
    ("nan", "regression", 12),
    ("syn", "regression", 1),
    ("nan", "binary", 14),
    ("syn", "binary", 1),
])
def test_goss_trees_match_jax(data, objective, flips):
    # lr 0.25: a warm-up of 4 plain iterations, then 4 sampled ones
    _compare(data, objective, dict(boosting="goss", learning_rate=0.25),
             flips)


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_rf_trees_match_jax(objective):
    _compare("syn", objective, dict(boosting="rf", bagging_fraction=0.8,
                                    bagging_freq=1, feature_fraction=0.8),
             0, leaf_atol=1e-5)


@pytest.mark.parametrize("data,objective,mode,flips", [
    ("syn", "regression", {}, 0),
    ("syn", "binary", dict(uniform_drop=True, xgboost_dart_mode=True), 2),
    ("nan", "regression", dict(uniform_drop=True), 9),
    ("nan", "binary", dict(xgboost_dart_mode=True), 5),
])
def test_dart_trees_and_drop_sets_match_jax(monkeypatch, data, objective,
                                            mode, flips):
    drops = {"jax": [], "port": []}

    def recording(cls, key):
        original = cls._select_drop

        def select(self):
            out = original(self)
            drops[key].append(list(out))
            return out
        monkeypatch.setattr(cls, "_select_drop", select)

    recording(JaxDART, "jax")
    recording(PortDART, "port")
    params = dict(boosting="dart", drop_rate=0.3, skip_drop=0.2, **mode)
    _compare(data, objective, params, flips, leaf_atol=1e-5)
    assert drops["port"] == drops["jax"]
    assert len(drops["port"]) == ROUNDS
    assert sum(len(d) for d in drops["port"]) > 0
