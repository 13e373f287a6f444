"""Port parity of validation and the rest of the training surface: valid
sets, metric curves, early stopping, ``feval``/``fobj``, learning-rate
schedules, continued training, ``add_valid`` after training, rollback,
``reset_parameter``, ``cv`` and the sklearn wrappers, against
``lightgbm_tpu`` (``tpu_hist_f64=true``) on the CPU (``device=cpu``).

Bars:
- ``evals_result`` has JAX's datasets, metrics and lengths, every value
  within 1e-6; ``best_iteration`` equal, ``best_score`` within 1e-6;
- split features and thresholds equal to JAX's wherever both packages
  train; predictions within 1e-5;
- ``fobj`` with the L2 gradient grows the built-in L2's trees bit for bit;
  a list and a callable ``learning_rates`` give the same model;
- ``add_valid`` after training: the replayed forest's metric within 1e-6
  of a set attached from the start;
- ``rollback_one_iter`` restores the train and valid scores bit for bit;
- ``cv``: JAX's keys and lengths, means within 1e-6;
- sklearn: ``best_iteration_`` equal to JAX's wrappers', predictions
  within 1e-5; ``clone``/``get_params`` round-trip; ``LGBMRanker`` and more
  than two classes train (their parity is ``test_torch_ranking.py``), an
  unported configuration raises naming its ROADMAP item.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.3,
        "min_data_in_leaf": 20, "min_sum_hessian_in_leaf": 1.0,
        "verbose": -1, "tpu_wave_size": 1}
METRICS = {"binary": ["auc", "binary_logloss", "binary_error"],
           "regression": ["l2", "l1"]}

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

NT = 2000

_DATA = {}


def _data(objective):
    """(X_train, y_train, X_valid, y_valid): 3000 x 8 with NaN, split
    2000 / 1000; the label is noisy, so the valid curve turns."""
    if not _DATA:
        rng = np.random.RandomState(5)
        X = rng.rand(3000, 8)
        X[rng.rand(3000) < 0.1, 2] = np.nan
        logit = 3 * X[:, 0] - 2 * X[:, 1] + X[:, 4] * X[:, 5] * 2 - 1
        _DATA["binary"] = (rng.rand(3000) < 1 / (1 + np.exp(-logit))
                           ).astype(float)
        _DATA["regression"] = logit + rng.randn(3000)
        _DATA["X"] = X
    X, y = _DATA["X"], _DATA[objective]
    return X[:NT], y[:NT], X[NT:], y[NT:]


def _train(pkg, objective, rounds=30, valid=True, extra=None, **kw):
    """One package's run with the train set and the valid set watched;
    returns (booster, evals_result)."""
    Xt, yt, Xv, yv = _data(objective)
    p = dict(BASE, objective=objective, metric=METRICS[objective])
    p.update(extra or {})
    p.update({"device": "cpu"} if pkg is lgt else {"tpu_hist_f64": True})
    dt = pkg.Dataset(Xt, label=yt)
    sets, names = ([dt, pkg.Dataset(Xv, label=yv, reference=dt)],
                   ["training", "valid"]) if valid else ([], [])
    evals = {}
    bst = pkg.train(p, dt, num_boost_round=rounds, valid_sets=sets,
                    valid_names=names, evals_result=evals, verbose_eval=False,
                    **kw)
    return bst, evals


def _same_trees(a, b, n=None):
    assert len(a.trees) == len(b.trees)
    for ta, tb in list(zip(a.trees, b.trees))[:n]:
        np.testing.assert_array_equal(tb.split_feature, ta.split_feature)
        np.testing.assert_array_equal(tb.threshold, ta.threshold)


def _same_curves(ref, ours):
    assert list(ours) == list(ref)
    for ds in ref:
        assert list(ours[ds]) == list(ref[ds])
        for metric in ref[ds]:
            np.testing.assert_allclose(ours[ds][metric], ref[ds][metric],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_curves_and_early_stopping_match_jax(objective):
    # the reference binary example's sampling, and early stopping
    extra = dict(feature_fraction=0.8, bagging_fraction=0.8, bagging_freq=5)
    ref, ref_ev = _train(lgb, objective, extra=extra, early_stopping_rounds=3)
    ours, our_ev = _train(lgt, objective, extra=extra,
                          early_stopping_rounds=3)
    _same_curves(ref_ev, our_ev)
    assert 0 < ours.best_iteration == ref.best_iteration < 30
    assert len(our_ev["valid"][METRICS[objective][0]]) < 30   # it stopped
    assert [(d, m) for d, m, _v, _h in ours.best_score] == \
        [(d, m) for d, m, _v, _h in ref.best_score]
    np.testing.assert_allclose([v for *_x, v, _h in ours.best_score],
                               [v for *_x, v, _h in ref.best_score],
                               rtol=0, atol=1e-6)
    _same_trees(ref, ours)
    Xv = _data(objective)[2]
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=1e-5)


def _feval(preds, data):
    return "mean_abs", float(np.mean(np.abs(preds - data.get_label()))), False


def test_feval_matches_jax_and_fobj_grows_l2_trees():
    ref, ref_ev = _train(lgb, "regression", rounds=6, feval=_feval)
    ours, our_ev = _train(lgt, "regression", rounds=6, feval=_feval)
    assert "mean_abs" in our_ev["valid"]
    _same_curves(ref_ev, our_ev)
    _same_trees(ref, ours)

    def l2(preds, data):
        return preds - data.get_label(), np.ones_like(preds)

    no_avg = {"boost_from_average": False}
    built_in, _ = _train(lgt, "regression", rounds=6, valid=False,
                         extra=no_avg)
    custom, _ = _train(lgt, "regression", rounds=6, valid=False,
                       extra=dict(no_avg, objective="none"), fobj=l2)
    assert [t.num_leaves for t in custom.trees] == \
        [t.num_leaves for t in built_in.trees]
    for a, b in zip(built_in.trees, custom.trees):
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_array_equal(b.leaf_value, a.leaf_value)


def test_learning_rates_list_and_callable():
    rates = [0.5 * 0.8 ** i for i in range(6)]
    as_list, _ = _train(lgt, "binary", rounds=6, valid=False,
                        learning_rates=rates)
    as_fn, _ = _train(lgt, "binary", rounds=6, valid=False,
                      learning_rates=lambda i: 0.5 * 0.8 ** i)
    assert as_list.model_to_string() == as_fn.model_to_string()
    ref, _ = _train(lgb, "binary", rounds=6, valid=False,
                    learning_rates=rates)
    _same_trees(ref, as_list)
    Xv = _data("binary")[2]
    np.testing.assert_allclose(as_list.predict(Xv), ref.predict(Xv),
                               rtol=0, atol=1e-5)


def test_init_model_continued_training_matches_jax():
    first_ref, _ = _train(lgb, "binary", rounds=3, valid=False)
    first, _ = _train(lgt, "binary", rounds=3, valid=False)
    ref, ref_ev = _train(lgb, "binary", rounds=3, init_model=first_ref)
    ours, our_ev = _train(lgt, "binary", rounds=3, init_model=first)
    assert len(ours.trees) == 6
    _same_trees(ref, ours)
    _same_curves(ref_ev, our_ev)
    Xv = _data("binary")[2]
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=1e-5)


def test_add_valid_after_training_replays_the_forest():
    Xt, yt, Xv, yv = _data("binary")
    bst, _ = _train(lgt, "binary", rounds=5, keep_training_booster=True)
    late = lgt.Dataset(Xv, label=yv, reference=bst.train_dataset)
    bst.add_valid(late, "late")

    def curves():
        res = {}
        for d, m, v, _h in bst.eval_valid():
            res.setdefault(d, {})[m] = v
        return res

    for _ in range(2):
        ev = curves()
        for m in METRICS["binary"]:
            assert abs(ev["late"][m] - ev["valid"][m]) <= 1e-6
        gbdt = bst._gbdt
        np.testing.assert_allclose(gbdt.valid_sets[1].score.numpy(),
                                   gbdt.valid_sets[0].score.numpy(), rtol=0,
                                   atol=1e-5)
        bst.update()                 # both sets follow the next tree
    # a booster that already knows the name refuses a second set under it
    with pytest.raises(LightGBMError, match="already attached"):
        bst.add_valid(lgt.Dataset(Xv, label=yv, reference=bst.train_dataset),
                      "late")


def test_rollback_restores_scores_bit_for_bit():
    bst, _ = _train(lgt, "binary", rounds=4, keep_training_booster=True,
                    extra=dict(bagging_fraction=0.7, bagging_freq=2))
    gbdt = bst._gbdt
    before = (gbdt.score.clone(), gbdt.valid_sets[0].score.clone())
    text = bst.model_to_string()
    bst.update()
    assert bst.current_iteration() == 5
    bst.rollback_one_iter()
    assert torch.equal(gbdt.score, before[0])
    assert torch.equal(gbdt.valid_sets[0].score, before[1])
    assert bst.model_to_string() == text
    # the same iteration trained again draws the same mask: the same model
    # as five rounds straight
    bst.update()
    straight, _ = _train(lgt, "binary", rounds=5,
                         extra=dict(bagging_fraction=0.7, bagging_freq=2))
    assert bst.model_to_string() == straight.model_to_string()


def test_reset_parameter_lambda_l2_matches_jax():
    Xt, yt = _data("regression")[:2]
    out = []
    for pkg, dev in ((lgb, {"tpu_hist_f64": True}), (lgt, {"device": "cpu"})):
        p = dict(BASE, objective="regression", **dev)
        bst = pkg.Booster(params=p, train_set=pkg.Dataset(Xt, label=yt))
        for _ in range(2):
            bst.update()
        bst.reset_parameter({"lambda_l2": 50.0})
        bst.update()
        bst._ensure_finalized()            # the host trees of the forest
        out.append(bst)
    ref, ours = out
    assert len(ours.trees) == len(ref.trees) == 3
    assert ours._gbdt.spec.lambda_l2 == 50.0
    _same_trees(ref, ours)
    for a, b in zip(ref.trees, ours.trees):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)
    # the reset reached the third tree: without it the leaves are larger
    plain, _ = _train(lgt, "regression", rounds=3, valid=False)
    assert np.abs(ours.trees[2].leaf_value).max() < \
        np.abs(plain.trees[2].leaf_value).max()


def test_cv_matches_jax():
    Xt, yt = _data("binary")[:2]
    p = dict(BASE, objective="binary", metric="auc")
    ref = lgb.cv(dict(p, tpu_hist_f64=True), lgb.Dataset(Xt, label=yt),
                 num_boost_round=4, nfold=3, seed=3)
    ours = lgt.cv(dict(p, device="cpu"), lgt.Dataset(Xt, label=yt),
                  num_boost_round=4, nfold=3, seed=3)
    assert list(ours) == list(ref) == ["auc-mean", "auc-stdv"]
    for key in ref:
        assert len(ours[key]) == len(ref[key]) == 4
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-6)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_sklearn_matches_jax(objective):
    Xt, yt, Xv, yv = _data(objective)
    name = "LGBMClassifier" if objective == "binary" else "LGBMRegressor"
    kw = dict(n_estimators=30, num_leaves=15, learning_rate=0.3,
              min_child_samples=20, verbose=-1)
    ref = getattr(lgb, name)(tpu_hist_f64=True, **kw)
    ours = getattr(lgt, name)(device="cpu", **kw)
    fit = dict(eval_set=[(Xv, yv)], early_stopping_rounds=3)
    ref.fit(Xt, yt, **fit)
    ours.fit(Xt, yt, **fit)
    assert 0 < ours.best_iteration_ == ref.best_iteration_ < 30
    np.testing.assert_allclose(ours.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=1e-5)
    if objective == "binary":
        np.testing.assert_allclose(ours.predict_proba(Xv),
                                   ref.predict_proba(Xv), rtol=0, atol=1e-5)
    from sklearn.base import clone
    twin = clone(ours)
    assert twin.get_params() == ours.get_params()
    assert twin.get_params()["device"] == "cpu"


def test_sklearn_unported_raise_naming_a2():
    """What A2 refused (a ranker, more than two classes) now trains; a
    wrapper given a configuration still unported raises naming its item."""
    Xt, yt = _data("binary")[:2]
    ranker = lgt.LGBMRanker(device="cpu", n_estimators=2).fit(
        Xt, yt, group=[NT])
    assert ranker.predict(Xt).shape == (NT,)
    clf = lgt.LGBMClassifier(device="cpu", n_estimators=2).fit(
        Xt, np.arange(NT) % 3)
    assert clf.predict_proba(Xt).shape == (NT, 3)
    with pytest.raises(LightGBMError, match=r"ROADMAP A16\b"):
        lgt.LGBMClassifier(device="cpu", tree_learner="voting").fit(
            Xt, np.arange(NT) % 3)
