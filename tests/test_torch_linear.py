"""Port parity for piecewise-linear leaves (``linear_tree=true``): the path
walk, the moments, the batched Cholesky, the score epilogue, whole models
and the API around them, against the JAX package on the same seeded numpy
inputs (CPU).

Bars:
- ``leaf_path_features`` on a tree the JAX package grew: equal, and the
  scratch node's children ignored (ROADMAP C15);
- ``accumulate_leaf_moments``: the port adds in f64, the JAX package in
  f32, so the moments agree within 1e-5 of each entry's magnitude (the sum
  of |terms|) and the fitted-row counts exactly;
- ``solve_leaf_models``: the same linear and degraded leaves, the planted
  singular Gram, the too-few-rows leaf and the categorical path among
  them, coefficients within 1e-4 (f64 against f32 Cholesky);
- end to end on ``bench.py``'s piecewise-linear data (L2, 5 rounds): every
  tree's structure and leaf features equal to the JAX package's (no tree
  differs: the count of differing trees is pinned at 0), coefficients and
  intercepts within 1e-4, predictions within 1e-4;
- model text crosses the packages both ways with bit-equal predictions;
- rows missing a leaf feature predict the leaf's constant; ``pred_contrib``
  and the unsupported configurations raise; the sklearn wrapper passes the
  linear and EFB keys through.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import linear as jlin
from lightgbm_tpu_torch.interop import (to_numpy, to_torch,
                                        tree_arrays_numpy, tree_arrays_torch)
from lightgbm_tpu_torch.ops import linear as tlin
from lightgbm_tpu_torch.utils.log import LightGBMError

PARAMS = dict(objective="regression", num_leaves=15, linear_tree=True,
              linear_lambda=0.01, min_data_in_leaf=20, device="cpu",
              verbose=-1)

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)


def _piecewise(n=2000, f=6, seed=17):
    """``bench.py``'s ``_piecewise_linear_data``: the slope switches with
    the sign of feature 0; 1% NaN cells."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f) * 2.0
    X[rng.rand(n, f) < 0.01] = np.nan
    y = np.where(np.nan_to_num(X[:, 0]) > 0,
                 3.0 * np.nan_to_num(X[:, 1]) + 1.0,
                 -2.0 * np.nan_to_num(X[:, 2]) + 0.5) \
        + 0.05 * rng.randn(n)
    return X, y


@pytest.fixture(scope="module")
def trained():
    """The JAX package's and the port's models on the same data (the JAX
    step compiles once), and the JAX booster's device trees."""
    X, y = _piecewise()
    jb = lgb.train(PARAMS, lgb.Dataset(X, label=y, params=PARAMS),
                   num_boost_round=5, keep_training_booster=True)
    tb = lgt.train(PARAMS, lgt.Dataset(X, label=y, params=PARAMS),
                   num_boost_round=5, keep_training_booster=True)
    return X, y, jb, tb


# ------------------------------------------------------------- the pieces

def test_leaf_path_features_match_jax(trained):
    _, _, jb, _ = trained
    for it in range(3):
        jt = jb._gbdt.models[it][0]
        is_cat = np.zeros(6, bool)
        is_cat[3] = True                  # a categorical feature on paths
        ref = jlin.leaf_path_features(jt, jnp.asarray(is_cat), 4, 14)
        ours = tlin.leaf_path_features(
            tree_arrays_torch(tree_arrays_numpy(jt)), to_torch(is_cat), 4)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


def test_path_features_ignore_the_scratch_node(trained):
    """The scratch node's children are not links of the tree (on the card
    the wave's duplicate writes leave any value there, ROADMAP C15): a
    real node planted there changes no leaf's path features."""
    _, _, _, tb = trained
    tree = tb._gbdt.models[1][0]
    M = tree.left_child.shape[0] - 1
    L = tree.leaf_value.shape[0] - 1
    assert int(tree.left_child[M]) == int(tree.right_child[M]) == -L - 1
    is_cat = torch.zeros(6, dtype=torch.bool)
    ref = tlin.leaf_path_features(tree, is_cat, 8)
    planted = tree._replace(left_child=tree.left_child.clone(),
                            right_child=tree.right_child.clone())
    planted.left_child[M] = 3
    planted.right_child[M] = 5
    for a, b in zip(tlin.leaf_path_features(planted, is_cat, 8), ref):
        assert torch.equal(a, b)


def _moment_inputs(seed=0, n=1024, F=5, L1=8, K=3):
    rng = np.random.RandomState(seed)
    raw = (rng.randn(n, F) * 3).astype(np.float32)
    miss = rng.rand(n, F) < 0.03
    raw[miss] = 0.0
    lid = rng.randint(0, L1 - 1, n).astype(np.int32)
    feats = np.full((L1, K), -1, np.int32)
    for leaf in range(L1 - 1):
        k = leaf % (K + 1)
        feats[leaf, :k] = rng.choice(F, k, replace=False)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    inc = (rng.rand(n) < 0.9).astype(np.float32)
    return raw, miss, lid, feats, g, h, inc


def test_moments_match_jax():
    args = _moment_inputs()
    ref = jlin.accumulate_leaf_moments(*[jnp.asarray(a) for a in args], 512)
    ours = tlin.accumulate_leaf_moments(*[to_torch(a) for a in args],
                                        chunk_rows=300)
    # the magnitude each entry sums over: the same moments of |terms|
    raw, miss, lid, feats, g, h, inc = args
    absm = tlin.accumulate_leaf_moments(
        to_torch(np.abs(raw)), to_torch(miss), to_torch(lid),
        to_torch(feats), to_torch(np.abs(g)), to_torch(h), to_torch(inc))
    for a, b, m in zip(ours, ref, absm):
        assert a.dtype == torch.float64
        err = np.abs(to_numpy(a) - np.asarray(b, np.float64))
        assert (err <= 1e-5 * to_numpy(m) + 1e-6).all(), err.max()
    np.testing.assert_array_equal(to_numpy(ours[2]), np.asarray(ref[2]))
    # the chunking does not change the sums beyond f64 rounding
    whole = tlin.accumulate_leaf_moments(*[to_torch(a) for a in args])
    for a, b in zip(ours, whole):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=1e-12,
                                   atol=1e-9)


def test_solve_degrades_the_same_leaves_as_jax():
    raw, miss, lid, feats, g, h, inc = _moment_inputs(seed=1)
    L1, K = feats.shape
    # leaf 3 fits one feature that is 0 on all its rows: a singular Gram at
    # lambda 0; leaf 5 keeps 2 rows (fewer than nfeat + 2); leaf 6 has a
    # categorical split on its path
    feats[3] = [2, -1, -1]
    raw[lid == 3, 2] = 0.0
    miss[lid == 3, 2] = False
    keep5 = np.nonzero(lid == 5)[0]
    inc[keep5[2:]] = 0.0
    nfeat = (feats >= 0).sum(axis=1).astype(np.int32)
    has_cat = np.zeros(L1, bool)
    has_cat[6] = True
    args = (raw, miss, lid, feats, g, h, inc)
    jm = jlin.accumulate_leaf_moments(*[jnp.asarray(a) for a in args], 512)
    tm = tlin.accumulate_leaf_moments(*[to_torch(a) for a in args])
    for lam in (0.0, 0.5):
        ref = jlin.solve_leaf_models(*jm[:2], jnp.asarray(feats),
                                     jnp.asarray(nfeat),
                                     jnp.asarray(has_cat), jm[2], lam)
        ours = tlin.solve_leaf_models(*tm[:2], to_torch(feats),
                                      to_torch(nfeat), to_torch(has_cat),
                                      tm[2], lam)
        np.testing.assert_array_equal(to_numpy(ours[2]), np.asarray(ref[2]))
        np.testing.assert_allclose(to_numpy(ours[0]), np.asarray(ref[0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_numpy(ours[1]), np.asarray(ref[1]),
                                   rtol=1e-4, atol=1e-4)
        degraded = to_numpy(ours[3])
        assert int(degraded.sum()) == int(ref[3])
        lin = to_numpy(ours[2])[:, 0] >= 0
        assert not lin[5] and not lin[6] and degraded[5]
        assert not degraded[6]            # a categorical path is not fitted
        assert lin[3] == (lam > 0) and degraded[3] == (lam == 0)


# ------------------------------------------------------------- end to end

def test_trees_match_jax(trained):
    X, _, jb, tb = trained
    assert len(jb.trees) == len(tb.trees) == 5
    n_differ = 0
    for jt, tt in zip(jb.trees, tb.trees):
        same = (np.array_equal(jt.split_feature, tt.split_feature)
                and np.array_equal(jt.threshold, tt.threshold)
                and [list(f) for f in jt.leaf_features]
                == [list(f) for f in tt.leaf_features])
        n_differ += not same
        if not same:
            continue
        for cj, ct in zip(jt.leaf_coeff, tt.leaf_coeff):
            np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tt.leaf_const, jt.leaf_const, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    assert n_differ == 0
    assert sum(len(f) > 0 for f in tb.trees[0].leaf_features) > 5
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-4)


def test_model_text_crosses_packages(trained):
    X, _, jb, tb = trained
    ours_from_jax = lgt.Booster(params={"device": "cpu"},
                                model_str=jb.model_to_string())
    np.testing.assert_array_equal(ours_from_jax.predict(X), jb.predict(X))
    jax_from_ours = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_array_equal(jax_from_ours.predict(X), tb.predict(X))
    assert ours_from_jax.model_to_string().split("Tree=0")[1] \
        == jb.model_to_string().split("Tree=0")[1]


def test_device_walk_matches_host_predict(trained):
    """The rank-encoded forest walk with the linear epilogue (the device
    route of ``Booster.predict``) against the host ``Tree.predict``."""
    from lightgbm_tpu_torch.ops.predict import forest_predict_raw
    X, _, _, tb = trained
    walk = forest_predict_raw(tb.trees, X, X.shape[1], torch.device("cpu"))
    host = np.zeros(len(X))
    for t in tb.trees:
        host += t.predict(X)
    np.testing.assert_allclose(walk, host, rtol=0, atol=1e-5)


def test_missing_leaf_feature_predicts_the_constant(trained):
    X, _, _, tb = trained
    t = tb.trees[0]
    leaves = t.predict_leaf(X)
    for i in np.nonzero(np.isnan(X).any(axis=1))[0][:50]:
        feats = t.leaf_features[leaves[i]]
        if len(feats) and np.isnan(X[i, feats]).any():
            assert t.predict(X[i:i + 1])[0] == t.leaf_value[leaves[i]]
    # the training scores of such rows took the constant as well
    g = tb._gbdt
    tree = g.models[0][0]
    lid = torch.as_tensor(leaves, dtype=torch.int32)
    out = tlin.linear_leaf_scores(tree, lid, *g.raw)
    nan_rows = np.isnan(X).any(axis=1)
    const = to_numpy(tree.leaf_value)[leaves]
    feats = to_numpy(tree.leaf_feat)[leaves]
    hit = np.array([nan_rows[i] and (feats[i] >= 0).any()
                    and np.isnan(X[i, feats[i][feats[i] >= 0]]).any()
                    for i in range(len(X))])
    assert hit.any()
    np.testing.assert_array_equal(to_numpy(out)[hit], const[hit])


def test_valid_set_and_rollback():
    X, y = _piecewise(n=1200, seed=3)
    ds = lgt.Dataset(X[:900], label=y[:900], params=PARAMS)
    dv = lgt.Dataset(X[900:], label=y[900:], reference=ds)
    ev = {}
    bst = lgt.train(dict(PARAMS, metric="l2"), ds, num_boost_round=4,
                    valid_sets=[dv], evals_result=ev,
                    keep_training_booster=True)
    curve = ev["valid_0"]["l2"]
    assert curve[-1] < curve[0]
    pred = bst.predict(X[900:])
    np.testing.assert_allclose(np.mean((pred - y[900:]) ** 2), curve[-1],
                               rtol=1e-5)
    g = bst._gbdt
    before = g.score.clone(), g.valid_sets[0].score.clone()
    bst.update()
    bst.rollback_one_iter()
    assert torch.equal(g.score, before[0])
    assert torch.equal(g.valid_sets[0].score, before[1])


def test_linear_on_binary_with_nan():
    rng = np.random.RandomState(4)
    X = rng.randn(1500, 5)
    X[rng.rand(1500) < 0.05, 0] = np.nan
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] > 0).astype(float)
    p = dict(PARAMS, objective="binary")
    bst = lgt.train(p, lgt.Dataset(X, label=y), num_boost_round=3)
    pred = bst.predict(X)
    assert np.isfinite(pred).all() and ((pred > 0.5) == y).mean() > 0.8
    assert any(len(f) for t in bst.trees for f in t.leaf_features)


# ------------------------------------------------------------ the surface

def test_pred_contrib_and_rejections_raise(trained):
    X, y, _, tb = trained
    with pytest.raises(LightGBMError, match="pred_contrib"):
        tb.predict(X[:5], pred_contrib=True)
    for bad in (dict(boosting="dart"), dict(boosting="rf", bagging_freq=1,
                                            bagging_fraction=0.5),
                dict(linear_lambda=-1.0), dict(linear_max_features=0),
                dict(tree_learner="data")):
        with pytest.raises(LightGBMError):
            lgt.train(dict(PARAMS, **bad), lgt.Dataset(X, label=y),
                      num_boost_round=1)
    # a Dataset constructed without the raw slice is refused
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params({"verbose": -1}))
    with pytest.raises(LightGBMError, match="raw feature"):
        lgt.train(PARAMS, ds, num_boost_round=1)


def test_sklearn_passes_linear_and_efb_keys():
    X, y = _piecewise(n=800, seed=5)
    reg = lgt.LGBMRegressor(n_estimators=3, num_leaves=7, linear_tree=True,
                            linear_lambda=0.1, device="cpu", verbose=-1)
    reg.fit(X, y)
    trees = reg.booster_.trees
    assert any(len(f) for t in trees for f in t.leaf_features)
    assert reg.booster_.config.linear_lambda == 0.1
    rng = np.random.RandomState(6)
    flags = np.eye(20)[rng.randint(0, 20, 600)]
    Xf = np.column_stack([rng.rand(600, 2), flags])
    yf = (Xf[:, 0] > 0.5).astype(int)
    for eb, bundled in (("auto", True), (False, False)):
        clf = lgt.LGBMClassifier(n_estimators=2, enable_bundle=eb,
                                 max_conflict_rate=0.0, device="cpu",
                                 verbose=-1)
        clf.fit(Xf, yf)
        assert clf.booster_.config.max_conflict_rate == 0.0
        booster = lgt.Booster(params=clf.booster_.params,
                              train_set=lgt.Dataset(Xf, label=yf))
        assert (booster._gbdt.bundle is not None) == bundled
