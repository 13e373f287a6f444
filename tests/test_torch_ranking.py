"""Port parity for ranking and the multiclass API: the lambdarank objective,
query groups through ``Dataset``/``cv``/valid sets, the NDCG/MAP metrics,
``LGBMRanker``, a 3-class ``LGBMClassifier`` and the boosting modes with
``num_class=3``, against the JAX package on the same seeded numpy inputs
(CPU).

Bars:
- lambdarank g/h per query: every value within 1e-5 of that query's
  largest |value| plus 1e-7. A row's g and h sum up to 2(M - 1) pair terms
  of a query padded to M <= 2048; torch and XLA add them in different
  orders, and their ``exp`` differ by an ulp (C2), so the expected
  difference grows like sqrt(M) f32 epsilons of the largest term:
  45 x 6e-8 = 2.7e-6 at M = 2048 (observed: 9.4e-7). The queries cover
  every bucket from 8 to 2048, a one-document query, a query whose labels
  are all equal (its g and h must be exactly 0), all-zero scores (each
  query one long tie, as at iteration 0) and planted score ties;
- g/h BIT-equal between two chunk budgets (the per-query arithmetic does
  not depend on the chunking);
- whole lambdarank models (5 rounds, 15 leaves, leaf-wise) at ROADMAP C6's
  bar: every split feature and threshold equal to the JAX package with
  ``tpu_hist_f64=true``, leaf values within 1e-5, NDCG curves within 1e-6;
- ``cv`` with groups builds the JAX package's folds (whole queries);
  ``LGBMRanker``, the 3-class ``LGBMClassifier`` and DART/GOSS with
  ``num_class=3`` grow the JAX package's trees (one GOSS input with an
  exact tie at the ``top_k`` boundary pinned to its one differing tree,
  ROADMAP C10); RF refuses multiclass in both packages (reference
  rf.hpp:42).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.dataset import Metadata as JaxMetadata
from lightgbm_tpu.objectives import create_objective as jax_create
from lightgbm_tpu_torch.dataset import Metadata
from lightgbm_tpu_torch.objectives import LambdarankNDCG, create_objective
from lightgbm_tpu_torch.utils.log import LightGBMError

E2E = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
       "min_data_in_leaf": 20, "min_sum_hessian_in_leaf": 1e-3,
       "verbose": -1, "tpu_wave_size": 1}

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)


def _queries(seed=1):
    """Query sizes covering every bucket 8..2048; labels 0-4 with one query
    of equal labels."""
    rng = np.random.RandomState(seed)
    sizes = np.array([1, 5, 8, 9, 16, 30, 64, 100, 250, 600, 1500]
                     + list(rng.randint(2, 200, 40)))
    n = int(sizes.sum())
    label = rng.randint(0, 5, n).astype(np.float32)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    label[qb[3]:qb[4]] = 2.0
    return sizes, label, qb


def _rank_objectives(sizes, label, extra=None):
    params = dict({"objective": "lambdarank", "verbose": -1}, **(extra or {}))
    out = []
    for meta_cls, cfg, create in ((JaxMetadata, lgb.Config, jax_create),
                                  (Metadata, lgt.Config, create_objective)):
        meta = meta_cls(len(label))
        meta.set_label(label)
        meta.set_group(sizes)
        obj = create(cfg.from_params(params))
        obj.init(meta, len(label))
        out.append(obj)
    return out


def _scores(kind, n, rng):
    if kind == "zeros":
        return np.zeros((1, n), np.float32)
    if kind == "ties":
        return (rng.randint(0, 4, (1, n)) / 4).astype(np.float32)
    return rng.randn(1, n).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["zeros", "ties", "random"])
def test_lambdarank_gradients_match_jax(kind, weighted):
    sizes, label, qb = _queries()
    n = len(label)
    rng = np.random.RandomState(5)
    jo, to = _rank_objectives(sizes, label)
    assert [b["m"] for b in to.buckets] == [b["m"] for b in jo.buckets]
    assert to.buckets[-1]["m"] == 2048
    np.testing.assert_array_equal(to.pos_of_row, jo._pos_of_row_np)
    s = _scores(kind, n, rng)
    w = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    jg, jh = [np.asarray(a)[0] for a in jo.gradients(
        jnp.asarray(s), jnp.asarray(label),
        None if w is None else jnp.asarray(w))]
    tg, th = [a.numpy()[0] for a in to.gradients(
        torch.as_tensor(s), torch.as_tensor(label),
        None if w is None else torch.as_tensor(w))]
    for q in range(len(sizes)):
        lo, hi = qb[q], qb[q + 1]
        for ref, ours in ((jg, tg), (jh, th)):
            tol = 1e-5 * np.abs(ref[lo:hi]).max() + 1e-7
            assert np.abs(ours[lo:hi] - ref[lo:hi]).max() <= tol, q
    # a one-document query and a query of equal labels have no pairs
    for q in (0, 3):
        assert not tg[qb[q]:qb[q + 1]].any() and not th[qb[q]:qb[q + 1]].any()
    assert np.abs(tg).max() > 0


@pytest.mark.parametrize("budget", [1 << 10, 1 << 16])
def test_lambdarank_chunk_budget_does_not_change_gradients(budget):
    sizes, label, _ = _queries(2)
    _, to = _rank_objectives(sizes, label)
    rng = np.random.RandomState(3)
    for kind in ("zeros", "ties", "random"):
        s = torch.as_tensor(_scores(kind, len(label), rng))
        lab = torch.as_tensor(label)
        base = to.gradients(s, lab, None)
        to.QUERY_CHUNK_BUDGET = budget
        chunked = to.gradients(s, lab, None)
        del to.QUERY_CHUNK_BUDGET
        assert torch.equal(base[0], chunked[0])
        assert torch.equal(base[1], chunked[1])
    assert LambdarankNDCG.QUERY_CHUNK_BUDGET == 1 << 26


def test_lambdarank_tie_keeps_document_order():
    """All-zero scores: the stable sort ranks each query in document order,
    so the first document of a query with a higher label than every later
    one gets the largest |g| (a descending sort would reverse the tie)."""
    label = np.array([3, 0, 0, 0, 0, 0, 0, 3], np.float32)
    jo, to = _rank_objectives([8], label)
    s = np.zeros((1, 8), np.float32)
    jg = np.asarray(jo.gradients(jnp.asarray(s), jnp.asarray(label),
                                 None)[0])[0]
    tg = to.gradients(torch.as_tensor(s), torch.as_tensor(label),
                      None)[0].numpy()[0]
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=0)
    assert abs(tg[0]) > abs(tg[7]) > 0


def _rank_problem(seed=7, n=4096):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 32, size=(n, 10)) / 31.0
    X[rng.rand(n) < 0.05, 4] = np.nan
    sizes, total = [], 0
    while total < n:
        q = int(min(rng.randint(5, 60), n - total))
        sizes.append(q)
        total += q
    latent = X[:, 0] * 3 + X[:, 1] ** 2 + rng.randn(n) * 0.5
    y = np.searchsorted(np.quantile(latent, [0.5, 0.75, 0.9, 0.97]),
                        latent).astype(np.float64)
    return X, y, np.array(sizes, np.int64)


def _splits(text):
    return [line.split("=", 1)[1].split() for line in text.splitlines()
            if line.startswith(("split_feature=", "threshold="))]


def _leaves(text):
    return np.array([float(v) for line in text.splitlines()
                     if line.startswith("leaf_value=")
                     for v in line.split("=", 1)[1].split()])


def test_lambdarank_trees_match_jax_f64():
    X, y, sizes = _rank_problem()
    nq = len(sizes) // 4
    vrows = int(sizes[:nq].sum())
    params = dict(E2E, objective="lambdarank", metric="ndcg",
                  ndcg_eval_at=[1, 5])
    out = []
    for pkg, extra in ((lgb, {"tpu_hist_f64": True}), (lgt, {"device": "cpu"})):
        dtr = pkg.Dataset(X[vrows:], label=y[vrows:], group=sizes[nq:])
        dva = pkg.Dataset(X[:vrows], label=y[:vrows], group=sizes[:nq],
                          reference=dtr)
        ev = {}
        bst = pkg.train(dict(params, **extra), dtr, num_boost_round=5,
                        valid_sets=[dva], valid_names=["v"], evals_result=ev,
                        verbose_eval=False)
        out.append((bst.model_to_string(), ev["v"]))
    (jt, jev), (tt, tev) = out
    assert _splits(tt) == _splits(jt)
    np.testing.assert_allclose(_leaves(tt), _leaves(jt), rtol=0, atol=1e-5)
    for k in ("ndcg@1", "ndcg@5"):
        np.testing.assert_allclose(tev[k], jev[k], rtol=0, atol=1e-6)
    assert tev["ndcg@5"][-1] > tev["ndcg@5"][0]
    # model text crosses both ways and predicts the same
    in_jax = lgb.Booster(model_str=tt)
    back = lgt.Booster(model_str=in_jax.model_to_string())
    np.testing.assert_array_equal(back.predict(X),
                                  lgt.Booster(model_str=tt).predict(X))
    np.testing.assert_array_equal(in_jax.predict(X), back.predict(X))


def test_cv_with_groups_matches_jax_folds():
    X, y, sizes = _rank_problem(n=1536)
    params = dict(E2E, objective="lambdarank", metric="ndcg",
                  ndcg_eval_at=[3])
    res = []
    for pkg, extra in ((lgb, {"tpu_hist_f64": True}), (lgt, {"device": "cpu"})):
        res.append(pkg.cv(dict(params, **extra),
                          pkg.Dataset(X, label=y, group=sizes),
                          num_boost_round=3, nfold=3, seed=4))
    assert sorted(res[0]) == sorted(res[1]) == ["ndcg@3-mean", "ndcg@3-stdv"]
    for key in res[0]:
        np.testing.assert_allclose(res[1][key], res[0][key], rtol=0,
                                   atol=1e-6)


def test_grouped_subset_keeps_whole_queries():
    X, y, sizes = _rank_problem(n=512)
    ds = lgt.Dataset(X, label=y, group=sizes)
    first = int(sizes[:3].sum())
    sub = ds.subset(np.arange(first))
    np.testing.assert_array_equal(sub.get_group(), sizes[:3])
    with pytest.raises(LightGBMError):
        ds.subset(np.arange(first + 1))


def test_lgbm_ranker_matches_jax():
    X, y, sizes = _rank_problem(n=2048)
    nq = len(sizes) // 4
    vrows = int(sizes[:nq].sum())
    kw = dict(n_estimators=4, num_leaves=15, min_child_samples=20,
              verbose=-1, tpu_wave_size=1)
    fits = []
    for pkg, extra in ((lgb, {"tpu_hist_f64": True}), (lgt, {"device": "cpu"})):
        r = pkg.LGBMRanker(**kw, **extra)
        r.fit(X[vrows:], y[vrows:], group=sizes[nq:],
              eval_set=[(X[:vrows], y[:vrows])], eval_group=[sizes[:nq]],
              eval_at=[3])
        fits.append(r)
    assert _splits(fits[1].booster_.model_to_string()) == \
        _splits(fits[0].booster_.model_to_string())
    np.testing.assert_allclose(fits[1].predict(X), fits[0].predict(X),
                               rtol=0, atol=1e-5)
    assert list(fits[1].evals_result_["valid_0"]) == ["ndcg@3"]
    with pytest.raises(LightGBMError):
        lgt.LGBMRanker(device="cpu").fit(X, y)


def _three_class(n=2048, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    logits = np.stack([X[:, 0], X[:, 1] - X[:, 2], 0.5 * X[:, 3]], 1) * 1.5
    p = np.exp(logits)
    p /= p.sum(1, keepdims=True)
    return X, (rng.rand(n, 1) > np.cumsum(p, 1)).sum(1)


def test_lgbm_classifier_three_classes_matches_jax():
    X, y = _three_class()
    labels = np.array(["a", "b", "c"])[y]
    kw = dict(n_estimators=3, num_leaves=15, verbose=-1, tpu_wave_size=1)
    ref = lgb.LGBMClassifier(tpu_hist_f64=True, **kw).fit(X, labels)
    ours = lgt.LGBMClassifier(device="cpu", **kw).fit(X, labels)
    assert list(ours.classes_) == ["a", "b", "c"] and ours.n_classes_ == 3
    assert ours.booster_.num_model_per_iteration == 3
    assert _splits(ours.booster_.model_to_string()) == \
        _splits(ref.booster_.model_to_string())
    proba = ours.predict_proba(X)
    assert proba.shape == (len(X), 3)
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(proba, ref.predict_proba(X), rtol=0,
                               atol=1e-5)
    assert (ours.predict(X) == ref.predict(X)).all()


@pytest.mark.parametrize("boosting,extra,seed,flips", [
    ("dart", {"drop_rate": 0.5, "skip_drop": 0.0}, 5, []),
    ("goss", {"learning_rate": 0.5}, 6, []),
    # C10: at iteration 2 the 409th and 410th largest sum |g h| tie exactly
    # in the port; softmax's ulps (C2) order them the other way in the JAX
    # package, so one row crosses GOSS's top_k boundary and tree 6 (class 0)
    # takes other thresholds on the same features
    ("goss", {"learning_rate": 0.5}, 5, [13]),
])
def test_boosting_modes_with_three_classes(boosting, extra, seed, flips):
    X, y = _three_class(seed=seed)
    params = dict(E2E, objective="multiclass", num_class=3,
                  boosting=boosting, **extra)
    ref = lgb.train(dict(params, tpu_hist_f64=True), lgb.Dataset(X, label=y),
                    num_boost_round=4)
    ours = lgt.train(dict(params, device="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=4)
    assert len(ours.trees) == len(ref.trees) == 12
    a, b = _splits(ours.model_to_string()), _splits(ref.model_to_string())
    assert [i for i in range(len(a)) if a[i] != b[i]] == flips
    if not flips:
        np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                                   atol=1e-5)


def test_rf_refuses_multiclass_in_both_packages():
    X, y = _three_class(256)
    params = dict(E2E, objective="multiclass", num_class=3, boosting="rf",
                  bagging_fraction=0.8, bagging_freq=1)
    with pytest.raises(Exception, match="multi-class"):
        lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=1)
    with pytest.raises(LightGBMError, match="multi-class"):
        lgt.train(dict(params, device="cpu"), lgt.Dataset(X, label=y),
                  num_boost_round=1)


def test_multiclass_valid_curves_and_early_stopping_match_jax():
    X, y = _three_class(3072)
    params = dict(E2E, objective="multiclass", num_class=3,
                  metric=["multi_logloss", "multi_error"])
    out = []
    for pkg, extra in ((lgb, {"tpu_hist_f64": True}), (lgt, {"device": "cpu"})):
        dtr = pkg.Dataset(X[:2048], label=y[:2048])
        dva = pkg.Dataset(X[2048:], label=y[2048:], reference=dtr)
        ev = {}
        bst = pkg.train(dict(params, **extra, learning_rate=0.5), dtr,
                        num_boost_round=30, valid_sets=[dva],
                        valid_names=["v"], evals_result=ev,
                        early_stopping_rounds=2, verbose_eval=False)
        out.append((bst.best_iteration, ev["v"]))
    assert out[0][0] == out[1][0] < 30
    for k in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(out[1][1][k], out[0][1][k], rtol=0,
                                   atol=1e-6)
