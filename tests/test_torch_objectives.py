"""Port parity for the objectives beyond binary and L2: L1, Huber, Fair,
Poisson, multiclass softmax and one-vs-all, cross-entropy and its lambda
form (lambdarank is ``test_torch_ranking.py``), against the JAX package on
the same seeded numpy inputs (CPU).

Bars:
- gradients, with and without weights: BIT-equal where the arithmetic has
  no transcendental (L2, Fair, the sign of L1, the inner branch of Huber);
  otherwise every value within ``k`` f32 epsilons of the largest magnitude
  of that output, ``k`` from the arithmetic: one ``exp``/``log1p`` rounds
  apart by an ulp between torch and XLA (C2), and the cancellations in
  h = |r|(s - |r|), ``exp(s) - y`` and softmax's ``p - onehot`` carry that
  ulp into the result at the scale of the largest term. ``k = 8`` for
  one transcendental in a sum or product (observed up to 3.9). Weighted
  cross-entropy-lambda chains ``exp``, ``log1p``,
  ``exp`` and ``1 / (c - 1)^2``, which is ill-conditioned where ``c``
  tends to 1 (the JAX package itself is off by 18% of h there): both are
  held against an f64 evaluation of the same formula, and the port's
  worst relative error may be at most twice the JAX package's plus 8
  epsilons (observed: equal for h, a third of JAX's for g);
- ``boost_from_average`` scores and converted outputs equal;
- whole models (5 rounds, 15 leaves, leaf-wise) on a 4,096-row synthetic
  set: every split feature and threshold equal to the JAX package with
  ``tpu_hist_f64=true``; predictions within 1e-4 (the gradients' ulps
  reach the leaf values; observed up to 1.4e-5 for L1);
- every objective and categorical key of the copied config reaches the
  port: changing it changes what it governs.
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
from lightgbm_tpu_torch.objectives import create_objective

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
N = 4096               # a multiple of the JAX package's row chunk: no padding
# (name, bit-equal g, bit-equal h, k) — see the module docstring
OBJECTIVES = [
    ("regression", True, True, 0),
    ("regression_l1", True, False, 8),
    ("huber", True, False, 8),
    ("fair", True, True, 0),
    ("poisson", False, False, 8),
    ("multiclass", False, False, 8),
    ("multiclassova", False, False, 8),
    ("xentropy", False, False, 8),
    ("xentlambda", False, False, 8),
]


def _labels(name, rng, n=N):
    if name.startswith("multiclass"):
        return rng.randint(0, 3, n).astype(np.float32)
    if name in ("xentropy", "xentlambda"):
        return rng.rand(n).astype(np.float32)
    if name == "poisson":
        return rng.poisson(2.0, n).astype(np.float32)
    return (rng.randn(n) * 2).astype(np.float32)


def _both(name, label, weight, extra=None):
    """(jax objective, port objective), both initialised on the label."""
    params = dict({"objective": name, "verbose": -1}, **(extra or {}))
    if name.startswith("multiclass"):
        params["num_class"] = 3
    out = []
    for meta_cls, cfg_cls, create in ((JaxMetadata, lgb.Config, jax_create),
                                      (Metadata, lgt.Config,
                                       create_objective)):
        meta = meta_cls(len(label))
        meta.set_label(label)
        meta.set_weight(weight)
        obj = create(cfg_cls.from_params(params))
        obj.init(meta, len(label))
        out.append(obj)
    return out


def _xentlambda_f64(score, label, weight):
    """Weighted cross-entropy-lambda g/h in f64, the same formula."""
    s, y, w = (np.asarray(a, np.float64) for a in (score, label, weight))
    epf = np.exp(s)
    z = 1.0 - np.exp(-w * np.log1p(epf))
    g = (1.0 - y / z) * w / (1.0 + np.exp(-s))
    c = 1.0 / (1.0 - z)
    d2 = c - 1.0
    b = (c / (d2 * d2)) * (1.0 + w * epf - c)
    return g, w * epf / (1.0 + epf) ** 2 * (1.0 + y * b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,exact_g,exact_h,k", OBJECTIVES)
def test_gradients_match_jax(name, exact_g, exact_h, k, weighted):
    rng = np.random.RandomState(0)
    label = _labels(name, rng)
    weight = (rng.rand(N) * 2 + 0.1).astype(np.float32) if weighted else None
    jo, to = _both(name, label, weight)
    assert jo.num_models == to.num_models
    score = (rng.randn(to.num_models, N) * 2).astype(np.float32)
    jg, jh = jo.gradients(jnp.asarray(score), jnp.asarray(label),
                          None if weight is None else jnp.asarray(weight))
    tg, th = to.gradients(torch.as_tensor(score), torch.as_tensor(label),
                          None if weight is None else torch.as_tensor(weight))
    jg, jh = np.asarray(jg), np.asarray(jh)
    for exact, ref, ours in ((exact_g, jg, tg), (exact_h, jh, th)):
        ours = ours.numpy()
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        if exact:
            np.testing.assert_array_equal(ours, ref)
        elif name == "xentlambda" and weighted:
            exact64 = _xentlambda_f64(score, label, weight)[
                0 if ref is jg else 1]
            rel = np.abs(exact64) + 1e-30
            err_ours = (np.abs(ours - exact64) / rel).max()
            err_ref = (np.abs(ref - exact64) / rel).max()
            assert err_ours <= 2 * err_ref + 8 * EPS32
        else:
            bound = k * EPS32 * np.abs(ref).max()
            assert np.abs(ours - ref).max() <= bound
    assert to.boost_from_average_score() == jo.boost_from_average_score()
    raw = (rng.randn(to.num_models, 64)).astype(np.float32)
    np.testing.assert_allclose(
        to.convert_output(torch.as_tensor(raw)).numpy(),
        np.asarray(jo.convert_output(jnp.asarray(raw))), rtol=8 * EPS32,
        atol=0)


@pytest.mark.parametrize("name", ["poisson", "xentropy", "xentlambda",
                                  "multiclass"])
def test_label_checks_match_jax(name):
    bad = {"poisson": -1.0, "xentropy": 1.5, "xentlambda": -0.5,
           "multiclass": 3.0}[name]
    label = _labels(name, np.random.RandomState(1), 64)
    label[5] = bad
    for pkg, meta_cls in ((lgb, JaxMetadata), (lgt, Metadata)):
        params = {"objective": name, "verbose": -1, "num_class":
                  3 if name == "multiclass" else 1}
        create = jax_create if pkg is lgb else create_objective
        obj = create(pkg.Config.from_params(params))
        meta = meta_cls(64)
        meta.set_label(label)
        with pytest.raises(Exception):
            obj.init(meta, 64)


def _synthetic(seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, 6)
    X[rng.rand(N) < 0.1, 2] = np.nan
    z = X[:, 0] + 0.5 * X[:, 1] - 0.7 * np.nan_to_num(X[:, 2]) \
        + 0.3 * rng.randn(N)
    logits = np.stack([X[:, 0], X[:, 1] - X[:, 3],
                       0.5 * X[:, 4] * X[:, 5]], 1) * 1.5
    p = np.exp(logits)
    p /= p.sum(1, keepdims=True)
    cls = (rng.rand(N, 1) > np.cumsum(p, 1)).sum(1).astype(float)
    labels = {"regression_l1": z, "huber": z, "fair": z,
              "poisson": rng.poisson(np.exp(0.5 * np.tanh(z))).astype(float),
              "xentropy": 1 / (1 + np.exp(-z)),
              "xentlambda": 1 / (1 + np.exp(-z)),
              "multiclass": cls, "multiclassova": cls}
    return X, labels, rng.rand(N) + 0.5


E2E_BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
            "min_data_in_leaf": 50, "min_sum_hessian_in_leaf": 1e-3,
            "verbose": -1, "tpu_wave_size": 1}


def _splits(text):
    out = []
    for line in text.splitlines():
        if line.startswith(("split_feature=", "threshold=")):
            out.append(line.split("=", 1)[1].split())
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["regression_l1", "huber", "fair",
                                  "poisson", "xentropy", "xentlambda",
                                  "multiclass", "multiclassova"])
def test_trees_match_jax_f64(name, weighted):
    X, labels, w = _synthetic()
    params = dict(E2E_BASE, objective=name)
    if name.startswith("multiclass"):
        params["num_class"] = 3
    weight = w if weighted else None
    ref = lgb.train(dict(params, tpu_hist_f64=True),
                    lgb.Dataset(X, label=labels[name], weight=weight),
                    num_boost_round=5)
    ours = lgt.train(dict(params, device="cpu"),
                     lgt.Dataset(X, label=labels[name], weight=weight),
                     num_boost_round=5)
    K = 3 if name.startswith("multiclass") else 1
    assert len(ours.trees) == len(ref.trees) == 5 * K
    assert all(t.num_leaves == 15 for t in ours.trees)
    assert _splits(ours.model_to_string()) == _splits(ref.model_to_string())
    pa, pb = ours.predict(X), ref.predict(X)
    assert pa.shape == pb.shape == ((N, K) if K > 1 else (N,))
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


def test_multiclass_model_text_crosses_both_ways():
    X, labels, _ = _synthetic()
    params = dict(E2E_BASE, objective="multiclass", num_class=3,
                  device="cpu")
    ours = lgt.train(params, lgt.Dataset(X, label=labels["multiclass"]),
                     num_boost_round=3)
    in_jax = lgb.Booster(model_str=ours.model_to_string())
    np.testing.assert_array_equal(in_jax.predict(X), ours.predict(X))
    back = lgt.Booster(model_str=in_jax.model_to_string())
    np.testing.assert_array_equal(back.predict(X), ours.predict(X))
    assert back.num_model_per_iteration == 3


# ------------------------------------------------- config keys reach the port

def _booster(params):
    X, labels, _ = _synthetic()
    X = X[:512].copy()
    X[:, 5] = np.arange(512) % 7
    return lgt.train(dict({"objective": "binary", "verbose": -1,
                           "device": "cpu", "categorical_feature": "5"},
                          **params),
                     lgt.Dataset(X, label=(labels["xentropy"][:512] > 0.5)),
                     num_boost_round=1, keep_training_booster=True)


@pytest.mark.parametrize("key,value", [
    ("cat_smooth", 3.0), ("cat_l2", 1.5), ("max_cat_threshold", 7),
    ("max_cat_to_onehot", 9), ("min_data_per_group", 17),
])
def test_categorical_keys_reach_the_grower(key, value):
    spec = _booster({key: value})._gbdt.spec
    assert spec.use_categorical and spec.cat_features == (5,)
    assert getattr(spec, key) == value
    # and through reset_parameter (the JAX package's gbdt.py:1988-1998)
    bst = _booster({})
    assert getattr(bst._gbdt.spec, key) != value
    bst.reset_parameter({key: value})
    assert getattr(bst._gbdt.spec, key) == value


@pytest.mark.parametrize("key,value,name", [
    ("huber_delta", 0.3, "huber"), ("fair_c", 0.4, "fair"),
    ("gaussian_eta", 2.5, "regression_l1"), ("sigmoid", 2.0, "binary"),
    ("sigmoid", 0.5, "multiclassova"), ("sigmoid", 1.7, "lambdarank"),
    ("label_gain", [0, 1, 2, 3, 4], "lambdarank"),
    ("max_position", 3, "lambdarank"),
])
def test_objective_keys_are_read(key, value, name):
    rng = np.random.RandomState(2)
    n = 256
    label = rng.randint(0, 3, n).astype(np.float32) \
        if name in ("multiclassova", "lambdarank", "binary") \
        else (rng.randn(n) * 2).astype(np.float32)
    grads = []
    for params in ({}, {key: value}):
        params = dict(params, objective=name, verbose=-1,
                      num_class=3 if name == "multiclassova" else 1)
        obj = create_objective(lgt.Config.from_params(params))
        meta = Metadata(n)
        meta.set_label(label)
        if name == "lambdarank":
            meta.set_group([16] * 16)
        obj.init(meta, n)
        score = torch.as_tensor(rng.randn(obj.num_models, n)
                                .astype(np.float32))
        rng = np.random.RandomState(2)         # the same scores both times
        grads.append(obj.gradients(score, torch.as_tensor(label), None))
    assert not (torch.equal(grads[0][0], grads[1][0])
                and torch.equal(grads[0][1], grads[1][1]))


def test_num_class_and_ndcg_eval_at_are_read():
    X, labels, _ = _synthetic()
    bst = lgt.train(dict(E2E_BASE, objective="multiclassova", num_class=3,
                         device="cpu"),
                    lgt.Dataset(X[:512], label=labels["multiclass"][:512]),
                    num_boost_round=2)
    assert bst.num_model_per_iteration == 3 and len(bst.trees) == 6
    evals = {}
    y = (labels["xentropy"][:512] * 4).astype(int)
    d = lgt.Dataset(X[:512], label=y, group=[32] * 16)
    v = lgt.Dataset(X[:256], label=y[:256], group=[32] * 8, reference=d)
    lgt.train({"objective": "lambdarank", "ndcg_eval_at": [2, 7],
               "device": "cpu", "verbose": -1}, d, num_boost_round=2,
              valid_sets=[v], valid_names=["t"], evals_result=evals)
    assert sorted(evals["t"]) == ["ndcg@2", "ndcg@7"]
