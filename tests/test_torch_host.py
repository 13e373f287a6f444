"""Port parity of the host layer: the copied config, binning, tree and
model-text modules, the metrics copy and the torch objectives, against
``lightgbm_tpu``.

- bin upper bounds and bin codes are byte-equal on
  ``tests/fixtures/nan_det.train`` and on synthetic data with zeros,
  NaNs, few distinct values and a constant column;
- every reference-CLI model in ``tests/fixtures/model_*.txt`` loads in the
  port and predicts bit-equal to ``lightgbm_tpu`` (both walk the same
  copied host ``Tree`` code); where the reference example data is mounted,
  binary.test also reproduces ``preds_binary.txt`` to the bar of
  ``test_reference_models.py`` (rtol 1e-6, atol 1e-9);
- L2 gradients/hessians are bit-equal to the JAX package's; binary ones
  differ only through ``exp``, which the two frameworks round differently
  by up to 1 f32 ulp: g is held to 2 ulp (that ulp plus the division's
  rounding), and h = |g|(sigmoid - |g|) to the propagated bound
  2 ulp(|g|) + 2 ulp(h) (its cancellation near |g| = 1 magnifies the
  relative error, not the absolute one);
- AUC / logloss / L2 metrics are equal.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.dataset import construct_dataset as jax_construct
from lightgbm_tpu_torch.dataset import construct_dataset
from lightgbm_tpu_torch.interop import (binned_dataset, booster_from_model,
                                        port_mappers)
from test_reference_models import EXAMPLES

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _synthetic(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 7)
    X[rng.rand(n) < 0.3, 0] = 0.0                   # many zeros
    X[rng.rand(n) < 0.2, 1] = np.nan               # NaNs
    X[:, 2] = np.round(X[:, 2])                     # few distinct values
    X[:, 3] = 1.5                                   # constant: dropped
    X[rng.rand(n) < 0.5, 4] = np.nan
    X[:, 5] = np.abs(X[:, 5]) * 1e6
    return X


@pytest.mark.parametrize("source,params", [
    ("nan_det", {"max_bin": 63}),
    ("nan_det", {"max_bin": 255, "use_missing": False}),
    ("synthetic", {"max_bin": 255}),
    ("synthetic", {"max_bin": 15, "zero_as_missing": True}),
    ("synthetic", {"max_bin": 63, "min_data_in_bin": 10}),
])
def test_bins_and_codes_byte_equal(source, params):
    if source == "nan_det":
        X = np.genfromtxt(os.path.join(FIX, "nan_det.train"))[:, 1:]
    else:
        X = _synthetic()
    ours = binned_dataset(construct_dataset(
        X, None, lgt.Config.from_params(dict(params, verbose=-1))))
    ref_cd = jax_construct(
        X, None, lgb.Config.from_params(dict(params, verbose=-1,
                                             enable_bundle=False)))
    ref = binned_dataset(ref_cd)
    assert ours["X_binned"].dtype == np.uint8
    assert ours["X_binned"].tobytes() == ref["X_binned"].tobytes()
    # the JAX package's mappers, carried over, bin like the port's own
    for inner, m in enumerate(port_mappers(ref_cd.mappers)):
        col = X[:, ref["real_feature_idx"][inner]]
        assert (m.value_to_bin(col).astype(np.uint8).tobytes()
                == ref["X_binned"][:, inner].tobytes())
    for key in ("num_bins", "missing_code", "default_bin",
                "real_feature_idx"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert len(ours["bin_upper_bound"]) == len(ref["bin_upper_bound"])
    for a, b in zip(ours["bin_upper_bound"], ref["bin_upper_bound"]):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("model", ["model_binary.txt", "model_regression.txt",
                                   "model_multiclass.txt", "model_rank.txt"])
def test_reference_models_load_and_predict_like_jax(model):
    path = os.path.join(FIX, model)
    ours = lgt.Booster(params={"device": "cpu"}, model_file=path)
    ref = lgb.Booster(model_file=path)
    F = ref.num_feature()
    assert ours.num_feature() == F
    assert ours.num_trees() == ref.num_trees()
    rng = np.random.RandomState(1)
    X = rng.randn(300, F) * 2
    X[rng.rand(300, F) < 0.05] = np.nan
    X[rng.rand(300, F) < 0.05] = 0.0
    for raw in (False, True):
        np.testing.assert_array_equal(ours.predict(X, raw_score=raw),
                                      ref.predict(X, raw_score=raw))
    np.testing.assert_array_equal(ours.predict(X, pred_leaf=True),
                                  ref.predict(X, pred_leaf=True))
    # the port writes the text back out byte for byte like the JAX package
    assert ours.model_to_string() == ref.model_to_string()
    data_file = f"{EXAMPLES}/binary_classification/binary.test"
    if model == "model_binary.txt" and os.path.exists(data_file):
        Xt = np.loadtxt(data_file)[:, 1:]
        np.testing.assert_allclose(
            ours.predict(Xt), np.loadtxt(os.path.join(FIX, "preds_binary.txt")),
            rtol=1e-6, atol=1e-9)


def test_model_round_trip_through_interop():
    path = os.path.join(FIX, "model_binary.txt")
    ref = lgb.Booster(model_file=path)
    ours = booster_from_model(ref, {"device": "cpu"})
    X = np.random.RandomState(2).randn(50, ref.num_feature())
    np.testing.assert_array_equal(ours.predict(X), ref.predict(X))
    back = lgb.Booster(model_str=ours.model_to_string())
    np.testing.assert_array_equal(back.predict(X), ref.predict(X))


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("weighted", [False, True])
def test_objective_gradients_match_jax(objective, weighted):
    from lightgbm_tpu.dataset import Metadata as JMeta
    from lightgbm_tpu.objectives import create_objective as jax_create
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    rng = np.random.RandomState(4)
    n = 5000
    label = (rng.rand(n) > 0.4).astype(np.float32) if objective == "binary" \
        else rng.randn(n).astype(np.float32)
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    score = (rng.randn(1, n) * 3).astype(np.float32)
    outs = []
    for meta_cls, create, conv in ((JMeta, jax_create, jnp.asarray),
                                   (Metadata, create_objective,
                                    torch.as_tensor)):
        meta = meta_cls(n)
        meta.set_label(label)
        meta.set_weight(weight)
        cfg_cls = lgb.Config if meta_cls is JMeta else lgt.Config
        obj = create(cfg_cls.from_params({"objective": objective,
                                          "verbose": -1}))
        obj.init(meta, n)
        g, h = obj.gradients(conv(score), conv(label),
                             None if weight is None else conv(weight))
        outs.append((np.asarray(g), np.asarray(h)))
        if meta_cls is not JMeta:
            assert obj.boost_from_average_score() == jax_obj_avg
        else:
            jax_obj_avg = obj.boost_from_average_score()
    (gj, hj), (gt, ht) = outs
    assert gj.dtype == gt.dtype == hj.dtype == ht.dtype == np.float32
    if objective == "regression":
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)
        return
    sp = np.spacing
    assert (np.abs(gt - gj) <= 2 * sp(np.maximum(np.abs(gt), np.abs(gj)))).all()
    bound = 2 * sp(np.abs(gj)) + 2 * sp(np.maximum(np.abs(ht), np.abs(hj)))
    assert (np.abs(ht - hj) <= bound).all()


def test_metrics_equal():
    from lightgbm_tpu.metrics import create_metrics as jax_metrics
    from lightgbm_tpu.dataset import Metadata as JMeta
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.metrics import create_metrics
    rng = np.random.RandomState(5)
    n = 2000
    label = (rng.rand(n) > 0.5).astype(np.float32)
    p = np.clip(label * 0.3 + rng.rand(n) * 0.7, 1e-6, 1 - 1e-6)[None, :]
    params = {"objective": "binary", "metric": "auc,binary_logloss,l2",
              "verbose": -1}
    vals = []
    for meta_cls, mk, cfg in ((JMeta, jax_metrics, lgb.Config),
                              (Metadata, create_metrics, lgt.Config)):
        meta = meta_cls(n)
        meta.set_label(label)
        ms = mk(cfg.from_params(params), "binary")
        for m in ms:
            m.init(meta, n)
        vals.append([v for m in ms for v in m.eval(p)])
    assert vals[0] == vals[1]
    assert [v[0] for v in vals[1]] == ["auc", "binary_logloss", "l2"]


def test_config_copy_resolves_like_jax():
    params = {"num_leaf": 7, "min_data": 3, "sub_feature": 0.5,
              "reg_lambda": 2.0, "max_bin": "63", "verbosity": -1,
              "boosting": "gbdt", "app": "binary"}
    a = lgt.Config.from_params(params).to_dict()
    b = lgb.Config.from_params(params).to_dict()
    assert a == b
