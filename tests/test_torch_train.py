"""The port's slice as a whole: ``lightgbm_tpu_torch.train`` ->
``Booster.predict`` -> model text, against ``lightgbm_tpu`` and the
reference engine's fixture, on the CPU (``device=cpu``).

Bars:
- on ``tests/fixtures/nan_det.train`` at ``test_tree_parity.py``'s BASE
  config (5 rounds, leaf-wise), binary and L2: every split feature and
  threshold equal to ``lightgbm_tpu`` trained with ``tpu_hist_f64=true``;
  leaf values within 1e-6 absolute (both sum f32 gradients near f64
  accuracy, in different orders; observed 3.2e-7); decision types differ
  only where the port's reverse scan wins an exact-arithmetic tie the JAX
  package's f32 forward scan takes by rounding (a leaf with no NaN rows),
  pinned to exactly 8 (binary) and 6 (L2) of 70 nodes (ROADMAP §C);
- against the reference CLI's ``ref_nan_det_model.txt``: all 70 split
  features, exactly 69/70 thresholds and 70/70 decision types — at or above
  the JAX package's bar (70, 69, 67) in ``test_tree_parity.py``;
- the package imports neither JAX nor ``lightgbm_tpu``; the default device
  (CUDA) raises without a card and never falls back to the CPU; configs
  outside the slice raise with their ROADMAP item;
- training is bit-identical run to run; model text crosses packages.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
from lightgbm_tpu_torch.utils.log import LightGBMError

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
        "feature_fraction": 1.0, "bagging_freq": 0, "min_data_in_leaf": 50,
        "min_sum_hessian_in_leaf": 5.0, "verbose": -1, "tpu_wave_size": 1}

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

_NAN_DET = {}


def _nan_det():
    if not _NAN_DET:
        data = np.genfromtxt(os.path.join(HERE, "fixtures", "nan_det.train"))
        _NAN_DET["X"], _NAN_DET["y"] = data[:, 1:], data[:, 0]
    return _NAN_DET["X"], _NAN_DET["y"]


def _train_port(params, rounds=5):
    X, y = _nan_det()
    return lgt.train(dict(params, device="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=rounds)


def _parse(text):
    trees, cur = [], {}
    for line in text.splitlines():
        if line.startswith("Tree=") and cur:
            trees.append(cur)
            cur = {}
        for key, name in (("split_feature=", "f"), ("threshold=", "t"),
                          ("decision_type=", "d"), ("leaf_value=", "lv")):
            if line.startswith(key):
                cur[name] = line.split("=", 1)[1].split()
    if cur:
        trees.append(cur)
    return trees


@pytest.mark.parametrize("objective,dtype_flips",
                         [("binary", 8), ("regression", 6)])
def test_trees_match_jax_f64(objective, dtype_flips):
    X, y = _nan_det()
    params = dict(BASE, objective=objective, use_missing=True)
    ref = lgb.train(dict(params, tpu_hist_f64=True), lgb.Dataset(X, label=y),
                    num_boost_round=5)
    ours = _train_port(params)
    assert len(ours.trees) == len(ref.trees) == 5
    flips = 0
    for a, b in zip(ref.trees, ours.trees):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)
        diff = b.decision_type != a.decision_type
        # every flip is the NaN-empty tie: the port's reverse scan
        # (default_left bit 2 set) where JAX took the forward scan
        np.testing.assert_array_equal(b.decision_type[diff],
                                      a.decision_type[diff] | 2)
        flips += int(diff.sum())
    assert flips == dtype_flips
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)


def test_meets_reference_engine_bar():
    bst = _train_port(dict(BASE, objective="binary", use_missing=True))
    ref_text = open(os.path.join(HERE, "fixtures",
                                 "ref_nan_det_model.txt")).read()
    ref, our = _parse(ref_text), _parse(bst.model_to_string())
    assert ref[0]["d"] == our[0]["d"], "tree-0 decision types diverge"
    total = feat_ok = thr_ok = d_ok = 0
    for rt, ot in zip(ref, our):
        for k in range(len(rt["f"])):
            total += 1
            feat_ok += rt["f"][k] == ot["f"][k]
            thr_ok += abs(float(rt["t"][k]) - float(ot["t"][k])) < 1e-9
            d_ok += rt["d"][k] == ot["d"][k]
    assert total == 70
    assert feat_ok == 70, f"features: {feat_ok}/{total}"
    assert thr_ok == 69, f"thresholds: {thr_ok}/{total} (expected 69/70)"
    assert d_ok == 70, f"decision types: {d_ok}/{total} (expected 70/70)"


def test_default_wave_size_and_determinism():
    params = dict(BASE, objective="binary", tpu_wave_size=0, num_leaves=31,
                  min_data_in_leaf=20)
    a = _train_port(params, rounds=3)
    b = _train_port(params, rounds=3)
    assert a.model_to_string() == b.model_to_string()
    X, y = _nan_det()
    ref = lgb.train(dict(params, tpu_hist_f64=True), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    for ta, tb in zip(ref.trees, a.trees):
        np.testing.assert_array_equal(tb.split_feature, ta.split_feature)
        np.testing.assert_array_equal(tb.threshold, ta.threshold)


def test_max_bin_511_matches_jax():
    """uint16 codes end to end: the same split features and thresholds as
    the JAX package (``tpu_hist_f64=true``) in every tree. Tree 0's leaf
    values are bit-equal; later trees start from binary gradients that
    differ from JAX's by the 1-ulp ``exp`` of ROADMAP C2, so their leaf
    values and the predictions are held within 1e-5 absolute (observed
    2.35e-6)."""
    rng = np.random.RandomState(11)
    X = rng.rand(4000, 4)
    X[:, 3] = rng.randn(4000)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 3] * 0.3
         + 0.2 * rng.randn(4000) > 0.6).astype(np.float64)
    params = dict(BASE, objective="binary", max_bin=511, num_leaves=31,
                  min_data_in_leaf=20, tpu_wave_size=0)
    ds = lgt.Dataset(X, label=y)
    ours = lgt.train(dict(params, device="cpu"), ds, num_boost_round=3)
    assert ds._constructed.X_binned.dtype == np.uint16
    assert ds._constructed.X_binned.max() > 255
    ref = lgb.train(dict(params, tpu_hist_f64=True), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    assert len(ours.trees) == len(ref.trees) == 3
    np.testing.assert_array_equal(ours.trees[0].leaf_value,
                                  ref.trees[0].leaf_value)
    for a, b in zip(ref.trees, ours.trees):
        assert a.num_leaves == b.num_leaves > 10
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)


def test_model_text_crosses_packages(tmp_path):
    X, y = _nan_det()
    ours = _train_port(dict(BASE, objective="binary"))
    path = str(tmp_path / "port_model.txt")
    ours.save_model(path)
    in_jax = lgb.Booster(model_file=path)
    np.testing.assert_array_equal(in_jax.predict(X), ours.predict(X))
    # a loaded model has no bin mappers, so its feature_infos read "none";
    # every tree crosses byte for byte
    ours_text = ours.model_to_string()
    jax_text = in_jax.model_to_string()
    assert jax_text.split("Tree=0")[1] == ours_text.split("Tree=0")[1]
    back = lgt.Booster(params={"device": "cpu"},
                       model_str=in_jax.model_to_string())
    np.testing.assert_array_equal(back.predict(X), ours.predict(X))


def test_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.interop, "
            "lightgbm_tpu_torch.ops.cuda_histogram, "
            "lightgbm_tpu_torch.utils.prng, lightgbm_tpu_torch.callback, "
            "lightgbm_tpu_torch.sklearn, lightgbm_tpu_torch.boosting.goss, "
            "lightgbm_tpu_torch.boosting.dart, "
            "lightgbm_tpu_torch.boosting.rf, lightgbm_tpu_torch.efb, "
            "lightgbm_tpu_torch.ops.linear, "
            "lightgbm_tpu_torch.observability.export, "
            "lightgbm_tpu_torch.observability.phases, "
            "lightgbm_tpu_torch.observability.costs, "
            "lightgbm_tpu_torch.observability.profiler, "
            "lightgbm_tpu_torch.observability.ledger, "
            "lightgbm_tpu_torch.observability.memory, "
            "lightgbm_tpu_torch.utils.timer\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _nan_det()
    before = launch_count()
    for device in (None, "tpu", "gpu", "cuda"):
        params = {"objective": "binary", "verbose": -1}
        if device:
            params["device"] = device
        with pytest.raises(LightGBMError, match="CUDA"):
            lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
    assert launch_count() == before
    # prediction on the default device takes the device walk for large
    # batches and raises likewise; device=cpu runs the same walk on the host
    model = _train_port(dict(BASE, objective="binary"), rounds=2)
    loaded = lgt.Booster(model_str=model.model_to_string())
    Xbig = np.tile(X, (125, 1))                     # 500k rows x 2 trees
    with pytest.raises(LightGBMError, match="CUDA"):
        loaded.predict(Xbig)
    host = lgt.Booster(params={"device": "cpu"},
                       model_str=model.model_to_string())
    walked = host.predict(Xbig)
    np.testing.assert_allclose(walked[:len(X)], model.predict(X), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(walked.reshape(125, -1)[-1], walked[:len(X)])


@pytest.mark.parametrize("params", [
    {"tree_learner": "voting"},
    {"categorical_feature": "0", "tree_learner": "voting"},
    {"tree_learner": "data", "checkpoint_dir": "checkpoints"},
    {"objective": "huber", "tree_learner": "feature"},
    {"tree_batch": 4, "boosting": "dart", "tree_learner": "voting"},
    {"tree_learner": "data"},
    {"tpu_residency": "stream", "tree_learner": "data"},
    {"tree_learner": "feature", "nan_policy": "raise"},
    {"tree_learner": "voting", "resume_from": "auto"},
])
def test_unported_configs_raise_with_roadmap_item(params, tmp_path,
                                                  monkeypatch):
    """These settings were refused naming ROADMAP A16. The distributed
    learners are ported: without a world (one process) each trains to the
    serial text, as the JAX package collapses one device to serial. A
    world of two trains the ones it refused before A16b was ported
    (``test_torch_multihost.py::test_a_world_refuses_naming_a16b``)."""
    monkeypatch.chdir(tmp_path)
    X, y = _nan_det()
    full = dict({"objective": "binary", "verbose": -1, "device": "cpu"},
                **params)
    ds_params = {"categorical_feature": params["categorical_feature"]} \
        if "categorical_feature" in params else {}
    got = lgt.train(full, lgt.Dataset(X, label=y, params=ds_params),
                    num_boost_round=2, keep_training_booster=True)
    assert got._gbdt.pctx.strategy == "serial"
    serial = dict(full, tree_learner="serial")
    want = lgt.train(serial, lgt.Dataset(X, label=y, params=ds_params),
                     num_boost_round=2)
    assert got.model_to_string() == want.model_to_string()


def test_resume_from_with_init_model_raises(tmp_path):
    """The JAX engine's refusal (engine.py:164-166): a checkpoint holds the
    whole training state, so ``init_model`` cannot be added to it."""
    X, y = _nan_det()
    params = {"objective": "binary", "verbose": -1, "device": "cpu",
              "checkpoint_dir": str(tmp_path)}
    first = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
    with pytest.raises(LightGBMError, match="init_model"):
        lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=2,
                  init_model=first, resume_from="auto")


@pytest.mark.parametrize("params", [
    {"linear_tree": True, "tree_batch": 2, "nan_policy": "clip"},
    {"objective": "multiclass", "num_class": 3, "nan_policy": "clip"},
], ids=["linear_tree", "multiclass"])
def test_nan_policy_clip_trains_like_jax(params):
    """Configurations the port refused before ``nan_policy`` was ported:
    on finite input the clip guard never fires, and the port trains the
    JAX package's trees at the bars of ``test_torch_linear.py`` and
    ``test_torch_objectives.py`` (the multiclass case on the latter's data
    and config): same split features and thresholds, predictions within
    1e-5 (linear) and 1e-4 (multiclass)."""
    from test_torch_objectives import E2E_BASE, _synthetic
    if "num_class" in params:
        X, labels, _ = _synthetic()
        y = labels["multiclass"]
        full, tol = dict(E2E_BASE, **params), 1e-4
    else:
        X, y = _nan_det()
        full, tol = dict(BASE, objective="binary", **params), 1e-5
    ref = lgb.train(dict(full, tpu_hist_f64=True),
                    lgb.Dataset(X, label=y, params=full), num_boost_round=4)
    ours = lgt.train(dict(full, device="cpu"),
                     lgt.Dataset(X, label=y, params=full), num_boost_round=4,
                     keep_training_booster=True)
    assert ours._gbdt.nan_policy == "clip"
    ref._ensure_finalized()
    assert len(ours.trees) == len(ref.trees) > 0
    for a, b in zip(ref.trees, ours.trees):
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=tol)


def test_tpu_only_keys_are_accepted_no_ops():
    a = _train_port(dict(BASE, objective="binary"), rounds=2)
    b = _train_port(dict(BASE, objective="binary", tpu_hist_kernel="pallas",
                         tpu_hist_hilo=False, tpu_hist_chunk=1024), rounds=2)
    assert a.model_to_string() == b.model_to_string()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when
    torch.cuda.is_available() is false, and alone in a directory."""
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src, \
                    open(script, "w") as dst:
                dst.write(src.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
