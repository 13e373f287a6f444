"""Port parity of the command line (``lightgbm_tpu_torch/cli.py``,
``python -m lightgbm_tpu_torch``) against ``lightgbm_tpu``, on the CPU
(``device=cpu`` in every call that trains or predicts).

- the cases of ``tests/test_cli.py`` on the port: the conf-file parse,
  train -> predict round trip, the reference example conf (where the
  reference examples are mounted) and the if-else C++ oracle compiled with
  ``g++``;
- a model trained from ``tests/fixtures/nan_det.train`` by the port's CLI
  is byte-equal to the port's ``lgt.train`` on the same file; against the
  JAX package's CLI (``tpu_hist_f64=true``) it meets ROADMAP C1's bar
  (every split feature and threshold equal, leaf values within 1e-6, the
  8 decision types that differ all the NaN-empty tie);
- ``python -m lightgbm_tpu_torch`` in a child process exits 0 and never
  imports ``jax`` or ``lightgbm_tpu`` (``-X importtime`` lists every
  module the child imported);
- ``data=`` naming a binary dataset file trains the same model as the
  arrays (the JAX package's CLI fails to read it, ROADMAP C20);
- ``task=serve_bench`` on a ``.proto`` model and ``snapshot_freq``.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.cli import main as jax_cli_main, parse_args as jax_parse_args
from lightgbm_tpu_torch.cli import main as cli_main, parse_args
from lightgbm_tpu_torch.io.file_io import load_data_file
from test_reference_models import EXAMPLES as REF_EXAMPLES

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAN_DET = os.path.join(HERE, "fixtures", "nan_det.train")
HAVE_REF = os.path.isdir(REF_EXAMPLES)
HAVE_GPP = os.system("which g++ > /dev/null 2>&1") == 0
# tests/test_torch_train.py's BASE: test_tree_parity.py's config
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
        "feature_fraction": 1.0, "bagging_freq": 0, "min_data_in_leaf": 50,
        "min_sum_hessian_in_leaf": 5.0, "verbose": -1, "tpu_wave_size": 1}


def _write_csv(path, X, y):
    with open(path, "w") as fh:
        for i in range(len(y)):
            fh.write(",".join([f"{y[i]:g}"] + [f"{v:.6g}" for v in X[i]]) + "\n")


def _argv(params):
    return [f"{k}={v}" for k, v in params.items()]


# ------------------------------------------------------ tests/test_cli.py

def test_parse_args_conf_and_overrides(tmp_path):
    conf = tmp_path / "train.conf"
    conf.write_text("task = train\n# a comment\nnum_trees = 7\n"
                    'data = "train.tsv"\n')
    argv = [f"config={conf}", "num_trees=9", "verbose=-1",
            "--telemetry-dir=/x/my-dir", "--dump-snapshot"]
    params = parse_args(argv)
    assert params["task"] == "train"
    assert params["num_trees"] == "9"          # argv beats conf
    assert params["data"] == "train.tsv"
    assert params == jax_parse_args(argv)
    assert parse_args(["predict"]) == jax_parse_args(["predict"]) == \
        {"task": "predict"}


def test_cli_train_predict_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(500, 5)
    y = X[:, 0] * 2 + X[:, 1] + 0.1 * rng.randn(500)
    data = tmp_path / "reg.csv"
    _write_csv(data, X, y)
    model = tmp_path / "model.txt"
    out = tmp_path / "preds.txt"
    assert cli_main([f"data={data}", "task=train", "objective=regression",
                     "num_trees=10", "num_leaves=7", "min_data_in_leaf=5",
                     f"output_model={model}", "device=cpu",
                     "verbose=-1"]) == 0
    assert model.exists()
    cli_main([f"data={data}", "task=predict", f"input_model={model}",
              f"output_result={out}", "verbose=-1", "device=cpu"])
    preds = np.loadtxt(out)
    bst = lgt.Booster(model_file=str(model), params={"device": "cpu"})
    np.testing.assert_allclose(preds, bst.predict(X), rtol=1e-10)
    # the JAX package's CLI predicting from the port's model file
    jout = tmp_path / "jax_preds.txt"
    jax_cli_main([f"data={data}", "task=predict", f"input_model={model}",
                  f"output_result={jout}", "verbose=-1"])
    np.testing.assert_allclose(preds, np.loadtxt(jout), rtol=1e-12)


@pytest.mark.skipif(not HAVE_REF, reason="reference examples not mounted")
def test_cli_reference_binary_conf(tmp_path):
    model = tmp_path / "model.txt"
    cli_main([f"data={REF_EXAMPLES}/binary_classification/binary.train",
              "task=train", "objective=binary", "metric=auc",
              "num_trees=20", "num_leaves=31", "device=cpu",
              f"output_model={model}", "verbose=-1"])
    bst = lgt.Booster(model_file=str(model), params={"device": "cpu"})
    X, yy, _ = load_data_file(
        f"{REF_EXAMPLES}/binary_classification/binary.test", {})
    p = bst.predict(X)
    order = np.argsort(p)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(p))
    npos = yy.sum()
    auc = (ranks[yy > 0].sum() - npos * (npos - 1) / 2) / (npos * (len(p) - npos))
    assert auc > 0.75


@pytest.mark.skipif(not HAVE_GPP, reason="g++ unavailable")
def test_ifelse_codegen_oracle(tmp_path):
    """Generated C++ reproduces Booster.predict (double math both sides),
    and the port's generated source is the JAX package's, byte for byte."""
    rng = np.random.RandomState(3)
    n = 1500
    cat = rng.randint(0, 9, n).astype(float)
    x1 = rng.randn(n)
    x2 = rng.randn(n)
    x2[rng.rand(n) < 0.2] = np.nan            # exercise missing handling
    y = (np.isin(cat, [1, 4]) * 2.0 + x1 + np.nan_to_num(x2) * 0.5
         + 0.1 * rng.randn(n))
    X = np.column_stack([cat, x1, x2])
    bst = lgt.train(dict(objective="regression", num_leaves=15, device="cpu",
                         min_data_in_leaf=5, use_missing=True, verbose=-1),
                    lgt.Dataset(X, label=y, categorical_feature=[0]),
                    num_boost_round=12)
    model = tmp_path / "m.txt"
    cpp, jcpp = tmp_path / "m.cpp", tmp_path / "j.cpp"
    so = tmp_path / "m.so"
    bst.save_model(str(model))
    cli_main([f"input_model={model}", "task=convert_model",
              f"convert_model={cpp}", "verbose=-1", "device=cpu"])
    jax_cli_main([f"input_model={model}", "task=convert_model",
                  f"convert_model={jcpp}", "verbose=-1"])
    assert cpp.read_text() == jcpp.read_text()
    subprocess.check_call(["g++", "-O2", "-shared", "-fPIC", str(cpp),
                           "-o", str(so)])
    lib = ctypes.CDLL(str(so))
    lib.PredictRawSingle.restype = ctypes.c_double
    lib.PredictRawSingle.argtypes = [ctypes.POINTER(ctypes.c_double)]
    expect = bst.predict(X, raw_score=True)
    Xc = np.ascontiguousarray(X, dtype=np.float64)
    got = np.array([
        lib.PredictRawSingle(Xc[i].ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        for i in range(200)])
    np.testing.assert_allclose(got, expect[:200], rtol=1e-12, atol=1e-12)


# --------------------------------------------------------- against the JAX

def test_nan_det_cli_model_equals_train_and_meets_c1(tmp_path):
    params = dict(BASE, objective="binary", use_missing=True)
    model = tmp_path / "cli.txt"
    cli_main([f"data={NAN_DET}", "task=train", "num_iterations=5",
              f"output_model={model}", "device=cpu", *_argv(params)])
    ours = lgt.train(dict(params, device="cpu"), lgt.Dataset(NAN_DET),
                     num_boost_round=5)
    assert model.read_text() == ours.model_to_string()
    # the JAX package's CLI on the same file, C1's bar
    jmodel = tmp_path / "jax.txt"
    jax_cli_main([f"data={NAN_DET}", "task=train", "num_iterations=5",
                  f"output_model={jmodel}", "device=cpu",
                  "tpu_hist_f64=true", *_argv(params)])
    ref = lgb.Booster(model_file=str(jmodel))
    cli = lgt.Booster(model_file=str(model), params={"device": "cpu"})
    assert len(cli.trees) == len(ref.trees) == 5
    flips = 0
    for a, b in zip(ref.trees, cli.trees):
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)
        diff = b.decision_type != a.decision_type
        np.testing.assert_array_equal(b.decision_type[diff],
                                      a.decision_type[diff] | 2)
        flips += int(diff.sum())
    assert flips == 8


def test_python_m_imports_neither_jax_nor_the_jax_package(tmp_path):
    model = tmp_path / "m.txt"
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "lightgbm_tpu_torch",
         f"data={NAN_DET}", "task=train", "objective=binary",
         "num_iterations=2", "num_leaves=7", f"output_model={model}",
         "device=cpu", "verbose=-1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert "lightgbm_tpu_torch.cli" in imported
    top = {name.split(".")[0] for name in imported}
    assert "jax" not in top and "lightgbm_tpu" not in top
    assert lgt.Booster(model_file=str(model)).num_trees() == 2


def test_cli_trains_from_a_binary_dataset_file(tmp_path):
    rng = np.random.RandomState(12)
    X = rng.randn(600, 6)
    y = (X[:, 0] - X[:, 2] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device": "cpu"}
    ds = lgt.Dataset(X, label=y, params=params)
    ds.construct()
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    model = tmp_path / "m.txt"
    cli_main([f"data={path}", "task=train", "num_iterations=4",
              f"output_model={model}", *_argv(params)])
    want = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=4)
    assert model.read_text() == want.model_to_string()
    # the JAX package's CLI sniffs the binary file as text (ROADMAP C20)
    with pytest.raises(UnicodeDecodeError):
        jax_cli_main([f"data={path}", "task=train", "num_iterations=1",
                      f"output_model={tmp_path / 'j.txt'}", *_argv(params)])


def test_cli_serve_bench_on_a_proto_model(tmp_path, capsys):
    rng = np.random.RandomState(13)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    data = tmp_path / "d.csv"
    _write_csv(data, X, y)
    bst = lgt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                     "device": "cpu"}, lgt.Dataset(X, label=y),
                    num_boost_round=3)
    proto = str(tmp_path / "m.proto")
    bst.save_model(proto)
    assert cli_main(["task=serve_bench", f"input_model={proto}",
                     f"data={data}", "device=cpu", "serve_buckets=4,64",
                     "verbose=-1"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["task"] == "serve_bench"
    assert sorted(report["shapes"]) == ["b1xc1", "b64xc4", "b8xc4"]
    assert all(not r["errors"] for r in report["shapes"].values())
    # the JAX package's report of the same file: the same keys and shapes
    assert jax_cli_main(["task=serve_bench", f"input_model={proto}",
                         f"data={data}", "serve_buckets=4,64",
                         "verbose=-1"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == set(theirs)
    for name, shape in report["shapes"].items():
        assert set(shape) == set(theirs["shapes"][name])
        assert {k: shape[k] for k in ("mode", "batch_rows", "concurrency",
                                      "requests", "n")} == \
            {k: theirs["shapes"][name][k] for k in (
                "mode", "batch_rows", "concurrency", "requests", "n")}


def test_cli_snapshot_freq_writes_snapshots(tmp_path):
    rng = np.random.RandomState(14)
    X = rng.randn(400, 4)
    y = X[:, 0] + 0.1 * rng.randn(400)
    data = tmp_path / "d.csv"
    _write_csv(data, X, y)
    model = str(tmp_path / "m.txt")
    cli_main([f"data={data}", "task=train", "objective=regression",
              "num_iterations=4", "snapshot_freq=2", "num_leaves=7",
              f"output_model={model}", "device=cpu", "verbose=-1"])
    final = lgt.Booster(model_file=model, params={"device": "cpu"})
    # the JAX package's CLI writes snapshots at the same iterations
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jax_cli_main([f"data={data}", "task=train", "objective=regression",
                  "num_iterations=4", "snapshot_freq=2", "num_leaves=7",
                  f"output_model={jdir / 'm.txt'}", "verbose=-1"])
    assert sorted(os.listdir(jdir)) == sorted(
        f for f in os.listdir(tmp_path) if f.startswith("m.txt"))
    for it in (2, 4):
        snap = lgt.Booster(model_file=f"{model}.snapshot_iter_{it}",
                           params={"device": "cpu"})
        assert snap.num_trees() == it
        np.testing.assert_array_equal(
            snap.predict(X, raw_score=True),
            final.predict(X, raw_score=True, num_iteration=it))
