"""Port parity of the model formats and the rest of the Booster API
(``lightgbm_tpu_torch/io/model_json.py``, ``model_proto.py``,
``codegen.py``, ``pmml.py``, ``plotting.py``; ``Booster.dump_model``,
``attr`` / ``set_attr``, ``get_leaf_output``, ``set_network``) against
``lightgbm_tpu``, on the CPU.

- the cases of ``tests/test_model_io.py``, ``test_booster_api.py``,
  ``test_pmml.py`` and ``test_plotting.py`` on the port, each API call
  also made on the JAX package (attributes, one-machine network
  parameters, feature names, categorical features, PMML files, plots and
  digraphs equal; ``set_network`` with two machines raises naming ROADMAP
  A16, where the JAX package records it);
- for a binary, a 3-class, a categorical and a linear-leaf model trained
  by the port and loaded from one model text in both packages:
  ``dump_model`` dict-equal, the ``.json`` file round trip (each package
  reads the other's file), the proto bytes byte-equal to the JAX
  package's ``model_pb2`` serialisation, and ``model_to_cpp`` and PMML
  text equal (PMML refuses linear leaves in both);
- the proto codec alone: with ``google.protobuf`` unimportable the port
  reads the reference fork's ``tests/fixtures/model_binary.proto`` and
  predicts as the JAX package does (and ``preds_binary_proto.txt`` where
  the reference examples are mounted); unpacked repeated fields and
  unknown fields of every wire type parse;
- ``ServingEngine`` serves a ``.proto`` and a ``.json`` file byte-equal
  to the text file.
"""
import json
import os
import struct
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import codegen as jcodegen
from lightgbm_tpu.io import pmml as jpmml
from lightgbm_tpu.io.model_proto import save_model_proto as jax_save_proto
from lightgbm_tpu_torch.io import model_proto
from lightgbm_tpu_torch.io.codegen import model_to_cpp
from lightgbm_tpu_torch.io.pmml import main as pmml_main, model_to_pmml
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_reference_models import EXAMPLES

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures")
CPU = {"device": "cpu", "verbose": -1}
KINDS = ("binary", "multiclass", "categorical", "linear")


# ----------------------------------------------- tests/test_model_io.py

@pytest.fixture(scope="module")
def trained():
    from sklearn.datasets import load_breast_cancer
    X, y = load_breast_cancer(return_X_y=True)
    bst = lgt.train(dict(CPU, objective="binary", num_leaves=15),
                    lgt.Dataset(X, label=y), num_boost_round=10)
    return bst, X, y


def test_text_roundtrip(trained, tmp_path):
    bst, X, y = trained
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    loaded = lgt.Booster(model_file=path, params=CPU)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               loaded.predict(X, raw_score=True), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(bst.predict(X), loaded.predict(X), rtol=1e-9)


def test_model_string_roundtrip(trained):
    bst, X, y = trained
    s = bst.model_to_string()
    assert s.startswith("tree\n")
    assert "feature_infos=" in s and "Tree=0" in s
    loaded = lgt.Booster(model_str=s, params=CPU)
    np.testing.assert_allclose(bst.predict(X), loaded.predict(X), rtol=1e-9)


def test_proto_roundtrip(trained, tmp_path):
    bst, X, y = trained
    path = str(tmp_path / "model.proto")
    bst.save_model(path)
    loaded = lgt.Booster(params=dict(CPU, model_format="proto"),
                         model_file=path)
    np.testing.assert_allclose(bst.predict(X), loaded.predict(X), rtol=1e-9)


def test_json_dump(trained):
    bst, X, y = trained
    d = bst.dump_model()
    json.dumps(d)  # must be serializable
    assert d["num_class"] == 1
    assert len(d["tree_info"]) == bst.num_trees()
    root = d["tree_info"][0]["tree_structure"]
    assert "split_feature" in root
    assert root["decision_type"] in ("<=", "==")
    assert bst.trees[0].leaf_count.sum() == len(y)


def test_truncated_save(trained, tmp_path):
    bst, X, y = trained
    path = str(tmp_path / "m5.txt")
    bst.save_model(path, num_iteration=5)
    loaded = lgt.Booster(model_file=path, params=CPU)
    assert loaded.num_trees() == 5
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               bst.predict(X, raw_score=True, num_iteration=5),
                               rtol=1e-9)


def test_multiclass_model_io(tmp_path):
    from sklearn.datasets import load_iris
    X, y = load_iris(return_X_y=True)
    bst = lgt.train(dict(CPU, objective="multiclass", num_class=3,
                         min_data_in_leaf=5), lgt.Dataset(X, label=y),
                    num_boost_round=8)
    path = str(tmp_path / "mc.txt")
    bst.save_model(path)
    loaded = lgt.Booster(model_file=path, params=CPU)
    assert loaded.num_model_per_iteration == 3
    np.testing.assert_allclose(bst.predict(X), loaded.predict(X), rtol=1e-8)


# ------------------------------------------- tests/test_booster_api.py

@pytest.fixture(scope="module")
def api_booster():
    rng = np.random.RandomState(8)
    X = rng.rand(800, 5)
    y = (X[:, 0] + 0.2 * rng.randn(800) > 0.5).astype(np.float32)
    ds = lgt.Dataset(X[:600], label=y[:600])
    vs = lgt.Dataset(X[600:], label=y[600:], reference=ds)
    bst = lgt.Booster(params=dict(CPU, objective="binary", num_leaves=15,
                                  metric="auc"), train_set=ds)
    bst.add_valid(vs, "va")
    for _ in range(8):
        bst.update()
    return bst, ds, vs, X, y


def test_eval_train_valid_and_eval(api_booster):
    bst, ds, vs, X, y = api_booster
    tr = bst.eval_train()
    assert tr and tr[0][0] == "training" and tr[0][1] == "auc"
    assert 0.5 < tr[0][2] <= 1.0
    va = bst.eval_valid()
    assert va and va[0][0] == "va"
    assert bst.eval(ds, "ignored")[0][0] == "training"
    assert bst.eval(vs, "ignored")[0][0] == "va"
    rng = np.random.RandomState(9)
    Xn = rng.rand(400, 5)
    yn = (Xn[:, 0] + 0.2 * rng.randn(400) > 0.5).astype(np.float32)
    fresh = lgt.Dataset(Xn, label=yn, reference=ds)
    out = bst.eval(fresh, "extra")
    assert out and out[0][0] == "extra"
    from bench import _auc
    want = _auc(yn, bst.predict(Xn))
    got = [v for d, n, v, h in out if n == "auc"][0]
    assert abs(got - want) < 5e-3, (got, want)
    assert got > 0.8

    def zero_metric(preds, dataset):
        return "zero", float(np.mean(preds) * 0), True

    assert ("training", "zero", 0.0, True) in bst.eval_train(zero_metric)
    assert any(r[1] == "zero" for r in bst.eval_valid(zero_metric))


def test_set_train_data_name(api_booster):
    bst = api_booster[0]
    bst.set_train_data_name("mytrain")
    assert bst.eval_train()[0][0] == "mytrain"
    bst.set_train_data_name("training")


def test_attr_roundtrip(api_booster):
    bst = api_booster[0]
    assert bst.attr("missing") is None
    bst.set_attr(owner="me", version="3")
    assert bst.attr("owner") == "me" and bst.attr("version") == "3"
    bst.set_attr(owner=None)
    assert bst.attr("owner") is None
    # the same calls on the JAX package's booster read the same values
    theirs = lgb.Booster(model_str=bst.model_to_string())
    assert theirs.set_attr(owner="me", version=3) is theirs
    theirs.set_attr(owner=None)
    assert bst.set_attr(version=3) is bst
    assert [bst.attr(k) for k in ("owner", "version", "missing")] == \
        [theirs.attr(k) for k in ("owner", "version", "missing")]


def test_num_feature_and_leaf_output(api_booster):
    bst = api_booster[0]
    assert bst.num_feature() == 5
    v = bst.get_leaf_output(0, 0)
    assert np.isfinite(v)
    s = bst.model_to_string()
    first = float([ln for ln in s.splitlines()
                   if ln.startswith("leaf_value=")][0].split("=")[1].split()[0])
    assert abs(v - first) < 1e-9
    root = bst.dump_model()["tree_info"][0]["tree_structure"]
    node = root
    while "left_child" in node:
        node = node["left_child"]
    assert node["leaf_value"] == bst.get_leaf_output(0, node["leaf_index"])
    theirs = lgb.Booster(model_str=s)
    assert [bst.get_leaf_output(t, 3) for t in range(8)] == \
        [theirs.get_leaf_output(t, 3) for t in range(8)]


def test_set_free_network(api_booster):
    """Two machines are recorded as the JAX package records them: the world
    is joined when training starts (a world of two trains through
    ``set_network`` in ``test_torch_multihost.py``); one machine too."""
    bst = api_booster[0]
    keys = ("machines", "local_listen_port", "time_out", "num_machines")
    theirs = lgb.Booster(model_str=bst.model_to_string())
    for machines, n in ((["10.0.0.1:12400", "10.0.0.2:12400"], 2),
                        (["10.0.0.1:12400"], 1)):
        bst.set_network(machines, local_listen_port=12400, num_machines=n)
        theirs.set_network(machines, local_listen_port=12400,
                           num_machines=n)
        assert bst.params["num_machines"] == n
        assert bst.params["machines"] == ",".join(machines)
        assert bst.config.num_machines == n
        assert {k: bst.params[k] for k in keys} == \
            {k: theirs.params[k] for k in keys}
    bst.free_network()
    theirs.free_network()
    assert not any(k in bst.params for k in keys)
    assert "machines" not in bst.params
    assert not set(keys) & (set(bst.params) | set(theirs.params))


def test_dataset_field_api_surface():
    rng = np.random.RandomState(14)
    X = rng.rand(300, 4)
    y = X[:, 0]
    ds = lgt.Dataset(X, label=y)
    ds.set_field("weight", np.ones(300))
    assert ds.get_field("weight") is not None
    ds.set_field("init_score", np.zeros(300))
    assert len(ds.get_init_score()) == 300
    with pytest.raises(ValueError, match="Unknown field"):
        ds.set_field("nope", y)

    va = lgt.Dataset(X[:100], label=y[:100])
    va.set_reference(ds)
    chain = va.get_ref_chain()
    assert ds in chain and va in chain

    ds.set_categorical_feature([1])
    ds.construct(lgt.Config.from_params(CPU))
    with pytest.raises(ValueError, match="categorical_feature"):
        ds.set_categorical_feature([2])
    with pytest.raises(ValueError, match="reference"):
        va.construct() and va.set_reference(lgt.Dataset(X, label=y))
    va.set_reference(ds)
    with pytest.raises(ValueError, match="Length of feature_name"):
        ds.set_feature_name(["a", "b"])
    ds.set_feature_name(["a", "b", "c", "d"])
    assert ds.constructed.feature_names == ["a", "b", "c", "d"]
    # the JAX package's Dataset under the same calls: the same names,
    # mappers (feature 1 categorical) and refusals
    jds = lgb.Dataset(X, label=y)
    jds.set_categorical_feature([1])
    jds.construct(lgb.Config.from_params(CPU))
    with pytest.raises(ValueError, match="categorical_feature"):
        jds.set_categorical_feature([2])
    with pytest.raises(ValueError, match="Length of feature_name"):
        jds.set_feature_name(["a", "b"])
    jds.set_feature_name(["a", "b", "c", "d"])
    assert jds.constructed.feature_names == ds.constructed.feature_names
    assert [m.bin_type for m in jds.constructed.mappers] == \
        [m.bin_type for m in ds.constructed.mappers]
    np.testing.assert_array_equal(jds.constructed.X_binned,
                                  ds.constructed.X_binned)

    rk = lgt.Dataset(X, label=(y > 0.5).astype(int),
                     group=np.array([150, 150]))
    assert list(rk.get_group()) == [150, 150]


def test_train_learning_rates_schedule():
    rng = np.random.RandomState(15)
    X = rng.rand(500, 4)
    y = X[:, 0] * 2 + 0.1 * rng.randn(500)
    base = dict(CPU, objective="regression", num_leaves=7, learning_rate=0.5)
    b1 = lgt.train(dict(base), lgt.Dataset(X, label=y), num_boost_round=6)
    b2 = lgt.train(dict(base), lgt.Dataset(X, label=y), num_boost_round=6,
                   learning_rates=lambda it: 0.5 * (0.1 ** it))
    l1 = [abs(b1.get_leaf_output(5, i)) for i in range(3)]
    l2 = [abs(b2.get_leaf_output(5, i)) for i in range(3)]
    assert max(l2) < max(l1)


def test_add_valid_guards(api_booster):
    bst, ds, vs, X, y = api_booster
    dup = lgt.Dataset(X[:50], label=y[:50], reference=ds)
    with pytest.raises(LightGBMError, match="unique"):
        bst.add_valid(dup, "va")
    freed = lgt.Dataset(X[:50], label=y[:50], reference=ds,
                        free_raw_data=True)
    freed.construct()
    assert freed.raw_data is None
    with pytest.raises(LightGBMError, match="free_raw_data"):
        bst.add_valid(freed, "freed")
    assert all(r[0] != "freed" for r in bst.eval_valid())
    ok = lgt.Dataset(X[:50], label=y[:50], reference=ds)
    bst.add_valid(ok, "freed")
    assert any(r[0] == "freed" for r in bst.eval_valid())


# --------------------------------------------------- tests/test_pmml.py

NS = {"p": "http://www.dmg.org/PMML-4_2"}


def _eval_pmml_tree(node, row):
    children = node.findall("p:Node", NS)
    if not children:
        return float(node.get("score"))
    for child in children:
        pred = child.find("p:SimplePredicate", NS)
        if pred is not None:
            v = row[pred.get("field")]
            thr = float(pred.get("value"))
            ok = v <= thr if pred.get("operator") == "lessOrEqual" else v > thr
            if ok:
                return _eval_pmml_tree(child, row)
            continue
        sset = child.find("p:SimpleSetPredicate", NS)
        if sset is not None:
            vals = set((sset.find("p:Array", NS).text or "").split())
            inside = str(int(row[sset.get("field")])) in vals
            if inside == (sset.get("booleanOperator") == "isIn"):
                return _eval_pmml_tree(child, row)
            continue
        if child.find("p:True", NS) is not None:
            return _eval_pmml_tree(child, row)
    raise AssertionError("no predicate matched")


def test_pmml_reproduces_raw_predictions():
    bst = lgt.Booster(model_file=os.path.join(FIX, "model_regression.txt"),
                      params=CPU)
    xml_text = model_to_pmml(bst)
    assert xml_text == jpmml.model_to_pmml(lgb.Booster(
        model_file=os.path.join(FIX, "model_regression.txt")))
    root = ET.fromstring(xml_text)
    trees = root.findall(".//p:TreeModel", NS)
    assert len(trees) == bst.num_trees()
    rng = np.random.RandomState(0)
    X = rng.rand(20, bst.num_total_features) * 3
    expect = bst.predict(X, raw_score=True)
    names = bst.feature_name()
    for i in range(X.shape[0]):
        row = dict(zip(names, X[i]))
        total = sum(_eval_pmml_tree(t.find("p:Node", NS), row) for t in trees)
        assert abs(total - expect[i]) < 1e-6, (i, total, expect[i])


def test_pmml_cli(tmp_path):
    out = str(tmp_path / "m.pmml")
    pmml_main([os.path.join(FIX, "model_binary.txt"), out])
    assert ET.parse(out).getroot().tag.endswith("PMML")
    jout = str(tmp_path / "jax.pmml")
    jpmml.main([os.path.join(FIX, "model_binary.txt"), jout])
    with open(out) as a, open(jout) as b:
        assert a.read() == b.read()
    with pytest.raises(SystemExit):
        pmml_main([])


# ----------------------------------------------- tests/test_plotting.py

@pytest.fixture(scope="module")
def plotted():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    rng = np.random.RandomState(0)
    X = rng.rand(300, 5)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.7).astype(float)
    params = dict(CPU, objective="binary", num_leaves=7, min_data_in_leaf=5,
                  metric="binary_logloss")
    ds = lgt.Dataset(X, label=y)
    record = {}
    bst = lgt.train(params, ds, num_boost_round=10, valid_sets=[ds],
                    valid_names=["train"],
                    callbacks=[lgt.record_evaluation(record)])
    return bst, record


def test_plot_importance(plotted):
    bst, _ = plotted
    ax = lgt.plot_importance(bst)
    assert ax.get_title() == "Feature importance"
    assert ax.get_xlabel() == "Feature importance"
    assert len(ax.patches) >= 1
    # the JAX package's plot of the same model text: the same bars
    jax_ax = lgb.plot_importance(lgb.Booster(model_str=bst.model_to_string()))
    assert [p.get_width() for p in ax.patches] == \
        [p.get_width() for p in jax_ax.patches]
    assert [t.get_text() for t in ax.get_yticklabels()] == \
        [t.get_text() for t in jax_ax.get_yticklabels()]
    ax2 = lgt.plot_importance(bst, max_num_features=1, title="t",
                              xlabel="x", ylabel="y")
    assert len(ax2.patches) == 1
    assert ax2.get_title() == "t"


def test_plot_metric(plotted):
    _, record = plotted
    ax = lgt.plot_metric(record)
    assert ax.get_ylabel() == "binary_logloss"
    assert len(ax.get_lines()) == 1
    assert len(ax.get_lines()[0].get_xdata()) == 10
    jax_ax = lgb.plot_metric(record)
    np.testing.assert_array_equal(ax.get_lines()[0].get_ydata(),
                                  jax_ax.get_lines()[0].get_ydata())
    assert (ax.get_title(), ax.get_xlabel()) == \
        (jax_ax.get_title(), jax_ax.get_xlabel())
    with pytest.raises(ValueError):
        lgt.plot_metric(record, metric="not_recorded")
    with pytest.raises(TypeError):
        lgt.plot_metric(lgt.Dataset(np.zeros((2, 2))))


def test_plot_tree(plotted):
    bst, _ = plotted
    info = ["split_gain", "internal_count", "leaf_count"]
    ax = lgt.plot_tree(bst, tree_index=1, show_info=info)
    assert len(ax.texts) > 3
    jax_ax = lgb.plot_tree(lgb.Booster(model_str=bst.model_to_string()),
                           tree_index=1, show_info=info)
    assert [t.get_text() for t in ax.texts] == \
        [t.get_text() for t in jax_ax.texts]
    with pytest.raises(IndexError):
        lgt.plot_tree(bst, tree_index=99)


def test_create_tree_digraph(plotted):
    graphviz = pytest.importorskip("graphviz")
    bst, _ = plotted
    g = lgt.create_tree_digraph(bst, tree_index=0,
                                show_info=["split_gain", "leaf_count"])
    assert isinstance(g, graphviz.Digraph)
    src = g.source
    assert "leaf" in src and "->" in src
    assert src == lgb.create_tree_digraph(
        lgb.Booster(model_str=bst.model_to_string()), tree_index=0,
        show_info=["split_gain", "leaf_count"]).source


# ------------------------------------- one model text in both packages

_MODELS = {}


def _model(kind):
    """(model text, X) of a small model of ``kind`` trained by the port."""
    if kind not in _MODELS:
        rng = np.random.RandomState(31)
        X = rng.randn(600, 5)
        X[rng.rand(600) < 0.1, 1] = np.nan
        X[:, 3] = rng.randint(0, 6, 600)
        params = dict(CPU, num_leaves=7, min_data_in_leaf=10)
        cat = "auto"
        if kind == "binary":
            params["objective"] = "binary"
            y = (X[:, 0] + np.nan_to_num(X[:, 1]) > 0).astype(float)
        elif kind == "multiclass":
            params.update(objective="multiclass", num_class=3)
            y = np.digitize(X[:, 0] + X[:, 2], [-0.5, 0.5]).astype(float)
        elif kind == "categorical":
            params.update(objective="binary", min_data_per_group=5,
                          cat_smooth=1.0)
            cat = [3]
            y = (np.isin(X[:, 3], [1, 4]) ^ (X[:, 0] > 1)).astype(float)
        else:
            params.update(objective="regression", linear_tree=True)
            y = np.where(X[:, 0] > 0, 2 * X[:, 2], -X[:, 4])
        bst = lgt.train(params, lgt.Dataset(X, label=y,
                                            categorical_feature=cat),
                        num_boost_round=4)
        if kind == "categorical":
            assert any(np.any(t.decision_type & 1) for t in bst.trees)
        _MODELS[kind] = (bst.model_to_string(), X)
    return _MODELS[kind]


def _both(kind):
    text, X = _model(kind)
    return (lgt.Booster(model_str=text, params=CPU),
            lgb.Booster(model_str=text), X)


@pytest.mark.parametrize("kind", KINDS)
def test_dump_model_equal_to_jax(kind):
    ours, theirs, _ = _both(kind)
    assert ours.dump_model() == theirs.dump_model()
    assert ours.dump_model(num_iteration=2) == \
        theirs.dump_model(num_iteration=2)


@pytest.mark.parametrize("kind", KINDS)
def test_json_file_round_trip(kind, tmp_path):
    ours, theirs, X = _both(kind)
    mine, jax_file = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    ours.save_model(mine)
    theirs.save_model(jax_file)
    with open(mine) as a, open(jax_file) as b:
        assert json.load(a) == json.load(b)
    want = ours.predict(X)
    for path in (mine, jax_file):
        back = lgt.Booster(model_file=path, params=CPU)
        np.testing.assert_array_equal(back.predict(X), want)
        assert back.dump_model() == ours.dump_model()
    np.testing.assert_array_equal(
        lgb.Booster(model_file=mine).predict(X), theirs.predict(X))


@pytest.mark.parametrize("kind", KINDS)
def test_proto_bytes_equal_to_model_pb2(kind, tmp_path):
    ours, theirs, X = _both(kind)
    jax_file = str(tmp_path / "j.proto")
    jax_save_proto(theirs, jax_file)
    with open(jax_file, "rb") as fh:
        want = fh.read()
    assert model_proto.model_to_proto_bytes(ours) == want
    assert model_proto.model_to_proto_bytes(ours, num_iteration=2) == \
        _jax_proto_bytes(theirs, 2, tmp_path)
    mine = str(tmp_path / "p.proto")
    ours.save_model(mine)
    back = lgt.Booster(model_file=mine, params=CPU)
    np.testing.assert_array_equal(back.predict(X), ours.predict(X))
    np.testing.assert_array_equal(lgb.Booster(model_file=mine).predict(X),
                                  theirs.predict(X))


def _jax_proto_bytes(booster, num_iteration, tmp_path):
    path = str(tmp_path / f"j{num_iteration}.proto")
    jax_save_proto(booster, path, num_iteration)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("kind", KINDS)
def test_cpp_and_pmml_text_equal_to_jax(kind):
    ours, theirs, _ = _both(kind)
    assert model_to_cpp(ours) == jcodegen.model_to_cpp(theirs)
    if kind == "linear":
        for fn, bst in ((model_to_pmml, ours), (jpmml.model_to_pmml, theirs)):
            with pytest.raises(ValueError, match="linear"):
                fn(bst)
    else:
        assert model_to_pmml(ours) == jpmml.model_to_pmml(theirs)


# ------------------------------------------------------ the proto codec

_NO_PROTOBUF = r"""
import json, sys
sys.modules["google"] = None
sys.modules["google.protobuf"] = None
sys.path.insert(0, {root!r})
import numpy as np
import lightgbm_tpu_torch as lgt
try:
    import google.protobuf
    blocked = False
except ImportError:
    blocked = True
bst = lgt.Booster(model_file={path!r}, params={{"device": "cpu"}})
X = np.random.RandomState(0).rand(300, bst.num_total_features) * 3
X[::7, 2] = np.nan
print(json.dumps({{"blocked": blocked, "pred": bst.predict(X).tolist(),
                  "protobuf_loaded": "google.protobuf" in sys.modules
                  and sys.modules["google.protobuf"] is not None,
                  "jax": "jax" in sys.modules}}))
"""


def test_reference_proto_fixture_without_protobuf():
    path = os.path.join(FIX, "model_binary.proto")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PROTOBUF.format(root=ROOT, path=path)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["blocked"] and not out["protobuf_loaded"] and not out["jax"]
    ref = lgb.Booster(model_file=path)
    X = np.random.RandomState(0).rand(300, ref.num_total_features) * 3
    X[::7, 2] = np.nan
    np.testing.assert_array_equal(np.asarray(out["pred"]), ref.predict(X))
    data_file = f"{EXAMPLES}/binary_classification/binary.test"
    if os.path.exists(data_file):
        from lightgbm_tpu_torch.io.file_io import load_data_file
        Xt, _, _ = load_data_file(data_file, {})
        bst = lgt.Booster(model_file=path, params=CPU)
        np.testing.assert_allclose(
            bst.predict(Xt), np.loadtxt(os.path.join(FIX,
                                                     "preds_binary_proto.txt")),
            rtol=1e-6, atol=1e-9)


def _key(num, wt):
    out = bytearray()
    model_proto._varint(num << 3 | wt, out)
    return bytes(out)


def _varint(v):
    out = bytearray()
    model_proto._varint(v, out)
    return bytes(out)


def _unknowns():
    """One unknown field of each wire type: varint, fixed64, length-
    delimited, fixed32."""
    return (_key(99, 0) + _varint(300) + _key(98, 1) + b"\x01" * 8
            + _key(97, 2) + _varint(3) + b"abc" + _key(96, 5) + b"\x02" * 4)


def test_proto_unpacked_repeated_and_unknown_fields_parse(tmp_path):
    text, X = _model("categorical")
    ours = lgt.Booster(model_str=text, params=CPU)
    packed = model_proto.model_to_proto_bytes(ours)
    ref = model_proto.decode(packed)
    # the same model with every repeated scalar unpacked and unknown fields
    # of each wire type in the model and in every tree
    out = bytearray()
    for num in sorted(model_proto._MODEL_FIELDS):
        name, typ = model_proto._MODEL_FIELDS[num]
        value = getattr(ref, name)
        if typ == "rep_tree":
            for t in value:
                body = bytearray(_unknowns())
                for tnum in sorted(model_proto._TREE_FIELDS):
                    tname, ttyp = model_proto._TREE_FIELDS[tnum]
                    tval = getattr(t, tname)
                    if not ttyp.startswith("rep_"):
                        one = model_proto.new_message("tree")
                        setattr(one, tname, tval)
                        body += model_proto.encode(one, "tree")
                        continue
                    base = ttyp[4:]
                    for v in tval:
                        if base == "double":
                            body += _key(tnum, 1) + struct.pack("<d", v)
                        else:
                            one = bytearray()
                            model_proto._encode_scalar(base, v, tname, one)
                            body += _key(tnum, 0) + bytes(one)
                out += _key(num, 2) + _varint(len(body)) + body
        else:
            one = model_proto.new_message("model")
            setattr(one, name, value)
            out += model_proto.encode(one)
    out += _unknowns()
    got = model_proto.decode(bytes(out))
    assert vars(got).keys() == vars(ref).keys()
    for name in vars(ref):
        if name == "trees":
            assert [vars(t) for t in got.trees] == [vars(t) for t in ref.trees]
        else:
            assert getattr(got, name) == getattr(ref, name), name
    assert len(out) > len(packed)
    path = str(tmp_path / "unpacked.proto")
    with open(path, "wb") as fh:
        fh.write(bytes(out))
    back = lgt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(back.predict(X), ours.predict(X))


def test_proto_codec_corner_values():
    """-0.0 is written (its bits are not zero), 0.0 and false omitted;
    sint32 zig-zag at the int32 extremes; a uint32 out of range raises like
    protobuf."""
    t = model_proto.new_message("tree")
    t.shrinkage = -0.0
    assert model_proto.encode(t, "tree") == b"y" + struct.pack("<d", -0.0)
    t.shrinkage = 0.0
    assert model_proto.encode(t, "tree") == b""
    t.left_child = [-(1 << 31), (1 << 31) - 1, -1, 0]
    back = model_proto.decode(model_proto.encode(t, "tree"), "tree")
    assert back.left_child == t.left_child
    t.leaf_count = [-1]
    with pytest.raises(ValueError, match="uint32"):
        model_proto.encode(t, "tree")


# ------------------------------------------------- serving the formats

def test_serving_engine_serves_proto_and_json_like_text(tmp_path):
    from lightgbm_tpu_torch.serving import ServingEngine
    text, X = _model("binary")
    bst = lgt.Booster(model_str=text, params=CPU)
    paths = {}
    for ext in ("txt", "proto", "json"):
        paths[ext] = str(tmp_path / f"m.{ext}")
        bst.save_model(paths[ext])
    served = {}
    for ext, path in paths.items():
        eng = ServingEngine(path, params=dict(CPU, serve_buckets="4,32"))
        served[ext] = eng.predict(X[:100])
        eng.close()
    for ext in ("proto", "json"):
        assert served[ext].tobytes() == served["txt"].tobytes(), ext
