"""Port parity of the file front end (``lightgbm_tpu_torch/io/file_io.py``,
``Dataset(path)``, ``save_binary`` / ``load_binary``) against
``lightgbm_tpu``, on the CPU.

- the cases of ``tests/test_loading.py`` on the port (the chunked-load case
  at 200,000 rows, also array-equal to the JAX package's parse);
- ``load_data_file`` array-equal (NaN-aware) to the JAX package's on CSV,
  TSV and LibSVM, with a header, name-spec columns, side files and every
  ``_NA_VALUES`` token;
- without pandas, CSV and TSV files (two-round too) refused naming it,
  and LibSVM files still equal to the JAX package's parse;
- a binary dataset file written by ``lightgbm_tpu`` read by the port in a
  child process that imports only the port (``lightgbm_tpu`` and ``jax``
  absent from its ``sys.modules`` afterwards), its codes and mappers equal
  and its model equal to the port's own file's; a pickle naming any other
  global refused before its module is imported;
- a deferred (device-ingest) dataset saved with host codes, still deferred.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import file_io as jfile_io
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.file_io import (_group_ids_to_sizes,
                                           is_binary_dataset, load_data_file,
                                           stream_construct_dataset)
from lightgbm_tpu_torch.utils.log import LightGBMError

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu", "verbose": -1}


def _write_csv(path, mat, header=None):
    with open(path, "w") as fh:
        if header:
            fh.write(",".join(header) + "\n")
        np.savetxt(fh, mat, delimiter=",", fmt="%.6g")


def _nan_equal(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _hide_pandas(monkeypatch):
    """pandas made unimportable for the loader."""
    monkeypatch.setitem(sys.modules, "pandas", None)


# ---------------------------------------------------- tests/test_loading.py

def test_group_ids_to_sizes():
    ids = np.array([1, 1, 1, 4, 4, 2, 2, 2, 2])
    np.testing.assert_array_equal(_group_ids_to_sizes(ids), [3, 2, 4])
    np.testing.assert_array_equal(_group_ids_to_sizes(ids),
                                  jfile_io._group_ids_to_sizes(ids))


def test_weight_group_ignore_columns_by_index(tmp_path):
    rng = np.random.RandomState(0)
    n = 40
    feats = rng.rand(n, 3)
    label = rng.randint(0, 2, n).astype(float)
    weight = rng.rand(n) + 0.5
    qid = np.repeat([0, 1, 2, 3], 10).astype(float)
    junk = np.full(n, 7.0)
    # file layout: label, f0, weight, f1, qid, junk, f2
    mat = np.column_stack([label, feats[:, 0], weight, feats[:, 1], qid,
                           junk, feats[:, 2]])
    p = str(tmp_path / "d.csv")
    _write_csv(p, mat)
    spec = {"label_column": "0", "weight_column": "2",
            "group_column": "4", "ignore_column": "5"}
    X, lab, side = load_data_file(p, spec)
    np.testing.assert_allclose(lab, label, rtol=1e-5)
    np.testing.assert_allclose(X, feats, rtol=1e-5)
    np.testing.assert_allclose(side["weight"], weight, rtol=1e-5)
    np.testing.assert_array_equal(side["group"], [10, 10, 10, 10])
    jX, jlab, jside = jfile_io.load_data_file(p, spec)
    assert _nan_equal(X, jX) and _nan_equal(lab, jlab)
    assert _nan_equal(side["weight"], jside["weight"])


def test_columns_by_name_with_header(tmp_path):
    rng = np.random.RandomState(1)
    n = 30
    mat = np.column_stack([rng.rand(n), rng.randint(0, 2, n).astype(float),
                           rng.rand(n)])
    p = str(tmp_path / "h.csv")
    _write_csv(p, mat, header=["w", "target", "x0"])
    X, lab, side = load_data_file(
        p, {"has_header": True, "label_column": "name:target",
            "weight_column": "name:w"})
    np.testing.assert_allclose(lab, mat[:, 1], rtol=1e-5)
    np.testing.assert_allclose(side["weight"], mat[:, 0], rtol=1e-5)
    assert side["feature_names"] == ["x0"]
    assert X.shape == (n, 1)


def test_two_round_matches_in_memory(tmp_path):
    rng = np.random.RandomState(2)
    n = 5000
    feats = rng.randn(n, 6)
    label = (feats[:, 0] > 0).astype(float)
    p = str(tmp_path / "big.csv")
    _write_csv(p, np.column_stack([label, feats]))

    cfg = Config.from_params(CPU)
    cd_stream = stream_construct_dataset(p, cfg)
    ds_mem = lgt.Dataset(p)
    ds_mem.construct(cfg)
    cd_mem = ds_mem.constructed

    assert cd_stream.num_data == cd_mem.num_data == n
    assert cd_stream.num_features == cd_mem.num_features
    np.testing.assert_allclose(cd_stream.metadata.label,
                               cd_mem.metadata.label, rtol=1e-5)
    # both see all rows (n < bin_construct_sample_cnt): equal codes
    np.testing.assert_array_equal(cd_stream.X_binned, cd_mem.X_binned)
    # and the JAX package's two-round codes
    from lightgbm_tpu.config import Config as JConfig
    jcd = jfile_io.stream_construct_dataset(p, JConfig.from_params(CPU))
    np.testing.assert_array_equal(cd_stream.X_binned, jcd.X_binned)


def test_two_round_via_dataset_param(tmp_path):
    rng = np.random.RandomState(3)
    n = 2000
    feats = rng.randn(n, 4)
    label = feats[:, 0] * 2 + 0.1 * rng.randn(n)
    _write_csv(str(tmp_path / "t.csv"), np.column_stack([label, feats]))
    ds = lgt.Dataset(str(tmp_path / "t.csv"), params={"two_round": True})
    bst = lgt.train(dict(CPU, objective="regression"), ds,
                    num_boost_round=5)
    assert ds.constructed is not None and ds._stream_path is not None
    pred = bst.predict(feats)
    assert np.mean((pred - label) ** 2) < np.var(label)


def test_binary_autodetect_roundtrip(tmp_path):
    rng = np.random.RandomState(4)
    X = rng.randn(500, 5)
    y = (X[:, 0] > 0).astype(float)
    ds = lgt.Dataset(X, label=y)
    ds.construct(Config.from_params(CPU))
    bin_path = str(tmp_path / "d.bin")
    ds.save_binary(bin_path)
    assert is_binary_dataset(bin_path)
    assert not is_binary_dataset(__file__)

    ds2 = lgt.Dataset(bin_path)
    assert ds2.num_data() == 500
    bst = lgt.train(dict(CPU, objective="binary"), ds2, num_boost_round=5)
    acc = np.mean((bst.predict(X) > 0.5) == y)
    assert acc > 0.85


def test_chunked_load_speed(tmp_path):
    """200,000 x 10 CSV parses through the chunked C reader in seconds, and
    equal to the JAX package's parse."""
    rng = np.random.RandomState(5)
    n = 200_000
    mat = np.column_stack([rng.randint(0, 2, n).astype(np.float32),
                           rng.rand(n, 10).astype(np.float32)])
    p = str(tmp_path / "big.csv")
    _write_csv(p, mat)
    t0 = time.perf_counter()
    X, lab, _ = load_data_file(p, {})
    dt = time.perf_counter() - t0
    assert X.shape == (n, 10)
    assert dt < 30, f"load took {dt:.1f}s"
    jX, jlab, _ = jfile_io.load_data_file(p, {})
    assert _nan_equal(X, jX) and _nan_equal(lab, jlab)


def test_libsvm_two_round_matches_one_round(tmp_path):
    rng = np.random.RandomState(2)
    n, f = 2000, 10
    X = np.zeros((n, f))
    nz = rng.rand(n, f) < 0.3
    X[nz] = rng.rand(int(nz.sum())) * 5
    y = (X[:, 0] - X[:, 1] > 0.4).astype(int)
    path = str(tmp_path / "data.libsvm")
    with open(path, "w") as fh:
        for i in range(n):
            feats = " ".join(f"{j}:{X[i, j]:.6g}" for j in range(f)
                             if X[i, j] != 0)
            fh.write(f"{y[i]} {feats}\n")
    params = dict(CPU, max_bin=63)
    one = lgt.Dataset(path, params=dict(params))
    one.construct()
    two = lgt.Dataset(path, params=dict(params, use_two_round_loading=True))
    two.construct()
    a, b = one._constructed, two._constructed
    np.testing.assert_array_equal(a.real_feature_idx, b.real_feature_idx)
    np.testing.assert_array_equal(a.X_binned, b.X_binned)
    np.testing.assert_array_equal(a.metadata.label, b.metadata.label)
    jtwo = lgb.Dataset(path, params=dict(params, use_two_round_loading=True))
    jtwo.construct()
    np.testing.assert_array_equal(b.X_binned, jtwo._constructed.X_binned)


def test_binary_dataset_preserves_raw_slice_for_linear(tmp_path):
    rng = np.random.RandomState(2)
    X = rng.randn(500, 4) * 2
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1], -X[:, 2])
    p_lin = dict(CPU, objective="regression", num_leaves=8,
                 min_data_in_leaf=10, linear_tree=True)
    ds = lgt.Dataset(X, label=y, params=p_lin)
    ds.construct()
    bpath = str(tmp_path / "lin.bin")
    ds.save_binary(bpath)
    ds2 = lgt.Dataset(bpath, params=p_lin)
    ds2.construct()
    assert ds2._constructed.X_raw is not None
    np.testing.assert_array_equal(ds2._constructed.X_raw,
                                  ds._constructed.X_raw)
    b = lgt.train(p_lin, ds2, num_boost_round=2)
    assert any(t.is_linear for t in b.trees)
    # a binary dataset written WITHOUT the raw slice fails loudly
    p_const = dict(p_lin, linear_tree=False)
    ds3 = lgt.Dataset(X, label=y, params=p_const)
    ds3.construct()
    bpath2 = str(tmp_path / "const.bin")
    ds3.save_binary(bpath2)
    ds4 = lgt.Dataset(bpath2, params=p_lin)
    with pytest.raises(LightGBMError, match="raw feature slice"):
        lgt.train(p_lin, ds4, num_boost_round=1)


# ------------------------------------------------ load_data_file vs the JAX

_NA_TOKENS = ["", "na", "NA", "nan", "NaN", "null", "N/A"]


def _table(seed=7, n=60):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 2, n).astype(float)
    weight = np.round(rng.rand(n) + 0.5, 4)
    qid = np.repeat(np.arange(6), 10).astype(float)
    feats = np.round(rng.randn(n, 4) * 10, 5)
    return label, weight, qid, feats


def _write_text(path, sep, header, rows):
    with open(path, "w") as fh:
        if header:
            fh.write(sep.join(header) + "\n")
        for r in rows:
            fh.write(sep.join(r) + "\n")


@pytest.mark.parametrize("fmt", ["csv", "tsv", "libsvm"])
def test_load_data_file_equal_to_jax(tmp_path, fmt):
    label, weight, qid, feats = _table()
    n = len(label)
    path = str(tmp_path / f"d.{fmt}")
    if fmt == "libsvm":
        with open(path, "w") as fh:
            for i in range(n):
                toks = " ".join(f"{j}:{feats[i, j]:g}" for j in range(4)
                                if i % 3 != j)
                fh.write(f"{label[i]:g} {toks}\n")
        spec = {}
    else:
        sep = "," if fmt == "csv" else "\t"
        header = ["qid", "y", "w", "a", "b", "c", "d"]
        rows = []
        for i in range(n):
            cells = [f"{qid[i]:g}", f"{label[i]:g}", f"{weight[i]:g}"] + \
                [f"{v:g}" for v in feats[i]]
            # every NA token, in the feature cells
            cells[3 + i % 4] = _NA_TOKENS[i % len(_NA_TOKENS)] \
                if i % 2 == 0 else cells[3 + i % 4]
            rows.append(cells)
        _write_text(path, sep, header, rows)
        spec = {"has_header": True, "label_column": "name:y",
                "weight_column": "name:w", "group_column": "name:qid",
                "ignore_column": "name:c"}
    # side files: init scores (and query sizes for LibSVM)
    np.savetxt(path + ".init", np.linspace(-1, 1, n))
    if fmt == "libsvm":
        np.savetxt(path + ".query", np.full(6, 10), fmt="%d")
    ours = load_data_file(path, spec)
    theirs = jfile_io.load_data_file(path, spec)
    assert _nan_equal(ours[0], theirs[0]) and _nan_equal(ours[1], theirs[1])
    assert set(ours[2]) == set(theirs[2])
    for key in ours[2]:
        if key == "feature_names":
            assert ours[2][key] == theirs[2][key]
        else:
            assert _nan_equal(ours[2][key], theirs[2][key]), key
    if fmt != "libsvm":
        # the tokens of rows i % 4 == 2 fall in the ignored column c
        assert np.isnan(ours[0]).sum() == n // 4
        assert ours[2]["feature_names"] == ["a", "b", "d"]
        # and Dataset(path) trains from it like arrays with its side fields
        ds = lgt.Dataset(path, params=spec)
        assert ds.feature_name == ["a", "b", "d"]
        assert _nan_equal(ds.get_weight(), theirs[2]["weight"])


@pytest.mark.parametrize("fmt", ["csv", "tsv", "two_round"])
def test_text_files_need_pandas(tmp_path, monkeypatch, fmt):
    """Without pandas a CSV or TSV file is refused naming it: no other
    reader gives the JAX package's floats (ROADMAP C22)."""
    label, _, _, feats = _table(seed=11)
    sep = "\t" if fmt == "tsv" else ","
    path = str(tmp_path / "d.txt")
    _write_text(path, sep, None,
                [[f"{label[i]:g}"] + [f"{v:.6g}" for v in feats[i]]
                 for i in range(len(label))])
    _hide_pandas(monkeypatch)
    with pytest.raises(LightGBMError, match="needs pandas"):
        if fmt == "two_round":
            lgt.Dataset(path, params=dict(CPU, two_round=True)).construct()
        else:
            load_data_file(path, {})


def test_libsvm_reads_without_pandas(tmp_path, monkeypatch):
    label, _, _, feats = _table(seed=11)
    path = str(tmp_path / "d.svm")
    with open(path, "w") as fh:
        for i in range(len(label)):
            toks = " ".join(f"{j}:{feats[i, j]:.17g}" for j in range(4)
                            if i % 3 != j)
            fh.write(f"{label[i]:g} {toks}\n")
    theirs = jfile_io.load_data_file(path, {})
    _hide_pandas(monkeypatch)
    ours = load_data_file(path, {})
    assert _nan_equal(ours[0], theirs[0]) and _nan_equal(ours[1], theirs[1])


def test_has_header_string_false_keeps_the_first_row(tmp_path):
    """``has_header=false`` from a conf file or the command line arrives as
    a string; the JAX package takes any non-empty string as true and drops
    the first data row (ROADMAP C21), the port parses it."""
    mat = np.arange(30, dtype=float).reshape(10, 3)
    path = str(tmp_path / "h.csv")
    _write_csv(path, mat)
    X, lab, _ = load_data_file(path, {"has_header": "false"})
    assert X.shape == (10, 2)
    jX, _, _ = jfile_io.load_data_file(path, {"has_header": "false"})
    assert jX.shape == (9, 2)
    np.testing.assert_array_equal(X[1:], jX)


# ----------------------------------------------------- binary dataset files

_CHILD = r"""
import json, sys
import numpy as np
sys.path.insert(0, {root!r})
import lightgbm_tpu_torch as lgt
ds = lgt.Dataset({path!r})
ds.construct()
cd = ds.constructed
bst = lgt.train({{"objective": "binary", "device": "cpu", "verbose": -1,
                 "num_leaves": 7}}, ds, num_boost_round=3)
print(json.dumps({{
    "jax": "jax" in sys.modules,
    "lightgbm_tpu": any(m == "lightgbm_tpu" or m.startswith("lightgbm_tpu.")
                        for m in sys.modules),
    "codes": cd.X_binned.tolist(),
    "mapper_type": type(cd.mappers[0]).__module__,
    "text": bst.model_to_string()}}))
"""


def _jax_binary_file(tmp_path, **params):
    rng = np.random.RandomState(21)
    X = rng.randn(400, 5)
    X[rng.rand(400) < 0.1, 1] = np.nan
    X[:, 4] = rng.randint(0, 4, 400)
    y = (X[:, 0] + (X[:, 4] == 2) > 0.3).astype(float)
    ds = lgb.Dataset(X, label=y, categorical_feature=[4],
                     params=dict(CPU, **params))
    ds.construct()
    path = str(tmp_path / "jax.bin")
    ds.save_binary(path)
    return path, ds._constructed, X, y


def test_port_reads_jax_binary_file_without_importing_it(tmp_path):
    path, jcd, X, y = _jax_binary_file(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=ROOT, path=path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["jax"] and not out["lightgbm_tpu"]
    assert out["mapper_type"] == "lightgbm_tpu_torch.binning"
    np.testing.assert_array_equal(np.asarray(out["codes"]), jcd.X_binned)
    # the same codes and mappers as the port's own file: the same model
    ds = lgt.Dataset(X, label=y, categorical_feature=[4], params=CPU)
    ds.construct()
    own = str(tmp_path / "own.bin")
    ds.save_binary(own)
    bst = lgt.train({"objective": "binary", "device": "cpu", "verbose": -1,
                     "num_leaves": 7}, lgt.Dataset(own), num_boost_round=3)
    assert out["text"] == bst.model_to_string()


def test_binary_mapper_attributes_match_jax(tmp_path):
    """The unpickler maps the JAX package's BinMapper onto the port's copy:
    every attribute of every mapper comes across with the same name and
    value."""
    path, jcd, _, _ = _jax_binary_file(tmp_path, max_bin=15)
    cd = lgt.Dataset(path).constructed
    assert len(cd.mappers) == len(jcd.mappers)
    for ours, theirs in zip(cd.mappers, jcd.mappers):
        assert type(ours).__module__ == "lightgbm_tpu_torch.binning"
        assert sorted(vars(ours)) == sorted(vars(theirs))
        for k, v in vars(theirs).items():
            w = getattr(ours, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(w, v)
            else:
                assert w == v, k
    assert sorted(vars(lgt.dataset.BinMapper())) == \
        sorted(vars(lgb.dataset.BinMapper()))


@pytest.mark.parametrize("module,name", [
    ("os", "system"), ("subprocess", "Popen"),
    ("lightgbm_tpu.dataset", "ConstructedDataset"),
    ("lightgbm_tpu_torch.basic", "Booster")])
def test_binary_file_with_another_global_is_refused(tmp_path, module, name):
    raw = pickle.dumps({"format": "lightgbm_tpu.dataset.v1", "config": 0},
                       protocol=pickle.HIGHEST_PROTOCOL)
    # a STACK_GLOBAL of module.name spliced in place of the config value
    glob = (pickle.SHORT_BINUNICODE + bytes([len(module)]) + module.encode()
            + pickle.SHORT_BINUNICODE + bytes([len(name)]) + name.encode()
            + pickle.STACK_GLOBAL)
    assert raw.count(b"K\x00") == 1
    path = str(tmp_path / "evil.bin")
    with open(path, "wb") as fh:
        fh.write(raw.replace(b"K\x00", glob))
    assert is_binary_dataset(path)
    with pytest.raises(pickle.UnpicklingError, match=f"{module}.{name}"):
        lgt.Dataset(path).construct()


def test_deferred_dataset_saves_host_codes_and_stays_deferred(tmp_path):
    rng = np.random.RandomState(9)
    X = rng.randn(3000, 6).astype(np.float32)
    X[rng.rand(3000) < 0.05, 2] = np.nan
    y = (X[:, 0] > 0).astype(np.float32)
    params = dict(CPU, tpu_ingest="device")
    ds = lgt.Dataset(X, label=y, params=params)
    ds.construct()
    assert ds.constructed.deferred
    path = str(tmp_path / "deferred.bin")
    ds.save_binary(path)
    assert ds.constructed.deferred
    host = lgt.Dataset(X, label=y, params=dict(CPU, tpu_ingest="host"))
    host.construct()
    loaded = lgt.Dataset(path)
    loaded.construct()
    np.testing.assert_array_equal(loaded.constructed.X_binned,
                                  host.constructed.X_binned)
    a = lgt.train(params, ds, num_boost_round=3)
    b = lgt.train(params, loaded, num_boost_round=3)
    assert a.model_to_string() == b.model_to_string()
