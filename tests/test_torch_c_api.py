"""Port parity of the C API: the cases of ``tests/test_c_api.py`` on the
port's shim (``lightgbm_tpu_torch/csrc/lgbm_capi.c`` -> ``capi_impl.py``),
driven through ``ctypes`` (the hosted mode) with ``device=cpu`` in every
parameter string: round trip, CSR, error reporting, push-rows streaming,
create-by-reference, merge and thread safety. Each case runs the same
calls on the same buffers through the JAX package's shim too
(``capi/lgbm_capi.c`` as it stands, compiled with the port's flags into a
temporary directory, forwarding to ``lightgbm_tpu.capi_impl``), with
``tpu_hist_f64=true`` on that side, and holds the two against each other:
model texts line for line (leaf and internal values at ROADMAP C1's
``1e-6``), predictions, ``GetPredict`` arrays, importances and counts.
Also:

- the shim is ``capi/lgbm_capi.c`` but for its header comment and the
  module it imports;
- in child processes, the hosted mode (a Python process loading the shim
  with ``ctypes``) and the embedded mode (a C program linked against the
  shim with ``gcc``, which starts its own interpreter; its model predicts
  what it printed) train through the ``LGBM_*`` calls without importing
  ``jax`` or ``lightgbm_tpu``;
- ``LGBM_NetworkInit`` with two machines fails naming ROADMAP A16, and the
  C API's model of a dataset is the Python API's.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import capi_shim

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SHIM = os.path.join(ROOT, "capi", "lgbm_capi.c")
# appended to both sides' booster parameters: the cases' labels are steps
# of a feature, so after a few splits the leaves are nearly pure and the
# best remaining gains are the sums' rounding (2^-18 to 2^-15), chosen
# differently by different arithmetic (ROADMAP C23, pinned by
# test_c_api_csr_dataset); no split below this gain is taken
GUARD = 1e-4
# appended to the JAX side's: histogram sums in f64, as the port's
# fixed-point sums (ROADMAP C1, C3)
JAX_EXTRA = b" tpu_hist_f64=true"
# model-text keys whose values come from the gradient sums: held at C1's
# 1e-6 (the values); the f32 gains within 1e-5 relative and 2^-15, an ulp
# of the root's gain terms, which a gain is the difference of; every other
# line of the two texts is equal
_SUM_KEYS = {"leaf_value": dict(rtol=0, atol=1e-6),
             "internal_value": dict(rtol=0, atol=1e-6),
             "split_gain": dict(rtol=1e-5, atol=2.0 ** -15)}


@pytest.fixture(scope="module")
def lib():
    return capi_shim.load_shim()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_shim") / "lib_lightgbm_tpu.so")
    subprocess.run(capi_shim._compile_command(out, source=JAX_SHIM),
                   check=True, capture_output=True, text=True)
    L = ctypes.CDLL(out)
    L.LGBM_GetLastError.restype = ctypes.c_char_p
    return L


@pytest.fixture(scope="module")
def sides(lib, jax_lib):
    """(port library, its parameter suffix), (JAX library, its suffix)."""
    guard = f" min_gain_to_split={GUARD}".encode()
    return (lib, guard), (jax_lib, guard + JAX_EXTRA)


def _check(lib, ret):
    assert ret == 0, lib.LGBM_GetLastError().decode()


def _assert_models_meet_c1(ours, theirs):
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        key = x.split("=", 1)[0]
        if key in _SUM_KEYS and x != y:
            assert y.split("=", 1)[0] == key
            np.testing.assert_allclose(
                np.array(x.split("=", 1)[1].split(), float),
                np.array(y.split("=", 1)[1].split(), float),
                err_msg=key, **_SUM_KEYS[key])
        else:
            assert x == y


def _model_string(lib, bst):
    buf = ctypes.create_string_buffer(1 << 20)
    slen = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterSaveModelToString(
        bst, 0, ctypes.c_int64(len(buf)), ctypes.byref(slen), buf))
    assert slen.value == len(buf.value) + 1
    return buf.value.decode()


def _predict_mat(lib, bst, X, predict_type=0):
    out_len = ctypes.c_int64()
    preds = np.zeros(len(X), np.float64)
    _check(lib, lib.LGBM_BoosterPredictForMat(
        bst, X.ctypes.data_as(ctypes.c_void_p), 1, X.shape[0], X.shape[1],
        1, predict_type, 0, b"", ctypes.byref(out_len),
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
    assert out_len.value == len(X)
    return preds


def _get_predict(lib, bst, data_idx, n):
    np_len = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterGetNumPredict(bst, data_idx,
                                              ctypes.byref(np_len)))
    assert np_len.value == n
    scores = np.zeros(n, np.float64)
    got = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterGetPredict(
        bst, data_idx, ctypes.byref(got),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
    assert got.value == n
    return scores


def _roundtrip(lib, extra, tmp_path):
    rng = np.random.RandomState(0)
    n, f = 500, 6
    X = np.ascontiguousarray(rng.rand(n, f), dtype=np.float64)
    y = np.ascontiguousarray(
        (X[:, 0] + X[:, 1] > 1.0).astype(np.float32))

    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1,
        b"max_bin=31 device=cpu", None, ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))

    nd = ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)))
    assert nd.value == n
    nf = ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetNumFeature(ds, ctypes.byref(nf)))
    assert nf.value == f

    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(
        ds, b"objective=binary num_leaves=7 min_data_in_leaf=10 verbose=-1 "
            b"device=cpu" + extra, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(5):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    it = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 5

    preds = _predict_mat(lib, bst, X)
    acc = np.mean((preds > 0.5) == (y > 0.5))
    assert acc > 0.9, acc

    # save / load / re-predict
    model_path = str(tmp_path / "c_api_model.txt").encode()
    _check(lib, lib.LGBM_BoosterSaveModel(bst, 0, model_path))
    bst2 = ctypes.c_void_p()
    niter = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterCreateFromModelfile(
        model_path, ctypes.byref(niter), ctypes.byref(bst2)))
    assert niter.value == 5
    np.testing.assert_allclose(_predict_mat(lib, bst2, X), preds,
                               rtol=1e-10)

    # model string + importance
    text = _model_string(lib, bst)
    assert text.startswith("tree")
    imp = np.zeros(f, np.float64)
    _check(lib, lib.LGBM_BoosterFeatureImportance(
        bst, 0, 0, imp.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
    assert imp.sum() > 0

    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_BoosterFree(bst2))
    _check(lib, lib.LGBM_DatasetFree(ds))
    return text, preds, imp


def test_c_api_train_predict_roundtrip(sides, tmp_path):
    (lib, ours), (jlib, theirs) = sides
    text, preds, imp = _roundtrip(lib, ours, tmp_path)
    jtext, jpreds, jimp = _roundtrip(jlib, theirs, tmp_path)
    _assert_models_meet_c1(text, jtext)
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(imp, jimp)


def _csr(lib, extra, binary):
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.RandomState(1)
    csr = sp.random(400, 10, density=0.3, random_state=rng, format="csr")
    y = np.ascontiguousarray(
        (csr.toarray()[:, 0] > 0.1).astype(np.float32))
    indptr = np.ascontiguousarray(csr.indptr, np.int32)
    indices = np.ascontiguousarray(csr.indices, np.int32)
    data = np.ascontiguousarray(csr.data, np.float64)

    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromCSR(
        indptr.ctypes.data_as(ctypes.c_void_p), 2,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.c_void_p), 1,
        ctypes.c_int64(len(indptr)), ctypes.c_int64(csr.nnz),
        ctypes.c_int64(10), b"max_bin=31 device=cpu", None, ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p), 400, 0))
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(
        ds, b"objective=binary num_leaves=7 verbose=-1 device=cpu" + extra,
        ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(3):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))

    out_len = ctypes.c_int64()
    preds = np.zeros(400, np.float64)
    _check(lib, lib.LGBM_BoosterPredictForCSR(
        bst, indptr.ctypes.data_as(ctypes.c_void_p), 2,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.c_void_p), 1,
        ctypes.c_int64(len(indptr)), ctypes.c_int64(csr.nnz),
        ctypes.c_int64(10), 0, 0, b"", ctypes.byref(out_len),
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
    assert out_len.value == 400
    assert np.isfinite(preds).all()
    # the CSR buffers predict as their dense matrix does
    dense = np.ascontiguousarray(csr.toarray(), np.float64)
    np.testing.assert_array_equal(_predict_mat(lib, bst, dense), preds)
    _check(lib, lib.LGBM_DatasetSaveBinary(ds, str(binary).encode()))
    text = _model_string(lib, bst)
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds))
    return text


def _nodes(text):
    """Per tree: (split features, thresholds, gains) of the model text."""
    out = []
    for block in text.split("\nTree=")[1:]:
        kv = dict(line.split("=", 1) for line in block.splitlines()[1:]
                  if "=" in line)
        out.append((kv.get("split_feature", "").split(),
                    kv.get("threshold", "").split(),
                    np.array(kv.get("split_gain", "").split(), float)))
    return out


def test_c_api_csr_dataset(sides, tmp_path):
    from lightgbm_tpu_torch.dataset import ConstructedDataset
    (lib, ours), (jlib, theirs) = sides
    text = _csr(lib, ours, tmp_path / "ours.bin")
    jtext = _csr(jlib, theirs, tmp_path / "theirs.bin")
    _assert_models_meet_c1(text, jtext)
    # the CSR buffers give both packages the same codes, mappers and labels
    a = ConstructedDataset.load_binary(str(tmp_path / "ours.bin"))
    b = ConstructedDataset.load_binary(str(tmp_path / "theirs.bin"))
    np.testing.assert_array_equal(a.X_binned, b.X_binned)
    np.testing.assert_array_equal(a.metadata.label, b.metadata.label)
    for ma, mb in zip(a.mappers, b.mappers):
        assert vars(ma).keys() == vars(mb).keys()
        for key, va in vars(ma).items():
            np.testing.assert_array_equal(va, vars(mb)[key], err_msg=key)
    # ROADMAP C23 without the guard: the first split where the two
    # packages part has a gain below it on both sides
    text = _csr(lib, b"", tmp_path / "ours.bin")
    jtext = _csr(jlib, JAX_EXTRA, tmp_path / "theirs.bin")
    for (f, t, g), (jf, jt, jg) in zip(_nodes(text), _nodes(jtext)):
        if (f, t) != (jf, jt):
            i = next(i for i, pair in enumerate(zip(f, t, jf, jt))
                     if pair[:2] != pair[2:])
            assert g[i] < GUARD and jg[i] < GUARD, (g[i], jg[i])
            break
        np.testing.assert_allclose(g, jg, **_SUM_KEYS["split_gain"])
    else:
        pytest.fail("the unguarded models no longer part (ROADMAP C23)")


def test_c_api_error_reporting(sides):
    for lib, _ in sides:
        bad = ctypes.c_void_p()
        ret = lib.LGBM_DatasetCreateFromFile(b"/nonexistent/file.csv", b"",
                                             None, ctypes.byref(bad))
        assert ret == -1
        assert "/nonexistent/file.csv" in lib.LGBM_GetLastError().decode()


def _push_rows(lib, extra):
    """Chunked out-of-core ingestion: CreateFromSampledColumn -> PushRows
    chunks -> FinishLoad -> train (reference c_api.h:67-102)."""
    rng = np.random.RandomState(7)
    n, f = 600, 5
    X = np.ascontiguousarray(rng.rand(n, f), dtype=np.float64)
    y = np.ascontiguousarray((X[:, 0] + X[:, 2] > 1.0).astype(np.float32))

    # column sample: every value is nonzero here, so sample = the column
    n_sample = 200
    sample_cols = [np.ascontiguousarray(X[:n_sample, j]) for j in range(f)]
    sample_idx = [np.arange(n_sample, dtype=np.int32) for _ in range(f)]
    col_ptrs = (ctypes.c_void_p * f)(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in sample_cols])
    idx_ptrs = (ctypes.c_void_p * f)(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in sample_idx])
    num_per_col = np.full(f, n_sample, dtype=np.int32)

    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromSampledColumn(
        col_ptrs, idx_ptrs, f,
        num_per_col.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_sample, n, b"max_bin=31 min_data_in_leaf=5 device=cpu",
        ctypes.byref(ds)))

    for start in range(0, n, 200):           # 3 chunks; last triggers finish
        chunk = np.ascontiguousarray(X[start:start + 200])
        _check(lib, lib.LGBM_DatasetPushRows(
            ds, chunk.ctypes.data_as(ctypes.c_void_p), 1, 200, f, start))
    _check(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))

    nd = ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)))
    assert nd.value == n

    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(
        ds, b"objective=binary num_leaves=7 min_data_in_leaf=5 verbose=-1 "
            b"device=cpu" + extra, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(5):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))

    preds = _predict_mat(lib, bst, X)
    acc = np.mean((preds > 0.5) == (y > 0.5))
    assert acc > 0.85, acc

    # GetNumPredict/GetPredict: training-data scores (c_api.h:488-505)
    scores = _get_predict(lib, bst, 0, n)
    # transformed training scores track the (identical-data) predictions
    assert np.allclose(scores, preds, atol=1e-5)
    text = _model_string(lib, bst)
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds))
    return text, preds, scores


def test_c_api_push_rows_streaming(sides):
    (lib, ours), (jlib, theirs) = sides
    text, preds, scores = _push_rows(lib, ours)
    jtext, jpreds, jscores = _push_rows(jlib, theirs)
    # the pushed rows are binned by the sample's mappers on both sides:
    # every threshold and child of the two models is equal
    _assert_models_meet_c1(text, jtext)
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=5e-6)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=5e-6)


def _by_reference(lib, extra):
    """CreateByReference + PushRowsByCSR: a valid set streamed in chunks,
    binned with the training set's mappers (c_api.h:83-127)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(11)
    n, f = 400, 6
    X = np.ascontiguousarray(rng.rand(n, f), dtype=np.float64)
    y = np.ascontiguousarray((X[:, 1] > 0.5).astype(np.float32))

    train = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1,
        b"max_bin=31 device=cpu", None, ctypes.byref(train)))
    _check(lib, lib.LGBM_DatasetSetField(
        train, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))

    nv = 200
    Xv = np.ascontiguousarray(rng.rand(nv, f), dtype=np.float64)
    yv = np.ascontiguousarray((Xv[:, 1] > 0.5).astype(np.float32))
    valid = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateByReference(
        train, ctypes.c_int64(nv), ctypes.byref(valid)))
    for start in (0, 100):
        csr = sp.csr_matrix(Xv[start:start + 100])
        indptr = np.ascontiguousarray(csr.indptr, np.int32)
        indices = np.ascontiguousarray(csr.indices, np.int32)
        data = np.ascontiguousarray(csr.data, np.float64)
        _check(lib, lib.LGBM_DatasetPushRowsByCSR(
            valid, indptr.ctypes.data_as(ctypes.c_void_p), 2,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            data.ctypes.data_as(ctypes.c_void_p), 1,
            ctypes.c_int64(len(indptr)), ctypes.c_int64(csr.nnz),
            ctypes.c_int64(f), ctypes.c_int64(start)))
    _check(lib, lib.LGBM_DatasetSetField(
        valid, b"label", yv.ctypes.data_as(ctypes.c_void_p), nv, 0))

    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(
        train,
        b"objective=binary metric=binary_logloss num_leaves=7 verbose=-1 "
        b"device=cpu" + extra, ctypes.byref(bst)))
    _check(lib, lib.LGBM_BoosterAddValidData(bst, valid))
    fin = ctypes.c_int()
    for _ in range(3):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    # the valid set's scores are the model's predictions of its rows
    vscores = _get_predict(lib, bst, 1, nv)
    np.testing.assert_allclose(vscores, _predict_mat(lib, bst, Xv),
                               rtol=0, atol=1e-6)
    text = _model_string(lib, bst)
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(valid))
    _check(lib, lib.LGBM_DatasetFree(train))
    return text, vscores


def test_c_api_create_by_reference_csr_push(sides):
    (lib, ours), (jlib, theirs) = sides
    text, vscores = _by_reference(lib, ours)
    jtext, jvscores = _by_reference(jlib, theirs)
    _assert_models_meet_c1(text, jtext)
    np.testing.assert_allclose(vscores, jvscores, rtol=0, atol=3e-6)


def _merge(lib, extra):
    """LGBM_BoosterMerge: merged forest's raw score = sum of the parts
    (boost_from_average off so init terms don't double)."""
    rng = np.random.RandomState(3)
    n, f = 300, 4
    X = np.ascontiguousarray(rng.rand(n, f), dtype=np.float64)
    y = np.ascontiguousarray((X[:, 0] > 0.5).astype(np.float32))
    params = (b"objective=binary num_leaves=7 verbose=-1 device=cpu "
              b"boost_from_average=false min_data_in_leaf=10" + extra)

    def train_one(seed_iters):
        ds = ctypes.c_void_p()
        _check(lib, lib.LGBM_DatasetCreateFromMat(
            X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1,
            b"max_bin=31 device=cpu", None, ctypes.byref(ds)))
        _check(lib, lib.LGBM_DatasetSetField(
            ds, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))
        bst = ctypes.c_void_p()
        _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
        fin = ctypes.c_int()
        for _ in range(seed_iters):
            _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
        return ds, bst

    ds1, b1 = train_one(3)
    ds2, b2 = train_one(2)
    r1, r2 = _predict_mat(lib, b1, X, 1), _predict_mat(lib, b2, X, 1)
    _check(lib, lib.LGBM_BoosterMerge(b1, b2))
    merged = _predict_mat(lib, b1, X, 1)
    assert np.allclose(merged, r1 + r2, atol=1e-5)
    text = _model_string(lib, b1)
    for h in (b1, b2):
        _check(lib, lib.LGBM_BoosterFree(h))
    for h in (ds1, ds2):
        _check(lib, lib.LGBM_DatasetFree(h))
    return text, merged


def test_c_api_booster_merge(sides):
    (lib, ours), (jlib, theirs) = sides
    text, merged = _merge(lib, ours)
    jtext, jmerged = _merge(jlib, theirs)
    _assert_models_meet_c1(text, jtext)
    np.testing.assert_allclose(merged, jmerged, rtol=0, atol=5e-6)


def _threads(lib, extra):
    """Two native threads hammer one booster (update vs predict) — the
    per-handle lock must serialize them without errors or corrupt state
    (reference Booster mutex, c_api.cpp:29; ctypes releases the GIL around
    foreign calls, so contention is real)."""
    rng = np.random.RandomState(5)
    n, f = 400, 4
    X = np.ascontiguousarray(rng.rand(n, f), dtype=np.float64)
    y = np.ascontiguousarray((X[:, 0] > 0.5).astype(np.float32))
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, b"max_bin=31 device=cpu",
        None, ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(
        ds, b"objective=binary num_leaves=7 verbose=-1 device=cpu" + extra,
        ctypes.byref(bst)))
    fin = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))

    errors = []

    def updater():
        fin = ctypes.c_int()
        for _ in range(6):
            if lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)) != 0:
                errors.append(lib.LGBM_GetLastError().decode())

    def predictor():
        out_len = ctypes.c_int64()
        preds = np.zeros(n, np.float64)
        for _ in range(6):
            if lib.LGBM_BoosterPredictForMat(
                    bst, X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, 0, 0,
                    b"", ctypes.byref(out_len),
                    preds.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) != 0:
                errors.append(lib.LGBM_GetLastError().decode())
            elif not np.isfinite(preds).all():
                errors.append("non-finite predictions")

    ts = [threading.Thread(target=updater), threading.Thread(target=predictor)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errors, errors
    it = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 7, it.value
    text = _model_string(lib, bst)
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds))
    return text


def test_c_api_thread_safety(sides):
    # the updates are serialised, so the interleaved predictions leave
    # the model as seven plain iterations make it
    (lib, ours), (jlib, theirs) = sides
    _assert_models_meet_c1(_threads(lib, ours), _threads(jlib, theirs))


# ------------------------------------------------------------- the port's

def _strip_header(text):
    """The source after its leading block comment."""
    assert text.startswith("/*")
    return text[text.index("*/") + 2:]


def test_shim_is_the_jax_package_shim_but_for_the_module():
    with open(os.path.join(ROOT, "capi", "lgbm_capi.c")) as fh:
        theirs = _strip_header(fh.read())
    with open(capi_shim.SOURCE) as fh:
        ours = _strip_header(fh.read())
    assert ours.count("lightgbm_tpu_torch.capi_impl") == 2
    assert ours.replace("lightgbm_tpu_torch.capi_impl",
                        "lightgbm_tpu.capi_impl") == theirs


_NETWORK_RANK = r"""
import ctypes, json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from lightgbm_tpu_torch import capi_shim
lib = capi_shim.load_shim()
ret = lib.LGBM_NetworkInit({machines!r}.encode(), {port}, 1, 2)
import torch.distributed as dist
out = [ret, dist.get_rank(), dist.get_world_size(), dist.get_backend()]
out.append(lib.LGBM_NetworkFree())
out.append(dist.is_initialized())
print(json.dumps(out))
"""


def test_network_init_and_the_python_api_model(lib, tmp_path):
    """Two machines: ``LGBM_NetworkInit`` joins a gloo world of two
    processes (each its rank by ``local_listen_port``) and
    ``LGBM_NetworkFree`` leaves it; a world of two trains through the C API
    in ``test_torch_multihost.py``. One machine needs no network."""
    from _torch_world import free_ports, machines
    ports = free_ports(2)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NETWORK_RANK.format(
            root=ROOT, machines=machines(ports), port=p)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in ports]
    outs = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=180)
        finally:
            proc.kill()
        assert proc.returncode == 0, stderr[-3000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    assert outs == [[0, 0, 2, "gloo", 0, False], [0, 1, 2, "gloo", 0, False]]
    _check(lib, lib.LGBM_NetworkInit(b"", 12400, 120, 1))
    _check(lib, lib.LGBM_NetworkFree())
    rng = np.random.RandomState(17)
    n, f = 400, 5
    X = np.ascontiguousarray(rng.rand(n, f), dtype=np.float64)
    y = np.ascontiguousarray((X[:, 0] > 0.5).astype(np.float32))
    params = "objective=binary num_leaves=7 verbose=-1 device=cpu"
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, b"device=cpu", None,
        ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p), n, 0))
    _check(lib, lib.LGBM_BoosterCreate(ds, params.encode(),
                                       ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(3):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    path = str(tmp_path / "capi.txt")
    _check(lib, lib.LGBM_BoosterSaveModel(bst, 0, path.encode()))
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds))
    want = lgt.train(dict(tok.split("=") for tok in params.split()),
                     lgt.Dataset(X, label=y), num_boost_round=3)
    with open(path) as fh:
        assert fh.read() == want.model_to_string()


_HOSTED = r"""
import ctypes, json, sys
import numpy as np
sys.path.insert(0, {root!r})
from lightgbm_tpu_torch import capi_shim
lib = capi_shim.load_shim()
X = np.ascontiguousarray(np.random.RandomState(3).rand(200, 4))
y = np.ascontiguousarray((X[:, 0] > 0.5).astype(np.float32))
ds, bst, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
rets = [lib.LGBM_DatasetCreateFromMat(X.ctypes.data_as(ctypes.c_void_p), 1,
                                      200, 4, 1, b"device=cpu", None,
                                      ctypes.byref(ds)),
        lib.LGBM_DatasetSetField(ds, b"label",
                                 y.ctypes.data_as(ctypes.c_void_p), 200, 0),
        lib.LGBM_BoosterCreate(ds, b"objective=binary verbose=-1 device=cpu",
                               ctypes.byref(bst)),
        lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin))]
print(json.dumps({{"rets": rets, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_hosted_process_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _HOSTED.format(root=ROOT)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rets"] == [0, 0, 0, 0]
    assert "lightgbm_tpu_torch" in out["modules"]
    assert "jax" not in out["modules"]
    assert "lightgbm_tpu" not in out["modules"]


_EMBEDDED = r"""
#include <Python.h>
#include <stdint.h>
#include <stdio.h>

typedef void* H;
int LGBM_DatasetCreateFromMat(const void*, int, int32_t, int32_t, int,
                              const char*, const H, H*);
int LGBM_DatasetSetField(H, const char*, const void*, int, int);
int LGBM_BoosterCreate(const H, const char*, H*);
int LGBM_BoosterUpdateOneIter(H, int*);
int LGBM_BoosterPredictForMat(H, const void*, int, int32_t, int32_t, int,
                              int, int, const char*, int64_t*, double*);
int LGBM_BoosterSaveModel(H, int, const char*);
int LGBM_BoosterFree(H);
int LGBM_DatasetFree(H);
const char* LGBM_GetLastError(void);

#define N 300
#define F 4
#define CHECK(call) if ((call) != 0) { \
    fprintf(stderr, "%s: %s\n", #call, LGBM_GetLastError()); return 1; }

int main(int argc, char** argv) {
  static double X[N * F], pred[N];
  static float y[N];
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < F; ++j)
      X[i * F + j] = (double)((i * 37 + j * 11) % 101) / 101.0;
    y[i] = X[i * F] + 0.5 * X[i * F + 2] > 0.7 ? 1.0f : 0.0f;
  }
  H ds, bst;
  int fin;
  int64_t len;
  CHECK(LGBM_DatasetCreateFromMat(X, 1, N, F, 1, "max_bin=31 device=cpu",
                                  NULL, &ds));
  CHECK(LGBM_DatasetSetField(ds, "label", y, N, 0));
  CHECK(LGBM_BoosterCreate(ds, "objective=binary num_leaves=7 "
                           "min_data_in_leaf=5 verbose=-1 device=cpu", &bst));
  for (int it = 0; it < 3; ++it) CHECK(LGBM_BoosterUpdateOneIter(bst, &fin));
  CHECK(LGBM_BoosterPredictForMat(bst, X, 1, N, F, 1, 0, 0, "", &len, pred));
  CHECK(LGBM_BoosterSaveModel(bst, 0, argv[1]));
  CHECK(LGBM_BoosterFree(bst));
  CHECK(LGBM_DatasetFree(ds));
  for (int i = 0; i < N; ++i) printf("%.17g\n", pred[i]);
  /* the embedded interpreter's modules, for the test */
  PyGILState_STATE gil = PyGILState_Ensure();
  char code[4096];
  snprintf(code, sizeof(code),
           "import sys\n"
           "with open(%s, 'w') as fh:\n"
           "    fh.write(' '.join(sorted(m.split('.')[0] for m in "
           "sys.modules)))\n", argv[2]);
  int rc = PyRun_SimpleString(code);
  PyGILState_Release(gil);
  return rc;
}
"""


@pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc unavailable")
def test_embedded_c_program_trains_through_the_shim(tmp_path):
    path, _ = capi_shim.build_shim()
    src, exe = tmp_path / "embedded.c", tmp_path / "embedded"
    src.write_text(_EMBEDDED)
    includes = capi_shim._config_flags("--includes")
    ldflags = capi_shim._config_flags("--ldflags", "--embed")
    subprocess.run(["gcc", "-O1", *includes, str(src), "-o", str(exe),
                    path, f"-Wl,-rpath,{os.path.dirname(path)}", *ldflags],
                   check=True, capture_output=True, text=True)
    model, mods = tmp_path / "model.txt", tmp_path / "modules.txt"
    # the embedded interpreter imports what this one does
    paths = [ROOT] + [p for p in sys.path if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(dict.fromkeys(paths)))
    proc = subprocess.run([str(exe), str(model), repr(str(mods))], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = np.array([float(v) for v in proc.stdout.split()])
    assert printed.shape == (300,)
    X = np.array([[((i * 37 + j * 11) % 101) / 101.0 for j in range(4)]
                  for i in range(300)])
    bst = lgt.Booster(model_file=str(model), params={"device": "cpu"})
    np.testing.assert_array_equal(bst.predict(X), printed)
    loaded = set(mods.read_text().split())
    assert "lightgbm_tpu_torch" in loaded
    assert "jax" not in loaded and "lightgbm_tpu" not in loaded
