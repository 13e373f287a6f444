"""Device ingest in ``lightgbm_tpu_torch`` (``tpu_ingest=device|auto``:
``ops/ingest.py``, ``dataset.DeferredBinning``, the booster's code matrix
and data fingerprint), on the CPU, against the JAX package.

The cases of ``tests/test_ingest.py`` but the sharded one (the port trains
on one device) and the stream-shard store (ROADMAP A14), with its bars:

- the bin step's codes equal the host oracle's (``BinMapper.value_to_bin``)
  bit for bit, with row and column padding, on the adversarial inputs
  (exact ties, NaN under both missing modes, ±inf, -0.0, categorical
  columns with negative, unseen, fractional and NaN values), and equal the
  JAX package's ``DeviceIngestor`` on the same inputs;
- the codes come in the port's residency dtype (``uint8``, or ``uint16`` as
  ``int16``), which replaces the JAX package's packed layouts;
- every chunk, the masked tail included, runs on the buffers of the first
  (``compiles == 1``), with prefetch on or off;
- the chunk-rows contract, the feeder's stall accounting, the eligibility
  gates, the ``auto`` row threshold and the lossy-f64 fallback;
- training from raw arrays under ``tpu_ingest=device`` places the same
  ``Xb`` and writes the same model text as ``host``, and the JAX package's
  on exact-arithmetic gradients (ROADMAP C14's bar); EFB's deferred
  planning gives the same plan and model;
- ``_data_fingerprint`` equals the JAX package's, deferred and not.

Each JAX configuration trains once.
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.dataset import bin_dense_host as jax_bin_dense_host
from lightgbm_tpu.dataset import construct_dataset as jax_construct
from lightgbm_tpu.ops import ingest as jax_ingest
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import (_AUTO_DEFER_MIN_ROWS, _map_find_bin,
                                        bin_dense_host, construct_dataset)
from lightgbm_tpu_torch.ops import ingest as ingest_mod

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _adversarial_matrix(n=3000, seed=3):
    """``tests/test_ingest.py``'s parity matrix: ties, NaN, ±inf, -0.0,
    categorical with negative/unseen/fractional values."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 4) / 4                # heavy exact ties
    X[rng.rand(n) < 0.15, 2] = np.nan                  # NaN-bin path
    X[: n // 8, 3] = np.inf
    X[n // 8: n // 4, 3] = -np.inf
    X[n // 4: n // 2, 3] = -0.0
    X[rng.rand(n) < 0.3, 4] = 0.0                      # zero/default bin
    X[:, 5] = rng.randint(0, 12, n).astype(np.float32)  # categorical
    X[: n // 10, 5] = -3.0                             # negative category
    X[n // 10: n // 8, 5] = 97.0                       # unseen category
    X[n // 8: n // 6, 5] = 4.5                         # fractional -> trunc
    X[rng.rand(n) < 0.05, 5] = np.nan                  # categorical NaN
    y = (X[:, 0] > 0).astype(np.float32)
    return X, y


def _params(extra=None):
    return dict({"max_bin": 63, "verbose": -1, "min_data_in_leaf": 5,
                 "tpu_ingest": "host"}, **(extra or {}))


def _mappers_for(X, y, params=None, categorical=None):
    return construct_dataset(X, y, Config.from_params(_params(params)),
                             categorical_features=categorical)


def _device_codes(X, cd, n_pad, cols_pad, chunk_rows=0, prefetch_depth=1):
    codes, rep = ingest_mod.device_ingest(
        X, cd.mappers, np.asarray(cd.real_feature_idx),
        n_rows=X.shape[0], n_rows_padded=n_pad, num_cols=cols_pad,
        out_dtype=cd.code_dtype, device=CPU, chunk_rows=chunk_rows,
        prefetch_depth=prefetch_depth)
    return codes, rep


def _host_padded(X, cd, n_pad, cols_pad):
    Xb = bin_dense_host(X, cd.mappers, np.asarray(cd.real_feature_idx,
                                                  np.int64),
                        X.shape[0], cd.code_dtype)
    ref = np.zeros((n_pad, cols_pad), cd.code_dtype)
    ref[: X.shape[0], : Xb.shape[1]] = Xb
    return ref


def _as_host_dtype(codes: torch.Tensor, dtype) -> np.ndarray:
    return codes.numpy().view(dtype)


def _jax_device_codes(X, y, n_pad, cols_pad, params=None, categorical=None,
                      chunk_rows=0):
    cfg = lgb.Config.from_params(_params(params))
    jcd = jax_construct(X, y, cfg, categorical_features=categorical)
    codes, _ = jax_ingest.device_ingest(
        X, jcd.mappers, np.asarray(jcd.real_feature_idx),
        n_rows=X.shape[0], n_rows_padded=n_pad, num_cols=cols_pad,
        out_dtype=jcd.code_dtype, chunk_rows=chunk_rows)
    return np.asarray(codes)


# ------------------------------------------------------- bit-exact parity

def test_device_matches_host_and_jax_adversarial():
    X, y = _adversarial_matrix()
    cd = _mappers_for(X, y, categorical=[5])
    n_pad, cols_pad = X.shape[0] + 512, len(cd.real_feature_idx) + 3
    dev, rep = _device_codes(X, cd, n_pad, cols_pad, chunk_rows=700)
    ref = _host_padded(X, cd, n_pad, cols_pad)
    assert dev.dtype == torch.uint8 and ref.dtype == np.uint8
    np.testing.assert_array_equal(dev.numpy(), ref)
    assert rep["compiles"] == 1 and rep["n_chunks"] == 6
    np.testing.assert_array_equal(
        dev.numpy(), _jax_device_codes(X, y, n_pad, cols_pad,
                                       categorical=[5], chunk_rows=700))


def test_device_matches_host_and_jax_zero_as_missing():
    X, y = _adversarial_matrix(seed=5)
    extra = {"zero_as_missing": True}
    cd = _mappers_for(X, y, extra, categorical=[5])
    n_pad, cols_pad = X.shape[0] + 256, len(cd.real_feature_idx)
    dev, _ = _device_codes(X, cd, n_pad, cols_pad)
    np.testing.assert_array_equal(dev.numpy(),
                                  _host_padded(X, cd, n_pad, cols_pad))
    np.testing.assert_array_equal(
        dev.numpy(), _jax_device_codes(X, y, n_pad, cols_pad, extra,
                                       categorical=[5]))


def test_exact_boundary_values_tie_left():
    """Every f32-rounded bin boundary fed back through both paths: the
    side='left' tie rule agrees bin for bin."""
    rng = np.random.RandomState(11)
    X = rng.randn(4000, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cd = _mappers_for(X, y, {"max_bin": 255})
    cols = []
    for m in cd.mappers:
        ub = np.asarray(m.bin_upper_bound, np.float64)
        b = ub[np.isfinite(ub)].astype(np.float32)
        reps = int(np.ceil(4000 / max(len(b), 1)))
        cols.append(np.tile(b, reps)[:4000])
    Xt = np.stack(cols, axis=1).astype(np.float32)
    dev, _ = _device_codes(Xt, cd, 4096, 3)
    np.testing.assert_array_equal(dev.numpy(), _host_padded(Xt, cd, 4096, 3))


@pytest.mark.parametrize("max_bin,torch_dtype,host_dtype", [
    (15, torch.uint8, np.uint8), (63, torch.uint8, np.uint8),
    (255, torch.uint8, np.uint8), (400, torch.int16, np.uint16)])
def test_residency_dtype_matches_host(max_bin, torch_dtype, host_dtype):
    """The codes come in the port's residency dtype (``uint16`` as
    ``int16``, ``boosting/gbdt._codes_tensor``) over the padded layout; the
    JAX package's u4/u6 packing is not ported (B1b dropped it)."""
    rng = np.random.RandomState(13)
    X = rng.rand(1500, 6).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    cd = _mappers_for(X, y, {"max_bin": max_bin})
    assert cd.code_dtype == host_dtype
    dev, _ = _device_codes(X, cd, 1792, 8)
    assert dev.dtype == torch_dtype
    np.testing.assert_array_equal(_as_host_dtype(dev, host_dtype),
                                  _host_padded(X, cd, 1792, 8))


def test_f64_lossless_input_matches():
    rng = np.random.RandomState(17)
    X = rng.randint(-500, 500, (2000, 4)).astype(np.float64) / 8.0
    y = (X[:, 0] > 0).astype(np.float32)
    assert ingest_mod.f32_lossless(X)
    cd = _mappers_for(X, y)
    dev, _ = _device_codes(X, cd, 2048, 4)
    np.testing.assert_array_equal(dev.numpy(), _host_padded(X, cd, 2048, 4))


# ---------------------------------------------------- buffers and chunks

@pytest.mark.parametrize("prefetch_depth", [1, 0])
def test_one_buffer_set_for_all_chunks_including_tail(prefetch_depth):
    """7 full chunks and a masked tail run on the first chunk's buffers
    (``compiles`` 1); a second pass through the same ingestor allocates
    nothing; prefetch off turns every chunk into a stall with the same
    codes."""
    X, y = _adversarial_matrix(n=2000)
    cd = _mappers_for(X, y, categorical=[5])
    C = len(cd.real_feature_idx)
    ing = ingest_mod.DeviceIngestor(cd.mappers, num_cols=C, n_rows=2000,
                                    out_dtype=cd.code_dtype, device=CPU)
    ref = _host_padded(X, cd, 2304, C)
    ptrs = None
    for _ in range(2):
        codes, rep = ingest_mod.device_ingest(
            X, cd.mappers, np.asarray(cd.real_feature_idx), n_rows=2000,
            n_rows_padded=2304, num_cols=C, out_dtype=cd.code_dtype,
            device=CPU, chunk_rows=256, prefetch_depth=prefetch_depth,
            ingestor=ing)
        np.testing.assert_array_equal(codes.numpy(), ref)
        assert rep["n_chunks"] == 9 and rep["compiles"] == ing.compiles == 1
        now = {k: v.data_ptr() for k, v in ing._buf.items()}
        assert ptrs is None or now == ptrs
        ptrs = now
    if prefetch_depth == 0:
        assert rep["stalls"] == 9 and rep["prefetch_hits"] == 0
        assert not rep["prefetch_enabled"]
    else:
        assert rep["prefetch_hits"] == 9 and rep["stalls"] == 0


def test_resolve_chunk_rows_contract():
    assert ingest_mod.resolve_chunk_rows(5000, 100000, 16) == 5000
    auto = ingest_mod.resolve_chunk_rows(0, 10 ** 9, 28)
    assert ingest_mod._CHUNK_MIN <= auto <= ingest_mod._CHUNK_MAX
    assert auto % 256 == 0
    assert ingest_mod.resolve_chunk_rows(0, 1000, 28) == 1000
    for args in ((5000, 100000, 16), (0, 10 ** 9, 28), (0, 1000, 28),
                 (0, 2_000_000, 137)):
        assert ingest_mod.resolve_chunk_rows(*args) == \
            jax_ingest.resolve_chunk_rows(*args)


def test_chunk_feeder_stall_accounting(monkeypatch):
    X = np.random.RandomState(0).rand(1024, 4).astype(np.float32)
    idx = np.arange(4)
    monkeypatch.setenv("LGBM_TPU_INGEST_NO_PREFETCH", "1")
    f = ingest_mod.ChunkFeeder(X, idx, chunk_rows=256, n_chunks=4,
                               num_cols=4, device=CPU)
    for i in range(4):
        f.prefetch(i)
        chunk, slot = f.get(i)
        np.testing.assert_array_equal(chunk.numpy(),
                                      X[i * 256:(i + 1) * 256])
        f.release(slot)
    assert f.stalls == 4 and f.hits == 0
    monkeypatch.delenv("LGBM_TPU_INGEST_NO_PREFETCH")
    f = ingest_mod.ChunkFeeder(X, idx, chunk_rows=256, n_chunks=4,
                               num_cols=4, device=CPU)
    for i in range(4):
        f.prefetch(i)
        f.get(i)
    assert f.hits == 4 and f.stalls == 0
    assert f.bytes_h2d == 4 * 256 * 4 * 4


# ----------------------------------------------------------- eligibility

def test_blocker_gates():
    m = _mappers_for(np.random.RandomState(0).rand(500, 2).astype(
        np.float32), np.zeros(500, np.float32)).mappers
    ok32 = np.zeros((8, 2), np.float32)
    assert ingest_mod.device_ingest_blocker(ok32, m) is None
    lossy = np.full((8, 2), 0.1, np.float64)
    assert "lossless" in ingest_mod.device_ingest_blocker(lossy, m)
    ints = np.zeros((8, 2), np.int32)
    assert "dtype" in ingest_mod.device_ingest_blocker(ints, m)
    sp = pytest.importorskip("scipy.sparse")
    assert "sparse" in ingest_mod.device_ingest_blocker(
        sp.csr_matrix(ok32), m)


def test_f32_lossless_probe():
    assert ingest_mod.f32_lossless(np.random.rand(100, 3).astype(np.float32))
    exact = np.arange(3000, dtype=np.float64).reshape(1000, 3)
    assert ingest_mod.f32_lossless(exact)
    exact[500, 1] = 0.1
    assert not ingest_mod.f32_lossless(exact)
    nan_ok = exact.copy()
    nan_ok[500, 1] = np.nan
    assert ingest_mod.f32_lossless(nan_ok)


def test_auto_defers_only_at_scale():
    rng = np.random.RandomState(2)
    small = rng.rand(1000, 4).astype(np.float32)
    cfg = Config.from_params({"verbose": -1, "tpu_ingest": "auto"})
    assert not construct_dataset(small, np.zeros(1000, np.float32),
                                 cfg).deferred
    big = rng.rand(_AUTO_DEFER_MIN_ROWS, 4).astype(np.float32)
    cd = construct_dataset(big, np.zeros(_AUTO_DEFER_MIN_ROWS, np.float32),
                           cfg)
    assert cd.deferred and cd.num_data == _AUTO_DEFER_MIN_ROWS
    rows = np.array([0, 17, 65535])
    got = cd.bin_rows(rows)
    assert cd._X_binned is None          # served without materialising
    full = cd.X_binned
    np.testing.assert_array_equal(got, full[rows])
    np.testing.assert_array_equal(
        full, bin_dense_host(big, cd.mappers,
                             np.asarray(cd.real_feature_idx, np.int64),
                             big.shape[0], cd.code_dtype))


def test_explicit_device_falls_back_on_lossy_f64(caplog):
    rng = np.random.RandomState(4)
    X = rng.rand(800, 4)                       # f64, not f32-representable
    y = (X[:, 0] > 0.5).astype(np.float32)
    p = dict(objective="binary", num_leaves=7, verbose=0,
             min_data_in_leaf=5, tpu_ingest="device", device="cpu")
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p),
                    num_boost_round=2, keep_training_booster=True)
    assert bst._gbdt._ingest_report is None
    assert np.isfinite(bst.predict(X)).all()
    assert any("falling back to host binning" in r.getMessage()
               for r in caplog.records)


# ------------------------------------------------- end-to-end bit identity

_TRAIN = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              min_data_in_leaf=5, verbose=-1, deterministic=True)


def _train(pkg, X, y, ingest, extra=None, rounds=8, fobj=None):
    extra = dict(extra or {})
    cats = extra.pop("_cats", "auto")
    p = dict(_TRAIN, tpu_ingest=ingest, **extra)
    if pkg is lgt:
        p["device"] = "cpu"
    ds = pkg.Dataset(X.copy(), label=y.copy(), params=p,
                     categorical_feature=cats)
    return pkg.train(p, ds, num_boost_round=rounds, fobj=fobj,
                     keep_training_booster=True)


def _exact_fobj(preds, ds):
    """Gradients on a 1/64 grid, unit hessians: every f32 sum exact."""
    y = ds.get_label()
    g = np.clip(np.round((preds - y) * 64) / 64.0, -2.0, 2.0)
    return g, np.ones_like(g)


def test_e2e_training_bit_identity_serial():
    X, y = _adversarial_matrix(n=3000)
    bh = _train(lgt, X, y, "host", {"_cats": [5]})
    bd = _train(lgt, X, y, "device", {"_cats": [5]})
    assert bh._gbdt._ingest_report is None
    assert bd._gbdt._ingest_report["compiles"] == 1
    assert torch.equal(bh._gbdt.Xb, bd._gbdt.Xb)
    np.testing.assert_array_equal(bh.predict(X), bd.predict(X))
    assert bh.model_to_string() == bd.model_to_string()


def test_e2e_model_text_equal_to_jax_on_exact_gradients():
    """Device ingest in both packages, on exact-arithmetic gradients
    (ROADMAP C14's bar): the same model text."""
    X, y = _adversarial_matrix(n=2000, seed=8)
    extra = {"_cats": [5], "objective": "regression",
             "boost_from_average": False, "metric": "none",
             "learning_rate": 0.5}
    ours = _train(lgt, X, y, "device", extra, rounds=5, fobj=_exact_fobj)
    ref = _train(lgb, X, y, "device", extra, rounds=5, fobj=_exact_fobj)
    assert ours._gbdt._ingest_report is not None
    assert ref._gbdt._ingest_report is not None
    assert ours.model_to_string() == ref.model_to_string()


def test_efb_deferred_planning_identity():
    rng = np.random.RandomState(7)
    g, p = 5, 10
    flags = np.zeros((3000, g * p), np.float32)
    picks = rng.randint(0, p, size=(3000, g))
    for gi in range(g):
        flags[np.arange(3000), gi * p + picks[:, gi]] = 1.0
    yf = (picks[:, 0] % 2).astype(np.float32)
    bh = _train(lgt, flags, yf, "host")
    bd = _train(lgt, flags, yf, "device")
    assert bh._gbdt.bundle is not None and bd._gbdt.bundle is not None
    assert bd._gbdt._ingest_report is None     # bundled codes: host
    assert torch.equal(bh._gbdt.bundle.col, bd._gbdt.bundle.col)
    assert torch.equal(bh._gbdt.Xb, bd._gbdt.Xb)
    np.testing.assert_array_equal(bh.predict(flags), bd.predict(flags))
    assert bh.model_to_string() == bd.model_to_string()
    assert bh._gbdt._data_fingerprint == bd._gbdt._data_fingerprint


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_data_fingerprint_equals_jax(ingest):
    X, y = _adversarial_matrix(n=2500, seed=9)
    ours = _train(lgt, X, y, ingest, {"_cats": [5]}, rounds=1)
    ref = _train(lgb, X, y, ingest, {"_cats": [5]}, rounds=1)
    assert (ours._gbdt._ingest_report is None) == (ingest == "host")
    assert ours._gbdt._data_fingerprint == ref._gbdt._data_fingerprint


# ------------------------------------------------ host-side satellites

def test_map_find_bin_deterministic_order():
    import time as _t
    active = [5, 0, 3, 9, 1]

    def find_one(j):
        _t.sleep(0.002 * (5 - (j % 5)))        # finish out of order
        return j * 10

    got = _map_find_bin(active, find_one)
    assert list(got.keys()) == active
    assert got == {j: j * 10 for j in active}
    assert _map_find_bin([2], lambda j: j + 1) == {2: 3}


def test_default_bin_is_the_one_zero_bin():
    X, y = _adversarial_matrix(n=1500)
    cd = _mappers_for(X, y, categorical=[5])
    for m in cd.mappers:
        assert m.default_bin == int(m.value_to_bin(np.zeros(1))[0])


def test_value_to_bin_out_parameter():
    X, y = _adversarial_matrix(n=1200)
    cd = _mappers_for(X, y, categorical=[5])
    jref = jax_bin_dense_host(
        X, cd.mappers, np.asarray(cd.real_feature_idx, np.int64),
        cd.code_dtype, X.shape[0])
    for inner, real in enumerate(cd.real_feature_idx):
        m = cd.mappers[inner]
        col = X[:, real]
        ref = m.value_to_bin(col)
        out = np.empty(1200, cd.code_dtype)
        ret = m.value_to_bin(col, out=out)
        assert ret is out
        np.testing.assert_array_equal(out, ref.astype(cd.code_dtype))
        np.testing.assert_array_equal(out, jref[:, inner])
