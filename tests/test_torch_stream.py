"""Out-of-core training in ``lightgbm_tpu_torch`` (``tpu_residency=stream|
auto``: ``ops/stream.py``, ``grower.StreamedGrower``, the histogram's
carried accumulator, ``observability/memory.py``, ``robustness/chaos.py``
and the command line's exit 144), on the CPU, against the JAX package.

The cases of ``tests/test_stream.py`` but data-parallel and its
recompile guard (the port compiles nothing), with their bars:

- a streamed run's model text, predictions, trees and eval curves are
  byte-equal to a resident run's, with compaction on and off (the sums are
  integers, so shard by shard gives one pass's bits): with bagging and
  feature_fraction, ``u4`` codes, categorical features and a valid set,
  multiclass, every shard size, a forced stall with a padded tail shard,
  ``nan_policy=skip_iter``, resumed into another shard size and into
  device residency, and the configurations the port refused before;
- against the JAX package: the packed bytes and unpacked codes of every
  layout, the shard geometry, shards and checksums, the ``auto``
  decisions at the JAX test's two budgets, and a streamed run's model
  text byte-equal to the JAX package's streamed text on exact-arithmetic
  gradients (ROADMAP C14's bar), within C1 and C3's bars (the same splits,
  leaves and predictions within 1e-5) otherwise;
- the plain histogram folded over shards into a carried int64
  accumulator is bit-equal to one pass;
- the refusals (feature-parallel, rollback, DART, linear leaves), the
  ``tree_batch`` fallback, the estimate charging two shards, and the CRC
  check: typed error, in flight, off by ``tpu_stream_verify=false``, and
  the CLI's exit 144 under ``LGBM_TPU_CHAOS_FLIP_SHARD``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import histogram as jax_hist
from lightgbm_tpu.ops import stream as jax_stream
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.ops.cuda_histogram import HistogramAccumulator
from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                              code_bytes_total,
                                              code_mode_for,
                                              histogram_scales, unpack_codes)
from lightgbm_tpu_torch.ops.stream import (HostShardStore,
                                           ShardCorruptionError,
                                           ShardPrefetcher, pack_codes_host,
                                           shard_geometry)
from lightgbm_tpu_torch.robustness.chaos import corrupt_host_shard
from lightgbm_tpu_torch.utils.log import LightGBMError

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _make_binary(n=3000, f=10, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    logit = X[:, 0] - 0.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.randn(n).astype(np.float32) * 0.2 > 0.3).astype(
        np.float32)
    return X, y


BASE = dict(objective="binary", num_leaves=31, learning_rate=0.1,
            min_data_in_leaf=3, verbose=-1, seed=5, metric="none",
            tpu_hist_chunk=256, bagging_fraction=0.7, bagging_freq=2,
            feature_fraction=0.8, device="cpu")


def _train(X, y, residency, rounds=6, **extra):
    params = dict(BASE, tpu_residency=residency, **extra)
    return lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=rounds,
                     keep_training_booster=True)


def _assert_identical(b1, b2, X):
    assert b1.model_to_string() == b2.model_to_string()
    np.testing.assert_array_equal(b1.predict(X), b2.predict(X))
    np.testing.assert_array_equal(b1.predict(X, raw_score=True),
                                  b2.predict(X, raw_score=True))
    assert len(b1.trees) == len(b2.trees) > 0
    for t1, t2 in zip(b1.trees, b2.trees):
        np.testing.assert_array_equal(t1.leaf_value, t2.leaf_value)
        np.testing.assert_array_equal(t1.split_feature, t2.split_feature)
        np.testing.assert_array_equal(t1.threshold_bin, t2.threshold_bin)


def _exact_fobj(preds, ds):
    """Gradients on a 1/64 grid, unit hessians: every f32 sum exact."""
    y = ds.get_label()
    g = np.clip(np.round((preds - y) * 64) / 64.0, -2.0, 2.0)
    return g, np.ones_like(g)


# ----------------------------------------------------- host shard transport

@pytest.mark.parametrize("mode,hi,dt", [
    ("u8", 256, np.uint8), ("u16", 4000, np.uint16), ("u4", 16, np.uint8),
    ("u6", 64, np.uint8)])
def test_pack_and_unpack_equal_jax(mode, hi, dt):
    """Every layout: the packed bytes are the JAX package's, and the
    port's unpack on torch gives the codes its own ``unpack_codes`` gives
    (``u16`` as ``int16``, the dtype the grower reads), into a buffer."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    for F in (3, 4, 5, 8):
        X = rng.randint(0, hi, size=(37, F)).astype(dt)
        pk = pack_codes_host(X, mode)
        np.testing.assert_array_equal(pk, jax_stream.pack_codes_host(X, mode))
        assert pk.shape == (37, code_bytes_total(F, mode))
        assert code_bytes_total(F, mode) == jax_hist.code_bytes_total(F, mode)
        want = np.asarray(jax_hist.unpack_codes(jnp.asarray(pk), F, mode))
        out = torch.empty((37, F), dtype=torch.uint8) \
            if mode in ("u4", "u6") else None
        got = unpack_codes(torch.from_numpy(pk), F, mode, out=out)
        assert got.dtype == (torch.int16 if mode == "u16" else torch.uint8)
        assert got.shape == (37, F)
        np.testing.assert_array_equal(got.numpy().astype(np.int64)
                                      & 0xFFFF, want.astype(np.int64))
    for max_code, itemsize in ((15, 1), (16, 1), (17, 1), (64, 1),
                               (65, 1), (256, 1), (257, 2), (40, 2)):
        dtype = jnp.uint16 if itemsize == 2 else jnp.uint8
        assert code_mode_for(max_code, itemsize) == \
            jax_hist.code_mode_for(max_code, dtype)


def test_shard_geometry_equals_jax():
    """The port's shards (the requested rows or an eighth of the rows, the
    last shard padded) hold the rows of the JAX package's padded chunk
    geometry (gbdt.py:344 and :424 there) in the same order: the real rows
    of both stores, shard after shard, are the same bytes."""
    assert shard_geometry(2_000_000) == (2_000_000, 250_000)
    assert shard_geometry(1500, 512) == (1536, 512)
    assert shard_geometry(777) == (784, 98)
    assert shard_geometry(100, 10**9) == (100, 100)
    assert shard_geometry(5) == (5, 1)
    rng = np.random.RandomState(8)
    for n, hist_chunk, req in ((1500, 256, 256), (3000, 256, 512),
                               (777, 32768, 0), (4096, 1024, 0)):
        X = rng.randint(0, 16, size=(n, 5)).astype(np.uint8)
        chunk = min(hist_chunk, -(-n // 256) * 256)
        padded = -(-n // chunk) * chunk
        ref = jax_stream.HostShardStore(
            X, n_rows_padded=padded, num_cols=6, n_devices=1,
            local_shard_rows=jax_stream.resolve_shard_rows(padded, chunk,
                                                           req),
            code_mode="u4")
        p_rows, rows = shard_geometry(n, req)
        ours = HostShardStore(X, n_rows_padded=p_rows, num_cols=6,
                              shard_rows=rows, code_mode="u4")
        assert ours.n_shards == -(-n // rows)
        assert sum(ours.real_rows(i) for i in range(ours.n_shards)) == n

        def real(store, rows_of):
            return np.concatenate([s[:rows_of(i)]
                                   for i, s in enumerate(store.shards)])
        R = ref.shards[0].shape[0]
        np.testing.assert_array_equal(
            real(ours, ours.real_rows),
            real(ref, lambda i: max(0, min(R, n - i * R))))


@pytest.mark.parametrize("mode,hi,dt", [
    ("u8", 250, np.uint8), ("u4", 16, np.uint8), ("u16", 3000, np.uint16)])
def test_store_shards_and_checksums_equal_jax(mode, hi, dt):
    """Row and column padding per shard, then packing: the port's shards
    and CRC32s are the JAX package's on one device."""
    rng = np.random.RandomState(5)
    X = rng.randint(0, hi, size=(1300, 7)).astype(dt)
    ours = HostShardStore(X, n_rows_padded=1536, num_cols=8, shard_rows=256,
                          code_mode=mode)
    ref = jax_stream.HostShardStore(X, n_rows_padded=1536, num_cols=8,
                                    local_shard_rows=256, n_devices=1,
                                    code_mode=mode)
    assert ours.n_shards == ref.n_shards == 6
    assert ours.shard_bytes == ref.shard_bytes
    assert ours.total_bytes == ref.total_bytes
    for a, b in zip(ours.shards, ref.shards):
        np.testing.assert_array_equal(a, b)
    assert ours.checksums == ref.checksums
    assert [ours.real_rows(i) for i in range(6)] == [256] * 5 + [20]


def test_plain_histogram_folded_over_shards_equals_one_pass():
    """``build_histograms(acc=...)`` over shards, and the accumulator class
    on the CPU, give one pass's bits; the plain version refuses a
    malformed accumulator."""
    rng = np.random.RandomState(2)
    N, F, B, S, L = 1000, 5, 16, 4, 9
    X = torch.from_numpy(rng.randint(0, B, size=(N, F)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(N).astype(np.float32))
    h = torch.from_numpy(rng.rand(N).astype(np.float32))
    inc = torch.from_numpy((rng.rand(N) < 0.8).astype(np.float32))
    leaf = torch.from_numpy(rng.randint(0, L, N).astype(np.int32))
    sol = torch.full((L + 1,), -1, dtype=torch.int32)
    sol[torch.tensor([1, 3, 4, 8])] = torch.arange(S, dtype=torch.int32)
    scales = histogram_scales(g * inc, h * inc)
    args = (g * inc, h * inc, inc, leaf, sol, S, B)
    one = build_histograms(X, *args, scales=scales)
    acc = torch.zeros((S, F, B, 3), dtype=torch.int64)
    for r0, r1 in ((0, 300), (300, 301), (301, 1000)):
        sl = slice(r0, r1)
        out = build_histograms(X[sl], g[sl] * inc[sl], h[sl] * inc[sl],
                               inc[sl], leaf[sl], sol, S, B, scales=scales,
                               acc=acc, raw_output=True)
        assert out is acc
    from lightgbm_tpu_torch.ops.histogram import finalize_histograms
    assert torch.equal(finalize_histograms(acc, scales), one)
    ha = HistogramAccumulator(S, F, B, CPU)
    ha.buf.fill_(7)
    ha.zero_()
    R = 256
    for i in range(4):
        n = min(R, N - i * R)
        shard = torch.zeros((R, F), dtype=torch.uint8)
        shard[:n] = X[i * R:i * R + n]
        ha.add(shard, g * inc, h * inc, inc, leaf, sol, i * R, n, scales)
    assert torch.equal(ha.finalize(scales), one)
    with pytest.raises(ValueError, match="acc must be int64"):
        build_histograms(X, *args, scales=scales,
                         acc=torch.zeros((S, F, B, 2), dtype=torch.int64))


# ------------------------------------------------------- bit-identity pins

def test_stream_vs_device_bit_identical():
    """With bagging and feature_fraction: streamed = resident, compaction
    on (the port's default) and off, and the streamed booster ran one
    flag read per wave and counted its copies."""
    X, y = _make_binary()
    b_st = _train(X, y, "stream", tpu_stream_shard_rows=512)
    g = b_st._gbdt
    assert g.residency == "stream" and g.Xb is None
    assert g.config.tpu_row_compact is False and not g.spec.row_compact
    assert g._stream_store.n_shards == 6
    gr = g._grower
    assert gr.flag_reads == gr.waves_run > 6
    rep = g._stream.report()
    # every shard handed out was copied once, and one copy may be in
    # flight for the next tree
    copies = rep["bytes_h2d"] // g._stream_store.shard_bytes
    assert copies - (rep["stalls"] + rep["prefetch_hits"]) in (0, 1)
    _assert_identical(b_st, _train(X, y, "device"), X)
    _assert_identical(b_st, _train(X, y, "device", tpu_row_compact=False), X)


def test_stream_u4_code_mode_bit_identical():
    X, y = _make_binary(seed=11)
    b_st = _train(X, y, "stream", max_bin=15, tpu_stream_shard_rows=256)
    assert b_st._gbdt._stream_store.code_mode == "u4"
    assert b_st._gbdt._grower.unpack_buf is not None
    _assert_identical(b_st, _train(X, y, "device", max_bin=15), X)


def test_stream_categorical_valid_sets_bit_identical():
    """Categorical routing of the shards and a resident valid set routed in
    the wave: the same model and the same eval curves."""
    rng = np.random.RandomState(4)
    n = 1500
    X = rng.rand(n, 6).astype(np.float32)
    X[:, 2] = rng.randint(0, 12, n)
    y = ((X[:, 0] > 0.5) ^ (X[:, 2] % 3 == 0)).astype(np.float32)
    Xv, yv = X[:300], y[:300]
    base = dict(objective="binary", num_leaves=15, min_data_in_leaf=3,
                verbose=-1, seed=5, metric="binary_logloss",
                tpu_hist_chunk=256, device="cpu")

    def run(res, extra):
        p = dict(base, tpu_residency=res, **extra)
        ev = {}
        ds = lgt.Dataset(X, label=y, params=p, categorical_feature=[2])
        b = lgt.train(p, ds, num_boost_round=4,
                      valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)],
                      valid_names=["v"], evals_result=ev,
                      verbose_eval=False)
        return b, ev

    bs, evs = run("stream", dict(tpu_stream_shard_rows=256))
    bd, evd = run("device", {})
    assert bs.model_to_string() == bd.model_to_string()
    np.testing.assert_array_equal(bs.predict(X), bd.predict(X))
    assert evs == evd and len(evs["v"]["binary_logloss"]) == 4


def test_stream_multiclass_bit_identical():
    rng = np.random.RandomState(4)
    X = rng.rand(1200, 6).astype(np.float32)
    y = rng.randint(0, 3, 1200).astype(np.float32)
    base = dict(objective="multiclass", num_class=3, num_leaves=15,
                min_data_in_leaf=3, verbose=-1, seed=5, metric="none",
                tpu_hist_chunk=256, device="cpu")
    bs = lgt.train(dict(base, tpu_residency="stream",
                        tpu_stream_shard_rows=256),
                   lgt.Dataset(X, label=y), num_boost_round=3)
    bd = lgt.train(dict(base, tpu_residency="device"),
                   lgt.Dataset(X, label=y), num_boost_round=3)
    assert bs.model_to_string() == bd.model_to_string()
    np.testing.assert_array_equal(bs.predict(X), bd.predict(X))


def test_stream_shard_size_never_changes_the_model():
    X, y = _make_binary(n=2048, seed=3)
    b1 = _train(X, y, "stream", rounds=4, tpu_stream_shard_rows=256)
    b2 = _train(X, y, "stream", rounds=4, tpu_stream_shard_rows=1024)
    assert b1._gbdt._stream_store.n_shards == 8
    assert b2._gbdt._stream_store.n_shards == 2
    _assert_identical(b1, b2, X)


@pytest.mark.parametrize("extra,rounds", [
    ({"objective": "poisson"}, 2),
    ({"enable_bundle": True}, 2),
    ({"nan_policy": "skip_iter"}, 2),
    ({"objective": "lambdarank", "tree_batch": 3}, 3),
    ({"tree_batch": 2}, 2),
    ({"tpu_ingest": "device"}, 2),
    ({"efb_one_hot": True}, 2),
], ids=["poisson", "bundle", "skip_iter", "lambdarank_batch", "tree_batch",
        "device_ingest", "efb_one_hot"])
def test_formerly_refused_stream_configs_train_like_resident(extra, rounds):
    """Configurations whose streaming the port refused before (ROADMAP
    A14): each trains streamed to the resident model text (deferred ingest
    falls back to host binning; on near-exclusive one-hot columns EFB's
    bundled codes stream)."""
    rng = np.random.RandomState(9)
    n = 1200
    extra = dict(extra)
    if extra.pop("efb_one_hot", False):
        picks = rng.randint(0, 10, size=(n, 5))
        X = np.zeros((n, 50), np.float32)
        for gi in range(5):
            X[np.arange(n), gi * 10 + picks[:, gi]] = 1.0
        y = (picks[:, 0] % 2).astype(np.float32)
        extra = {"enable_bundle": True}
    else:
        X = rng.rand(n, 8)
        X[:, 4:] = (rng.rand(n, 4) < 0.2) * rng.randint(1, 4, (n, 4))
        y = (X[:, 0] + X[:, 4] > 1.0).astype(np.float64)
    group = [100] * 12 if extra.get("objective") == "lambdarank" else None
    p = dict({"objective": "binary", "verbose": -1, "device": "cpu",
              "num_leaves": 7, "min_data_in_leaf": 5}, **extra)
    texts = []
    for res in ("stream", "device"):
        ds = lgt.Dataset(X, label=y, params=p, group=group)
        b = lgt.train(dict(p, tpu_residency=res), ds,
                      num_boost_round=rounds, keep_training_booster=True)
        assert b._gbdt.residency == res
        texts.append(b.model_to_string())
    if X.shape[1] == 50:
        assert b._gbdt.bundle is not None and b._gbdt.Xb.shape[1] < 50
    assert texts[0] == texts[1]


# ------------------------------------------------------- against the JAX one

_JAX_STREAM = dict(num_leaves=15, min_data_in_leaf=5, verbose=-1, seed=5,
                   metric="none", tpu_hist_chunk=256, bagging_fraction=0.7,
                   bagging_freq=2, feature_fraction=0.8,
                   tpu_residency="stream", tpu_stream_shard_rows=512)


def test_streamed_model_text_equals_jax_on_exact_gradients():
    """Both packages streamed (the JAX package through its own shard loop
    and one-hot pass), on 1/64-grid gradients: the same model text."""
    X, y = _make_binary(n=2048, seed=3)
    p = dict(_JAX_STREAM, objective="regression", learning_rate=0.5,
             boost_from_average=False)
    ref = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=4,
                    fobj=_exact_fobj)
    ours = lgt.train(dict(p, device="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=4, fobj=_exact_fobj,
                     keep_training_booster=True)
    assert ours._gbdt.residency == "stream"
    assert ours.model_to_string() == ref.model_to_string()


def test_streamed_binary_within_jax_bars():
    """Binary on arbitrary floats, both streamed (the JAX package in f64,
    ``tpu_hist_f64=true``): the same split features, thresholds and
    decision types; leaf values and predictions within C1 / C3's 1e-5
    (binary's g starts from the 1-ulp ``exp`` of C2)."""
    X, y = _make_binary(n=2048, seed=3)
    p = dict(_JAX_STREAM, objective="binary", learning_rate=0.1,
             tpu_hist_f64=True)
    ref = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=4)
    ours = lgt.train(dict(p, device="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=4)
    ref._ensure_finalized()
    assert len(ours.trees) == len(ref.trees) == 4
    for a, b in zip(ref.trees, ours.trees):
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_array_equal(b.decision_type, a.decision_type)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------- auto fallback

@pytest.mark.parametrize("budget,want", [(50_000, "stream"),
                                         (10 * (1 << 30), "device")])
def test_auto_residency_decision_equals_jax(budget, want):
    """``auto`` at the JAX test's two budgets: the port's decision from
    its own estimate is the JAX package's from its own."""
    X, y = _make_binary(n=2000)
    p = dict(BASE, tpu_residency="auto", tpu_hbm_budget_bytes=budget)
    ours = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y,
                                                       params=p))._gbdt
    jp = {k: v for k, v in p.items() if k != "device"}
    ref = lgb.Booster(params=jp, train_set=lgb.Dataset(X, label=y,
                                                       params=jp))._gbdt
    assert ours.residency == ref.residency == want
    assert (ours._stream_store is not None) == (want == "stream")
    # the effective config is normalized (stream implies no compaction)
    assert ours.config.tpu_row_compact is (want == "device")
    est = ours.residency_estimates
    assert est["stream"]["total_bytes"] < est["device"]["total_bytes"]


def test_auto_residency_budget_from_environment(monkeypatch):
    X, y = _make_binary(n=2000)
    p = dict(BASE, tpu_residency="auto", tpu_hbm_budget_bytes=10 * (1 << 30))
    monkeypatch.setenv("LGBM_TPU_HBM_BUDGET", "50000")
    b = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    assert b._gbdt.residency == "stream"


def test_stream_preflight_counts_shards_not_full_codes():
    """The estimate under stream charges the two shard buffers, not the
    code matrix."""
    X, y = _make_binary(n=4096)
    p = dict(BASE, tpu_residency="stream", tpu_stream_shard_rows=256)
    bst = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    est = bst._gbdt.residency_estimates["stream"]
    assert est["residency"] == "stream"
    store = bst._gbdt._stream_store
    assert est["components"]["codes"] == 2 * store.shard_bytes
    assert est["components"]["codes"] < store.total_bytes
    dev = bst._gbdt.residency_estimates["device"]
    assert dev["components"]["codes"] == 4096 * 10
    assert dev["total_bytes"] - est["total_bytes"] > \
        store.total_bytes - 2 * store.shard_bytes


# -------------------------------------------------------- checkpoint/resume

def test_stream_kill_and_resume_bit_identical(tmp_path):
    """Train 3 + resume 3 == train 6, resumed under another shard size and
    into device residency."""
    X, y = _make_binary(n=2048, seed=3)
    ck = str(tmp_path)
    p = dict(BASE, tpu_residency="stream", tpu_stream_shard_rows=512)
    b0 = lgt.train(dict(p), lgt.Dataset(X, label=y), num_boost_round=6)
    b1 = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    for _ in range(3):
        b1.update()
    b1.save_checkpoint(ck)
    for p2 in (dict(p, tpu_stream_shard_rows=256),
               dict(p, tpu_residency="device", tpu_row_compact=False)):
        b2 = lgt.Booster(params=p2,
                         train_set=lgt.Dataset(X, label=y, params=p2))
        b2.resume(ck)
        for _ in range(3):
            b2.update()
        np.testing.assert_array_equal(b0.predict(X), b2.predict(X))
        assert b0.model_to_string() == b2.model_to_string()


# ------------------------------------------------- forced stall / tail shard

def test_forced_stall_partial_tail_rows_not_double_counted(monkeypatch):
    """Prefetch off (every copy a counted stall) with a tail shard that is
    more padding than data: every real row counts once, and the model is
    the resident one."""
    monkeypatch.setenv("LGBM_TPU_STREAM_NO_PREFETCH", "1")
    n = 1500                      # pads to 2048: the tail shard is 548
    X, y = _make_binary(n=n, seed=13)   # rows of padding and 476 of data
    p = dict(BASE, tpu_residency="stream", tpu_stream_shard_rows=1024,
             bagging_fraction=1.0, bagging_freq=0, feature_fraction=1.0)
    bst = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    bst.update()
    g = bst._gbdt
    assert g._stream_store.n_rows_padded == 2048
    assert g._stream_store.n_shards == 2
    assert g._stream_store.real_rows(1) == 476
    assert g._stream.prefetch_enabled is False
    assert g._stream.hits == 0 and g._stream.stalls > 0
    assert g._stream.stall_seconds > 0.0
    bst._ensure_finalized()
    assert float(np.sum(bst.trees[0].leaf_count)) == pytest.approx(float(n))
    monkeypatch.delenv("LGBM_TPU_STREAM_NO_PREFETCH")
    b_dev = _train(X, y, "device", rounds=1, bagging_fraction=1.0,
                   bagging_freq=0, feature_fraction=1.0)
    np.testing.assert_array_equal(bst.predict(X), b_dev.predict(X))
    assert bst.model_to_string() == b_dev.model_to_string()


# -------------------------------------------------------------- guard rails

def test_stream_forces_tree_batch_to_one():
    X, y = _make_binary(n=1024)
    p = dict(BASE, tpu_residency="stream", tree_batch=4)
    bst = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    assert bst._gbdt.tree_batch == 1
    b = lgt.train(dict(p), lgt.Dataset(X, label=y), num_boost_round=2)
    assert len(b.trees) == 2


def test_stream_config_validation():
    X, y = _make_binary(n=256)
    for bad in (dict(tpu_residency="bogus"), dict(tpu_stream_shard_rows=-1)):
        with pytest.raises(LightGBMError):
            lgt.Booster(params=dict(BASE, **bad),
                        train_set=lgt.Dataset(X, label=y))


def test_stream_refusals():
    """Feature-parallel, DART and linear leaves refuse stream with the JAX
    package's reasons; rollback refuses on a streamed booster; ``auto``
    never picks stream where it is refused."""
    X, y = _make_binary(n=1024)

    def boost(**extra):
        p = dict(BASE, **extra)
        return lgt.Booster(params=p,
                           train_set=lgt.Dataset(X, label=y, params=p))
    with pytest.raises(LightGBMError, match="feature replicates rows"):
        boost(tpu_residency="stream", tree_learner="feature")
    with pytest.raises(LightGBMError, match="boosting=dart keeps"):
        boost(tpu_residency="stream", boosting="dart")
    with pytest.raises(LightGBMError, match="linear_tree"):
        boost(tpu_residency="stream", linear_tree=True)
    dart = boost(tpu_residency="auto", boosting="dart",
                 tpu_hbm_budget_bytes=50_000)
    assert dart._gbdt.residency == "device"
    bst = boost(tpu_residency="stream")
    bst.update()
    with pytest.raises(LightGBMError, match="rollback"):
        bst.rollback_one_iter()
    assert bst._gbdt._capture_blocker().startswith("tpu_residency=stream")


def test_stream_nan_policy_skip_iter():
    """A fobj poisons iteration 1: skip_iter drops it and training goes
    on, as the resident booster does."""
    from lightgbm_tpu.robustness.chaos import nan_gradient_fobj
    X, y = _make_binary(n=1024)
    models = []
    for res in ("stream", "device"):
        p = dict(BASE, tpu_residency=res, nan_policy="skip_iter",
                 objective="regression", bagging_fraction=1.0,
                 bagging_freq=0)
        bst = lgt.Booster(params=p,
                          train_set=lgt.Dataset(X, label=y, params=p))
        fobj = nan_gradient_fobj([1], seed=0)
        for _ in range(4):
            bst.update(fobj=fobj)
        assert len(bst._gbdt.models) == 3
        models.append(bst.model_to_string())
    assert models[0] == models[1]


# ----------------------------------------------------- shard integrity (CRC)

def test_shard_checksums_verify_and_catch_bit_flips():
    rng = np.random.RandomState(3)
    X = rng.randint(0, 16, size=(1024, 8)).astype(np.uint8)
    store = HostShardStore(X, n_rows_padded=1024, num_cols=8,
                           shard_rows=256, code_mode="u4")
    assert len(store.checksums) == store.n_shards == 4
    assert all(store.verify_shard(i) for i in range(store.n_shards))
    assert corrupt_host_shard(store, shard_index=2, seed=11) == 2
    assert not store.verify_shard(2)
    assert all(store.verify_shard(i) for i in (0, 1, 3))


def test_prefetcher_raises_typed_error_on_corrupt_shard():
    """A corrupted shard raises on its next copy, prefetched or stalled,
    counted as ``fault.shard_corrupt``; ``verify=False`` copies it."""
    obs.reset_for_tests()
    rng = np.random.RandomState(4)
    X = rng.randint(0, 250, size=(512, 4)).astype(np.uint8)
    store = HostShardStore(X, n_rows_padded=512, num_cols=4, shard_rows=128,
                           code_mode="u8")
    pf = ShardPrefetcher(store, CPU, prefetch_enabled=True)
    assert pf.verify_enabled
    pf.prefetch(0)
    assert torch.equal(pf.get(0), torch.from_numpy(X[:128]))
    pf.release(0)
    corrupt_host_shard(store, shard_index=1, seed=5)
    with pytest.raises(ShardCorruptionError, match="shard 1.*CRC32"):
        pf.prefetch(1)
    with pytest.raises(ShardCorruptionError):
        pf.get(1)
    snap = obs.snapshot()["counters"]
    assert snap["fault.shard_corrupt"] == 2
    assert snap["stream.prefetch_hits"] == 1
    pf_off = ShardPrefetcher(store, CPU, verify=False)
    assert pf_off.get(1) is not None
    obs.reset_for_tests()


def test_streamed_training_detects_in_flight_shard_corruption():
    X, y = _make_binary(n=2048)
    p = dict(BASE, tpu_residency="stream", tpu_stream_shard_rows=256)
    bst = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    bst.update()
    corrupt_host_shard(bst._gbdt._stream_store, shard_index=0, seed=7)
    with pytest.raises(ShardCorruptionError):
        bst.update()
    assert len(bst._gbdt.models) == 1


def test_stream_verify_knob_disables_the_check():
    X, y = _make_binary(n=1024)
    p = dict(BASE, tpu_residency="stream", tpu_stream_shard_rows=256,
             tpu_stream_verify=False)
    bst = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y, params=p))
    assert bst._gbdt._stream.verify_enabled is False
    corrupt_host_shard(bst._gbdt._stream_store, shard_index=0, seed=7)
    bst.update()
    assert len(bst._gbdt.models) == 1


def test_cli_exits_144_on_a_flipped_shard(tmp_path, monkeypatch):
    """``LGBM_TPU_CHAOS_FLIP_SHARD`` flips a shard when the store is built:
    the port's command line exits with the JAX package's status 144, and
    the next run (the marker exists) trains."""
    from lightgbm_tpu_torch.cli import main as cli_main
    from lightgbm_tpu_torch.ops.stream import EXIT_SHARD_CORRUPT
    X, y = _make_binary(n=600)
    data = tmp_path / "train.tsv"
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.6f")
    marker = tmp_path / "flipped"
    monkeypatch.setenv("LGBM_TPU_CHAOS_FLIP_SHARD", str(marker))
    argv = [f"data={data}", "task=train", "objective=binary",
            "num_iterations=2", "tpu_residency=stream", "device=cpu",
            "verbose=-1", f"output_model={tmp_path / 'm.txt'}"]
    with pytest.raises(SystemExit) as e:
        cli_main(argv)
    assert e.value.code == EXIT_SHARD_CORRUPT == 144
    assert marker.exists()
    assert cli_main(argv) == 0
    assert (tmp_path / "m.txt").exists()
