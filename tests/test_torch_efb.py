"""Port parity for sparse input and EFB (exclusive feature bundling): the
copied ``efb.py``, the bundle-space split scan, bundled growth and routing,
``enable_bundle=auto`` and whole trees, against the JAX package on the same
seeded numpy inputs (CPU).

Bars (bit-equal unless a tolerance is named):
- ``plan_bundles`` / ``materialize_bundles`` / ``build_code_feat`` and the
  conflict sample: every field and code equal, with and without conflicts;
- ``per_feature_best_bundled`` and ``unpack_bundled_hist`` on bundle-space
  histograms whose g/h are multiples of 2^-8 (every sum exact in f32): every
  field equal, a gain tie planted across a member boundary resolved to the
  lowest original feature;
- ``grow_tree`` in bundle space on quantised g/h: every ``TreeArrays``
  field and the final ``leaf_id`` equal;
- whole models on exact-arithmetic gradients (a quantised-residual
  ``fobj``, as ``tests/test_efb_bundlespace.py`` drives the JAX package's
  own arms): the JAX package bundled, the port bundled and the port
  unbundled give the same model text, with conflicts, ``uint16`` bundles
  and a categorical column among the cases;
- ``enable_bundle=auto`` bundles exactly where the JAX package does, the
  Bosch shape of ROADMAP C13 included;
- CSR and CSC input train the same model as dense input, and a sparse
  valid set and sparse ``predict`` (chunked past 2^24 / F rows) give the
  same numbers.
"""
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import efb as jefb
from lightgbm_tpu.grower import BundleDecode as JaxBundle
from lightgbm_tpu.grower import GrowerSpec as JaxSpec
from lightgbm_tpu.grower import grow_tree as jax_grow
from lightgbm_tpu.ops import split_finder as jsf
from lightgbm_tpu_torch import efb
from lightgbm_tpu_torch.grower import BundleDecode, GrowerSpec, grow_tree
from lightgbm_tpu_torch.interop import binned_dataset, to_numpy, to_torch
from lightgbm_tpu_torch.ops import split_finder as tsf

HYPER = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=5.0,
             min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
BASE = dict(objective="regression", boost_from_average=False, num_leaves=15,
            min_data_in_leaf=5, learning_rate=0.5, device="cpu", verbose=-1,
            metric="none")


# ------------------------------------------------------------ data builders

def _mixed_sparse(n=1200, dense=4, groups=3, per_group=20, seed=3):
    """Dense columns and mutually exclusive binary flag groups (no
    conflicts) — the JAX package's EFB test shape."""
    rng = np.random.RandomState(seed)
    Xd = rng.rand(n, dense)
    flags = np.zeros((n, groups * per_group))
    picks = rng.randint(0, per_group, size=(n, groups))
    for g in range(groups):
        flags[np.arange(n), g * per_group + picks[:, g]] = 1.0
    X = np.concatenate([Xd, flags], axis=1)
    y = (Xd[:, 0] + 0.3 * (picks[:, 0] > per_group // 2)
         + 0.1 * rng.randn(n) > 0.65).astype(np.float64)
    return X, y


def _near_exclusive(n=1500, F=30, seed=1):
    """One-hot sensor codes with 2% dense rows: every feature pair
    conflicts on ~2% of rows, so bundles form only under
    ``max_conflict_rate`` above that."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, F))
    picks = rng.randint(0, F, n)
    X[np.arange(n), picks] = rng.randint(1, 8, n) / 8.0
    dense = rng.choice(n, n // 50, replace=False)
    X[dense] = rng.randint(1, 8, (len(dense), F)) / 8.0
    y = ((picks % 2) ^ (rng.rand(n) < 0.1)).astype(np.float64)
    return X, y


def _bosch_like(n, n_features=968, group_size=8, seed=2):
    """``bench.py``'s Bosch-shaped generator at ``n`` rows (CSR)."""
    rng = np.random.RandomState(seed)
    rows = np.arange(n)
    r, c, v = [], [], []
    for g in range(n_features // group_size):
        active = rng.rand(n) < 0.75
        member = rng.randint(0, group_size, n)[active]
        r.append(rows[active])
        c.append(g * group_size + member)
        v.append(rng.randint(1, 8, member.size) / 8.0)
    X = sp.csr_matrix((np.concatenate(v), (np.concatenate(r),
                                           np.concatenate(c))),
                      shape=(n, n_features))
    y = (np.asarray(X[:, 0].todense()).ravel()
         + rng.randn(n) * 0.3 > 0.1).astype(np.float64)
    return X, y


def _exact_fobj(preds, ds):
    """Gradients on a 1/64 grid, unit hessians: every f32 sum exact."""
    y = ds.get_label()
    g = np.clip(np.round((preds - y) * 64) / 64.0, -2.0, 2.0)
    return g, np.ones_like(g)


def _binned(X, y, **params):
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params(dict(verbose=-1, **params)))
    return ds.constructed


# -------------------------------------------------------- the efb.py copy

@pytest.mark.parametrize("data,rate", [("mixed", 0.0), ("near", 0.0),
                                       ("near", 0.05), ("wide", 0.0)])
def test_efb_copy_matches_jax(data, rate):
    if data == "mixed":
        X, y = _mixed_sparse()
    elif data == "near":
        X, y = _near_exclusive()
    else:       # a >255-bin column: a singleton bundle with uint16 codes
        X, y = _mixed_sparse()
        X = np.column_stack([X, np.random.RandomState(0).randn(len(y))])
    cfg = dict(max_conflict_rate=rate, max_bin=511 if data == "wide" else 255)
    cd = _binned(X, y, **cfg)
    meta = cd.feature_meta_arrays()
    nb = meta["num_bins"].astype(np.int64)
    db = meta["default_bin"].astype(np.int64)
    jcfg = lgb.Config.from_params(dict(verbose=-1, **cfg))
    ours = efb.plan_bundles(cd.X_binned, nb, db, cd.config)
    ref = jefb.plan_bundles(np.ascontiguousarray(cd.X_binned), nb, db, jcfg)
    if data == "near" and rate == 0.0:
        assert ours is None and ref is None
        return
    assert ours.groups == ref.groups
    for name in ("group_total_bins", "col", "lo", "hi", "off", "unpack_bin",
                 "X_bundled"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name), err_msg=name)
    assert ours.X_bundled.dtype == ref.X_bundled.dtype \
        == (np.uint16 if data == "wide" else np.uint8)
    G, Bb = ours.num_groups, max(8, -(-ours.max_bundle_bins // 8) * 8)
    np.testing.assert_array_equal(efb.build_code_feat(ours, G, Bb, db),
                                  jefb.build_code_feat(ref, G, Bb, db))
    # materialising an existing plan again (the block-wise writer)
    np.testing.assert_array_equal(
        efb.materialize_bundles(ours, cd.X_binned, db, block_rows=97),
        ref.X_bundled)
    if rate > 0:
        assert ours.num_groups < X.shape[1]      # conflicts admitted


def test_efb_row_sample_matches_jax():
    for n in (5_000, 250_000):
        np.testing.assert_array_equal(efb.sample_row_indices(n),
                                      jefb.sample_row_indices(n))
    codes = np.random.RandomState(1).randint(0, 9, (150_000, 3))
    np.testing.assert_array_equal(efb.sample_rows(codes),
                                  jefb.sample_rows(codes))


# ----------------------------------------------------- the bundle-space scan

def _bundle_tables(plan, cd):
    meta = cd.feature_meta_arrays()
    db = meta["default_bin"].astype(np.int64)
    G = plan.num_groups
    Bb = max(8, -(-plan.max_bundle_bins // 8) * 8)
    B = max(8, -(-cd.max_num_bin // 8) * 8)
    ub = np.pad(plan.unpack_bin, ((0, 0), (0, B - plan.unpack_bin.shape[1])),
                constant_values=-1)
    cf = efb.build_code_feat(plan, G, Bb, db)
    tables = dict(col=plan.col, lo=plan.lo, hi=plan.hi, off=plan.off,
                  unpack_bin=ub, code_feat=cf)
    return ({k: np.asarray(v, np.int32) for k, v in tables.items()}, Bb, B,
            meta)


def _bundled_hist(plan, Bb, T, rng, tie=None):
    """[T, G, Bb, 3] bundle-space histograms from random rows: g on a 2^-8
    grid, integer counts; the leaf totals are any column's sums."""
    n = 600
    Xb = plan.X_bundled
    rows = rng.randint(0, Xb.shape[0], (T, n))
    g = rng.randint(-256, 256, (T, n)) / 256.0
    h = rng.randint(1, 64, (T, n)) / 256.0
    G = Xb.shape[1]
    hist = np.zeros((T, G, Bb, 3))
    for t in range(T):
        codes = Xb[rows[t]].astype(np.int64)
        for gi in range(G):
            np.add.at(hist[t, gi, :, 0], codes[:, gi], g[t])
            np.add.at(hist[t, gi, :, 1], codes[:, gi], h[t])
            np.add.at(hist[t, gi, :, 2], codes[:, gi], 1.0)
    if tie is not None:
        # two members of one bundle with identical histograms
        (ga, a_lo, a_hi), b_lo = tie
        hist[:, ga, b_lo:b_lo + (a_hi - a_lo)] = hist[:, ga, a_lo:a_hi]
    tot = hist[:, 0].sum(axis=1)
    return hist.astype(np.float32), [tot[:, j].astype(np.float32)
                                     for j in range(3)]


@pytest.mark.parametrize("planted_tie", [False, True])
def test_bundled_scan_matches_jax(planted_tie):
    X, y = _mixed_sparse(n=900)
    X[np.random.RandomState(4).rand(900) < 0.1, 1] = np.nan   # a NaN member
    cd = _binned(X, y)
    meta = cd.feature_meta_arrays()
    plan = efb.plan_bundles(cd.X_binned, meta["num_bins"].astype(np.int64),
                            meta["default_bin"].astype(np.int64), cd.config)
    tab, Bb, B, meta = _bundle_tables(plan, cd)
    tie = None
    if planted_tie:
        big = [m for m in plan.groups if len(m) > 2][0]
        fa, fb = big[0], big[1]
        assert plan.col[fa] == plan.col[fb]
        tie = ((int(plan.col[fa]), int(plan.lo[fa]), int(plan.hi[fa])),
               int(plan.lo[fb]))
    hist, par = _bundled_hist(plan, Bb, 6, np.random.RandomState(7), tie)
    F = cd.num_features
    ok = np.ones(F, bool)
    ok[2] = False
    fmeta = [meta["num_bins"], meta["missing_code"], meta["default_bin"]]
    keys = ("col", "lo", "hi", "off", "code_feat")
    ref = jsf.per_feature_best_bundled(
        jnp.asarray(hist), *[jnp.asarray(p) for p in par],
        *[jnp.asarray(m) for m in fmeta], jnp.asarray(ok),
        *[jnp.asarray(tab[k]) for k in keys], **HYPER)
    ours = tsf.per_feature_best_bundled(
        to_torch(hist), *[to_torch(p) for p in par],
        *[to_torch(m) for m in fmeta], to_torch(ok),
        *[to_torch(tab[k]) for k in keys], **HYPER)
    for name in ref._fields:
        np.testing.assert_array_equal(to_numpy(getattr(ours, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    jc = jsf.reduce_features(ref)
    tc = tsf.reduce_features(ours, num_bins_padded=B)
    for name in ("gain", "feature", "threshold", "default_left", "left_g",
                 "left_h", "left_c"):
        np.testing.assert_array_equal(to_numpy(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    if planted_tie:
        # the two members tie; the lower original index must win wherever
        # one of them is the best feature
        fa, fb = big[0], big[1]
        np.testing.assert_array_equal(to_numpy(ours.gain)[:, fa],
                                      to_numpy(ours.gain)[:, fb])
        assert fb not in set(to_numpy(tc.feature).tolist())
    # the categorical members' unpack, on every feature
    ci = np.arange(F)
    ref_u = jsf.unpack_bundled_hist(
        jnp.asarray(hist), jnp.asarray(tab["col"][ci]),
        jnp.asarray(tab["unpack_bin"][ci]), *[jnp.asarray(p) for p in par],
        jnp.asarray(meta["default_bin"][ci]))
    ours_u = tsf.unpack_bundled_hist(
        to_torch(hist), to_torch(tab["col"][ci]),
        to_torch(tab["unpack_bin"][ci]), *[to_torch(p) for p in par],
        to_torch(meta["default_bin"][ci]))
    np.testing.assert_array_equal(to_numpy(ours_u), np.asarray(ref_u))


def test_grow_tree_bundled_matches_jax():
    X, y = _mixed_sparse(n=1536)
    X[np.random.RandomState(5).rand(1536) < 0.15, 0] = np.nan
    cd = _binned(X, y)
    meta = cd.feature_meta_arrays()
    plan = efb.plan_bundles(cd.X_binned, meta["num_bins"].astype(np.int64),
                            meta["default_bin"].astype(np.int64), cd.config)
    tab, Bb, B, meta = _bundle_tables(plan, cd)
    rng = np.random.RandomState(6)
    N, F, L = len(y), cd.num_features, 31
    g = (rng.randint(-128, 128, N) / 256.0).astype(np.float32)
    h = (rng.randint(1, 64, N) / 256.0).astype(np.float32)
    inc = np.ones(N, np.float32)
    ok = np.ones(F, bool)
    cat = np.zeros(F, bool)
    fmeta = [meta["num_bins"], meta["missing_code"], meta["default_bin"]]
    common = dict(num_leaves=L, num_features=F, num_bins_padded=B,
                  hist_slots=25, wave_size=25, max_depth=-1, hist_bins=Bb,
                  **HYPER)
    keys = BundleDecode._fields
    jt, jleaf = jax_grow(
        jnp.asarray(plan.X_bundled), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(inc), jnp.asarray(ok), jnp.asarray(cat),
        *[jnp.asarray(m) for m in fmeta],
        JaxSpec(chunk_rows=512, **common),
        bundle=JaxBundle(*[jnp.asarray(tab[k]) for k in keys]))
    tt, tleaf = grow_tree(
        to_torch(plan.X_bundled), to_torch(g), to_torch(h), to_torch(inc),
        to_torch(ok), to_torch(cat), *[to_torch(m) for m in fmeta],
        GrowerSpec(**common),
        bundle=BundleDecode(*[to_torch(tab[k]) for k in keys]))
    nl = int(jt.num_leaves)
    assert int(tt.num_leaves) == nl > 10
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_gain",
                 "internal_value", "internal_count"):
        np.testing.assert_array_equal(to_numpy(getattr(tt, name))[:L - 1],
                                      np.asarray(getattr(jt, name))[:L - 1],
                                      err_msg=name)
    for name in ("leaf_value", "leaf_count", "leaf_parent"):
        np.testing.assert_array_equal(to_numpy(getattr(tt, name))[:L],
                                      np.asarray(getattr(jt, name))[:L],
                                      err_msg=name)
    np.testing.assert_array_equal(to_numpy(tleaf), np.asarray(jleaf))
    # the bundled walk lands every row in the leaf the grower routed it to
    from lightgbm_tpu_torch.ops.predict import leaves_from_binned
    walked = leaves_from_binned(
        tt, to_torch(plan.X_bundled), *[to_torch(m) for m in fmeta],
        bundle=BundleDecode(*[to_torch(tab[k]) for k in keys]))
    np.testing.assert_array_equal(to_numpy(walked), to_numpy(tleaf))


# ------------------------------------------------------- whole models, trio

def _trio_data(case):
    if case == "flags":
        X, y = _mixed_sparse()
        return X, y, {}, {}
    if case == "conflicts":
        X, y = _near_exclusive()
        return X, y, dict(max_conflict_rate=0.05), {}
    if case == "uint16":
        X, y = _mixed_sparse()
        X = np.column_stack([X, np.round(
            np.random.RandomState(8).randn(len(y)) * 300)])
        return X, y, dict(max_bin=511), {}
    X, y = _mixed_sparse()
    cat = np.random.RandomState(9).randint(0, 6, len(y)).astype(np.float64)
    y = np.where(cat >= 4, 1.0 - y, y)
    return (np.column_stack([X, cat]), y, dict(min_data_per_group=5),
            {"categorical_feature": [X.shape[1]]})


@pytest.fixture(scope="module")
def jax_trio_models():
    """The JAX package's bundled models, one per case (one compile each)."""
    out = {}
    for case in ("flags", "conflicts", "uint16", "categorical"):
        X, y, extra, kw = _trio_data(case)
        bst = lgb.train(dict(BASE, **extra), lgb.Dataset(X, label=y, **kw),
                        num_boost_round=6, fobj=_exact_fobj,
                        keep_training_booster=True, verbose_eval=False)
        assert bst._gbdt.bundle is not None
        out[case] = bst.model_to_string()
    return out


@pytest.mark.parametrize("case", ["flags", "conflicts", "uint16",
                                  "categorical"])
def test_trio_model_text_on_exact_arithmetic(jax_trio_models, case):
    """JAX bundled == port bundled (== port unbundled where there are no
    conflicts), model text byte for byte."""
    X, y, extra, kw = _trio_data(case)

    def port(**more):
        return lgt.train(dict(BASE, **extra, **more),
                         lgt.Dataset(X, label=y, **kw), num_boost_round=6,
                         fobj=_exact_fobj, keep_training_booster=True)
    bundled = port()
    g = bundled._gbdt
    assert g.bundle is not None and g.Xb.shape[1] < X.shape[1]
    if case == "uint16":
        assert g.Xb.dtype == torch.int16 and g.efb_plan.max_bundle_bins > 255
    text = bundled.model_to_string()
    assert text.split("Tree=0")[1] == jax_trio_models[case].split(
        "Tree=0")[1]
    if case == "categorical":
        assert any((np.asarray(t.decision_type) & 1).any()
                   for t in bundled.trees)
    if case != "conflicts":
        off = port(enable_bundle=False)
        assert off._gbdt.bundle is None
        assert off.model_to_string() == text


# ------------------------------------------------------------ auto decision

def _auto_shapes():
    rng = np.random.RandomState(0)
    Xd = rng.rand(600, 8)
    yd = (Xd[:, 0] > 0.5).astype(float)
    Xf, yf = _mixed_sparse(n=600)
    # a plan that exists but does not win: two exclusive flags beside 20
    # dense columns make 21 bundles of 22 features (G * Bb_pad is not
    # below 0.9 F * Bpad, and 2G > F)
    Xw = np.column_stack([rng.rand(600, 20), Xf[:, 4:6]])
    Xw[:, 20] = (Xf[:, 4:24].argmax(axis=1) < 10)
    Xw[:, 21] = 1.0 - Xw[:, 20]
    Xb, yb = _bosch_like(1500)
    return {"dense": (Xd, yd), "flags": (Xf, yf), "few flags": (Xw, yf),
            "Bosch (C13)": (Xb, yb)}


@pytest.mark.parametrize("shape", ["dense", "flags", "few flags",
                                   "Bosch (C13)"])
def test_enable_bundle_auto_decides_as_jax(shape):
    X, y = _auto_shapes()[shape]
    p = dict(objective="binary", device="cpu", verbose=-1)
    ref = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y))
    ours = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y))
    bundled = ours._gbdt.bundle is not None
    assert bundled == (ref._gbdt.bundle is not None)
    if bundled:
        np.testing.assert_array_equal(to_numpy(ours._gbdt.bundle.col),
                                      np.asarray(ref._gbdt.bundle.col))
    if shape == "Bosch (C13)":
        # G * Bb_pad == F * Bpad and 2G <= F: bundles by the column rule
        plan = ours._gbdt.efb_plan
        assert bundled and plan.num_groups == 121
        assert plan.num_groups * 64 == X.shape[1] * 8
    if shape == "dense":
        assert not bundled
    if shape == "few flags":
        assert ours._gbdt.efb_wins is False
        assert ours._gbdt.efb_plan is None


# ------------------------------------------------------------ sparse input

@pytest.fixture(scope="module")
def sparse_models():
    X, y = _mixed_sparse(n=1000)
    X[:, 0] *= np.random.RandomState(2).rand(1000) < 0.5   # zeros to store
    p = dict(objective="binary", num_leaves=15, min_data_in_leaf=5,
             device="cpu", verbose=-1, metric="binary_logloss")
    out = {}
    for kind, conv in (("dense", np.asarray), ("csr", sp.csr_matrix),
                       ("csc", sp.csc_matrix)):
        d = lgt.Dataset(conv(X[:800]), label=y[:800])
        v = lgt.Dataset(conv(X[800:]), label=y[800:], reference=d)
        ev = {}
        out[kind] = (lgt.train(p, d, num_boost_round=4, valid_sets=[v],
                               evals_result=ev), ev)
    return X, y, out


@pytest.mark.parametrize("kind", ["csr", "csc"])
def test_sparse_training_matches_dense(sparse_models, kind):
    X, y, out = sparse_models
    dense, ev_dense = out["dense"]
    bst, ev = out[kind]
    assert bst.model_to_string() == dense.model_to_string()
    assert ev == ev_dense
    Xs = sp.csr_matrix(X) if kind == "csr" else sp.csc_matrix(X)
    np.testing.assert_array_equal(bst.predict(Xs), dense.predict(X))


def test_sparse_codes_match_jax():
    Xb, yb = _bosch_like(600)
    ours = binned_dataset(_binned(Xb, yb))
    ds = lgb.Dataset(Xb, label=yb)
    ds.construct(lgb.Config.from_params({"verbose": -1}))
    ref = binned_dataset(ds.constructed)
    for name in ("X_binned", "num_bins", "default_bin", "real_feature_idx"):
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
    # a valid set binned from CSR with the training mappers
    cd = _binned(Xb, yb)
    np.testing.assert_array_equal(cd.bin_raw(Xb[:100].tocsc()),
                                  ds.constructed.bin_raw(Xb[:100]))


def test_sparse_predict_in_chunks():
    """Past 2^24 / F rows a CSR batch is densified and predicted chunk by
    chunk, and agrees with the dense batch."""
    rng = np.random.RandomState(3)
    F = 1000
    Xs = sp.random(17_000, F, density=0.002, format="csr", random_state=rng)
    y = (np.asarray(Xs[:, 0].todense()).ravel() > 0).astype(float)
    bst = lgt.train(dict(objective="binary", device="cpu", verbose=-1,
                         num_leaves=4, min_data_in_leaf=2),
                    lgt.Dataset(Xs[:2000], label=y[:2000]),
                    num_boost_round=2)
    assert Xs.shape[0] > (1 << 24) // F
    np.testing.assert_array_equal(bst.predict(Xs),
                                  bst.predict(Xs.toarray()))


def test_kernel_plan_at_the_bundled_bosch_shape():
    """B1's wrapper at the Bosch shape under EFB: 121 bundled columns of 64
    bins fit one feature group (one block's shared memory holds them all);
    a uint16 singleton bundle (Bb_pad 512) splits the columns into groups
    that each fit, whole 32-bit words of codes."""
    from lightgbm_tpu_torch.ops.cuda_histogram import (MIN_ROWS_PER_BLOCK,
                                                       SMEM_BLOCK_LIMIT,
                                                       feature_groups,
                                                       grid_blocks)
    assert feature_groups(121, 64, 1) == (121, 1)
    assert 121 * 64 * 20 <= SMEM_BLOCK_LIMIT
    # the grid hist_kernel spreads a pass over: one block an SM at this
    # shared memory size, runs of at least MIN_ROWS_PER_BLOCK positions
    grid = grid_blocks(1_184_000, 121, 64, 1, 132)
    assert grid == 132
    assert -(-1_184_000 // grid) >= MIN_ROWS_PER_BLOCK
    fg, groups = feature_groups(122, 512, 2)
    assert groups > 1 and fg * 512 * 20 <= SMEM_BLOCK_LIMIT
    assert fg % 2 == 0 and fg * groups >= 122
