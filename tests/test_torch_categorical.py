"""Port parity for categorical features: binning, the categorical split
scan, routing through ``grow_tree`` and whole trees, against the JAX
package on the same seeded numpy inputs (CPU).

Bars:
- ``BinMapper`` of a categorical column (a 300-category Zipf column with
  negative values and NaN): ``bin_2_categorical``, ``num_bin``,
  ``missing_type`` and every code equal;
- ``per_feature_best_categorical``: BIT-equal to the JAX scan (gain, left
  sums, threshold, default_left and the left-set mask) on histograms whose
  g/h are multiples of 2^-8 and whose counts are whole numbers, so every
  prefix sum is exact in f32 on both sides; both modes and the
  ``max_cat_to_onehot`` boundary, ``min_data_per_group`` resets and breaks,
  a planted ctr tie and a planted direction tie, missing types 0/1/2 and a
  ``cat_ok`` gate;
- ``grow_tree`` with categorical features on quantised g/h: every
  ``TreeArrays`` field and the final ``leaf_id`` of every row bit-equal;
- ``tests/fixtures/cat_det.train`` end to end (binary, 5 rounds,
  leaf-wise): against the JAX package with ``tpu_hist_f64=true``, every
  split feature, decision type and ``cat_threshold`` equal; against the
  reference CLI's ``ref_cat_det_model.txt`` at the JAX package's own bar
  (``test_tree_parity.py``): every decision type, exactly 68/70 split
  features and the root bitset; model text crossing the packages both ways
  and predicting the same.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.binning import BIN_CATEGORICAL as JAX_CAT
from lightgbm_tpu.binning import BinMapper as JaxBinMapper
from lightgbm_tpu.grower import GrowerSpec as JaxSpec
from lightgbm_tpu.grower import grow_tree as jax_grow
from lightgbm_tpu.ops.categorical import \
    per_feature_best_categorical as jax_cat_scan
from lightgbm_tpu_torch.binning import BIN_CATEGORICAL, BinMapper
from lightgbm_tpu_torch.grower import GrowerSpec, grow_tree
from lightgbm_tpu_torch.interop import (binned_dataset, to_numpy, to_torch,
                                        tree_arrays_numpy)
from lightgbm_tpu_torch.ops.categorical import per_feature_best_categorical

HERE = os.path.dirname(__file__)
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
        "feature_fraction": 1.0, "bagging_freq": 0, "min_data_in_leaf": 50,
        "min_sum_hessian_in_leaf": 5.0, "verbose": -1, "tpu_wave_size": 1}

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

HYPER = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=5.0,
             min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
             cat_smooth=10.0, cat_l2=10.0, max_cat_threshold=32,
             max_cat_to_onehot=4, min_data_per_group=100.0)


# ----------------------------------------------------------------- binning

def test_categorical_bin_mapper_matches_jax():
    rng = np.random.RandomState(7)
    n = 20000
    v = (rng.zipf(1.3, n) % 300).astype(np.float64)
    neg = rng.rand(n) < 0.03
    v[neg] = -rng.randint(1, 5, int(neg.sum()))
    v[rng.rand(n) < 0.05] = np.nan
    for use_missing in (True, False):
        ours, ref = BinMapper(), JaxBinMapper()
        for m, cat in ((ours, BIN_CATEGORICAL), (ref, JAX_CAT)):
            m.find_bin(v.copy(), n, 255, 3, 0, cat, use_missing, False)
        assert ours.num_bin == ref.num_bin > 256
        assert ours.missing_type == ref.missing_type
        assert list(ours.bin_2_categorical) == list(ref.bin_2_categorical)
        probe = np.concatenate([v, [np.nan, -1.0, 1e9, 299.0, 0.0, 2.5]])
        np.testing.assert_array_equal(ours.value_to_bin(probe),
                                      ref.value_to_bin(probe))


# ------------------------------------------------------------ split scan

def _hist(seed, S, F, B, num_bins, cmax=60):
    """A quantised histogram: g, h multiples of 2^-8, whole counts; bins at
    and above a feature's num_bins are empty."""
    rng = np.random.RandomState(seed)
    c = rng.randint(0, cmax, (S, F, B)).astype(np.float32)
    g = (rng.randint(-512, 512, (S, F, B)) / 256.0).astype(np.float32)
    h = (rng.randint(1, 256, (S, F, B)) / 256.0).astype(np.float32)
    live = np.arange(B)[None, None, :] < np.asarray(num_bins)[None, :, None]
    hist = np.stack([g, h, c], axis=-1) * live[..., None]
    # every feature of a slot sees the same rows: parent sums from feature 0
    # (the scan reads parents, not per-feature totals, so any exact values do)
    pg = hist[:, 0, :, 0].sum(axis=1)
    ph = hist[:, 0, :, 1].sum(axis=1)
    pc = hist[:, 0, :, 2].sum(axis=1)
    return hist.astype(np.float32), pg, ph, pc


def _scan_both(hist, pg, ph, pc, num_bins, missing, cat_ok, **over):
    kw = dict(HYPER, **over)
    args = (hist, pg, ph, pc, np.asarray(num_bins, np.int32),
            np.asarray(missing, np.int32), np.asarray(cat_ok, bool))
    jpf, jmask = jax_cat_scan(*[jnp.asarray(a) for a in args], **kw)
    tpf, tmask = per_feature_best_categorical(
        *[to_torch(a) for a in args], **kw)
    return jpf, jmask, tpf, tmask


def _assert_scan_equal(jpf, jmask, tpf, tmask):
    for name in jpf._fields:
        np.testing.assert_array_equal(to_numpy(getattr(tpf, name)),
                                      np.asarray(getattr(jpf, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(to_numpy(tmask), np.asarray(jmask))


@pytest.mark.parametrize("case", [
    dict(),                                              # defaults
    dict(min_data_per_group=30.0),                       # resets
    dict(min_data_per_group=300.0, cmax=200),            # breaks early
    dict(max_cat_to_onehot=12),                          # boundary: B=12 onehot
    dict(max_cat_to_onehot=11),                          # ... and just above
    dict(cat_smooth=1.0, max_cat_threshold=3),           # short scan
    dict(lambda_l1=0.5, min_gain_to_split=0.25, cat_l2=1.0),
    dict(min_sum_hessian_in_leaf=3.0),
])
def test_categorical_scan_bit_equal(case):
    case = dict(case)
    cmax = case.pop("cmax", 60)
    S, F, B = 6, 5, 40
    num_bins = [12, 40, 4, 3, 33]
    missing = [0, 2, 1, 0, 2]
    for seed in range(3):
        hist, pg, ph, pc = _hist(seed, S, F, B, num_bins, cmax)
        res = _scan_both(hist, pg, ph, pc, num_bins, missing, [True] * F,
                         **case)
        _assert_scan_equal(*res)
        assert np.isfinite(np.asarray(res[0].gain)).any()


def test_categorical_scan_cat_ok_gate_and_ties():
    S, F, B = 3, 4, 16
    num_bins = [16, 16, 3, 16]
    hist, pg, ph, pc = _hist(11, S, F, B, num_bins)
    # a ctr tie: categories 2 and 5 of feature 0 carry identical sums (the
    # stable sort keeps their bin order)
    hist[:, 0, 5] = hist[:, 0, 2]
    # a direction tie: feature 3 is symmetric in g (gain is even in g, so
    # the prefixes from both ends score the same); dir=+1 must win
    sym = np.array([-6, -4, -2, -1, 1, 2, 4, 6] + [0] * 8, np.float32)
    hist[:, 3, :, 0] = sym[None, :]
    hist[:, 3, :, 1] = np.where(sym != 0, 2.0, 0.0)[None, :]
    hist[:, 3, :, 2] = np.where(sym != 0, 40.0, 0.0)[None, :]
    for s in range(S):
        pg[s], ph[s], pc[s] = (hist[s, 3, :, 0].sum(), hist[s, 3, :, 1].sum(),
                               hist[s, 3, :, 2].sum())
    hist[:, :3, :, 2] = np.minimum(hist[:, :3, :, 2], 40.0)
    for cat_ok in ([True] * 4, [True, False, True, True]):
        res = _scan_both(hist, pg, ph, pc, num_bins, [0, 2, 0, 0], cat_ok,
                         min_data_per_group=10.0, min_data_in_leaf=1.0)
        _assert_scan_equal(*res)
        gain = to_numpy(res[2].gain)
        assert np.isfinite(gain[:, 3]).all()
        assert cat_ok[1] or np.isneginf(gain[:, 1]).all()
        # the winner on feature 3 is the forward prefix: the negative g side
        mask3 = to_numpy(res[3])[:, 3]
        assert mask3[:, :4].all() and not mask3[:, 4:].any()


def test_categorical_scan_at_b512():
    """The width a 300-category column gives (uint16 codes): B = 512."""
    S, F, B = 2, 2, 512
    num_bins = [301, 512]
    hist, pg, ph, pc = _hist(3, S, F, B, num_bins, cmax=30)
    res = _scan_both(hist, pg, ph, pc, num_bins, [2, 0], [True, True],
                     min_data_per_group=50.0)
    _assert_scan_equal(*res)


# ------------------------------------------------------------- grow_tree

def _cat_inputs(seed=0):
    rng = np.random.RandomState(seed)
    N = 3072                                # a multiple of chunk_rows
    X = rng.rand(N, 5)
    X[:, 0] = rng.randint(0, 25, N)                      # sorted-ctr mode
    X[:, 1] = rng.randint(0, 3, N)                       # one-hot mode
    X[rng.rand(N) < 0.1, 0] = np.nan
    X[:, 3] = np.round(X[:, 3] * 8)
    cd = lgb.dataset.construct_dataset(
        X, None, lgb.Config(max_bin=63, verbose=-1),
        categorical_features=[0, 1])
    data = binned_dataset(cd)
    is_cat = np.array([m.bin_type == JAX_CAT for m in cd.mappers])
    g = (rng.randint(-128, 128, N) / 256.0).astype(np.float32)
    g += (X[:, 0] % 3 == 0).astype(np.float32) * 0.25
    h = (rng.randint(1, 64, N) / 256.0).astype(np.float32)
    return data, is_cat, g, h


@pytest.mark.parametrize("wave_size", [1, None])
def test_grow_tree_categorical_bit_equal(wave_size):
    data, is_cat, g, h = _cat_inputs()
    X = data["X_binned"]
    N, F = X.shape
    L = 31
    B = int(max(8, -(-data["num_bins"].max() // 8) * 8))
    S = min(25, L - 1)
    cat = dict(cat_features=tuple(int(i) for i in np.nonzero(is_cat)[0]),
               cat_smooth=5.0, cat_l2=10.0, max_cat_threshold=32,
               max_cat_to_onehot=4, min_data_per_group=20.0)
    common = dict(num_leaves=L, num_features=F, num_bins_padded=B,
                  hist_slots=S, wave_size=min(wave_size or S, S),
                  max_depth=-1, lambda_l1=0.0, lambda_l2=0.0,
                  min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
                  min_gain_to_split=0.0, **cat)
    inc = np.ones(N, np.float32)
    ok = np.ones(F, bool)
    meta = (data["num_bins"], data["missing_code"], data["default_bin"])
    jt, jleaf = jax_grow(
        jnp.asarray(X), jnp.asarray(g), jnp.asarray(h), jnp.asarray(inc),
        jnp.asarray(ok), jnp.asarray(is_cat), *[jnp.asarray(m) for m in meta],
        JaxSpec(chunk_rows=512, use_categorical=True, **common))
    tt, tleaf = grow_tree(
        to_torch(X), to_torch(g), to_torch(h), to_torch(inc), to_torch(ok),
        to_torch(is_cat), *[to_torch(m) for m in meta],
        GrowerSpec(**common))
    ja, ta = tree_arrays_numpy(jt), tree_arrays_numpy(tt)
    nl = int(ja["num_leaves"])
    assert nl == int(ta["num_leaves"]) > 4
    assert ja["is_cat"][:nl - 1].any(), "no categorical split to compare"
    for name, arr in ja.items():
        if name == "num_leaves":
            continue
        rows = nl - 1 if arr.shape[0] == L else nl
        np.testing.assert_array_equal(ta[name][:rows], arr[:rows],
                                      err_msg=name)
    np.testing.assert_array_equal(to_numpy(tleaf), np.asarray(jleaf))


# ------------------------------------------------------------- end to end

def _parse(text):
    trees, cur = [], {}
    for line in text.splitlines():
        if line.startswith("Tree=") and cur:
            trees.append(cur)
            cur = {}
        for key, name in (("split_feature=", "f"), ("decision_type=", "d"),
                          ("cat_threshold=", "ct"), ("threshold=", "t"),
                          ("leaf_value=", "lv"), ("leaf_count=", "lc")):
            if line.startswith(key):
                cur[name] = line.split("=", 1)[1].split()
    if cur:
        trees.append(cur)
    return trees


_CAT_DET = {}


def _cat_det():
    if not _CAT_DET:
        data = np.loadtxt(os.path.join(HERE, "fixtures", "cat_det.train"))
        _CAT_DET["X"], _CAT_DET["y"] = data[:, 1:], data[:, 0]
    return _CAT_DET["X"], _CAT_DET["y"]


def _train_cat_det_port(**more):
    key = ("port",) + tuple(sorted(more.items()))
    if key not in _CAT_DET:
        X, y = _cat_det()
        _CAT_DET[key] = lgt.train(
            dict(BASE, objective="binary", device="cpu", **more),
            lgt.Dataset(X, label=y, categorical_feature=[2]),
            num_boost_round=5)
    return _CAT_DET[key]


def _train_cat_det_jax(**more):
    key = ("jax",) + tuple(sorted(more.items()))
    if key not in _CAT_DET:
        X, y = _cat_det()
        _CAT_DET[key] = lgb.train(
            dict(BASE, objective="binary", tpu_hist_f64=True, **more),
            lgb.Dataset(X, label=y, categorical_feature=[2]),
            num_boost_round=5)
    return _CAT_DET[key]


def test_cat_det_trees_match_jax_f64():
    """At ``cat_l2`` 0, where the two packages' leaf rules agree: all five
    trees' split features, decision types and bitsets equal, and the
    predictions."""
    X, y = _cat_det()
    ref = _train_cat_det_jax(cat_l2=0.0)
    ours = _train_cat_det_port(cat_l2=0.0)
    rt, ot = _parse(ref.model_to_string()), _parse(ours.model_to_string())
    assert len(rt) == len(ot) == 5
    n_cat = 0
    for a, b in zip(rt, ot):
        assert a["f"] == b["f"]
        assert a["d"] == b["d"]
        assert a.get("ct") == b.get("ct")
        n_cat += sum(int(d) & 1 for d in a["d"])
    assert n_cat > 0
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)


def test_cat_det_sorted_split_leaves_take_cat_l2():
    """At the default ``cat_l2`` (10), tree by tree while both packages
    grow at the same scores: every split feature, decision type and bitset
    equal, and every leaf value equal but those of the children of a
    sorted-prefix categorical split, which the port takes at ``lambda_l2 +
    cat_l2`` (LightGBM's rule; the JAX package's is ``lambda_l2``): there,
    the JAX package's value times ``H / (H + cat_l2)``, ``H`` the leaf's
    hessian sum at the scores of the trees before. The scores part after
    the first such tree."""
    X, y = _cat_det()
    ref = _train_cat_det_jax()
    ours = _train_cat_det_port()
    rt, ot = _parse(ref.model_to_string()), _parse(ours.model_to_string())
    assert len(rt) == len(ot) == 5
    jax_leaf = ref.predict(X, pred_leaf=True)
    n_cat = scaled = 0
    for t, (a, b) in enumerate(zip(rt, ot)):
        assert a["f"] == b["f"]
        assert a["d"] == b["d"]
        assert a.get("ct") == b.get("ct")
        n_cat += sum(int(d) & 1 for d in a["d"])
        raw = ref.predict(X, raw_score=True, num_iteration=t) if t \
            else np.zeros(len(y))
        p = 1.0 / (1.0 + np.exp(-raw))
        H = np.bincount(jax_leaf[:, t], weights=p * (1.0 - p))
        want = _leaf_table(ref.dump_model()["tree_info"][t]["tree_structure"])
        got = _leaf_table(ours.dump_model()["tree_info"][t]["tree_structure"])
        for leaf, (value, under_cat) in want.items():
            if under_cat:
                value *= H[leaf] / (H[leaf] + 10.0)
                scaled += 1
            np.testing.assert_allclose(got[leaf][0], value, rtol=0,
                                       atol=1e-6, err_msg=f"tree {t} leaf {leaf}")
        if scaled:
            break
    assert n_cat > 0 and scaled > 0


def _leaf_table(node, under_cat=False):
    """``{leaf index: (value, whether its parent is a categorical split)}``
    (every categorical column here has more than ``max_cat_to_onehot``
    categories: the sorted-prefix mode)."""
    if "leaf_value" in node:
        return {node["leaf_index"]: (node["leaf_value"], under_cat)}
    cat = node["decision_type"] == "=="
    return {**_leaf_table(node["left_child"], cat),
            **_leaf_table(node["right_child"], cat)}


def test_cat_det_against_reference_engine():
    """Against the reference CLI's model: every decision type, every split
    feature (70/70), every categorical bitset and leaf count, and every
    leaf value to 1e-6. The JAX package's bar (test_tree_parity.py) is
    68/70 split features: it takes the children of a sorted-prefix
    categorical split at ``lambda_l2``, where LightGBM and the port add
    ``cat_l2``, and its trees leave the reference's after the first."""
    ref = _parse(open(os.path.join(HERE, "fixtures",
                                   "ref_cat_det_model.txt")).read())
    our = _parse(_train_cat_det_port().model_to_string())
    assert len(ref) == len(our) == 5
    total = feat_ok = 0
    for rt, ot in zip(ref, our):
        assert rt["d"] == ot["d"], "decision types diverge"
        for rf, of in zip(rt["f"], ot["f"]):
            total += 1
            feat_ok += rf == of
        assert rt.get("ct") == ot.get("ct"), "a categorical bitset differs"
        assert rt["lc"] == ot["lc"], "a leaf count differs"
        np.testing.assert_allclose(np.asarray(ot["lv"], float),
                                   np.asarray(rt["lv"], float), rtol=0,
                                   atol=1e-6)
    assert feat_ok == total == 70, f"{feat_ok}/{total}"


def test_cat_model_text_crosses_both_ways():
    X, _ = _cat_det()
    ours = _train_cat_det_port()
    text = ours.model_to_string()
    in_jax = lgb.Booster(model_str=text)
    np.testing.assert_array_equal(in_jax.predict(X), ours.predict(X))
    back = lgt.Booster(model_str=in_jax.model_to_string())
    np.testing.assert_array_equal(back.predict(X), ours.predict(X))
    assert "cat_threshold=" in back.model_to_string()


def test_categorical_forest_batch_predict_takes_host_route():
    """A large batch of a categorical forest goes to the host Tree.predict
    (the JAX package's design); a numerical forest takes the device walk."""
    X, _ = _cat_det()
    ours = _train_cat_det_port()
    big = np.tile(X, (60, 1))                            # >= 1M row-trees
    host = lgt.Booster(params={"device": "cpu"},
                       model_str=ours.model_to_string())
    out = host.predict(big)
    np.testing.assert_array_equal(out[:len(X)], ours.predict(X))


def test_categorical_valid_scores_match_predict():
    """The running valid score (the binned walk through categorical masks)
    agrees with Booster.predict's host route."""
    X, y = _cat_det()
    n = len(y) // 2
    params = dict(BASE, objective="binary", device="cpu",
                  metric="binary_logloss")
    dtr = lgt.Dataset(X[:n], label=y[:n], categorical_feature=[2])
    dva = lgt.Dataset(X[n:], label=y[n:], reference=dtr)
    bst = lgt.train(params, dtr, num_boost_round=5, valid_sets=[dva],
                    keep_training_booster=True)
    vs = bst._gbdt.valid_sets[0]
    running = bst._gbdt._convert(vs.score).cpu().numpy()[0]
    np.testing.assert_allclose(running, bst.predict(X[n:]), rtol=0,
                               atol=1e-6)
