"""Batches of iterations (``tree_batch``) and the sync-free wave of
``lightgbm_tpu_torch``, on the CPU, against the JAX package.

Pins:

- ``tree_batch=K`` is bit-identical to K=1 (``tests/test_tree_batch.py``'s
  contract), over a partial last batch, with bagging and feature_fraction,
  and trains the JAX package's ``tree_batch`` trees;
- eval lands on batch boundaries with K=1's values there; GOSS, DART,
  ``learning_rates`` and ``fobj`` fall back to K=1 with a warning;
- the grower's wave: no-op waves after ``done`` leave the state as it was,
  the scatter partition is the boolean-mask one, the valid rows' routed
  leaf ids are ``leaves_from_binned``'s, and no part of an iteration reads
  a device value on the host (what a CUDA graph capture needs; the card's
  check is ``chip_smoke.py`` phase 13);
- the device fixed-point scales are bit-equal to the host formula;
- pandas input (ROADMAP C16): column names and ``category`` columns as the
  JAX package takes them.

Each JAX configuration trains once per module.
"""
import contextlib
import math
import re
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import grower as gr
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.interop import to_numpy, to_torch
from lightgbm_tpu_torch.ops.histogram import (fixed_point_scale,
                                              histogram_scales,
                                              pass_positions)
from lightgbm_tpu_torch.ops.predict import leaves_from_binned

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)


def _make_binary(n=1500, f=10, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    logit = X[:, 0] - 0.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.randn(n).astype(np.float32) * 0.2 > 0.3).astype(
        np.float32)
    return X, y


BASE = dict(objective="binary", num_leaves=15, learning_rate=0.1,
            min_data_in_leaf=5, verbose=-1, seed=5,
            bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)


def _port(X, y, tree_batch, rounds=10, **extra):
    params = dict(BASE, device="cpu", tree_batch=tree_batch, **extra)
    return lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=rounds,
                     keep_training_booster=True)


@pytest.fixture(scope="module")
def binary_data():
    return _make_binary()


@pytest.fixture(scope="module")
def port_k1(binary_data):
    return _port(*binary_data, 1)


def test_tree_batch_bit_identical(binary_data, port_k1):
    # rounds=10, K=4: two full batches and a partial one of 2
    X, y = binary_data
    b4 = _port(X, y, 4)
    assert b4._gbdt.tree_batch == 4
    assert len(port_k1.trees) == len(b4.trees) == 10
    np.testing.assert_array_equal(port_k1.predict(X), b4.predict(X))
    np.testing.assert_array_equal(port_k1.predict(X, raw_score=True),
                                  b4.predict(X, raw_score=True))
    for t1, t4 in zip(port_k1.trees, b4.trees):
        np.testing.assert_array_equal(t1.leaf_value, t4.leaf_value)
        np.testing.assert_array_equal(t1.split_feature, t4.split_feature)
    assert port_k1.model_to_string() == b4.model_to_string()


def test_tree_batch_matches_jax_tree_batch(binary_data):
    """The port's K=4 trees are the JAX package's ``tree_batch=4`` trees, at
    the sampled-path bar of ``test_torch_sampling.py`` (its split
    constraints; same splits, leaf values within 1e-6: binary g differs
    from XLA's by an ulp of ``exp``, ROADMAP C2, and histogram sums by C3)."""
    X, y = binary_data
    p = dict(BASE, tree_batch=4, max_bin=63, min_data_in_leaf=50,
             min_sum_hessian_in_leaf=5.0, tpu_wave_size=1)
    ref = lgb.train(dict(p, tpu_hist_f64=True), lgb.Dataset(X, label=y),
                    num_boost_round=10)
    ours = lgt.train(dict(p, device="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=10)
    ref._ensure_finalized()
    assert len(ref.trees) == len(ours.trees) == 10
    for a, b in zip(ref.trees, ours.trees):
        assert a.num_leaves == b.num_leaves > 1
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_array_equal(b.decision_type, a.decision_type)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)


def test_tree_batch_eight_with_eval_history(binary_data):
    # eval on batch boundaries only, with K=1's values there
    X, y = binary_data
    ev1, ev8 = {}, {}
    for k, ev in ((1, ev1), (8, ev8)):
        ds = lgt.Dataset(X, label=y)
        lgt.train(dict(BASE, device="cpu", tree_batch=k,
                       metric="binary_logloss"), ds, num_boost_round=16,
                  valid_sets=[lgt.Dataset(X[:500], label=y[:500],
                                          reference=ds)],
                  valid_names=["v"], evals_result=ev, verbose_eval=False)
    l1, l8 = ev1["v"]["binary_logloss"], ev8["v"]["binary_logloss"]
    assert len(l1) == 16 and len(l8) == 2
    assert l8[0] == l1[7] and l8[1] == l1[15]


@pytest.mark.parametrize("case", ["goss", "dart", "learning_rates", "fobj"])
def test_tree_batch_falls_back_to_one_with_a_warning(binary_data, case,
                                                     caplog):
    X, y = binary_data
    params = dict(BASE, device="cpu", tree_batch=4, verbose=0)
    kw = {}
    if case in ("goss", "dart"):
        params.update(boosting=case, bagging_freq=0, bagging_fraction=1.0)
        want = rf"tree_batch=4 is not supported with boosting={case}"
    elif case == "learning_rates":
        kw["learning_rates"] = lambda it: 0.1 * 0.9 ** it
        want = r"tree_batch=4 is not supported with before-iteration"
    else:
        def fobj(preds, ds):
            p = 1.0 / (1.0 + np.exp(-preds))
            return p - ds.get_label(), p * (1.0 - p)
        kw["fobj"] = fobj
        params["objective"] = "none"
        want = r"tree_batch=4 needs a built-in objective"
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3,
                        **kw)
    assert any(re.search(want, r.getMessage()) for r in caplog.records)
    ref = lgt.train(dict(params, tree_batch=1), lgt.Dataset(X, label=y),
                    num_boost_round=3, **kw)
    assert bst.model_to_string() == ref.model_to_string()


class _PyGraphs(gbdt_mod._IterationGraphs):
    """The runner of captured iterations with each graph replaced by the
    Python it captures, run at every replay: on the CPU it drives the
    runner's own control flow (binding, speculative waves, the count of
    replays and syncs). Every replay checks that the scores it writes are
    still the buffers bound when its graph was made, as a real graph's
    addresses are."""

    def _capture(self, key, fn):
        gb = self.gbdt
        bound = [gb.score] + [vs.score for vs in gb.valid_sets]

        class Replay:
            def replay(self):
                now = [gb.score] + [vs.score for vs in gb.valid_sets]
                assert all(a is b for a, b in zip(bound, now)), key
                fn()
        return Replay()

    def _read_flags(self, flags):
        return flags.tolist()


def _emulated_graphs(self):
    if self._stack is None or self._capture_blocker() is not None:
        return None
    if self._graphs is None:
        self._graphs = _PyGraphs(self)
    self._graphs.bind()
    return self._graphs


@pytest.mark.parametrize("case", ["sampled_valid", "multiclass",
                                  "learning_rates"])
def test_replayed_iterations_equal_eager_ones(binary_data, case,
                                              monkeypatch):
    X, y = binary_data
    params = dict(BASE, device="cpu", tree_batch=4, metric="auc")
    kw = {}
    if case == "multiclass":
        params.update(objective="multiclass", num_class=3, metric=
                      "multi_logloss")
        y = np.digitize(X[:, 0] + X[:, 1], [0.7, 1.3]).astype(np.float32)
    elif case == "learning_rates":
        # batches of one; the shrinkage is an input of every replay
        kw["learning_rates"] = lambda it: 0.2 * 0.8 ** it

    def run():
        ev = {}
        ds = lgt.Dataset(X, label=y)
        bst = lgt.train(params, ds, num_boost_round=10,
                        valid_sets=[lgt.Dataset(X[:400], label=y[:400],
                                                reference=ds)],
                        evals_result=ev, keep_training_booster=True, **kw)
        return bst, ev

    eager, ev_eager = run()
    monkeypatch.setattr(gbdt_mod.GBDT, "_graphs_for_batch", _emulated_graphs)
    replayed, ev_replayed = run()
    runner = replayed._gbdt._graphs
    K = replayed._gbdt.num_models
    assert runner is not None and runner.trees == 9 * K   # after iteration 0
    # one read of the flags per tree, more where a tree needed more waves
    # than the last one; the extra waves were no-ops
    assert runner.trees <= runner.syncs < 2 * runner.trees
    assert runner.waves_run >= runner.waves_needed
    assert runner.replays == 9 * (1 + 2 * K) + runner.waves_run
    assert replayed.model_to_string() == eager.model_to_string()
    assert ev_replayed == ev_eager
    # a rollback rebinds the scores; the next batch copies them back in
    gb = replayed._gbdt
    gb.rollback_one_iter()
    gb.train_batch(1)
    eager._gbdt.rollback_one_iter()
    eager._gbdt.train_batch(1)
    assert torch.equal(gb.score, eager._gbdt.score)
    assert torch.equal(gb.valid_sets[0].score, eager._gbdt.valid_sets[0].score)


# ------------------------------------- resume and nan_policy, replayed

@pytest.mark.parametrize("tree_batch", [1, 4])
def test_replayed_resume_equals_uninterrupted(binary_data, tree_batch,
                                              monkeypatch, tmp_path):
    """Checkpoint and resume on the replayed path: a run stopped after 6
    iterations and resumed from its snapshot at 4 writes the uninterrupted
    eager run's model text; the resumed booster's first iteration runs
    eagerly and the rest replay. ``Booster.resume`` into a booster whose
    graphs are bound copies into their buffers (a rebind would leave the
    replays reading the old ones)."""
    X, y = binary_data
    params = dict(BASE, device="cpu", tree_batch=tree_batch)
    straight = lgt.train(params, lgt.Dataset(X, label=y),
                         num_boost_round=10).model_to_string()
    monkeypatch.setattr(gbdt_mod.GBDT, "_graphs_for_batch", _emulated_graphs)
    ck = dict(params, checkpoint_dir=str(tmp_path), checkpoint_interval=4,
              checkpoint_keep_last_n=0)
    first = lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=6,
                      keep_training_booster=True)
    assert first._gbdt._graphs.trees == 5
    resumed = lgt.train(ck, lgt.Dataset(X, label=y), num_boost_round=10,
                        resume_from=str(tmp_path / "ckpt_0000000001.pkl"),
                        keep_training_booster=True)
    assert resumed._gbdt._graphs.trees == 5      # iterations 5-9
    assert resumed.model_to_string() == straight
    gb = first._gbdt
    bound = gb._graphs.score
    first.resume(str(tmp_path / "ckpt_0000000001.pkl"))
    assert gb.score is bound and gb.iter_ == 4
    gb.train_batch(6)
    assert first.model_to_string() == straight


@pytest.mark.parametrize("policy", ["skip_iter", "raise", "clip"])
def test_replayed_nan_policy_equals_eager(policy, monkeypatch):
    """``tests/test_tree_batch.py``'s infinite-weight input at
    ``tree_batch=4``: the replayed guard ends as the eager one (error,
    iteration counter, kept iterations, scores bit-equal), and on clean
    input it adds no host read to the runner's one per tree."""
    rng = np.random.RandomState(7)
    X = rng.rand(400, 10).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    w = np.ones(400, np.float32)
    w[7] = np.inf
    params = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
                  device="cpu", verbose=-1, nan_policy=policy,
                  tree_batch=4, metric="none")

    def run(weight):
        bst = lgt.Booster(params=params, train_set=lgt.Dataset(
            X, label=y, weight=weight))
        err = None
        try:
            for _ in range(4):
                bst._gbdt.train_batch(4)
        except Exception as e:                  # noqa: BLE001
            err = str(e)
        return bst._gbdt, err

    eager, err_e = run(w)
    monkeypatch.setattr(gbdt_mod.GBDT, "_graphs_for_batch", _emulated_graphs)
    replayed, err_r = run(w)
    assert replayed._graphs is not None and replayed._graphs.trees > 0
    assert err_r == err_e and (err_e is None) == (policy == "clip")
    assert replayed.iter_ == eager.iter_
    assert len(replayed.models) == len(eager.models)
    assert torch.equal(replayed.score, eager.score)
    assert torch.equal(replayed.bag_mask, eager.bag_mask)
    guarded, _ = run(None)
    params["nan_policy"] = "none"
    plain, _ = run(None)
    assert guarded._graphs.syncs == plain._graphs.syncs
    assert guarded._graphs.trees == plain._graphs.trees == 15
    assert torch.equal(guarded.score, plain.score)


# ------------------------------------------------------------ the wave

N, F, L = 2048, 6, 31
HYPER = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
             min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)


@pytest.fixture(scope="module")
def wave_inputs():
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.dataset import construct_dataset
    from lightgbm_tpu_torch.interop import binned_dataset
    rng = np.random.RandomState(0)
    X = rng.rand(N + 500, F)
    X[rng.rand(N + 500) < 0.2, 1] = np.nan
    X[:, 5] = rng.randint(0, 6, N + 500)            # categorical column
    cd = construct_dataset(X[:N], None, Config(max_bin=63, verbose=-1),
                           categorical_features=[5])
    d = binned_dataset(cd)
    valid_codes = cd.bin_raw(X[N:])
    # odd categories pull g one way: only a categorical split separates them
    g = ((X[:N, 5] % 2) * 0.5 - 0.25
         + rng.randint(-32, 32, N) / 256.0).astype(np.float32)
    h = (rng.randint(1, 64, N) / 256.0).astype(np.float32)
    return d, valid_codes, g, h


def _grower(wave_inputs, categorical=False, route=()):
    d, _, _, _ = wave_inputs
    B = int(max(8, -(-d["num_bins"].max() // 8) * 8))
    is_cat = np.zeros(F, bool)
    if categorical:
        is_cat[5] = True
    spec = gr.GrowerSpec(num_leaves=L, num_features=F, num_bins_padded=B,
                         hist_slots=25, wave_size=25, max_depth=-1,
                         cat_features=(5,) if categorical else (), **HYPER)
    meta = [to_torch(d[k]) for k in ("num_bins", "missing_code",
                                     "default_bin")]
    return gr.TreeGrower(to_torch(d["X_binned"]), to_torch(is_cat), *meta,
                         spec, route=[to_torch(r) for r in route])


def _begin(grower, wave_inputs):
    _, _, g, h = wave_inputs
    grower.begin(to_torch(g), to_torch(h), torch.ones(N),
                 torch.ones(F, dtype=torch.bool))


def _real_rows(state):
    """Every array of the state without its scratch row (leaf L, node M)."""
    out = {}
    for name, v in vars(state).items():
        if name == "tree":
            for f, a in zip(state.tree._fields, state.tree):
                if a is not None:
                    out["tree." + f] = a if a.dim() == 0 else a[:-1]
        elif name == "cand":
            for f, a in zip(state.cand._fields, state.cand):
                out["cand." + f] = a[:-1]
        elif name == "valid_leaf":
            for i, a in enumerate(v):
                out[f"valid_leaf{i}"] = a
        elif name in ("leaf_id", "perm", "flags"):
            out[name] = v
        else:
            out[name] = v[:-1]
    return {k: a.clone() for k, a in out.items()}


def test_noop_waves_leave_state_bit_identical(wave_inputs):
    grower = _grower(wave_inputs, categorical=True,
                     route=[wave_inputs[1]])
    _begin(grower, wave_inputs)
    waves = 0
    while not bool(grower.state.flags[1]):
        grower.wave()
        waves += 1
    nl, done, counted = grower.state.flags.tolist()
    assert done == 1 and counted == waves and nl > 10
    before = _real_rows(grower.state)
    for _ in range(3):
        grower.wave()
    after = _real_rows(grower.state)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k


def _partition_by_mask(state, f_row, go_left, right_row, p, q, nl_before):
    """The partition's boolean-mask form (the port before its scatter):
    ``perm[newpos[in_split]] = perm[in_split]``."""
    perm = state.perm.clone()
    k_row = torch.where(f_row >= 0, right_row - nl_before, -1)
    code_row = torch.where(f_row >= 0, 2 * k_row + (~go_left).int(), -1)
    code_pos = code_row[perm.long()]
    in_split = code_pos >= 0
    left_pos = in_split & ((code_pos & 1) == 0)
    right_pos = in_split & ((code_pos & 1) == 1)
    k_pos = (code_pos >> 1).long()
    cl = torch.cumsum(left_pos.long(), 0)
    cr = torch.cumsum(right_pos.long(), 0)
    cl0 = torch.cat([cl.new_zeros(1), cl])
    cr0 = torch.cat([cr.new_zeros(1), cr])
    start_k = state.seg_start[p].long()
    n_k = state.seg_rows[p].long()
    nL = cl0[start_k + n_k] - cl0[start_k]
    k_safe = torch.clamp(k_pos, min=0)
    base_l = torch.where(k_pos >= 0, (start_k - cl0[start_k])[k_safe], 0)
    base_r = torch.where(k_pos >= 0,
                         (start_k + nL - cr0[start_k])[k_safe], 0)
    newpos = torch.where(left_pos, cl - left_pos.long() + base_l,
                         cr - right_pos.long() + base_r)
    out = perm.clone()
    out[newpos[in_split]] = perm[in_split]
    return out


def test_scatter_partition_equals_boolean_mask_version(wave_inputs,
                                                       monkeypatch):
    seen = []
    orig = gr._partition

    def spy(state, *a):
        seen.append(_partition_by_mask(state, *a))
        orig(state, *a)
        assert torch.equal(state.perm, seen[-1])

    monkeypatch.setattr(gr, "_partition", spy)
    grower = _grower(wave_inputs)
    _begin(grower, wave_inputs)
    while not bool(grower.state.flags[1]):
        grower.wave()
    assert len(seen) >= 2
    perm = to_numpy(grower.state.perm)
    assert sorted(perm.tolist()) == list(range(N))


@pytest.mark.parametrize("categorical", [False, True])
def test_valid_leaf_ids_from_routing_equal_leaves_from_binned(
        wave_inputs, categorical):
    d, valid_codes, _, _ = wave_inputs
    grower = _grower(wave_inputs, categorical, route=[valid_codes])
    _begin(grower, wave_inputs)
    while not bool(grower.state.flags[1]):
        grower.wave()
    tree, _ = grower.finish()
    assert int(tree.num_leaves) > 10
    if categorical:
        assert bool(tree.is_cat.any())
    meta = [to_torch(d[k]) for k in ("num_bins", "missing_code",
                                     "default_bin")]
    walked = leaves_from_binned(tree, to_torch(valid_codes), *meta,
                                has_cat=categorical)
    np.testing.assert_array_equal(to_numpy(grower.state.valid_leaf[0]),
                                  to_numpy(walked))


@pytest.mark.parametrize("n", [1, 2, 3, 2 ** 21])
def test_device_histogram_scales_bit_equal_host_formula(n):
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    edges = [0.0, float(tiny), float(tiny) * 3, 1e-30, 0.5, 1.0, 3.0,
             123.5, 1e30, float(np.finfo(np.float32).max), math.inf,
             math.nan]
    for mg in edges:
        for mh in (0.0, float(tiny), 1.0, math.inf, math.nan):
            g = torch.zeros(n, dtype=torch.float32)
            h = torch.zeros(n, dtype=torch.float32)
            g[n // 2] = -mg if mg == mg else mg
            h[0] = mh
            got = histogram_scales(g, h)
            assert got.dtype == torch.float64
            want = (fixed_point_scale(float(np.float32(mg)), n),
                    fixed_point_scale(float(np.float32(mh)), n))
            assert tuple(got.tolist()) == want, (mg, mh, n)


# ------------------------------------------- no host read in an iteration

# ops that read a tensor on the host or size their output from its data
# (a sync on the card), and ``lift_fresh``: a tensor made from host data
# (``torch.tensor``, or ``t[i] = 0.5``), a host-to-device copy on the card,
# which a capture refuses
_HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique", "_unique2", "unique_consecutive", "bincount",
               "item", "is_nonzero", "equal", "lift_fresh"}


class _HostReadCheck(TorchDispatchMode):
    """Records every op that reads a tensor on the host or sizes its
    output from tensor data (a sync on the card, and a capture error),
    boolean-mask indexing included. The plain histogram, the CPU stand-in
    for the kernel, is left out (``paused``)."""

    def __init__(self):
        super().__init__()
        self.hits = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            name = func._schema.name.split("::")[-1]
            if name in _HOST_READS:
                port = [f for f in traceback.extract_stack()
                        if "lightgbm_tpu_torch" in f.filename]
                self.hits.append(f"{name} at {port[-1].filename}:"
                                 f"{port[-1].lineno}" if port else name)
            if name.startswith(("index", "_index_put")) and len(args) > 1 \
                    and isinstance(args[1], (list, tuple)):
                if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in args[1]):
                    self.hits.append(name + "[bool mask]")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    check = _HostReadCheck()
    real_hist = gr.build_histograms_cuda

    def hist(*a, **k):
        check.paused += 1
        try:
            return real_hist(*a, **k)
        finally:
            check.paused -= 1

    monkeypatch.setattr(gr, "build_histograms_cuda", hist)
    with check:
        yield check


def _booster_case(case):
    rng = np.random.RandomState(11)
    n = 1200
    X = rng.rand(n, 8)
    X[rng.rand(n) < 0.1, 2] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.1 > 0.8).astype(float)
    p = dict(num_leaves=15, min_data_in_leaf=5, device="cpu", verbose=-1)
    kw = {}
    if case == "binary":
        p["objective"] = "binary"
    elif case == "sampled":
        p.update(objective="binary", bagging_fraction=0.7, bagging_freq=2,
                 feature_fraction=0.8)
        kw["valid"] = X[:300], y[:300]
    elif case == "multiclass":
        p.update(objective="multiclass", num_class=3)
        y = np.digitize(X[:, 0] + X[:, 1], [0.7, 1.3]).astype(float)
    elif case == "categorical":
        p["objective"] = "binary"
        X[:, 7] = rng.randint(0, 9, n)
        kw["categorical_feature"] = [7]
    elif case == "efb":
        p.update(objective="regression", enable_bundle="true")
        flags = np.zeros((n, 12))
        flags[np.arange(n), rng.randint(0, 12, n)] = 1.0
        X = np.hstack([X[:, :3], flags])
        y = X[:, 0] + flags[:, :4].sum(1)
    elif case == "lambdarank":
        p["objective"] = "lambdarank"
        y = rng.randint(0, 4, n).astype(float)
        kw["group"] = [40] * (n // 40)
    elif case == "rf":
        p.update(objective="binary", boosting="rf", bagging_fraction=0.6,
                 bagging_freq=1)
    elif case == "no_row_compact":
        # positions derived on the device by a sort (ops/histogram.py)
        p.update(objective="binary", tpu_row_compact=False)
    elif case == "nan_skip_iter":
        # the guard's flags and the gate of scores, valid scores and mask
        p.update(objective="binary", nan_policy="skip_iter",
                 bagging_fraction=0.7, bagging_freq=1)
        kw["valid"] = X[:300], y[:300]
    elif case == "nan_clip":
        p.update(objective="regression", nan_policy="clip")
    return X, y, p, kw


@pytest.mark.parametrize("case", ["binary", "sampled", "multiclass",
                                  "categorical", "efb", "lambdarank", "rf",
                                  "no_row_compact", "nan_skip_iter",
                                  "nan_clip"])
def test_iteration_parts_read_nothing_on_the_host(case, monkeypatch):
    X, y, params, kw = _booster_case(case)
    ds = lgt.Dataset(X, label=y, group=kw.get("group"),
                     categorical_feature=kw.get("categorical_feature",
                                                "auto"))
    bst = lgt.Booster(params=params, train_set=ds)
    if "valid" in kw:
        bst.add_valid(lgt.Dataset(*kw["valid"][:1], label=kw["valid"][1],
                                  reference=ds), "v")
    gbdt = bst._gbdt
    if case == "efb":
        assert gbdt.bundle is not None
    gbdt.train_one_iter()                 # the eager warm-up iteration
    tab_i, tab_f = gbdt._batch_inputs([1], gbdt._step_shrinkage())
    gbdt._in_i.copy_(tab_i[0])
    gbdt._in_f.copy_(tab_f[0])
    with _no_host_reads(monkeypatch) as check:
        gbdt._part_start(1)
        for k in range(gbdt.num_models):
            gbdt._part_tree(k)
            for _ in range(4):
                gbdt._grower.wave()
            gbdt._part_tree_end(k)
        if case == "no_row_compact":
            # the card derives the pass's positions (the CPU's plain
            # version takes the rows directly)
            leaves = gbdt.spec.num_leaves + 1
            slot_of_leaf = (torch.arange(leaves) % 3 - 1).to(torch.int32)
            pass_positions(gbdt._grower.state.leaf_id, slot_of_leaf, 25)
    assert check.hits == []


# ------------------------------------------------ pandas input (C16)

pd = pytest.importorskip("pandas")


def _both(df, y, params, rounds):
    ref = lgb.train(dict(params, verbose=-1, tpu_hist_f64=True),
                    lgb.Dataset(df, label=y), num_boost_round=rounds)
    ours = lgt.train(dict(params, verbose=-1, device="cpu"),
                     lgt.Dataset(df, label=y), num_boost_round=rounds)
    return ref, ours


def _same_frame_handling(ref, ours):
    """The model text's frame-derived parts are the JAX package's: the
    header (feature names, infos) and the ``pandas_categorical`` line. The
    trees are held by their predictions: these separable frames leave
    splits of gain ~1e-6 (zero in exact arithmetic) that the two packages'
    histogram sums decide differently (ROADMAP C3)."""
    a, b = ref.model_to_string(), ours.model_to_string()
    assert b.split("Tree=")[0] == a.split("Tree=")[0]
    pc = [ln for ln in a.splitlines() if ln.startswith("pandas_categorical")]
    assert len(pc) == 1 and pc[0] in b.splitlines()


CATS = ["low", "mid", "high", "ultra"]


def _roundtrip_frame():
    rng = np.random.RandomState(0)
    n = 400
    df = pd.DataFrame({
        "num": rng.rand(n),
        "cat": pd.Categorical(rng.choice(CATS, n), categories=CATS),
    })
    y = ((df["cat"].cat.codes >= 2) ^ (df["num"] > 0.7)).astype(float)
    return df, y, {"objective": "binary", "num_leaves": 7,
                   "min_data_in_leaf": 5}, 10


def _unseen_frame():
    rng = np.random.RandomState(1)
    df = pd.DataFrame({
        "num": rng.rand(200),
        "cat": pd.Categorical(rng.choice(["a", "b"], 200)),
    })
    y = (df["num"] > 0.5).astype(float)
    return df, y, {"objective": "binary", "num_leaves": 4,
                   "min_data_in_leaf": 5}, 3


def test_pandas_categorical_roundtrip(tmp_path):
    cats = CATS
    df, y, params, rounds = _roundtrip_frame()
    ref, bst = _both(df, y, params, rounds)
    assert bst.pandas_categorical == ref.pandas_categorical == [cats]
    assert bst.feature_name() == ["num", "cat"]
    _same_frame_handling(ref, bst)
    p0 = bst.predict(df)
    np.testing.assert_allclose(p0, ref.predict(df), rtol=0, atol=1e-5)
    # shuffled category order in the predict frame must not change results
    df2 = df.copy()
    df2["cat"] = pd.Categorical(df["cat"].astype(str),
                                categories=list(reversed(cats)))
    np.testing.assert_allclose(bst.predict(df2), p0, atol=1e-12)
    # model file round-trip keeps the category mapping
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    bst2 = lgt.Booster(model_file=path)
    assert bst2.pandas_categorical == [cats]
    np.testing.assert_allclose(bst2.predict(df2), p0, atol=1e-12)
    assert np.mean((p0 > 0.5) == y.values.astype(bool)) > 0.8


def test_pandas_unseen_category_is_missing():
    df, y, params, rounds = _unseen_frame()
    ref, bst = _both(df, y, params, rounds)
    _same_frame_handling(ref, bst)
    df_new = pd.DataFrame({
        "num": [0.2, 0.9],
        "cat": pd.Categorical(["c", "a"], categories=["a", "b", "c"]),
    })
    p = bst.predict(df_new)              # unseen 'c' -> missing, no crash
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, ref.predict(df_new), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bst.predict(df), ref.predict(df), rtol=0,
                               atol=1e-5)


def _quarter_fobj(preds, ds):
    """Gradients on a 1/4 grid, unit hessians: every sum is exact in f32
    and f64 alike, so no split is decided by rounding."""
    y = np.asarray(ds.get_label())
    g = np.clip(np.round((np.asarray(preds) - y) * 4) / 4.0, -2.0, 2.0)
    return g, np.ones_like(g)


@pytest.mark.parametrize("frame", [_roundtrip_frame, _unseen_frame],
                         ids=["categorical_roundtrip", "unseen_category"])
def test_pandas_model_text_equals_jax_on_exact_arithmetic(frame):
    """The two C16 frames on exact-arithmetic gradients (as the EFB trio
    test does, ROADMAP C14): the whole model text is the JAX package's,
    byte for byte, and so are the predictions."""
    df, y, params, rounds = frame()
    ref = lgb.train(dict(params, verbose=-1), lgb.Dataset(df, label=y),
                    num_boost_round=rounds, fobj=_quarter_fobj)
    ours = lgt.train(dict(params, verbose=-1, device="cpu"),
                     lgt.Dataset(df, label=y), num_boost_round=rounds,
                     fobj=_quarter_fobj)
    text = ours.model_to_string()
    assert all(t.num_leaves > 1 for t in ours.trees)
    assert "pandas_categorical:[[" in text
    if frame is _roundtrip_frame:        # the category column is split on
        assert all((np.asarray(t.decision_type) & 1).any()
                   for t in ours.trees)
    assert text == ref.model_to_string()
    np.testing.assert_array_equal(ours.predict(df), ref.predict(df))
