"""The ``expo`` configuration on the CPU at a tiny size: its data keeps the
shape the configuration states, the port's bin mappers give the
reference's splittable categories bins of their own, the reference's
categorical search gives the hand-worked answers, the port trains the
rows with categorical splits and the reference judges them; every planted
fault, the control and a flipped bit of a bitset read above the sound
program, and a program without the categorical gauges cannot run the
cell."""
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from benchmark.harness import data as datagen
from benchmark.harness import manifest
from benchmark.reference import categorical as cat
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_benchmark_faults import (
    _answer_altered, _half_rows, _metric_on_half_rows, _state_unchanged,
    _valid_stale)

CELL = "expo.train"
SEED = 3000000019
# below 200,000 rows the port's bin finding counts every row, as the
# reference does; small trees in waves of 3 keep the plain scan quick
TINY = {"data": {"train_rows": 150000, "valid_rows": 20000},
        "params": {"num_leaves": 15, "min_sum_hessian_in_leaf": 5,
                   "tree_batch": 2, "metric_freq": 2, "tpu_wave_size": 3,
                   "tpu_hist_slots": 3}}
# past 200,000 rows the port counts a 200,000-row sample
SAMPLED = {"train_rows": 400000, "valid_rows": 1000}


@pytest.fixture(scope="module")
def cfg():
    return manifest.config("expo")


@pytest.fixture(scope="module")
def tiny(cfg):
    return datagen.training_data(cfg["data"], SEED, torch.device("cpu"),
                                 TINY["data"])


def _run(seed=5, control=False):
    from benchmark.harness.report import run_cell
    return run_cell(CELL, seed, 0.5, False, torch.device("cpu"),
                    time.perf_counter(), control=control, root=ROOT,
                    overrides=TINY)


def test_columns_keep_their_shape(cfg, tiny):
    spec = cfg["data"]
    X, y = tiny["X"], tiny["y"]
    for col, k in zip(spec["categorical"], spec["cardinality"]):
        ids = torch.unique(X[:, col])
        assert torch.equal(ids, torch.arange(1, k + 1, dtype=X.dtype)), col
    for col in range(X.shape[1]):
        if col not in spec["categorical"]:
            assert len(torch.unique(X[:, col])) <= spec["levels"]
    assert 0.0 <= float(X[:, 6].min()) and float(X[:, 6].max()) <= 2359
    for labels in (y, tiny["yv"]):
        assert abs(float(labels.double().mean()) - 0.19) < 0.01
    head = int(spec["head"])
    for col in spec["airports"]:
        counts = torch.bincount(X[:, col].long()).double()[1:]
        ranked = torch.sort(counts, descending=True).values
        # the tail's share, and every head airport above every tail one
        assert abs(float(ranked[head:].sum()) / X.shape[0]
                   - spec["tail_share"]) < 0.0006
        assert float(ranked[head - 1]) > 4 * float(ranked[head])


@pytest.mark.parametrize("seed", [11, 2147483659, 4100000037])
def test_the_port_gives_the_splittable_categories_bins_of_their_own(cfg,
                                                                    seed):
    """On 400,000 rows, whose bins the port finds from a 200,000-row
    sample: the same splittable categories as the reference's full counts,
    a last bin holding the leftovers, and the scan's ``used_bin`` leaving
    it out."""
    spec = cfg["data"]
    d = datagen.training_data(spec, seed, torch.device("cpu"), SAMPLED)
    X = d["X"]
    params = dict(cfg["params"], device="cpu")
    ds = lgt.Dataset(X.numpy(), label=d["y"].numpy(),
                     categorical_feature=spec["categorical"])
    ds.construct(lgt.Config.from_params(params))
    cd = ds.constructed
    meta = cd.feature_meta_arrays()
    bins = cat.Bins(X, spec["categorical"], max_bin=params["max_bin"])
    for col in spec["categorical"]:
        mapper = cd.mappers[col]
        used = int(meta["num_bins"][col]) - int(meta["missing_code"][col]
                                                != 0)
        assert used == bins.used_bin(col), col
        assert mapper.num_bin == bins.num_bin[col], col
        assert sorted(mapper.bin_2_categorical[:used]) == \
            sorted(bins.category[col].tolist()), col
        shared = bins.shared[col]
        if col in spec["airports"]:
            assert used == spec["head"] and len(shared) == 300 - used
            codes = mapper.value_to_bin(shared.astype(np.float64))
            assert (codes == mapper.num_bin - 1).all(), col
        else:
            assert shared is None and used == mapper.num_bin, col


def _rule(**over):
    return cat.SplitRule(dict(dict(
        min_sum_hessian_in_leaf=1.0, min_data_in_leaf=1, lambda_l2=0.0,
        cat_l2=10.0, cat_smooth=10.0, max_cat_threshold=32,
        max_cat_to_onehot=4, min_data_per_group=100), **over))


def _search(g, rule, c=None, h=10.0):
    g = np.asarray(g, np.float64)
    c = np.full(len(g), 200.0) if c is None else np.asarray(c, np.float64)
    hist = np.stack([g, np.full(len(g), h), c], axis=1)
    tot = tuple(float(v) for v in hist.sum(axis=0))
    return cat.categorical_search(hist, tot, rule, len(g), len(g))


@pytest.mark.parametrize("case", [
    # one-hot (3 bins <= 4): category 0 alone, 100/10 + 100/20, at l2 0
    dict(g=[-10, 2, 8], left=[0], gain=15.0, l2=0.0),
    # sorted, forward: the smallest ratio alone, 900/20 + 900/60 at l2 10
    dict(g=[-30, 5, 5, 5, 5, 10], left=[0], gain=60.0, l2=10.0),
    # sorted, reverse: the largest ratio alone
    dict(g=[30, -5, -5, -5, -5, -10], left=[0], gain=60.0, l2=10.0),
    # two categories: 1600/30 + 1600/50
    dict(g=[-20, -20, 10, 10, 10, 10], left=[0, 1], gain=1600 / 30 + 32.0,
         l2=10.0),
    # max_cat_threshold 1 caps it at one: 400/20 + 400/60
    dict(g=[-20, -20, 10, 10, 10, 10], left=[0], gain=20.0 + 400 / 60,
         l2=10.0, over=dict(max_cat_threshold=1)),
    # category 0 holds 60 rows, under min_data_per_group: the first prefix
    # evaluated is {0, 1}, 625/30 + 625/50
    dict(g=[-30, 5, 5, 5, 5, 10], c=[60, 200, 200, 200, 200, 200],
         left=[0, 1], gain=625 / 30 + 12.5, l2=10.0),
])
def test_the_categorical_search_gives_the_hand_worked_answer(case):
    gain, left, l2 = _search(case["g"], _rule(**case.get("over", {})),
                             case.get("c"))
    assert sorted(left.tolist()) == case["left"]
    assert gain == pytest.approx(case["gain"], rel=1e-12)
    assert l2 == case["l2"]


def test_the_port_trains_categorical_splits_and_the_reference_judges_it():
    res = _run()
    assert res["correct"] is True, res["checks"]
    detail = res["detail"]["judge_detail"]
    # the window's trees (as many as its half second holds, up to 4)
    assert detail and all(d["cat_nodes"] >= 1 for d in detail)


@pytest.mark.parametrize("fault,number", [
    (_state_unchanged, None), (_half_rows, None), (_answer_altered, None),
    (_valid_stale, "valid_score_gap"),
    (_metric_on_half_rows, "valid_metric_gap")])
def test_a_training_fault_is_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed
    if number is not None:
        assert number in failed


def test_a_flipped_bitset_bit_is_not_correct(monkeypatch):
    """The lowest category of the first bitset of the model's last tree
    taken out of its left set in the model text, after training: that
    tree (always among the checked) routes that category's rows right."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    orig = GBDT.finalize_model
    flipped = []

    def flip(self):
        forest = orig(self)
        if not forest or forest[-1][0].cat_threshold is None:
            return forest
        words = forest[-1][0].cat_threshold
        w = int(np.nonzero(words)[0][0])
        low = int(words[w]) & -int(words[w])
        words[w] = np.uint32(int(words[w]) ^ low)
        flipped.append(w * 32 + low.bit_length() - 1)
        return forest
    monkeypatch.setattr(GBDT, "finalize_model", flip)
    res = _run()
    assert flipped
    assert res["correct"] is False
    assert res["checks"]["count_mismatch"]["value"] > 0


def test_the_control_reads_above_the_sound_program():
    res = _run(control=True)
    assert res["correct"] is True
    readings = res["control"]["control_bf16"]
    assert any(readings[k] > 10 * max(c["value"], 1e-300)
               for k, c in res["checks"].items() if k != "count_mismatch")


def test_a_program_without_the_categorical_gauges_cannot_run_it(monkeypatch):
    from lightgbm_tpu_torch import observability as obs
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    obs.reset_for_tests()
    monkeypatch.setattr(GBDT, "_publish_categorical_gauges",
                        lambda self, reg, num_bins: None)
    try:
        with pytest.raises(RuntimeError, match="categorical"):
            _run()
    finally:
        obs.reset_for_tests()


def test_categorical_children_at_lambda_l2_alone_are_not_correct(
        monkeypatch):
    """The leaf rule the port had before it took LightGBM's: the children
    of a sorted-prefix categorical split valued at ``lambda_l2`` (here 0),
    not ``lambda_l2 + cat_l2``."""
    from lightgbm_tpu_torch import grower
    orig = grower.leaf_output
    monkeypatch.setattr(grower, "leaf_output",
                        lambda g, h, l1, l2: orig(g, h, l1, 0.0))
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["leaf_gap"]["value"] \
        > res["checks"]["leaf_gap"]["limit"]


def test_a_tie_of_ratios_at_the_cap_lets_either_category_go_left():
    """Categories 0 (large) and 1 (small) have ratios 1e-7 apart at the
    ``max_cat_threshold`` cap of 1: the search takes category 0 alone, and
    the judge's best allowed gain (``margin`` > 0) is the least over both
    orders, the best of the order that puts category 1 first."""
    g = np.array([-30.000003, -20.0, 25.0, 25.0, 0.0, 0.0])
    h = np.array([20.0, 10.0, 20.0, 20.0, 1.0, 1.0])
    c = np.array([200.0, 200.0, 200.0, 200.0, 5.0, 5.0])
    hist = np.stack([g, h, c], axis=1)
    tot = tuple(float(v) for v in hist.sum(axis=0))
    rule = _rule(max_cat_threshold=1)
    G, H = tot[0], tot[1]

    def gain(left):
        gl, hl = g[left].sum(), h[left].sum()
        return (cat._term(gl, hl, 0, 10) + cat._term(G - gl, H - hl, 0, 10)
                - cat._term(G, H, 0, 0))
    best, left, _ = cat.categorical_search(hist, tot, rule, 6, 6)
    assert left.tolist() == [0] and best == pytest.approx(gain([0]))
    # category 1 first: {1} forward, {2} (or {3}) from the other end
    judged, left, _ = cat.categorical_search(hist, tot, rule, 6, 6,
                                             margin=cat.HESSIAN_MARGIN)
    assert judged == pytest.approx(max(gain([1]), gain([2])))
    assert judged < best
