"""The plain references agree with lightgbm_tpu_torch on the CPU at a tiny
size: the trees the port grows pass the reference's judgement, the
reference's own trees judge clean, and the reference's walk of a forest
gives the port's predictions."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from benchmark.harness import data as datagen
from benchmark.harness import forest as forestgen
from benchmark.harness import manifest
from benchmark.reference import gbdt as ref
from benchmark.reference import modeltext, walk

HIGGS = dict(manifest.config("higgs")["data"], train_rows=6000,
             valid_rows=10)
MSLR = dict(manifest.config("mslr")["data"], train_rows=6000, valid_rows=40,
            train_queries=50, valid_queries=1)


def _params(objective, wave):
    p = {"objective": objective, "num_leaves": 63, "learning_rate": 0.1,
         "max_bin": 255, "min_data_in_leaf": 0,
         "min_sum_hessian_in_leaf": 1 if objective == "lambdarank" else 5,
         "tpu_wave_size": wave, "tpu_hist_slots": 25, "device": "cpu",
         "verbose": -1}
    return p


@pytest.mark.parametrize("objective,wave", [("binary", 25), ("binary", 1),
                                            ("lambdarank", 25)])
def test_port_trees_pass_the_reference(objective, wave):
    spec = HIGGS if objective == "binary" else MSLR
    d = datagen.training_data(spec, 3, torch.device("cpu"))
    params = _params(objective, wave)
    X, y = d["X"], d["y"]
    bst = lgt.train(params, lgt.Dataset(X.numpy(), label=y.numpy(),
                                        group=d.get("group")),
                    num_boost_round=4)
    trees = modeltext.parse(bst.model_to_string())["trees"]
    raw = bst.predict(X.numpy(), raw_score=True)
    assert np.abs(walk.raw_scores(trees, X).numpy() - raw).max() < 1e-9
    bins = ref.Bins(X)
    rule = ref.SplitRule(params)
    score = walk.raw_scores(trees[:1], X)
    for t in range(1, 4):
        g, h = ref.gradients(objective, score, y, d.get("group"), params)
        v = ref.judge(trees[t], bins, g, h, rule, 0.1, ref.wave_size(params))
        assert v["count_mismatch"] == 0
        assert v["split_gap"] < 1e-6
        assert v["leaf_gap"] < 1e-4
        own = ref.grow(bins, g, h, rule, 63, 0.1, ref.wave_size(params))
        mine = ref.judge(own, bins, g, h, rule, 0.1, ref.wave_size(params))
        assert mine["split_gap"] < 1e-12
        assert mine["leaf_gap"] == 0.0 and mine["count_mismatch"] == 0
        score += torch.as_tensor(trees[t]["leaf_value"])[
            walk.leaves(trees[t], X)]


def test_lambdarank_gradients_match_the_port():
    d = datagen.training_data(MSLR, 4, torch.device("cpu"))
    params = _params("lambdarank", 25)
    gb = lgt.Booster(params=params, train_set=lgt.Dataset(
        d["X"].numpy(), label=d["y"].numpy(), group=d["group"]))._gbdt
    score = torch.randn(6000, generator=torch.Generator().manual_seed(1))
    g, h = gb.objective.gradients(score[None, :].float(), gb.label, None)
    rg, rh = ref.lambdarank_gradients(score.float(), d["y"], d["group"])
    assert torch.allclose(g.reshape(-1).double(), rg, rtol=1e-4, atol=1e-6)
    assert torch.allclose(h.reshape(-1).double(), rh, rtol=1e-4, atol=1e-6)


def test_forest_walk_matches_the_port():
    """A ten-tree forest the benchmark makes, as model text: the reference
    walk and ``Booster.predict`` (device walk and host walk) agree."""
    gen = datagen.generator(9, torch.device("cpu"))
    rows = datagen.rows(HIGGS, 5000, gen, torch.device("cpu"))[0]
    text, trees = forestgen.make({"num_trees": 10, "num_leaves": 255,
                                  "shape_seed": 3, "smallest_share": 0.1,
                                  "leaf_scale": 0.05}, [0, 22], rows, gen,
                                 5000)
    bst = lgt.Booster(params={"device": "cpu", "verbose": -1},
                      model_str=text)
    X = rows.double().numpy()
    ref_raw = walk.raw_scores(trees, rows).numpy()
    for host in (False, True):
        got = bst.predict(X, raw_score=True, force_host_predict=host)
        assert np.abs(got - ref_raw).max() < 1e-12
    assert modeltext.depth_of(trees[0]) >= 10
