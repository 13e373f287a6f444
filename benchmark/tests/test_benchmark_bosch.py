"""The ``bosch`` configuration on the CPU at a tiny size: its data keeps the
shape the configuration states, the port bins its CSR rows as the
reference assumes, trains them in bundle space, and the reference judges
the trees; every planted fault, and a planted fault of the bundles, turns
``correct`` false."""
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from benchmark.harness import data as datagen
from benchmark.harness import manifest
from benchmark.reference import gbdt as ref
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_benchmark_faults import (
    _answer_altered, _half_rows, _metric_on_half_rows, _state_unchanged,
    _valid_stale)

CELL = "bosch.train"
SEED = 2147483659
# enough rows that each value of the least visited station's features is
# drawn some 18 times (LightGBM's bin finding merges a value of fewer than
# min_data_in_bin = 3); small trees, so that the plain bundle-space scan
# stays quick on the CPU
TINY = {"data": {"train_rows": 40000, "valid_rows": 5000},
        "params": {"num_leaves": 7, "min_sum_hessian_in_leaf": 5,
                   "tree_batch": 2, "metric_freq": 2, "tpu_wave_size": 3,
                   "tpu_hist_slots": 3}}


@pytest.fixture(scope="module")
def cfg():
    return manifest.config("bosch")


@pytest.fixture(scope="module")
def gen_mod(cfg):
    return manifest.generator(cfg["data"]["generator"])


@pytest.fixture(scope="module")
def tiny(cfg):
    return datagen.training_data(cfg["data"], SEED, torch.device("cpu"),
                                 TINY["data"])


@pytest.fixture
def fresh_obs():
    from lightgbm_tpu_torch import observability as obs
    obs.reset_for_tests()
    yield obs
    obs.reset_for_tests()


def _run(overrides=TINY, seed=5):
    from benchmark.harness.report import run_cell
    return run_cell(CELL, seed, 0.5, False, torch.device("cpu"),
                    time.perf_counter(), root=ROOT, overrides=overrides)


def test_every_station_is_whole_and_alternatives_exclusive(cfg, gen_mod,
                                                           tiny):
    """A station's features are all present or all absent in a row; a row
    visits at most one alternative of a fork, and exactly one line of the
    lines it chooses among."""
    spec = cfg["data"]
    present = tiny["X"] != 0
    sts = gen_mod.stations(spec)
    visit = torch.stack([present[:, st["col"]] for st in sts], dim=1)
    for st in sts:
        cols = present[:, st["col"]:st["col"] + st["width"]]
        assert torch.equal(cols.all(dim=1), cols.any(dim=1)), st["s"]
    forks = {}
    for st in sts:
        forks.setdefault(st["fork"], []).append(st["s"])
    for members in forks.values():
        assert int(visit[:, members].sum(dim=1).max()) <= 1
    on_line = {}
    for st in sts:
        on_line[st["line"]] = on_line.get(st["line"], False) \
            | visit[:, st["s"]]
    chosen = [ln["name"] for ln in spec["lines"] if "choice" in ln]
    taken = torch.stack([on_line[n] for n in chosen], dim=1).sum(dim=1)
    # a row on a line visits a station of each of its forks, so the
    # stations show the one line each row chose
    assert int(taken.min()) == 1 and int(taken.max()) == 1


def _present_share(spec):
    """The share of cells a row holds, in expectation over routes."""
    total = cells = 0.0
    for line in spec["lines"]:
        p = float(line.get("choice", line.get("visit")))
        for alternatives in line["forks"]:
            total += sum(alternatives)
            cells += p * sum(alternatives) / len(alternatives)
    return cells / total


def test_absent_share_and_positive_rate_are_in_their_bands(cfg, gen_mod,
                                                           tiny):
    spec = cfg["data"]
    assert abs(_present_share(spec) - 0.19) < 0.01
    absent = float((tiny["X"] == 0).double().mean())
    assert 0.80 <= absent <= 0.82
    for y in (tiny["y"], tiny["yv"]):
        assert abs(float(y.double().mean()) - 0.0058) <= 0.0005
        assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    # the planted logit: a positive's signal feature is above a negative's
    col = gen_mod.column(spec, *spec["label"]["values"][0][:2])
    x, y = tiny["X"][:, col], tiny["y"]
    assert float(x[y == 1].mean()) > float(x[y == 0].mean())


def test_the_port_keeps_each_value_and_zero_in_a_bin_of_its_own(cfg, tiny):
    """The port's mappers, found from the CSR rows at ``max_bin`` 63, give
    every value the reference sees (zero among them) a bin of its own."""
    to_csr = manifest.driver("train_loop_csr").to_csr
    X = tiny["X"]
    params = dict(cfg["params"], device="cpu")
    ds = lgt.Dataset(to_csr(X), label=tiny["y"].numpy())
    ds.construct(lgt.Config.from_params(params))
    mappers = ds.constructed.mappers
    assert len(mappers) == X.shape[1]
    bins = ref.Bins(X)
    levels = int(cfg["data"]["levels"])
    for f, mapper in enumerate(mappers):
        values = bins.levels[f].numpy()
        assert len(values) == levels + 1 and 0.0 in values, f
        codes = mapper.value_to_bin(values)
        assert len(np.unique(codes)) == len(values), f
        assert mapper.num_bin == len(values), f
        assert mapper.default_bin == int(codes[values == 0.0][0]), f


def test_to_csr_keeps_every_nonzero_value(tiny):
    to_csr = manifest.driver("train_loop_csr").to_csr
    X = tiny["Xv"]
    csr = to_csr(X)
    assert csr.nnz == int((X != 0).sum())
    assert np.array_equal(csr.toarray(), X.numpy())


def test_the_port_trains_bundled_and_the_reference_judges_it(fresh_obs):
    res = _run()
    gauges = fresh_obs.get_registry().snapshot()["gauges"]
    assert gauges["efb.features"] == 968
    assert gauges["efb.bundles"] <= 968 // 2
    assert gauges["efb.bundled_features"] > 968 // 2
    assert res["correct"] is True, res["checks"]


def test_bundled_and_unbundled_trees_pass_the_same_judge(fresh_obs):
    overrides = {"data": TINY["data"],
                 "params": dict(TINY["params"], enable_bundle="false")}
    res = _run(overrides)
    snap = fresh_obs.get_registry().snapshot()
    assert "efb.bundles" not in snap["gauges"]
    assert res["correct"] is True, res["checks"]


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


def test_a_bundle_fault_is_not_correct(cfg, gen_mod, monkeypatch):
    """The bin offset of one bundled feature (the planted logit's first)
    shifted by one in the decode tables, after its codes were written: its
    splits and its rows' routes go wrong."""
    from lightgbm_tpu_torch import efb
    col = gen_mod.column(cfg["data"], *cfg["data"]["label"]["values"][0][:2])
    orig = efb.plan_bundles
    shifted = {}

    def plan_with_offset_shifted(*args, **kwargs):
        plan = orig(*args, **kwargs)
        if plan is not None:
            shifted["members"] = len(plan.groups[int(plan.col[col])])
            plan.off[col] += 1
        return plan
    monkeypatch.setattr(efb, "plan_bundles", plan_with_offset_shifted)
    res = _run()
    assert shifted["members"] > 1
    assert res["correct"] is False
