"""The roofline counts against small cases worked by hand."""
import numpy as np
import pytest

from benchmark.reference import gbdt as ref
from benchmark.roofline import counts

# a tree of three leaves: root (100 rows) -> leaf 0 (30) and node 1 (70);
# node 1 -> leaf 1 (50) and leaf 2 (20)
TREE = {"num_leaves": 3, "split_feature": np.array([0, 1]),
        "left_child": np.array([~0, ~1]), "right_child": np.array([1, ~2]),
        "internal_count": np.array([100, 70]),
        "leaf_count": np.array([30, 50, 20])}


def test_histogram_pass_cost_by_hand():
    # 10 rows x 2 features of 1-byte codes: 10 * (2 + 12) bytes of rows,
    # 10 * 4 of positions + 2 * 1 * 4 of segment tables, 1 * 2 * 4 * 3 * 4
    # of output; 3 * 10 * 2 adds
    c = counts.histogram_pass_cost(10, 2, 4, 1)
    assert c == {"bytes": 140 + 48 + 96, "operations": 60,
                 "output_bytes": 96}


def test_histogram_rows_take_the_smaller_child():
    assert list(counts.histogram_rows(TREE)) == [100, 30, 20]


def test_b1_work_sums_one_pass_per_histogram():
    w = counts.b1_work([TREE], num_features=2, num_bins=4)
    per = [counts.histogram_pass_cost(n, 2, 4, 1) for n in (100, 30, 20)]
    assert w == {"bytes": sum(p["bytes"] for p in per),
                 "operations": sum(p["operations"] for p in per)}
    assert w["operations"] == 3 * 150 * 2


def test_iteration_work_by_hand():
    shape = {"rows": 100, "valid_rows": 10, "features": 2, "bins": 4}
    w = counts.iteration_work([TREE], shape)
    b1 = counts.b1_work([TREE], 2, 4)
    assert w["bytes"] == b1["bytes"] + 100 * 2 + 100 * 28 + 10 * 2 + 10 * 8
    assert w["operations"] == b1["operations"] + 100 * 7
    w = counts.iteration_work([TREE], dict(shape, pairs=5))
    assert w["operations"] == b1["operations"] + 5 * 21


def test_least_seconds_is_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert counts.share_pct(1.0, 4.0) == 25.0
    assert counts.share_pct(1.0, 0.0) is None


def test_scoring_work_and_ranking_pairs_by_hand():
    w = counts.scoring_work(rows=4, features=3, comparisons=40)
    assert w == {"bytes": 4 * 3 * 8 + 4 * 8, "operations": 40.0}
    # one query of labels 0, 0, 1, 2: pairs with different labels 5
    assert ref.ordered_pairs(np.array([0, 0, 1, 2]), np.array([4])) == 5
    assert ref.ordered_pairs(np.array([1, 1, 0, 2, 2]),
                             np.array([2, 3])) == 2
