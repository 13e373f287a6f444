"""The device rank encode of ``Booster.predict`` (``ops/cuda_encode.py``) on
the CPU, where its plain version runs in the kernel's place.

Bars:
- ``encode_rows_plain``: codes bit-equal to the port's and the JAX
  package's ``StackedForest._encode_loop`` and masks equal to
  ``encode_rows``', on request rows with NaN, +-inf, -0.0, values within
  1e-20 of zero and ties at grid values, over a forest that holds a
  feature with an empty grid and one with a single threshold; at 1, 13,
  400 and 65,537 rows (one past a chunk);
- ``forest_predict_raw`` on the CPU: the raw scores of the host encode's
  route (host ``encode_rows``, then the walk and the sum), bit for bit, for
  a binary, a 3-class and a linear-leaf forest, over several chunks, and it
  never calls the host encode;
- the ``predict.encode.rows_plain`` counter counts the encoded rows; a
  tensor on neither the CPU nor a card raises rather than falling back.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.tree import Tree as JTree
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.ops import cuda_encode
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.tree import Tree
from test_torch_serving import _probe, _ties

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

EMPTY, SINGLE = 8, 9          # the extra columns: never split; one stump


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _rows(n=1500, seed=0):
    """Eight features of ``test_torch_serving``'s kind of rows, and two
    constant columns the trained trees never split on."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 10) * 4 - 2
    X[rng.rand(n, 10) < 0.08] = np.nan
    X[rng.rand(n, 10) < 0.08] = 0.0
    X[:, EMPTY] = 1.0
    X[:, SINGLE] = 1.0
    return X


def _stump(make):
    """A one-split tree on feature ``SINGLE`` at 0.5 (NaN goes left)."""
    return make(
        num_leaves=2, split_feature=np.array([SINGLE], np.int32),
        threshold_bin=np.zeros(1, np.int32),
        threshold=np.array([0.5]),
        decision_type=np.array([(2 << 2) | 2], np.uint8),
        left_child=np.array([-1], np.int32),
        right_child=np.array([-2], np.int32),
        split_gain=np.ones(1), internal_value=np.zeros(1),
        internal_count=np.array([10], np.int64),
        leaf_value=np.array([0.25, -0.5]),
        leaf_count=np.array([5, 5], np.int64),
        leaf_parent=np.zeros(2, np.int32))


def _train(objective, **extra):
    X = _rows()
    s = np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) ** 2
    if objective == "binary":
        y = (s > np.median(s)).astype(np.float64)
    elif objective == "multiclass":
        y = np.digitize(s, np.quantile(s, [0.33, 0.66])).astype(np.float64)
    else:
        y = s + 0.1 * np.random.RandomState(1).randn(len(s))
    p = dict(objective=objective, num_leaves=15, min_data_in_leaf=10,
             device="cpu", verbose=-1, **extra)
    return lgt.train(p, lgt.Dataset(X, label=y, params=p),
                     num_boost_round=8), X


@pytest.fixture(scope="module")
def forests():
    """The binary model's trees plus the stump, in both packages, with the
    probe rows (NaN, +-inf, -0.0, near-zero values and grid ties)."""
    bst, X = _train("binary")
    jb = lgb.Booster(model_str=bst.model_to_string())
    ours = tpredict.StackedForest(bst.trees + [_stump(Tree)], X.shape[1])
    ref = jpredict.StackedForest(jb.trees + [_stump(JTree)], X.shape[1])
    assert len(ours.grids[EMPTY]) == 0 and len(ours.grids[SINGLE]) == 1
    P = _ties(ours, _probe(X, 400))
    P[4:8, 2] = [1e-21, -1e-20, 1e-20, 2e-20]
    return ours, ref, P


@pytest.mark.parametrize("rows", [1, 13, 400, 65_537])
def test_plain_encode_bit_equal_to_the_loops(forests, rows):
    ours, ref, P = forests
    X = np.resize(P, (rows, P.shape[1]))
    codes, is_nan, is_zero = cuda_encode.encode_rows(
        torch.from_numpy(X), *ours.encode_tables("cpu"), ours.encode_steps)
    assert codes.dtype == torch.int32 and is_nan.dtype == torch.bool
    loop = ours._encode_loop(X)
    np.testing.assert_array_equal(codes.numpy(), loop)
    np.testing.assert_array_equal(codes.numpy(), ref._encode_loop(X))
    _, host_nan, host_zero = ours.encode_rows(X)
    np.testing.assert_array_equal(is_nan.numpy(), host_nan)
    np.testing.assert_array_equal(is_zero.numpy(), host_zero)
    assert (codes[:, EMPTY] == 0).all()
    assert set(codes[:, SINGLE].tolist()) <= {0, 1}


def _host_encode_route(forest, X, chunk_rows):
    """``forest_predict_raw``'s raw scores as the host encode gave them:
    ``encode_rows`` on the host, then the same walk and sum."""
    dev = torch.device("cpu")
    walk = forest.to(dev)
    leaf_value, *lin = forest.leaf_tables(dev)
    t_iota = torch.arange(forest.num_trees)[None, :]
    out = np.zeros(X.shape[0])
    for lo in range(0, X.shape[0], chunk_rows):
        chunk = X[lo:lo + chunk_rows]
        leaves = tpredict.forest_walk_leaves(
            *walk, *(torch.from_numpy(a) for a in forest.encode_rows(chunk)),
            forest.max_depth)
        if forest.has_linear:
            raw32 = chunk.astype(np.float32)
            raw_nan = np.isnan(raw32)
            np.nan_to_num(raw32, copy=False, nan=0.0)
            sums = tpredict.forest_walk_linear(
                leaves, *lin, torch.from_numpy(raw32),
                torch.from_numpy(raw_nan)).sum(dim=1)
        else:
            sums = leaf_value[t_iota, leaves].sum(dim=1)
        out[lo:lo + chunk_rows] = sums.numpy()
    return out


@pytest.mark.parametrize("kind", ["binary", "multiclass", "linear"])
def test_forest_predict_raw_gives_the_host_encode_routes_scores(
        kind, monkeypatch):
    bst, X = (_train("multiclass", num_class=3) if kind == "multiclass"
              else _train("regression", linear_tree=True,
                          linear_lambda=0.01) if kind == "linear"
              else _train("binary"))
    P = np.resize(_probe(X, 300), (700, X.shape[1]))
    K = 3 if kind == "multiclass" else 1
    forests = [tpredict.StackedForest(bst.trees[k::K], X.shape[1])
               for k in range(K)]
    assert forests[0].has_linear == (kind == "linear")
    before = [_host_encode_route(f, P, 256) for f in forests]

    def no_host_encode(*a, **k):
        raise AssertionError("forest_predict_raw encoded on the host")
    monkeypatch.setattr(tpredict.StackedForest, "encode_rows",
                        no_host_encode)
    monkeypatch.setattr(np, "searchsorted", no_host_encode)
    for k, f in enumerate(forests):
        got = tpredict.forest_predict_raw(bst.trees[k::K], P, X.shape[1],
                                          torch.device("cpu"),
                                          chunk_rows=256, forest=f)
        np.testing.assert_array_equal(got, before[k])


def test_rows_plain_counter_counts_the_encoded_rows(forests):
    ours, _, P = forests
    X = np.resize(P, (1000, P.shape[1]))
    tpredict.forest_predict_raw(ours._trees, X, X.shape[1],
                                torch.device("cpu"), chunk_rows=300,
                                forest=ours)
    counters = obs.snapshot()["counters"]
    assert counters["predict.encode.rows_plain"] == 1000
    assert "predict.encode.rows_cuda" not in counters


def test_encode_rows_raises_off_the_cpu_and_the_card(forests):
    ours, _, P = forests
    X = torch.from_numpy(P).to("meta")
    grids, offsets = (t.to("meta") for t in ours.encode_tables("cpu"))
    n0 = cuda_encode.launch_count()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_encode.encode_rows(X, grids, offsets, ours.encode_steps)
    assert cuda_encode.launch_count() == n0
