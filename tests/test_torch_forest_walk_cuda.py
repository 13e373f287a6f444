"""The forest walk's two routes (``ops/cuda_walk.forest_walk_sums``): the
plain version on CPU tensors and the hand-written kernel (``csrc/walk.cu``)
on CUDA tensors.

Two sums are compared. The *tree-order reference* adds each row's leaf
values in f64 in tree order (``s += leaf_value[t, leaves[:, t]]`` for t = 0,
1, ...) over the plain walk's leaves: the kernel adds in that order, so it
must be bit-equal to it, which pins both its leaves and its order. The
*plain route* is ``forest_walk_leaves`` and a ``torch.sum`` over trees,
which adds in its own order: the two orders differ by f64 rounding only,
at most ``4 T 2**-53 sum_t |v_t|`` a row (``cuda_walk.sum_tolerance``).

On the CPU:
- CPU tensors take the plain route, bit-equal to ``forest_walk_leaves`` and
  ``.sum(dim=1)``, count ``predict.walk.rows_plain`` and neither build nor
  load a library nor count a launch;
- the wrapper refuses a wrong dtype, shape or a strided input with
  ``native.check_tensor``'s messages, and a tensor on neither the CPU nor
  a card;
- the tree-order reference agrees with the plain route within the
  tolerance, and the plain walk's leaves are the host ``Tree.predict_leaf``
  leaves, at 1, 13, 400 and 65,537 rows, on a forest that holds a
  root-is-leaf tree, all three missing types each with both default sides,
  trees of unequal depth (a chain among them), over rows with NaN, zeros,
  values within ``K_ZERO_RANGE`` of zero and ties at thresholds;
- the packed node records (``cuda_walk.pack_nodes``), 8 and 16 bytes,
  walked in numpy exactly as the kernel reads them (row words, masks,
  signed children) give the tree-order reference bit for bit.

On the card (marked ``card``; they skip here): bit-equal to the tree-order
reference and within the tolerance of the plain route at the
``higgs.score`` forest (500 trees, 255 leaves, depth up to 19, 28 features
with NaN columns 0 and 22), over several shared-memory tree groups; on a
3-class forest's class slices at odd row counts; on forests the kernel
walks in device memory or with 16-byte records; two launches bit-equal;
a 500,000-row ``Booster.predict`` launches 8 times and counts 500,000 rows
on ``rows_cuda``. Run them on the card with ``python3 -m pytest
tests/test_torch_forest_walk_cuda.py -m card --noconftest`` (the suite's
``conftest.py`` imports JAX, which the card's machine does not have).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.binning import K_ZERO_RANGE
from lightgbm_tpu_torch.ops import cuda_encode, cuda_walk, native
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.tree import Tree

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

F = 6                                          # features of the CPU forest
LEVELS = np.array([-2.0, -1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 3.0])


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


def _tree(rng, num_leaves, num_features, thresholds, chain=False,
          first_decision=0):
    """A random model-space tree of ``num_leaves`` leaves in LightGBM's
    layout (a split keeps its leaf's index on the left and adds a leaf on
    the right); ``chain`` always splits the newest leaf, so the depth is
    ``num_leaves - 1``. Decision types cycle through the three missing
    types and both default sides from ``first_decision``."""
    M = num_leaves - 1
    left = np.zeros(M, np.int32)
    right = np.zeros(M, np.int32)
    owner = {0: None}
    for n in range(M):
        k = n if chain else rng.randint(n + 1)
        if owner[k] is not None:
            node, side = owner[k]
            (left if side == 0 else right)[node] = n
        left[n], right[n] = ~k, ~(n + 1)
        owner[k], owner[n + 1] = (n, 0), (n, 1)
    kinds = [(mt << 2) | (dl << 1) for mt in (0, 1, 2) for dl in (0, 1)]
    decision = np.array([kinds[(first_decision + n) % 6] for n in range(M)],
                        np.uint8)
    return Tree(
        num_leaves=num_leaves,
        split_feature=rng.randint(0, num_features, M).astype(np.int32),
        threshold_bin=np.zeros(M, np.int32),
        threshold=rng.choice(thresholds, M).astype(np.float64),
        decision_type=decision, left_child=left, right_child=right,
        split_gain=np.ones(M), internal_value=np.zeros(M),
        internal_count=np.full(M, 10, np.int64),
        leaf_value=rng.randn(num_leaves) * 10.0 ** rng.randint(-3, 3,
                                                               num_leaves),
        leaf_count=np.full(num_leaves, 5, np.int64),
        leaf_parent=np.zeros(num_leaves, np.int32))


def _root_leaf(value):
    """A tree of one leaf (no split)."""
    e = np.zeros(0)
    return Tree(num_leaves=1, split_feature=e.astype(np.int32),
                threshold_bin=e.astype(np.int32), threshold=e,
                decision_type=e.astype(np.uint8),
                left_child=e.astype(np.int32),
                right_child=e.astype(np.int32), split_gain=e,
                internal_value=e, internal_count=e.astype(np.int64),
                leaf_value=np.array([value]),
                leaf_count=np.array([5], np.int64),
                leaf_parent=np.zeros(1, np.int32))


def _cpu_trees(seed=3):
    """Trees of 2 to 40 leaves with random shapes, a 12-leaf chain and a
    root-is-leaf tree; thresholds on the rows' levels (ties) and between
    them."""
    rng = np.random.RandomState(seed)
    thresholds = np.concatenate([LEVELS, [-0.75, 0.1, 2.0]])
    trees = [_tree(rng, n, F, thresholds, first_decision=i)
             for i, n in enumerate([2, 7, 40, 3, 17, 25, 5, 31])]
    trees.insert(3, _root_leaf(0.125))
    trees.insert(6, _tree(rng, 12, F, thresholds, chain=True))
    return trees


def _cpu_rows(n, seed=0):
    """Rows of the levels, NaN, zeros of both signs and values within
    ``K_ZERO_RANGE`` of zero."""
    rng = np.random.RandomState(seed)
    X = rng.choice(LEVELS, (n, F)) + rng.choice([0.0, 0.01], (n, F))
    X[rng.rand(n, F) < 0.12] = np.nan
    X[rng.rand(n, F) < 0.06] = -0.0
    X[rng.rand(n, F) < 0.06] = K_ZERO_RANGE / 2
    return X


@pytest.fixture(scope="module")
def cpu_forest():
    trees = _cpu_trees()
    forest = tpredict.StackedForest(trees, F)
    assert forest.root_is_leaf.any()
    mts = {(int(d) >> 2) & 3 for t in trees for d in t.decision_type}
    assert mts == {0, 1, 2}
    return trees, forest


def _encode(forest, X, device="cpu"):
    return cuda_encode.encode_rows(
        torch.from_numpy(X).to(device), *forest.encode_tables(device),
        forest.encode_steps)


def _plain_leaves(forest, inputs):
    dev = inputs[0].device
    return tpredict.forest_walk_leaves(*forest.to(dev), *inputs,
                                       forest.max_depth).cpu().numpy()


def _tree_order(leaf_value, leaves):
    """Each row's leaf values summed in f64 in tree order."""
    s = np.zeros(leaves.shape[0])
    for t in range(leaves.shape[1]):
        s += leaf_value[t, leaves[:, t]]
    return s


def _within_tolerance(got, want, leaf_value, leaves):
    vals = leaf_value[np.arange(leaves.shape[1])[None, :], leaves]
    err = np.abs(np.asarray(got) - want)
    tol = cuda_walk.sum_tolerance(vals)
    worst = int(np.argmax(err - tol))
    assert (err <= tol).all(), (
        f"row {worst} differs by {err[worst]:.3e}, allowed {tol[worst]:.3e}")


def _emulate_kernel(nodes, leaf_value, root_is_leaf, zero_rank, codes,
                    is_nan, is_zero):
    """``csrc/walk.cu``'s walk in numpy over the packed records: the row
    words, the masks and the 16-bit signed children as the kernel reads
    them, the leaf values added in tree order."""
    u = nodes.view(np.uint32).astype(np.int64)
    if nodes.shape[2] == 2:
        w0, w1 = u[..., 0], u[..., 1]
        feat, mask, dl, thr = w0 & 0x1FFF, (w0 >> 13) & 3, (w0 >> 15) & 1, \
            w0 >> 16
        left = (w1 & 0xFFFF).astype(np.uint16).view(np.int16).astype(int)
        right = (w1 >> 16).astype(np.uint16).view(np.int16).astype(int)
    else:
        w0 = u[..., 0]
        feat, mask, dl = w0 & 0x1FFFFFFF, (w0 >> 29) & 3, w0 >> 31
        thr, left, right = (nodes[..., k].astype(int) for k in (1, 2, 3))
    code = np.where(is_nan, zero_rank[None, :], codes).astype(np.int64)
    words = code << 2 | is_zero.astype(np.int64) << 1 | is_nan
    N = codes.shape[0]
    rows = np.arange(N)
    acc = np.zeros(N)
    for t in range(nodes.shape[0]):
        node = np.full(N, -1 if root_is_leaf[t] else 0)
        while (node >= 0).any():
            a = node >= 0
            n = node[a]
            w = words[rows[a], feat[t, n]]
            go_left = np.where(w & mask[t, n], dl[t, n] == 1,
                               (w >> 2) <= thr[t, n])
            node[a] = np.where(go_left, left[t, n], right[t, n])
        acc += leaf_value[t, ~node]
    return acc


# ------------------------------------------------------------------ CPU


def test_cpu_tensors_take_the_plain_route(cpu_forest, monkeypatch):
    """Bit-equal to the walk and ``torch.sum``; counted as plain; no
    library built or loaded, no launch counted."""
    _, forest = cpu_forest
    X = _cpu_rows(500)
    inputs = _encode(forest, X)

    def no_build(*_):
        raise AssertionError("the CPU route built or loaded a library")
    monkeypatch.setattr(native, "build", no_build)
    monkeypatch.setattr(native, "load", no_build)
    launches = cuda_walk.launch_count()
    got = cuda_walk.forest_walk_sums(forest, *inputs)
    assert got.dtype == torch.float64 and got.shape == (500,)
    leaves = tpredict.forest_walk_leaves(*forest.to("cpu"), *inputs,
                                         forest.max_depth)
    t_iota = torch.arange(forest.num_trees)[None, :]
    want = forest.leaf_tables("cpu")[0][t_iota, leaves].sum(dim=1)
    assert torch.equal(got, want)
    counters = obs.snapshot()["counters"]
    assert counters["predict.walk.rows_plain"] == 500
    assert "predict.walk.rows_cuda" not in counters
    assert cuda_walk.launch_count() == launches


def _meta_inputs(forest, n=8):
    codes, is_nan, is_zero = _encode(forest, _cpu_rows(n))
    return [t.to("meta") for t in (codes, is_nan, is_zero)]


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "is_nan must be torch.bool, got torch.uint8"),
    ("shape", ValueError, r"is_nan must have shape \(8, 6\), got \(8, 5\)"),
    ("strided", ValueError, "is_nan must be contiguous"),
    ("off_the_card", ValueError, "is_nan must be a CUDA tensor, got meta")])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(
        cpu_forest, monkeypatch, case, error, match):
    """The masks are checked first (against the codes' shape), then the
    codes; a tensor on neither the CPU nor a card is refused, not walked
    by the plain version."""
    _, forest = cpu_forest
    codes, is_nan, is_zero = _meta_inputs(forest)
    if case == "dtype":
        is_nan = is_nan.to(torch.uint8)
    elif case == "shape":
        is_nan = is_nan[:, :-1].contiguous()
    elif case == "strided":
        is_nan = torch.empty((F, 8), dtype=torch.bool, device="meta").t()

    def no_load(*_):
        raise AssertionError("the wrapper loaded a library before its checks")
    monkeypatch.setattr(native, "load", no_load)
    launches = cuda_walk.launch_count()
    with pytest.raises(error, match=match):
        cuda_walk.forest_walk_sums(forest, codes, is_nan, is_zero)
    assert cuda_walk.launch_count() == launches
    assert "predict.walk.rows_cuda" not in obs.snapshot()["counters"]


@pytest.mark.parametrize("rows", [1, 13, 400, 65_537])
def test_tree_order_reference_agrees_with_the_plain_route(cpu_forest, rows):
    trees, forest = cpu_forest
    X = _cpu_rows(rows, seed=rows)
    inputs = _encode(forest, X)
    leaves = _plain_leaves(forest, inputs)
    for t, tree in enumerate(trees):
        np.testing.assert_array_equal(leaves[:, t], tree.predict_leaf(X))
    plain = cuda_walk.forest_walk_sums(forest, *inputs).numpy()
    _within_tolerance(_tree_order(forest.leaf_value, leaves), plain,
                      forest.leaf_value, leaves)


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_packed_records_walk_to_the_tree_order_sums(cpu_forest, width):
    """The records the kernel reads, walked as the kernel walks them, give
    the tree-order reference bit for bit; 8-byte records where the ranges
    allow, else 16 (here forced by rows past 2**13 features)."""
    _, forest = cpu_forest
    F_rows = F if width == "narrow" else (1 << 13) + 1
    nodes = cuda_walk.pack_nodes(forest.split_feature, forest.thr_rank,
                                 forest.decision, forest.left, forest.right,
                                 forest.max_leaves, F_rows)
    assert nodes.dtype == np.int32
    assert nodes.shape == forest.split_feature.shape + (
        2 if width == "narrow" else 4,)
    if width == "narrow":
        np.testing.assert_array_equal(nodes, forest.walk_nodes("cpu").numpy())
    X = _cpu_rows(3000, seed=5)
    inputs = _encode(forest, X)
    leaves = _plain_leaves(forest, inputs)
    got = _emulate_kernel(nodes, forest.leaf_value, forest.root_is_leaf,
                          forest.zero_rank, *(t.numpy() for t in inputs))
    np.testing.assert_array_equal(got, _tree_order(forest.leaf_value,
                                                   leaves))


@pytest.mark.parametrize("case", ["left_past_nodes", "right_past_leaves",
                                  "feature_past_rows"])
def test_pack_nodes_refuses_what_the_kernel_would_read_out_of_bounds(
        cpu_forest, case):
    _, forest = cpu_forest
    left, right = forest.left.copy(), forest.right.copy()
    num_features = F
    if case == "left_past_nodes":
        left[1, 0] = forest.left.shape[1]
    elif case == "right_past_leaves":
        right[1, 0] = -forest.max_leaves - 1
    else:
        num_features = int(forest.split_feature.max())
    with pytest.raises(ValueError, match="outside"):
        cuda_walk.pack_nodes(forest.split_feature, forest.thr_rank,
                             forest.decision, left, right, forest.max_leaves,
                             num_features)


def test_forest_predict_raw_counts_every_row_on_the_plain_walk(cpu_forest):
    trees, forest = cpu_forest
    X = _cpu_rows(1000, seed=9)
    got = tpredict.forest_predict_raw(trees, X, F, torch.device("cpu"),
                                      chunk_rows=300, forest=forest)
    counters = obs.snapshot()["counters"]
    assert counters["predict.walk.rows_plain"] == 1000
    assert "predict.walk.rows_cuda" not in counters
    leaves = np.stack([t.predict_leaf(X) for t in trees], axis=1)
    _within_tolerance(got, _tree_order(forest.leaf_value, leaves),
                      forest.leaf_value, leaves)


# ------------------------------------------------------------ the card


def _card_case(forest, X, dev):
    """The kernel on ``X``'s rows encoded on the card: (kernel sums, plain
    sums, leaves of the plain walk) on the host."""
    inputs = _encode(forest, X, dev)
    launches = cuda_walk.launch_count()
    got = cuda_walk.forest_walk_sums(forest, *inputs)
    torch.cuda.synchronize()
    assert cuda_walk.launch_count() == launches + 1
    plain = cuda_walk.forest_walk_sums_plain(forest, *inputs)
    return got.cpu().numpy(), plain.cpu().numpy(), _plain_leaves(forest,
                                                                 inputs)


def _assert_kernel(forest, X, dev):
    got, plain, leaves = _card_case(forest, X, dev)
    np.testing.assert_array_equal(got, _tree_order(forest.leaf_value,
                                                   leaves))
    _within_tolerance(got, plain, forest.leaf_value, leaves)
    return got


def _higgs_score(dev, rows=500_000, seed=20261016):
    """The ``higgs.score`` cell's rows and forest from the benchmark's own
    generator: (raw rows f64 on the host, model text)."""
    from benchmark.harness import data as datagen
    from benchmark.harness import forest as forestgen
    from benchmark.harness import manifest
    cfg = manifest.config("higgs")
    gen = datagen.generator(seed, dev)
    pool = datagen.rows(cfg["data"], rows, gen, dev)[0]
    text, _ = forestgen.make(cfg["forest"], cfg["data"]["nan_columns"],
                             pool, gen, rows)
    return np.ascontiguousarray(pool.double().cpu().numpy()), text


@pytest.mark.card
def test_kernel_at_the_higgs_score_shape(card):
    X, text = _higgs_score(card)
    bst = lgt.Booster(params={"device": "cuda", "verbose": -1},
                      model_str=text)
    forest = bst._stacked_forests(bst.trees, 1)[0]
    assert forest.num_trees == 500 and forest.max_leaves == 255
    assert np.isnan(X[:, [0, 22]]).any()
    assert forest.walk_nodes(card).shape[2] == 2
    group = cuda_walk.group_size(forest, card)
    assert 0 < group < forest.num_trees        # several tree groups
    _assert_kernel(forest, X[:1 << 16], card)
    _assert_kernel(forest, X[(1 << 16) - 7:(1 << 17) + 3], card)


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 13, 257, 65_537])
def test_kernel_on_class_slices_at_odd_rows(card, rows):
    rng = np.random.RandomState(rows)
    thresholds = np.concatenate([LEVELS, [-0.75, 0.1, 2.0]])
    trees = [_tree(rng, int(n), F, thresholds, first_decision=i)
             for i, n in enumerate(rng.randint(2, 64, 3 * 40))]
    trees[4] = _root_leaf(-0.5)
    X = _cpu_rows(rows, seed=rows + 1)
    for k in range(3):
        forest = tpredict.StackedForest(trees[k::3], F)
        _assert_kernel(forest, X, card)


@pytest.mark.card
@pytest.mark.parametrize("case,words,shared", [
    ("large_trees", 2, False),        # one tree past a block's shared memory
    ("wide_rows", 4, False),          # features past 2**13: 16-byte records
    ("fine_grid", 4, True)],          # ranks past 2**16: 16-byte records
    ids=["large_trees", "wide_rows", "fine_grid"])
def test_kernel_in_device_memory_and_with_wide_records(card, case, words,
                                                       shared):
    rng = np.random.RandomState(11)
    if case == "large_trees":
        num_features, n_trees, leaves = F, 3, 16_000
        thresholds = np.concatenate([LEVELS, [-0.75, 0.1, 2.0]])
    elif case == "wide_rows":
        num_features, n_trees, leaves = 9000, 20, 63
        thresholds = np.concatenate([LEVELS, [-0.75, 0.1, 2.0]])
    else:
        num_features, n_trees, leaves = 1, 400, 255
        thresholds = rng.standard_normal(200_000)
    trees = [_tree(rng, leaves, num_features, thresholds, first_decision=i)
             for i in range(n_trees)]
    forest = tpredict.StackedForest(trees, num_features)
    assert forest.walk_nodes(card).shape[2] == words
    assert (cuda_walk.group_size(forest, card) > 0) == shared
    X = rng.choice(np.concatenate([LEVELS, thresholds[:50]]),
                   (777, num_features))
    X[rng.rand(*X.shape) < 0.1] = np.nan
    X[rng.rand(*X.shape) < 0.05] = 0.0
    _assert_kernel(forest, X, card)


@pytest.mark.card
@pytest.mark.parametrize("case,error,match", [
    ("codes_dtype", TypeError, "codes must be torch.int32, got torch.int64"),
    ("is_zero_shape", ValueError, "is_zero must have shape")])
def test_the_wrapper_refuses_on_the_card(card, cpu_forest, case, error,
                                         match):
    _, forest = cpu_forest
    codes, is_nan, is_zero = _encode(forest, _cpu_rows(8), card)
    if case == "codes_dtype":
        codes = codes.long()
    else:
        is_zero = is_zero[:4]
    launches = cuda_walk.launch_count()
    with pytest.raises(error, match=match):
        cuda_walk.forest_walk_sums(forest, codes, is_nan, is_zero)
    assert cuda_walk.launch_count() == launches


@pytest.mark.card
def test_two_launches_are_bit_equal(card):
    X, text = _higgs_score(card, rows=1 << 16)
    bst = lgt.Booster(params={"device": "cuda", "verbose": -1},
                      model_str=text)
    forest = bst._stacked_forests(bst.trees, 1)[0]
    inputs = _encode(forest, X, card)
    a = cuda_walk.forest_walk_sums(forest, *inputs)
    b = cuda_walk.forest_walk_sums(forest, *inputs)
    assert torch.equal(a, b)


@pytest.mark.card
def test_booster_predict_launches_once_a_chunk(card):
    X, text = _higgs_score(card)
    bst = lgt.Booster(params={"device": "cuda", "verbose": -1},
                      model_str=text)
    bst.predict(X[:1000])
    obs.reset_for_tests()
    cuda_walk.reset_launch_count()
    got = bst.predict(X, raw_score=True)
    assert cuda_walk.launch_count() == 8
    counters = obs.snapshot()["counters"]
    assert counters["predict.walk.rows_cuda"] == 500_000
    assert "predict.walk.rows_plain" not in counters
    forest = bst._stacked_forests(bst.trees, 1)[0]
    leaves = np.concatenate([
        _plain_leaves(forest, _encode(forest, X[lo:lo + (1 << 16)], card))
        for lo in range(0, len(X), 1 << 16)])
    np.testing.assert_array_equal(got, _tree_order(forest.leaf_value,
                                                   leaves))
