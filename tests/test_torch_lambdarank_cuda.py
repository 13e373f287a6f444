"""The lambdarank objective's two routes (``objectives.LambdarankNDCG``):
the plain version on CPU tensors and the hand-written kernel
(``ops/cuda_lambdarank.py``, ``csrc/lambdarank.cu``) on CUDA tensors.

On the CPU:
- the kernel's block table (``query_tiles``): every document in one tile,
  queries longest first, a query longer than a tile cut into tiles;
- the rank rule the kernel counts, ``#{j : s_j > s_i} + #{j : s_j == s_i,
  j < i}``, equals the position under ``torch.argsort(-s, stable=True)``
  on scores with planted ties;
- the f64 pair loop the card tests hold the kernel to
  (``_lambdarank_reference.py``, row order, stable ranks) agrees with the
  plain version: every g and h within 1e-5 of its scale, the sum of its
  terms' magnitudes and for h each pair's |delta| too (f32's cancellation
  in ``2 - p``, the reference's note) (the plain version's f32 terms and
  f32 sums over at most 2,047 pairs a document: n x epsilon is 1.2e-4 at
  worst, torch's blocked sums give about log2(n) x epsilon, 7e-7);
- CPU tensors take the plain route: ``objective.lambdarank.queries_plain``
  counts the queries, ``.queries_cuda`` stays 0, and the kernel's wrapper
  raises for CPU tensors rather than falling back; neither this kernel's
  nor B1's nor the rank encode's CPU route builds or loads a library
  (``ops/native.py``) or counts a launch.

On the card (marked ``card``; they skip here), at the MS-LTR shape (the
benchmark's 18,919 query sizes over 2,270,296 rows) and on a set of odd
queries: the kernel against the f64 pair loop over the card's own
discounts, every g and h within 1e-5 of that scale (the kernel's terms are
f32, about ten roundings of 6e-8 each; its sums are f64), and against the
plain version on the card within 1e-4 of it (the plain version's f32 sums,
n x epsilon with n up to 1,133 documents: 6.8e-5). Iteration 0 (all ties), a
query of one document and one of equal labels (g = h = 0 exactly),
queries longer than the shared-memory chunk, weights, the pre-partitioned
row layout, two launches bit-equal, a CUDA-graph replay bit-equal to the
eager call. Run them on the card with ``python3 -m pytest
tests/test_torch_lambdarank_cuda.py -m card --noconftest`` (the suite's
``conftest.py`` imports JAX, which the card's machine does not have).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.dataset import Metadata
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import (cuda_encode, cuda_histogram,
                                    cuda_lambdarank, native)
from lightgbm_tpu_torch.ops.histogram import histogram_scales
from _lambdarank_reference import pair_loop_f64

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

F64_TOL = 1e-5       # against the f64 pair loop, times the terms' magnitudes
PLAIN_TOL = 1e-4     # kernel against the plain version on the card, likewise
# MS-LTR's label shares (labels 0-4), as the benchmark's generator cuts them
LABEL_SHARES = [0.55, 0.20, 0.15, 0.07, 0.03]


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


def _objective(sizes, label, extra=None):
    params = dict({"objective": "lambdarank", "verbose": -1}, **(extra or {}))
    meta = Metadata(len(label))
    meta.set_label(label)
    meta.set_group(np.asarray(sizes))
    obj = create_objective(lgt.Config.from_params(params))
    obj.init(meta, len(label))
    return obj


def _labels(n, rng):
    return rng.choice(len(LABEL_SHARES), size=n,
                      p=LABEL_SHARES).astype(np.float32)


def _scores(kind, n, rng):
    if kind == "zeros":                   # iteration 0: one long tie
        return np.zeros(n, np.float32)
    if kind == "ties":
        return (rng.randint(0, 4, n) / 4).astype(np.float32)
    return rng.randn(n).astype(np.float32)


def _odd_queries(seed=1):
    """One document, equal labels (query 1), queries past the shared-memory
    chunk and past several tiles, and small ones."""
    rng = np.random.RandomState(seed)
    sizes = np.array([1, 40, 1500, 3, 600, 129, 2, 128, 8]
                     + list(rng.randint(2, 300, 30)))
    label = _labels(int(sizes.sum()), rng)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    label[qb[1]:qb[2]] = 2.0
    return sizes, label, qb


def _reference(obj, s, label, device="cpu"):
    """The f64 pair loop over the discounts the routes on ``device`` read
    (``torch.log2`` of the card and of the CPU may part by an ulp, and a
    difference of neighbouring ranks' discounts magnifies it)."""
    longest = int(np.diff(obj.query_boundaries).max())
    disc = 1.0 / torch.log2(torch.arange(longest, dtype=torch.float32,
                                         device=device) + 2.0)
    return pair_loop_f64(s, label, obj.query_boundaries, obj.inv_max_dcg,
                         obj.label_gain, disc.cpu().numpy(),
                         obj.config.sigmoid)


def _within(got, want, scale, tol, what):
    got = np.asarray(got, np.float64)
    err = np.abs(got - want)
    bound = tol * scale + 1e-30
    worst = int(np.argmax(err / bound))
    assert (err <= bound).all(), (
        f"{what}: row {worst} differs by {err[worst]:.3e}, allowed "
        f"{bound[worst]:.3e} ({got[worst]!r} against {want[worst]!r})")


# ------------------------------------------------------------------ CPU


def test_query_tiles_cover_every_document_longest_first():
    sizes = np.array([5, 300, 0, 128, 129, 300, 1, 1000])
    qb = np.concatenate([[0], np.cumsum(sizes)])
    tiles = cuda_lambdarank.query_tiles(qb, tile=128)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    # longest first, ties in query order; a query's tiles in order
    assert tiles[:, 0].tolist() == ([7] * 8 + [1] * 3 + [5] * 3 + [4] * 2
                                    + [3, 0, 6])
    assert tiles[:8, 1].tolist() == [0, 128, 256, 384, 512, 640, 768, 896]
    assert tiles[8:11, 1].tolist() == [0, 128, 256]
    assert tiles[-3:, 1].tolist() == [0, 0, 0]
    # every document of every query in exactly one tile; none for the
    # empty query
    covered = np.zeros(int(qb[-1]), np.int64)
    for q, first in tiles:
        lo, hi = qb[q] + first, min(qb[q] + first + 128, qb[q + 1])
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert 2 not in tiles[:, 0]
    # the default tile is the source's
    default = cuda_lambdarank.query_tiles(qb)
    assert cuda_lambdarank.TILE == 128
    np.testing.assert_array_equal(default, tiles)


def test_objective_builds_the_table_at_init():
    sizes, label, qb = _odd_queries()
    obj = _objective(sizes, label)
    np.testing.assert_array_equal(obj.query_boundaries, qb)
    np.testing.assert_array_equal(obj.query_tiles,
                                  cuda_lambdarank.query_tiles(qb))
    longest = int(np.argmax(sizes))
    assert sizes[longest] > cuda_lambdarank.CHUNK
    assert (obj.query_tiles[:12, 0] == longest).all()   # 1500 docs: 12 tiles


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_by_counting_equals_the_stable_argsort(seed):
    """The kernel's rule (``rank_kernel`` in ``csrc/lambdarank.cu``) on
    scores with planted ties, -0.0 beside 0.0, and one long tie."""
    rng = np.random.RandomState(seed)
    for n in (1, 2, 37, 300):
        s = (rng.randint(-3, 4, n) / 2).astype(np.float32)   # ties
        free = rng.rand(n) < 0.3
        s[free] = rng.randn(int(free.sum()))
        s[: n // 3] = 0.0                                      # a long tie
        if n > 3:
            s[1] = -0.0
        st = torch.from_numpy(s)
        j = torch.arange(n)
        counted = ((st[None, :] > st[:, None])
                   | ((st[None, :] == st[:, None]) & (j[None, :] < j[:, None]))
                   ).sum(dim=1)
        order = torch.argsort(-st, stable=True)
        position = torch.empty_like(order)
        position[order] = torch.arange(n)
        assert torch.equal(counted, position)


@pytest.mark.parametrize("kind", ["zeros", "ties", "random"])
def test_f64_pair_loop_agrees_with_the_plain_version(kind):
    sizes, label, qb = _odd_queries()
    obj = _objective(sizes, label)
    rng = np.random.RandomState(4)
    s = _scores(kind, len(label), rng)
    g, h = obj.gradients(torch.from_numpy(s)[None, :],
                         torch.from_numpy(label), None)
    rg, rh, ag, ah = _reference(obj, s, label)
    _within(g[0].numpy(), rg, ag, F64_TOL, "g")
    _within(h[0].numpy(), rh, ah, F64_TOL, "h")
    for q in (0, 1):     # one document; equal labels: no pairs
        assert not g[0, qb[q]:qb[q + 1]].any()
        assert not h[0, qb[q]:qb[q + 1]].any()
    assert float(h.abs().max()) > 0


def _histogram_on_the_cpu():
    """B1's CPU route, a pass and an accumulated wave: the plain version."""
    gen = torch.Generator().manual_seed(0)
    N, F, B = 64, 3, 8
    X = torch.randint(0, B, (N, F), generator=gen, dtype=torch.uint8)
    grad = torch.randn(N, generator=gen)
    hess = torch.rand(N, generator=gen)
    included = torch.ones(N)
    leaf_id = torch.zeros(N, dtype=torch.int32)
    slot_of_leaf = torch.tensor([0, -1], dtype=torch.int32)
    out = cuda_histogram.build_histograms_cuda(
        X, grad, hess, included, leaf_id, slot_of_leaf, 1, B)
    assert out.shape == (1, F, B, 3) and int(out[..., 2].sum()) == N * F
    acc = cuda_histogram.HistogramAccumulator(1, F, B, torch.device("cpu"))
    acc.zero_()
    scales = histogram_scales(grad, hess)
    acc.add(X, grad, hess, included, leaf_id, slot_of_leaf, 0, N, scales)
    assert int(acc.finalize(scales)[..., 2].sum()) == N * F


def _encode_on_the_cpu():
    """The rank encode's CPU route: the plain version, counted as such."""
    X = torch.tensor([[0.3, float("nan")], [1.0, -2.0], [0.0, 5.0]],
                     dtype=torch.float64)
    grids = torch.tensor([0.1, 0.5, 0.9, -1.0, 2.0], dtype=torch.float64)
    offsets = torch.tensor([0, 3, 5], dtype=torch.int64)
    codes, is_nan, _ = cuda_encode.encode_rows(X, grids, offsets, 3)
    assert codes.tolist() == [[1, 2], [3, 0], [0, 2]]
    assert is_nan.tolist() == [[False, True], [False, False], [False, False]]
    assert obs.snapshot()["counters"]["predict.encode.rows_plain"] == 3


def _lambdarank_on_the_cpu():
    """The objective's CPU route: the plain version, counted as such; the
    kernel's wrapper raises for CPU tensors rather than falling back."""
    sizes, label, _ = _odd_queries()
    obj = _objective(sizes, label)
    s = torch.zeros((1, len(label)))
    for _ in range(2):
        obj.gradients(s, torch.from_numpy(label), None)
    counters = obs.snapshot()["counters"]
    assert counters["objective.lambdarank.queries_plain"] == 2 * len(sizes)
    assert counters.get("objective.lambdarank.queries_cuda", 0) == 0
    assert obj._plan is None
    plan = cuda_lambdarank.QueryPlan(obj.query_boundaries, obj.query_tiles,
                                     obj.inv_max_dcg, obj.label_gain,
                                     torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_lambdarank.lambdarank_grads(s[0], torch.from_numpy(label),
                                         plan, 1.0)


@pytest.mark.parametrize("wrapper,route", [
    (cuda_histogram, _histogram_on_the_cpu),
    (cuda_encode, _encode_on_the_cpu),
    (cuda_lambdarank, _lambdarank_on_the_cpu)],
    ids=["histogram", "encode", "lambdarank"])
def test_cpu_tensors_take_the_plain_route(monkeypatch, wrapper, route):
    """CPU tensors never build, load or launch a kernel's library."""
    def no_build(*_):
        raise AssertionError("the CPU route built or loaded a library")
    monkeypatch.setattr(native, "build", no_build)
    monkeypatch.setattr(native, "load", no_build)
    launches0 = wrapper.launch_count()
    route()
    assert wrapper.launch_count() == launches0


# ------------------------------------------------------------ the card


def _msltr(seed):
    """The ``mslr.train`` cell's query sizes (its generator's, every seed
    the same sizes) over 2,270,296 rows, MS-LTR label shares."""
    from benchmark.harness import data as datagen
    gen = torch.Generator().manual_seed(seed)
    sizes = datagen.query_sizes(2_270_296, 18_919, 120, 0.6, 8, gen)
    rng = np.random.RandomState(seed)
    return sizes, _labels(int(sizes.sum()), rng)


def _card_route(obj, s, label, dev, weight=None):
    """(g, h) of the CUDA route, on the host, and the queries it counted."""
    before = obs.snapshot()["counters"].get(
        "objective.lambdarank.queries_cuda", 0)
    g, h = obj.gradients(torch.from_numpy(s)[None, :].to(dev),
                         torch.from_numpy(label).to(dev),
                         None if weight is None
                         else torch.from_numpy(weight).to(dev))
    torch.cuda.synchronize()
    counted = obs.snapshot()["counters"].get(
        "objective.lambdarank.queries_cuda", 0) - before
    return g[0].cpu().numpy(), h[0].cpu().numpy(), counted


@pytest.mark.card
@pytest.mark.parametrize("kind", ["zeros", "ties", "random"])
def test_kernel_at_the_msltr_shape(card, kind):
    sizes, label = _msltr(7)
    obj = _objective(sizes, label)
    rng = np.random.RandomState(11)
    s = _scores(kind, len(label), rng)
    launches = cuda_lambdarank.launch_count()
    g, h, counted = _card_route(obj, s, label, card)
    assert cuda_lambdarank.launch_count() == launches + 1
    assert counted == len(sizes)
    assert obs.snapshot()["counters"].get(
        "objective.lambdarank.queries_plain", 0) == 0
    rg, rh, ag, ah = _reference(obj, s, label, card)
    _within(g, rg, ag, F64_TOL, "g against f64")
    _within(h, rh, ah, F64_TOL, "h against f64")
    pg, ph = obj._plain_grads(torch.from_numpy(s).to(card),
                              torch.from_numpy(label).to(card))
    _within(g, pg.cpu().numpy().astype(np.float64), ag, PLAIN_TOL,
            "g against the plain version")
    _within(h, ph.cpu().numpy().astype(np.float64), ah, PLAIN_TOL,
            "h against the plain version")


@pytest.mark.card
@pytest.mark.parametrize("kind", ["zeros", "ties", "random"])
def test_kernel_on_odd_queries(card, kind):
    sizes, label, qb = _odd_queries()
    obj = _objective(sizes, label)
    s = _scores(kind, len(label), np.random.RandomState(3))
    g, h, _ = _card_route(obj, s, label, card)
    rg, rh, ag, ah = _reference(obj, s, label, card)
    _within(g, rg, ag, F64_TOL, "g against f64")
    _within(h, rh, ah, F64_TOL, "h against f64")
    for q in (0, 1):     # one document; equal labels: exactly 0
        assert not g[qb[q]:qb[q + 1]].any()
        assert not h[qb[q]:qb[q + 1]].any()
    # a query longer than the shared-memory chunk and cut into tiles
    assert sizes.max() > cuda_lambdarank.CHUNK
    assert h[qb[2]:qb[3]].any()


@pytest.mark.card
def test_kernel_with_weights(card):
    sizes, label, _ = _odd_queries(2)
    obj = _objective(sizes, label)
    rng = np.random.RandomState(5)
    s = _scores("random", len(label), rng)
    w = (rng.rand(len(label)) + 0.5).astype(np.float32)
    g, h, _ = _card_route(obj, s, label, card, w)
    rg, rh, ag, ah = _reference(obj, s, label, card)
    _within(g, rg * w, ag * w, F64_TOL, "weighted g")
    _within(h, rh * w, ah * w, F64_TOL, "weighted h")


@pytest.mark.card
def test_kernel_in_the_pre_partitioned_layout(card):
    """``set_row_layout``: world row r at padded position ``positions[r]``
    (two blocks with padding between); the kernel's g and h land there,
    padding rows 0, and equal the CPU route's within the tolerance."""
    sizes, label, _ = _odd_queries(3)
    n = len(label)
    half = n // 2
    npad = 2 * (half + 7)
    positions = np.concatenate([np.arange(half),
                                half + 7 + np.arange(n - half)])
    obj = _objective(sizes, label)
    obj.set_row_layout(positions, npad)
    rng = np.random.RandomState(6)
    s = _scores("random", n, rng)
    s_pad = np.zeros(npad, np.float32)
    l_pad = np.zeros(npad, np.float32)
    s_pad[positions], l_pad[positions] = s, label
    g, h, _ = _card_route(obj, s_pad, l_pad, card)
    rg, rh, ag, ah = _reference(obj, s, label, card)
    pad = np.ones(npad, bool)
    pad[positions] = False
    assert not g[pad].any() and not h[pad].any()
    _within(g[positions], rg, ag, F64_TOL, "g")
    _within(h[positions], rh, ah, F64_TOL, "h")


@pytest.mark.card
def test_two_launches_are_bit_equal(card):
    sizes, label = _msltr(3)
    obj = _objective(sizes, label)
    s = torch.from_numpy(_scores("ties", len(label),
                                 np.random.RandomState(2)))[None, :].to(card)
    lab = torch.from_numpy(label).to(card)
    g1, h1 = obj.gradients(s, lab, None)
    g2, h2 = obj.gradients(s, lab, None)
    assert torch.equal(g1, g2) and torch.equal(h1, h2)


@pytest.mark.card
def test_graph_replay_equals_the_eager_call(card):
    sizes, label = _msltr(5)
    obj = _objective(sizes, label)
    rng = np.random.RandomState(8)
    lab = torch.from_numpy(label).to(card)
    s = torch.from_numpy(_scores("random", len(label), rng))[None, :].to(card)
    obj.gradients(s, lab, None)              # tables placed, library built
    torch.cuda.synchronize()
    launches = cuda_lambdarank.launch_count()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            g_out, h_out = obj.gradients(s, lab, None)
    torch.cuda.current_stream().wait_stream(stream)
    assert cuda_lambdarank.launch_count() == launches + 1
    for kind in ("random", "zeros", "ties"):
        s.copy_(torch.from_numpy(_scores(kind, len(label), rng))[None, :])
        graph.replay()
        eager_g, eager_h = obj.gradients(s, lab, None)
        torch.cuda.synchronize()
        assert torch.equal(g_out, eager_g) and torch.equal(h_out, eager_h)
    assert cuda_lambdarank.launch_count() == launches + 4
