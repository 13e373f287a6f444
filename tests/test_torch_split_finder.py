"""Port parity: the numerical split scan against the JAX package's
``find_best_splits_numerical`` on fixed histograms.

The histograms hold g/h that are multiples of 2^-8 and integer counts, and
each slot's parent totals are the exact sums of its bins, so every
cumulative sum and subtraction is exact in f32 on both sides: the
``SplitCandidates`` must be identical, field for field. Cases cover
MissingType none / zero / NaN features, 2-bin features, min_data and
min_hessian limits, L1/L2 and min_gain_to_split, and planted gain ties —
equal gains at two thresholds (lowest wins), two identical features
(lowest index wins), and NaN features whose NaN bin is empty, where the
reverse and forward scans split the rows identically (the reverse scan
wins, which sets default_left).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.split_finder import \
    find_best_splits_numerical as jax_find
from lightgbm_tpu_torch.interop import to_numpy, to_torch
from lightgbm_tpu_torch.ops.split_finder import (find_best_splits_numerical,
                                                 leaf_output,
                                                 leaf_split_gain,
                                                 prefix_sums)

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

S, B = 5, 16
# per feature: (num_bins, missing_code, default_bin)
FEATURES = [(16, 0, 0), (12, 2, 0), (10, 1, 3), (2, 2, 0), (16, 0, 0),
            (9, 2, 0), (6, 1, 0), (12, 2, 0)]
F = len(FEATURES)


def _hist(seed):
    rng = np.random.RandomState(seed)
    hist = np.zeros((S, F, B, 3), np.float32)
    for f, (nb, mc, db) in enumerate(FEATURES):
        c = rng.randint(0, 40, size=(S, nb)).astype(np.float32)
        hist[:, f, :nb, 2] = c
        hist[:, f, :nb, 0] = rng.randint(-64, 64, size=(S, nb)) / 256.0 * c
        hist[:, f, :nb, 1] = rng.randint(1, 32, size=(S, nb)) / 256.0 * c
    # every feature partitions the same rows: rebalance each feature's
    # last real bin so all features share feature 0's totals
    tot = hist[:, 0].sum(axis=1)                             # [S, 3]
    for f, (nb, mc, db) in enumerate(FEATURES[1:], start=1):
        rest = hist[:, f, :nb - 1].sum(axis=1)
        hist[:, f, nb - 1] = tot - rest
        neg = hist[:, f, nb - 1, 2] < 0
        hist[neg, f, :, :] = 0
        hist[neg, f, 0] = tot[neg]
    # planted ties: feature 4 duplicates feature 0 (lowest index wins)
    hist[:, 4] = hist[:, 0]
    # a NaN feature whose NaN bin is empty in slots 0-2
    nb7 = FEATURES[7][0]
    hist[:3, 7, nb7 - 2] += hist[:3, 7, nb7 - 1]
    hist[:3, 7, nb7 - 1] = 0
    return hist


def _parents(hist):
    # exact parent totals: the bins of feature 0 (f64 sums of dyadic values)
    tot = hist[:, 0].astype(np.float64).sum(axis=1).astype(np.float32)
    return tot[:, 0], tot[:, 1], tot[:, 2]


def _meta():
    nb = np.array([f[0] for f in FEATURES], np.int32)
    mc = np.array([f[1] for f in FEATURES], np.int32)
    db = np.array([f[2] for f in FEATURES], np.int32)
    return nb, mc, db


KW = [dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
           min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0),
      dict(lambda_l1=0.5, lambda_l2=2.0, min_data_in_leaf=5.0,
           min_sum_hessian_in_leaf=1.0, min_gain_to_split=0.25),
      dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=200.0,
           min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", range(len(KW)))
def test_split_candidates_equal_jax(seed, kw):
    hist = _hist(seed)
    pg, ph, pc = _parents(hist)
    nb, mc, db = _meta()
    ok = np.ones(F, bool)
    ok[6] = seed != 1                        # feature mask honoured
    args = (hist, pg, ph, pc, nb, mc, db, ok)
    ref = jax_find(*[jnp.asarray(a) for a in args], **KW[kw])
    ours = find_best_splits_numerical(*[to_torch(a) for a in args], **KW[kw])
    for name in ref._fields:
        np.testing.assert_array_equal(to_numpy(getattr(ours, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_planted_ties_resolve_like_jax():
    hist = _hist(0)
    # slot 4, feature 0: g antisymmetric about the middle, so splitting
    # after bin 2 and after bin 12 give the same (exact) gain
    g = np.array([10, 10, 10, -5, -5, -5, -5, -5,
                  5, 5, 5, 5, 5, -10, -10, -10], np.float32)
    hist[4, 0] = np.stack([g, np.full(16, 15.0), np.full(16, 30.0)], -1)
    hist[4, 4] = hist[4, 0]
    pg, ph, pc = _parents(hist)
    nb, mc, db = _meta()
    ok = np.zeros(F, bool)
    ok[[0, 4]] = True                     # only the duplicated pair
    args = (hist, pg, ph, pc, nb, mc, db, ok)
    cand = find_best_splits_numerical(*[to_torch(a) for a in args], **KW[0])
    ref = jax_find(*[jnp.asarray(a) for a in args], **KW[0])
    finite = torch.isfinite(cand.gain)
    assert bool(finite.all())
    assert (cand.feature == 0).all()      # lowest feature of a tie
    assert int(cand.threshold[4]) == 2    # lowest threshold of a tie
    for name in ref._fields:
        np.testing.assert_array_equal(to_numpy(getattr(cand, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_empty_nan_bin_sets_default_left():
    """NaN feature 7 has no NaN rows in slots 0-2: its best split there is
    the reverse scan's, so missing values default left (decision type 10),
    matching the reference engine's exact-arithmetic tie."""
    hist = _hist(2)
    pg, ph, pc = _parents(hist)
    nb, mc, db = _meta()
    ok = np.zeros(F, bool)
    ok[7] = True
    args = [to_torch(a) for a in (hist, pg, ph, pc, nb, mc, db, ok)]
    cand = find_best_splits_numerical(*args, **KW[0])
    assert bool(torch.isfinite(cand.gain[:3]).all())
    assert bool(cand.default_left[:3].all())


def test_leaf_math_matches_jax():
    from lightgbm_tpu.ops.split_finder import leaf_output as jo
    from lightgbm_tpu.ops.split_finder import leaf_split_gain as jg
    rng = np.random.RandomState(9)
    g = rng.randn(64).astype(np.float32)
    h = np.abs(rng.randn(64)).astype(np.float32)
    h[:4] = 0.0                                  # zero denominators -> 0
    for l1, l2 in ((0.0, 0.0), (0.3, 1.5)):
        np.testing.assert_array_equal(
            leaf_output(torch.tensor(g), torch.tensor(h), l1, l2).numpy(),
            np.asarray(jo(jnp.asarray(g), jnp.asarray(h), l1, l2)))
        np.testing.assert_array_equal(
            leaf_split_gain(torch.tensor(g), torch.tensor(h) + 1, l1,
                            l2).numpy(),
            np.asarray(jg(jnp.asarray(g), jnp.asarray(h) + 1, l1, l2)))


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_sums_do_not_depend_on_the_addition_order(seed):
    """The scan's prefix sums add f32 bins in f64 and round once: the card's
    tree-ordered ``cumsum`` and the CPU's sequential one then give the same
    bits (ROADMAP C11), which f32 addition does not."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(7, 256) * np.exp2(rng.randint(-10, 10, (7, 256))))
    x = x.astype(np.float32)
    ours = prefix_sums(torch.as_tensor(x)).numpy()
    exact = np.cumsum(x.astype(np.float64), axis=1)
    np.testing.assert_array_equal(ours, exact.astype(np.float32))
    # a tree order of the same additions: pairwise sums of halves
    half = x[:, :128].astype(np.float64).sum(1) + \
        x[:, 128:].astype(np.float64).sum(1)
    np.testing.assert_array_equal(ours[:, -1], half.astype(np.float32))
    f32_seq = np.cumsum(x, axis=1, dtype=np.float32)[:, -1]
    f32_tree = x[:, :128].sum(1, dtype=np.float32) + \
        x[:, 128:].sum(1, dtype=np.float32)
    assert not np.array_equal(f32_seq, f32_tree)
