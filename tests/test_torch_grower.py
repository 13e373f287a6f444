"""Port parity: ``lightgbm_tpu_torch.grower.grow_tree`` against the JAX
package's ``grow_tree`` on the same inputs.

The bin codes and feature metadata come from binning one numpy matrix (with
NaN columns, so the missing-value scan runs); g/h are quantised to
multiples of 2^-8 with small magnitude, so every histogram sum, sibling
subtraction and cumulative sum is exact in f32 on both sides. On such data
the two growers must agree BIT for bit: every ``TreeArrays`` field over
the real nodes and leaves, and the final ``leaf_id`` of every row — at
``wave_size=1`` (exact leaf-wise order) and at the default wave size, with
the JAX package's compacted passes forced on (``compact_frac=1.0``) and off
(the port compacts every pass).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.grower import GrowerSpec as JaxSpec
from lightgbm_tpu.grower import grow_tree as jax_grow
from lightgbm_tpu_torch import Config
from lightgbm_tpu_torch.dataset import construct_dataset
from lightgbm_tpu_torch.grower import GrowerSpec, grow_tree
from lightgbm_tpu_torch.interop import (binned_dataset, to_numpy, to_torch,
                                        tree_arrays_numpy, tree_arrays_torch)

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

N, F, L = 2048, 6, 31


def _inputs(seed=0, max_bin=63):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, F)
    X[rng.rand(N) < 0.2, 1] = np.nan
    X[rng.rand(N) < 0.1, 4] = np.nan
    X[:, 5] = np.round(X[:, 5] * 4)                 # few distinct values
    cd = construct_dataset(X, None, Config(max_bin=max_bin, verbose=-1))
    data = binned_dataset(cd)
    g = (rng.randint(-128, 128, N) / 256.0).astype(np.float32)
    h = (rng.randint(1, 64, N) / 256.0).astype(np.float32)
    return data, g, h


def _grow_both(wave_size, compact_frac, seed=0, max_depth=-1, max_bin=63):
    data, g, h = _inputs(seed, max_bin)
    B = int(max(8, -(-data["num_bins"].max() // 8) * 8))
    S = min(25, L - 1)
    common = dict(num_leaves=L, num_features=F, num_bins_padded=B,
                  hist_slots=S, wave_size=min(wave_size or S, S),
                  max_depth=max_depth, lambda_l1=0.0, lambda_l2=0.0,
                  min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
                  min_gain_to_split=0.0, compact_frac=compact_frac)
    inc = np.ones(N, np.float32)
    ok = np.ones(F, bool)
    cat = np.zeros(F, bool)
    meta = (data["num_bins"], data["missing_code"], data["default_bin"])
    jt, jleaf = jax_grow(
        jnp.asarray(data["X_binned"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(inc), jnp.asarray(ok), jnp.asarray(cat),
        *[jnp.asarray(m) for m in meta],
        JaxSpec(chunk_rows=512, **common))
    codes = data["X_binned"]
    if codes.dtype == np.uint16:
        codes = codes.view(np.int16)        # the booster's device form
    # the port compacts every pass: compact_frac is the JAX package's
    del common["compact_frac"]
    tt, tleaf = grow_tree(
        to_torch(codes), to_torch(g), to_torch(h), to_torch(inc),
        to_torch(ok), to_torch(cat), *[to_torch(m) for m in meta],
        GrowerSpec(**common))
    return jt, jleaf, tt, tleaf


@pytest.mark.parametrize("wave_size,compact_frac",
                         [(1, 0.25), (0, 0.25), (0, 1.0), (1, 1.0)])
def test_grow_tree_matches_jax_bitwise(wave_size, compact_frac):
    jt, jleaf, tt, tleaf = _grow_both(wave_size, compact_frac)
    nl = int(jt.num_leaves)
    assert int(tt.num_leaves) == nl
    assert nl > 10                       # the tree really grew
    M = L - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_gain",
                 "internal_value", "internal_count"):
        np.testing.assert_array_equal(
            to_numpy(getattr(tt, name))[:M], np.asarray(getattr(jt, name))[:M],
            err_msg=name)
    for name in ("leaf_value", "leaf_count", "leaf_parent"):
        np.testing.assert_array_equal(
            to_numpy(getattr(tt, name))[:L], np.asarray(getattr(jt, name))[:L],
            err_msg=name)
    np.testing.assert_array_equal(to_numpy(tleaf), np.asarray(jleaf))


@pytest.mark.parametrize("compact_frac", [0.25, 1.0])
def test_grow_tree_uint16_codes_match_jax_bitwise(compact_frac):
    """max_bin 511: uint16 codes, B = 512 through the histogram, the split
    scan and the routing, unchanged; bit-equal to JAX as above."""
    data, _, _ = _inputs(seed=2, max_bin=511)
    assert data["X_binned"].dtype == np.uint16
    assert data["num_bins"].max() > 256
    jt, jleaf, tt, tleaf = _grow_both(0, compact_frac, seed=2, max_bin=511)
    nl = int(jt.num_leaves)
    assert int(tt.num_leaves) == nl > 10
    for name in ("split_feature", "threshold_bin", "default_left",
                 "split_gain", "internal_value"):
        np.testing.assert_array_equal(
            to_numpy(getattr(tt, name))[:L - 1],
            np.asarray(getattr(jt, name))[:L - 1], err_msg=name)
    np.testing.assert_array_equal(to_numpy(tt.leaf_value)[:L],
                                  np.asarray(jt.leaf_value)[:L])
    np.testing.assert_array_equal(to_numpy(tleaf), np.asarray(jleaf))
    assert int(to_numpy(tt.threshold_bin)[:nl - 1].max()) > 0


def test_grow_tree_max_depth_matches_jax():
    jt, jleaf, tt, tleaf = _grow_both(0, 0.25, seed=3, max_depth=3)
    assert int(tt.num_leaves) == int(jt.num_leaves) <= 8
    np.testing.assert_array_equal(to_numpy(tleaf), np.asarray(jleaf))
    np.testing.assert_array_equal(to_numpy(tt.leaf_value),
                                  np.asarray(jt.leaf_value))


def test_leaves_from_binned_walks_to_the_grown_leaves():
    """Walking the grown tree over the bin codes lands every row in the
    leaf the grower routed it to, and agrees with the JAX walk."""
    from lightgbm_tpu.ops.predict import leaves_from_binned as jax_walk
    from lightgbm_tpu_torch.ops.predict import (add_tree_scores,
                                                leaves_from_binned)
    data, _, _ = _inputs(seed=1)
    jt, _, tt, tleaf = _grow_both(0, 0.25, seed=1)
    meta = (data["num_bins"], data["missing_code"], data["default_bin"])
    walked = leaves_from_binned(tt, to_torch(data["X_binned"]),
                                *[to_torch(m) for m in meta])
    np.testing.assert_array_equal(to_numpy(walked), to_numpy(tleaf))
    ref = jax_walk(jt, jnp.asarray(data["X_binned"]),
                   *[jnp.asarray(m) for m in meta])
    np.testing.assert_array_equal(to_numpy(walked), np.asarray(ref))
    # the JAX tree, carried over, walks the same in the port
    carried = tree_arrays_torch(tree_arrays_numpy(jt))
    np.testing.assert_array_equal(
        to_numpy(leaves_from_binned(carried, to_torch(data["X_binned"]),
                                    *[to_torch(m) for m in meta])),
        np.asarray(ref))
    score = torch.zeros(N)
    np.testing.assert_array_equal(
        to_numpy(add_tree_scores(score, tt, walked)),
        to_numpy(tt.leaf_value)[to_numpy(tleaf)])


def test_partition_stays_leaf_contiguous():
    """The carried permutation keeps every leaf's rows contiguous and in
    ascending row order (the invariant the compacted pass relies on)."""
    from lightgbm_tpu_torch import grower as gr
    seen = {}
    orig = gr._partition

    def spy(state, *a, **k):
        orig(state, *a, **k)
        seen["state"] = state

    gr._partition = spy
    try:
        _, _, tt, tleaf = _grow_both(0, 1.0, seed=5)
    finally:
        gr._partition = orig
    st = seen["state"]
    perm = to_numpy(st.perm)
    leaf = to_numpy(tleaf)
    assert sorted(perm.tolist()) == list(range(N))
    for lf in range(int(tt.num_leaves)):
        s, n = int(st.seg_start[lf]), int(st.seg_rows[lf])
        rows = perm[s:s + n]
        assert (leaf[rows] == lf).all()
        assert (np.diff(rows) > 0).all()
        assert n == int((leaf == lf).sum())
