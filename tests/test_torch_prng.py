"""Port parity: ``lightgbm_tpu_torch.utils.prng`` against ``jax.random``.

Bar: bit-equal. ``prng_key``, ``fold_in``, ``split``, ``random_bits`` and
``uniform`` give the same uint32 words (and f32 bit patterns) as
``jax.random.PRNGKey`` / ``fold_in`` / ``split`` / ``bits`` / ``uniform``
(threefry2x32, partitionable, 32-bit mode) for the listed seeds, fold-in
data and shapes and under a hypothesis property; ``top_k_indices`` gives
``lax.top_k``'s indices, ties included (the lower index first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lightgbm_tpu_torch.interop import prng_key_from_jax
from lightgbm_tpu_torch.utils import prng

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

SEEDS = [0, 1, 3, 2**31 - 1, -1, -12345]
DATA = [0, 1, 7, 1000, 2**31 - 1]
SHAPES = [1, 28, 1000, 2**20 + 3]


def _words(jkey):
    return tuple(int(w) for w in np.asarray(jkey))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_equal(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    assert key == _words(jkey)
    assert prng_key_from_jax(np.asarray(jkey)) == key
    for d in DATA:
        assert prng.fold_in(key, d) == _words(jax.random.fold_in(jkey, d))
    for num in (2, 3):
        assert list(prng.split(key, num)) == [
            _words(k) for k in jax.random.split(jkey, num)]
    # the booster's per-iteration derivation (gbdt.py:1344, :1356, :1185)
    k_it = jax.random.fold_in(jkey, 5)
    jb, jf = jax.random.split(jax.random.fold_in(k_it, 0))
    b, f = prng.split(prng.fold_in(prng.fold_in(key, 5), 0))
    assert (b, f) == (_words(jb), _words(jf))
    assert prng.fold_in(f, 0) == _words(jax.random.fold_in(jf, 0))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SHAPES)
def test_bits_and_uniform_bit_equal(seed, n):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    key = prng_key_from_jax(np.asarray(jkey))
    bits = prng.random_bits(key, n).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(jkey, (n,))).astype(np.int64))
    u = prng.uniform(key, n).numpy()
    ju = np.asarray(jax.random.uniform(jkey, (n,)))
    np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0


def test_multidimensional_shape_and_prefix_stability():
    jkey = jax.random.PRNGKey(3)
    key = prng.prng_key(3)
    np.testing.assert_array_equal(
        prng.uniform(key, (7, 13)).numpy().view(np.uint32),
        np.asarray(jax.random.uniform(jkey, (7, 13))).view(np.uint32))
    # a draw over N rows is the prefix of the draw over the padded rows
    np.testing.assert_array_equal(prng.uniform(key, 1000).numpy(),
                                  prng.uniform(key, 1024).numpy()[:1000])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(-2**31, 2**31 - 1), data=st.integers(0, 2**32 - 1),
       n=st.integers(1, 300))
def test_property_random_seed_data_length(seed, data, n):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    key = prng.fold_in(prng.prng_key(seed), data)
    assert key == _words(jkey)
    np.testing.assert_array_equal(
        prng.uniform(key, n).numpy().view(np.uint32),
        np.asarray(jax.random.uniform(jkey, (n,))).view(np.uint32))


@pytest.mark.parametrize("k", [1, 3, 7, 20])
def test_top_k_indices_tie_order_matches_lax(k):
    rng = np.random.RandomState(k)
    # planted ties: few distinct values, and the -1 padding mark
    vals = rng.randint(0, 4, 40).astype(np.float32) / 4.0
    vals[::9] = -1.0
    _, jidx = jax.lax.top_k(jnp.asarray(vals), k)
    import torch
    ours = prng.top_k_indices(torch.as_tensor(vals), k).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jidx))
    # GOSS's case: most weights equal (zero), top_k larger than the nonzeros
    w = np.zeros(30, np.float32)
    w[[4, 9, 17]] = [0.5, 0.5, 0.25]
    _, jidx = jax.lax.top_k(jnp.asarray(w), 6)
    np.testing.assert_array_equal(
        prng.top_k_indices(torch.as_tensor(w), 6).numpy(), np.asarray(jidx))
