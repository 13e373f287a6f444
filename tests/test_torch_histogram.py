"""Port parity: the histogram (kernel B1's plain version and its wrapper)
against the JAX package's ``build_histograms`` and its Pallas kernel
``build_histograms_pallas``, the latter in interpret mode as
``tests/test_pallas_hist.py`` runs it.

Tolerances:
- g/h quantised to multiples of 2^-8 with |x| < 1 make every bin sum exact
  in f32 for all three implementations (bf16 holds such values exactly, so
  the JAX hi/lo split loses nothing): the results must be BIT-equal;
- on arbitrary f32 g/h the JAX side carries bf16 hi/lo pairs (~2^-16
  relative per summand) while the port adds 64-bit fixed point (error below
  1e-12 here), so the bound is 2^-16 relative to the bin's sum of |x| plus
  1e-6 absolute (observed: a quarter of that);
- counts are always exact.
The kernel itself (CUDA tensors) is held against this plain version on the
card by ``chip_smoke.py``; on CPU tensors the wrapper runs the plain version
and counts no launch.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import pallas_histogram as ph
from lightgbm_tpu.ops.histogram import build_histograms as jax_hist
from lightgbm_tpu_torch.interop import to_torch
from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                              fixed_point_scale,
                                              histogram_scales, root_sums)

N, F, B, S, LEAVES = 4096, 6, 32, 4, 9


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(ph, "_INTERPRET", True)


def _data(seed=0, quantised=True):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, B, size=(N, F)).astype(np.uint8)
    if quantised:
        g = (rng.randint(-255, 256, N) / 256.0).astype(np.float32)
        h = (rng.randint(0, 256, N) / 256.0).astype(np.float32)
    else:
        g = rng.randn(N).astype(np.float32)
        h = np.abs(rng.randn(N)).astype(np.float32)
    inc = (rng.rand(N) > 0.2).astype(np.float32)
    g, h = g * inc, h * inc                    # callers pre-mask g/h
    leaf_id = rng.randint(0, LEAVES - 1, size=N).astype(np.int32)
    return X, g, h, inc, leaf_id


def _slot_of_leaf(pending):
    sol = np.full(LEAVES, -1, np.int32)
    sol[list(pending)] = np.arange(len(pending))
    return sol


def _partition(leaf_id, pending):
    """A leaf-contiguous permutation (rows grouped by leaf, ascending) and
    the pending slots' segment tables — the grower's incremental layout."""
    perm = np.argsort(leaf_id, kind="stable").astype(np.int32)
    counts = np.bincount(leaf_id, minlength=LEAVES)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_counts = np.zeros(S, np.int32)
    slot_starts = np.zeros(S, np.int32)
    slot_counts[:len(pending)] = counts[list(pending)]
    slot_starts[:len(pending)] = starts[list(pending)]
    return perm, slot_counts, slot_starts


def _port(X, g, h, inc, leaf_id, sol, **kw):
    t = {k: to_torch(v) for k, v in kw.items() if not np.isscalar(v)}
    t.update({k: v for k, v in kw.items() if np.isscalar(v)})
    return build_histograms(to_torch(X), to_torch(g), to_torch(h),
                            to_torch(inc), to_torch(leaf_id), to_torch(sol),
                            S, B, **t).numpy()


def _jax(fn, X, g, h, inc, leaf_id, sol, **kw):
    args = [jnp.asarray(a) for a in (X, g, h, inc, leaf_id, sol)]
    kw = {k: (v if k == "max_rows" else jnp.asarray(v))
          for k, v in kw.items()}
    return np.asarray(fn(*args, num_slots=S, num_bins_padded=B,
                         chunk_rows=1024, **kw))


@pytest.mark.parametrize("pending", [(0,), (1, 3, 5), (0, 2, 4, 7)])
def test_full_pass_bit_equal_to_jax_and_pallas(pending):
    X, g, h, inc, leaf_id = _data(seed=len(pending))
    sol = _slot_of_leaf(pending)
    ours = _port(X, g, h, inc, leaf_id, sol)
    np.testing.assert_array_equal(ours, _jax(jax_hist, X, g, h, inc,
                                             leaf_id, sol))
    np.testing.assert_array_equal(
        ours, _jax(ph.build_histograms_pallas, X, g, h, inc, leaf_id, sol))


@pytest.mark.parametrize("pending", [(1,), (2, 5), (1, 3, 6, 7)])
def test_compacted_pass_bit_equal_to_jax_and_pallas(pending):
    X, g, h, inc, leaf_id = _data(seed=10 + len(pending))
    sol = _slot_of_leaf(pending)
    perm, counts, starts = _partition(leaf_id, pending)
    n_active = int(counts.sum())
    kw = dict(row_idx=perm, n_active=n_active, slot_counts=counts,
              slot_starts=starts)
    ours = _port(X, g, h, inc, leaf_id, sol, **kw)
    np.testing.assert_array_equal(ours, _port(X, g, h, inc, leaf_id, sol))
    np.testing.assert_array_equal(
        ours, _jax(jax_hist, X, g, h, inc, leaf_id, sol, **kw))
    np.testing.assert_array_equal(
        ours, _jax(ph.build_histograms_pallas, X, g, h, inc, leaf_id, sol,
                   max_rows=N, **kw))


@pytest.mark.parametrize("compacted", [False, True])
def test_arbitrary_floats_within_hilo_tolerance(compacted):
    X, g, h, inc, leaf_id = _data(seed=21, quantised=False)
    pending = (0, 3, 6)
    sol = _slot_of_leaf(pending)
    kw = {}
    if compacted:
        perm, counts, starts = _partition(leaf_id, pending)
        kw = dict(row_idx=perm, n_active=int(counts.sum()),
                  slot_counts=counts, slot_starts=starts)
    ours = _port(X, g, h, inc, leaf_id, sol, **kw)
    ref = _jax(jax_hist, X, g, h, inc, leaf_id, sol, **kw)
    absum = _port(X, np.abs(g), np.abs(h), inc, leaf_id, sol, **kw)
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    bound = 2.0 ** -16 * absum[..., :2] + 1e-6
    assert (np.abs(ours[..., :2] - ref[..., :2]) <= bound).all()
    # and against an f64 oracle the port is far tighter than f32 rounding
    slot = sol[leaf_id]
    for s in range(len(pending)):
        rows = slot == s
        for f in range(F):
            exact = np.bincount(X[rows, f], weights=g[rows].astype(np.float64),
                                minlength=B)
            np.testing.assert_allclose(ours[s, f, :, 0], exact, rtol=2 ** -23,
                                       atol=1e-9)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    X, g, h, inc, leaf_id = _data(seed=4)
    sol = _slot_of_leaf((0, 1))
    before = build_histograms_cuda.launches
    out = build_histograms_cuda(to_torch(X), to_torch(g), to_torch(h),
                                to_torch(inc), to_torch(leaf_id),
                                to_torch(sol), S, B)
    assert build_histograms_cuda.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  _port(X, g, h, inc, leaf_id, sol))


@pytest.mark.parametrize("fault", ["code", "slot", "n_active"])
def test_wrapper_raises_on_out_of_range_input(fault):
    """A code >= B, a slot >= S or n_active past the compacted segments
    raises (the kernel device-asserts on the same input); no row is
    silently dropped."""
    X, g, h, inc, leaf_id = _data(seed=5)
    pending = (0, 2)
    sol = _slot_of_leaf(pending)
    kw = {}
    if fault == "code":
        X[np.flatnonzero(sol[leaf_id] >= 0)[0], 3] = B
    elif fault == "slot":
        sol[2] = S
    else:
        perm, counts, starts = _partition(leaf_id, pending)
        kw = dict(row_idx=to_torch(perm), n_active=int(counts.sum()) + 1,
                  slot_counts=to_torch(counts), slot_starts=to_torch(starts))
    with pytest.raises(ValueError, match="num_bins_padded|num_slots"):
        build_histograms_cuda(to_torch(X), to_torch(g), to_torch(h),
                              to_torch(inc), to_torch(leaf_id),
                              to_torch(sol), S, B, **kw)


def test_fixed_point_scale_is_safe_power_of_two():
    for max_abs, n in [(1.0, 2_000_000), (0.25, 17), (123.5, 4096),
                       (1e-30, 10)]:
        s = fixed_point_scale(max_abs, n)
        m, _ = math.frexp(s)
        assert m == 0.5                            # a power of two
        assert n * max_abs * s < 2.0 ** 62
        assert n * max_abs * s * 4 >= 2.0 ** 62 or s == 2.0 ** 200
    assert fixed_point_scale(0.0, 10) == 1.0
    g = torch.tensor([0.5, -2.0, 1.0])
    assert histogram_scales(g, g.abs()) == (fixed_point_scale(2.0, 3),) * 2


def test_root_sums_are_rounded_f64_sums():
    rng = np.random.RandomState(3)
    g = rng.randn(10_000).astype(np.float32)
    rg, rh, rc = root_sums(torch.tensor(g), torch.tensor(np.abs(g)),
                           torch.ones(10_000))
    assert float(rg) == np.float32(g.astype(np.float64).sum())
    assert float(rh) == np.float32(np.abs(g).astype(np.float64).sum())
    assert float(rc) == 10_000.0
