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
``uint16`` codes (``max_bin`` above 255) go to the port as ``int16`` (the
booster's device form) and to the JAX package as ``uint16``, with the same
bars. The kernel's ranges (its grid from ``grid_blocks``, and the walk
``hist_kernel`` makes over it on the card, transcribed here as
``_kernel_ranges``) and the positions the wrapper derives for a call without a partition
(``pass_positions``) are plain Python and torch, checked here. The kernel
itself (CUDA tensors) is held against this plain version on the card by
``chip_smoke.py``; on CPU tensors the wrapper runs the plain version and
counts no launch.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import pallas_histogram as ph
from lightgbm_tpu.ops.histogram import build_histograms as jax_hist
from lightgbm_tpu_torch.interop import to_torch
from lightgbm_tpu_torch.ops.cuda_histogram import (MAX_BINS,
                                                   MIN_ROWS_PER_BLOCK,
                                                   SMEM_BLOCK_LIMIT,
                                                   build_histograms_cuda,
                                                   feature_groups, grid_blocks,
                                                   launch_count)
from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                              fixed_point_scale,
                                              histogram_scales, pass_positions,
                                              root_sums)

# one intra-op thread: the test workers share the machine's cores, and
# a torch pool of one thread per core on every worker oversubscribes
# them many times over (the port's small CPU ops then wait on it)
torch.set_num_threads(1)

N, F, B, S, LEAVES = 4096, 6, 32, 4, 9


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(ph, "_INTERPRET", True)


def _data(seed=0, quantised=True, num_bins=B):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, num_bins, size=(N, F)).astype(
        np.uint8 if num_bins <= 256 else np.uint16)
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


def _port(X, g, h, inc, leaf_id, sol, num_bins=B, **kw):
    t = {k: to_torch(v) for k, v in kw.items() if not np.isscalar(v)}
    # n_active: a 0-d int64 tensor, as the grower and the card keep it
    t.update({k: torch.tensor(v, dtype=torch.int64)
              for k, v in kw.items() if np.isscalar(v)})
    if X.dtype == np.uint16:
        X = X.view(np.int16)                # the booster's device form
    return build_histograms(to_torch(X), to_torch(g), to_torch(h),
                            to_torch(inc), to_torch(leaf_id), to_torch(sol),
                            S, num_bins, **t).numpy()


def _jax(fn, X, g, h, inc, leaf_id, sol, num_bins=B, **kw):
    args = [jnp.asarray(a) for a in (X, g, h, inc, leaf_id, sol)]
    kw = {k: (v if k == "max_rows" else jnp.asarray(v))
          for k, v in kw.items()}
    return np.asarray(fn(*args, num_slots=S, num_bins_padded=num_bins,
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
def test_sampled_input_bit_equal_to_jax_and_pallas(compacted):
    """The sampled path's input (``chip_smoke.py``'s ``sampled`` case): 80%
    of the rows in the bag with g = h = 0 outside it, and a GOSS-like tenth
    of the in-bag rows with g and h scaled by 8 (still exact in f32)."""
    X, g, h, inc, leaf_id = _data(seed=31)
    goss = (np.random.RandomState(32).rand(N) < 0.1) & (inc > 0)
    w = np.where(goss, 8.0, 1.0).astype(np.float32)
    g, h = g * w, h * w
    pending = (0, 2, 5)
    sol = _slot_of_leaf(pending)
    kw = {}
    if compacted:
        perm, counts, starts = _partition(leaf_id, pending)
        kw = dict(row_idx=perm, n_active=int(counts.sum()),
                  slot_counts=counts, slot_starts=starts)
    ours = _port(X, g, h, inc, leaf_id, sol, **kw)
    assert ours[:, 0, :, 2].sum() == inc[np.isin(leaf_id, pending)].sum()
    np.testing.assert_array_equal(
        ours, _jax(jax_hist, X, g, h, inc, leaf_id, sol, **kw))
    np.testing.assert_array_equal(
        ours, _jax(ph.build_histograms_pallas, X, g, h, inc, leaf_id, sol,
                   **(dict(kw, max_rows=N) if compacted else {})))


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


B16 = 512                        # max_bin 511: uint16 codes


@pytest.mark.parametrize("compacted", [False, True])
def test_uint16_codes_bit_equal_to_jax_and_pallas(compacted):
    X, g, h, inc, leaf_id = _data(seed=30 + compacted, num_bins=B16)
    assert X.dtype == np.uint16 and X.max() >= 256
    pending = (1, 4, 6)
    sol = _slot_of_leaf(pending)
    kw = {}
    if compacted:
        perm, counts, starts = _partition(leaf_id, pending)
        kw = dict(row_idx=perm, n_active=int(counts.sum()),
                  slot_counts=counts, slot_starts=starts)
    ours = _port(X, g, h, inc, leaf_id, sol, num_bins=B16, **kw)
    assert ours[..., 2].sum() == inc[sol[leaf_id] >= 0].sum() * F
    np.testing.assert_array_equal(
        ours, _jax(jax_hist, X, g, h, inc, leaf_id, sol, num_bins=B16, **kw))
    pallas_kw = dict(kw, max_rows=N) if compacted else kw
    np.testing.assert_array_equal(
        ours, _jax(ph.build_histograms_pallas, X, g, h, inc, leaf_id, sol,
                   num_bins=B16, **pallas_kw))


def test_uint16_arbitrary_floats_within_hilo_tolerance():
    X, g, h, inc, leaf_id = _data(seed=32, quantised=False, num_bins=B16)
    sol = _slot_of_leaf((0, 5))
    ours = _port(X, g, h, inc, leaf_id, sol, num_bins=B16)
    ref = _jax(jax_hist, X, g, h, inc, leaf_id, sol, num_bins=B16)
    absum = _port(X, np.abs(g), np.abs(h), inc, leaf_id, sol, num_bins=B16)
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    bound = 2.0 ** -16 * absum[..., :2] + 1e-6
    assert (np.abs(ours[..., :2] - ref[..., :2]) <= bound).all()


@pytest.mark.parametrize("pending", [(0,), (1, 3, 5), (0, 2, 4, 7)])
def test_derived_positions_give_the_plain_histogram(pending):
    """The positions the wrapper derives for a call without a partition
    (slot by slot, rows ascending) give the histogram of the plain call."""
    X, g, h, inc, leaf_id = _data(seed=40 + len(pending))
    sol = _slot_of_leaf(pending)
    perm, counts, n_active = pass_positions(to_torch(leaf_id), to_torch(sol),
                                            S)
    slot = sol[leaf_id]
    assert n_active == int((slot >= 0).sum())
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(slot[slot >= 0], minlength=S))
    expect = np.concatenate([np.flatnonzero(slot == s) for s in range(S)]
                            + [np.flatnonzero(slot < 0)])
    np.testing.assert_array_equal(perm.numpy(), expect)
    derived = build_histograms(to_torch(X), to_torch(g), to_torch(h),
                               to_torch(inc), to_torch(leaf_id),
                               to_torch(sol), S, B, row_idx=perm,
                               n_active=n_active, slot_counts=counts)
    np.testing.assert_array_equal(derived.numpy(),
                                  _port(X, g, h, inc, leaf_id, sol))


def test_derived_positions_refuse_a_slot_past_num_slots():
    X, g, h, inc, leaf_id = _data(seed=44)
    sol = _slot_of_leaf((0, 2))
    sol[2] = S
    perm, counts, n_active = pass_positions(to_torch(leaf_id), to_torch(sol),
                                            S)
    assert int(counts.sum()) < n_active          # the bad rows sort last
    with pytest.raises(ValueError, match="num_slots"):
        build_histograms(to_torch(X), to_torch(g), to_torch(h),
                         to_torch(inc), to_torch(leaf_id), to_torch(sol), S,
                         B, row_idx=perm, n_active=n_active,
                         slot_counts=counts)


def _kernel_ranges(grid, counts, n_active):
    """``(R, ranges)``: the run of positions a block takes and (block, slot,
    first position, length) of every range the blocks add. A transcription
    of ``hist_kernel``'s walk on the card (``csrc/histogram.cu``): of a grid
    of ``grid`` blocks the first ``min(grid, ceil(n_active /
    MIN_ROWS_PER_BLOCK))`` take runs of ``R`` positions, the rest exit, and
    each run splits at slot boundaries."""
    if n_active <= 0:
        return 0, []
    nblocks = min(grid, -(-n_active // MIN_ROWS_PER_BLOCK))
    R = -(-n_active // nblocks)
    cum = np.cumsum(counts)
    ranges = []
    for b in range(grid):
        p = b * R
        if p >= n_active:
            continue
        end = min(p + R, n_active)
        s = 0
        while s < len(cum) and cum[s] <= p:
            s += 1
        while p < end and s < len(cum):
            seg_end = min(end, cum[s])
            if seg_end > p:
                ranges.append((b, s, p, seg_end - p))
                p = seg_end
            s += 1
    return R, ranges


def _check_plan(num_rows, n_active, counts, num_features, num_bins,
                code_bytes, num_sms):
    """The grid the wrapper launches for a shape of ``num_rows`` rows, and
    the ranges ``hist_kernel`` gives a pass over ``n_active`` of them."""
    grid = grid_blocks(num_rows, num_features, num_bins, code_bytes,
                       num_sms)
    fg, groups = feature_groups(num_features, num_bins, code_bytes)
    smem = fg * num_bins * 20
    # every position of [0, n_active) once, no range across a slot
    cum = np.cumsum(counts)
    seen = np.zeros(n_active, np.int64)
    R, ranges = _kernel_ranges(grid, counts, n_active)
    for b, s, p, n in ranges:
        assert n > 0 and 0 <= b < grid
        assert b * R <= p
        assert p + n <= min((b + 1) * R, n_active)
        assert (cum[s] - counts[s]) <= p and p + n <= cum[s]
        seen[p:p + n] += 1
    assert (seen == 1).all()
    # ranges are in order: a block walks its slots upwards
    assert [r[2] for r in ranges] == sorted(r[2] for r in ranges)
    # the grid bound: at most k blocks per SM (one SM's 233,472 bytes of
    # shared memory and 2048 threads), ceil(num_rows / 2048) in all; a pass
    # uses at most ceil(n_active / 2048) of them
    per_sm = 2 if smem + 2048 <= 233472 // 2 else 1
    assert 1 <= grid <= -(-per_sm * num_sms // groups)
    assert grid <= -(-num_rows // 2048)
    used = len({r[0] for r in ranges})
    assert used <= -(-n_active // 2048)
    assert n_active == 0 or (used - 1) * R < n_active <= used * R
    # feature groups fit a block (a [group_features, B] sub-histogram, 20
    # bytes a bin, beside the kernel's 1 KB of segment tables) and cover
    # every feature
    assert smem <= SMEM_BLOCK_LIMIT <= 232448 - 1024
    assert fg * groups >= num_features
    assert fg * (groups - 1) < num_features
    return grid, ranges


@pytest.mark.parametrize("counts,num_features,num_bins,code_bytes,num_sms", [
    ([2_000_000] + [0] * 24, 28, 256, 1, 132),     # root wave, S=25
    ([80_000] * 25, 28, 256, 1, 132),              # 25 slots, every row
    ([0, 9000, 0, 0, 120_001, 7, 0, 63_000], 28, 256, 1, 132),  # empties
    ([0] * 25, 28, 256, 1, 132),                   # n_active = 0
    ([5, 1, 0, 3], 6, 32, 1, 132),                 # tiny pass
    ([400_000, 300_000, 1], 28, 512, 2, 132),      # uint16, two groups
    ([70_000] * 3, 100, 256, 1, 7),                # three groups, few SMs
    ([1_000_003, 999_997], 28, MAX_BINS, 2, 132),  # one feature per block
])
def test_plan_ranges_cover_every_position_once(counts, num_features,
                                               num_bins, code_bytes,
                                               num_sms):
    """The grid is sized for every row of the shape and the pass's own
    ``n_active`` spread over it on the card: as a pass over all rows, and
    as one of a 2,000,000-row shape (a later wave)."""
    n_active = int(sum(counts))
    for num_rows in sorted({max(n_active, 1), 2_000_000}):
        grid, ranges = _check_plan(num_rows, n_active, np.asarray(counts),
                                   num_features, num_bins, code_bytes,
                                   num_sms)
        if n_active == 0:
            assert ranges == []
        # a root wave's blocks each see one slot: one flush per block
        if sum(c > 0 for c in counts) == 1:
            assert len(ranges) == len({r[0] for r in ranges})


def test_plan_ranges_random_slot_counts():
    rng = np.random.RandomState(7)
    for _ in range(50):
        S_ = int(rng.randint(1, 65))
        counts = rng.randint(0, 60_000, S_) * (rng.rand(S_) < 0.7)
        n_active = int(counts.sum())
        _check_plan(n_active + int(rng.randint(1, 500_000)), n_active,
                    counts, 28, 256, 1, 132)


def test_feature_groups_fit_shared_memory():
    # all 28 features of a B=256 row in one block (143,360 bytes); uint16
    # at B=512 in two groups of 14 (whole 32-bit words of codes)
    assert feature_groups(28, 256, 1) == (28, 1)
    assert feature_groups(28, 512, 2) == (14, 2)
    assert feature_groups(100, 256, 1) == (36, 3)
    assert feature_groups(28, MAX_BINS, 2) == (1, 28)
    assert MAX_BINS == 11_520
    with pytest.raises(ValueError, match="shared memory"):
        feature_groups(28, MAX_BINS + 8, 2)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    X, g, h, inc, leaf_id = _data(seed=4)
    sol = _slot_of_leaf((0, 1))
    before = launch_count()
    out = build_histograms_cuda(to_torch(X), to_torch(g), to_torch(h),
                                to_torch(inc), to_torch(leaf_id),
                                to_torch(sol), S, B)
    assert launch_count() == before
    np.testing.assert_array_equal(out.numpy(),
                                  _port(X, g, h, inc, leaf_id, sol))


@pytest.mark.parametrize("fault", ["code", "slot", "n_active", "code16"])
def test_wrapper_raises_on_out_of_range_input(fault):
    """A code >= B, a slot >= S or n_active past the compacted segments
    raises (the kernel device-asserts on the same input); no row is
    silently dropped. A uint16 code of 2**15 or more reads as a negative
    int16 and is refused the same way."""
    X, g, h, inc, leaf_id = _data(seed=5)
    pending = (0, 2)
    sol = _slot_of_leaf(pending)
    kw = {}
    if fault == "code":
        X[np.flatnonzero(sol[leaf_id] >= 0)[0], 3] = B
    elif fault == "code16":
        X = X.astype(np.uint16)
        X[np.flatnonzero(sol[leaf_id] >= 0)[0], 3] = 40_000
        X = X.view(np.int16)
    elif fault == "slot":
        sol[2] = S
    else:
        perm, counts, starts = _partition(leaf_id, pending)
        kw = dict(row_idx=to_torch(perm),
                  n_active=torch.tensor(int(counts.sum()) + 1),
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
    assert tuple(histogram_scales(g, g.abs()).tolist()) == \
        (fixed_point_scale(2.0, 3),) * 2


def test_root_sums_are_rounded_f64_sums():
    rng = np.random.RandomState(3)
    g = rng.randn(10_000).astype(np.float32)
    rg, rh, rc = root_sums(torch.tensor(g), torch.tensor(np.abs(g)),
                           torch.ones(10_000))
    assert float(rg) == np.float32(g.astype(np.float64).sum())
    assert float(rh) == np.float32(np.abs(g).astype(np.float64).sum())
    assert float(rc) == 10_000.0


@pytest.mark.parametrize("compacted", [False, True])
def test_f137_bit_equal_to_jax(compacted):
    """The MS-LTR width: 137 uint8 features at B=256. On the card that is
    four feature groups of 36, 36, 36 and 29 features with rows of 137
    bytes (not whole 32-bit words), the ``f137`` case of ``chip_smoke.py``;
    the plain version must equal the JAX package's ``build_histograms``."""
    assert feature_groups(137, 256, 1) == (36, 4)
    nf, nb, n = 137, 256, 2048
    rng = np.random.RandomState(137)
    X = rng.randint(0, nb, size=(n, nf)).astype(np.uint8)
    inc = (rng.rand(n) > 0.2).astype(np.float32)
    g = (rng.randint(-255, 256, n) / 256.0).astype(np.float32) * inc
    h = (rng.randint(0, 256, n) / 256.0).astype(np.float32) * inc
    leaf_id = rng.randint(0, LEAVES - 1, size=n).astype(np.int32)
    pending = (1, 3, 6, 7)
    sol = _slot_of_leaf(pending)
    kw = {}
    if compacted:
        perm = np.argsort(leaf_id, kind="stable").astype(np.int32)
        counts = np.bincount(leaf_id, minlength=LEAVES)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        kw = dict(row_idx=perm, n_active=int(counts[list(pending)].sum()),
                  slot_counts=counts[list(pending)].astype(np.int32),
                  slot_starts=starts[list(pending)].astype(np.int32))
    ours = _port(X, g, h, inc, leaf_id, sol, num_bins=nb, **kw)
    assert ours.shape == (S, nf, nb, 3)
    ref = _jax(jax_hist, X, g, h, inc, leaf_id, sol, num_bins=nb, **kw)
    np.testing.assert_array_equal(ours, ref)
