"""Wide bins in ``lightgbm_tpu_torch`` (ROADMAP B1c): ``max_bin`` past the
histogram kernel's shared-memory limit (11,520 bins) and past ``2**15``,
up to the JAX package's ``uint16`` range, on the CPU against the JAX
package.

- ``feature_groups`` / ``bin_tiles`` give the kernel's bin tiling: one
  feature per block past ``MAX_BINS``, tiles of at most ``MAX_BINS`` bins;
- ``_codes_tensor`` keeps codes of ``2**15`` and more (``int32`` on the
  device where a feature has more than 32,768 bins, ``int16`` below), and
  the streamed ``u16`` shards widen the same way;
- the plain version's tiled and untiled sums are bit-equal, so the tiled
  kernel that the card holds against it is held to one untiled pass;
- at ``max_bin`` 16,383 and 40,000 the port trains the JAX package's model
  text byte for byte on exact-arithmetic gradients (ROADMAP C14's bar: an
  L2 objective whose residuals a ``fobj`` rounds to a 1/64 grid);
- streamed, device-ingested and validated runs at 40,000 bins give the
  resident host-binned text.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting.gbdt import _codes_tensor
from lightgbm_tpu_torch.ops.cuda_histogram import (MAX_BINS, bin_tiles,
                                                   build_histograms_cuda,
                                                   feature_groups,
                                                   grid_blocks)
from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                              device_code_dtype,
                                              histogram_scales, unpack_codes)
from lightgbm_tpu_torch.ops.stream import pack_codes_host

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ROUNDS = 3
# the JAX package's one-hot histogram chunk: its default (32,768 rows) holds
# a [chunk, F, B] one-hot of several GB at 40,000 bins; the port ignores it
JAX_CHUNK = 1024


def _wide_data(n, f=3, seed=0):
    """Every value distinct, so that ``max_bin`` bins are found (with
    ``min_data_in_bin=1``), on a 1/64 grid; labels on a 1/4 grid."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.permutation(n) for _ in range(f)], 1) / 64.0
    y = np.floor(X[:, 0] * 256.0 / n) / 4.0 + (X[:, 1] > n / 128.0) * 0.5
    return X, y


def _exact_fobj(preds, ds):
    """L2 residuals rounded to a 1/64 grid, unit hessians: every sum exact
    in both packages' arithmetic (ROADMAP C14's bar)."""
    g = np.clip(np.round((preds - ds.get_label()) * 64) / 64.0, -2.0, 2.0)
    return g, np.ones_like(g)


def _params(max_bin, **extra):
    p = {"objective": "regression", "max_bin": max_bin, "num_leaves": 15,
         "min_data_in_leaf": 5, "min_data_in_bin": 1,
         "boost_from_average": False, "learning_rate": 0.5,
         "metric": "none", "verbose": -1, "tpu_hist_chunk": JAX_CHUNK}
    p.update(extra)
    return p


def _train_port(X, y, max_bin, rounds=ROUNDS, valid=None, **extra):
    ds = lgt.Dataset(X, label=y)
    kw = {}
    if valid is not None:
        kw = dict(valid_sets=[lgt.Dataset(valid[0], label=valid[1],
                                          reference=ds)],
                  evals_result={})
    return lgt.train(_params(max_bin, device="cpu", **extra), ds,
                     num_boost_round=rounds, fobj=_exact_fobj,
                     keep_training_booster=True, **kw)


# ------------------------------------------------------------ the tiling

@pytest.mark.parametrize("B,tile,tiles", [
    (256, 256, 1), (MAX_BINS, MAX_BINS, 1), (MAX_BINS + 8, 5768, 2),
    (16384, 8192, 2), (40000, 10000, 4), (65536, 10928, 6)])
def test_bin_tiles_cover_the_bins_within_shared_memory(B, tile, tiles):
    assert bin_tiles(B) == (tile, tiles)
    assert tile <= MAX_BINS and tile % 8 == 0 or tiles == 1
    assert (tiles - 1) * tile < B <= tiles * tile
    fg, groups = feature_groups(8, B, 2)
    if tiles > 1:
        # a wide feature has a block (a y-coordinate) per tile of its own
        assert (fg, groups) == (1, 8)
        # every SM gets a block of the pass: 132 SMs over 8 x tiles tiles
        assert grid_blocks(2_000_000, 8, B, 2, 132) == -(-132 // (8 * tiles))
    else:
        assert fg * B * 20 <= 230_400


def test_feature_groups_no_longer_refuse_wide_bins():
    """The pin of the old refusal (``feature_groups`` raised past
    ``MAX_BINS``, ROADMAP B1c) turned into the tiling."""
    assert feature_groups(28, MAX_BINS + 8, 2) == (1, 28)
    assert feature_groups(4, 40008, 4) == (1, 4)


# --------------------------------------------------------- codes on device

@pytest.mark.parametrize("num_bins,dtype", [
    (256, torch.int16), (2 ** 15, torch.int16), (2 ** 15 + 8, torch.int32),
    (65536, torch.int32)])
def test_codes_tensor_keeps_codes_of_2_15_and_more(num_bins, dtype):
    codes = np.array([[0, 1], [num_bins - 1, 300]], np.uint16)
    t = _codes_tensor(codes, torch.device("cpu"), num_bins)
    assert t.dtype == dtype == device_code_dtype(num_bins)
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  codes.astype(np.int64))
    assert device_code_dtype(255, 1) == torch.uint8


def test_streamed_u16_codes_widen_into_int32():
    codes = np.array([[0, 40_000], [65_535, 7]], np.uint16)
    xb = torch.as_tensor(pack_codes_host(codes, "u16"))
    out = torch.empty((2, 2), dtype=torch.int32)
    got = unpack_codes(xb, 2, "u16", out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(got.numpy(), codes.astype(np.int32))
    # at most 32,768 bins the view stays int16, no copy
    assert unpack_codes(xb, 2, "u16").dtype == torch.int16


# ------------------------------------------------------ plain version tiled

@pytest.mark.parametrize("B,code_dtype", [(16_384, torch.int16),
                                          (40_000, torch.int32)])
def test_plain_tiled_sums_equal_untiled(B, code_dtype):
    rng = np.random.RandomState(3)
    N, F, S = 4000, 3, 3
    X = torch.as_tensor(rng.randint(0, B, (N, F))).to(code_dtype)
    g = torch.as_tensor(rng.randn(N).astype(np.float32))
    h = torch.as_tensor(rng.rand(N).astype(np.float32))
    inc = torch.as_tensor((rng.rand(N) < 0.9).astype(np.float32))
    leaf_id = torch.as_tensor(rng.randint(0, 4, N).astype(np.int32))
    sol = torch.tensor([0, 1, -1, 2, -1], dtype=torch.int32)
    scales = histogram_scales(g, h)
    args = (X, g, h, inc, leaf_id, sol, S, B)
    whole = build_histograms(*args, scales=scales, raw_output=True)
    tile, tiles = bin_tiles(B)
    assert tiles > 1
    tiled = build_histograms(*args, scales=scales, raw_output=True,
                             tile_bins=tile)
    assert torch.equal(whole, tiled)
    # every (row, feature) lands once: the counts sum to the rows
    assert int(whole[..., 2].sum()) == int(inc[sol[leaf_id.long()] >= 0]
                                           .sum()) * F
    # the wrapper on CPU tensors runs the plain version, codes >= 2**15 too
    out = build_histograms_cuda(*args, scales=scales)
    assert torch.equal(out, build_histograms(*args, scales=scales))


# ------------------------------------------------- whole models vs the JAX

@pytest.mark.parametrize("max_bin,n,code_dtype", [
    (16_383, 20_000, torch.int16), (40_000, 41_000, torch.int32)])
def test_wide_bin_model_text_equals_jax(max_bin, n, code_dtype):
    X, y = _wide_data(n)
    ours = _train_port(X, y, max_bin)
    g = ours._gbdt
    assert g.spec.num_bins_padded > MAX_BINS
    assert g.Xb.dtype == code_dtype
    assert int(g.Xb.max()) == g.train_set.max_num_bin - 1
    ref = lgb.train(_params(max_bin), lgb.Dataset(X, label=y),
                    num_boost_round=ROUNDS, fobj=_exact_fobj)
    assert ours.model_to_string() == ref.model_to_string()


def test_wide_bins_stream_ingest_and_valid_give_the_resident_text():
    """At 40,000 bins (``int32`` codes): streamed from host shards (``u16``
    shards widened on the device), binned on the device (B7) and with a
    valid set, each run gives the resident host-binned model text."""
    X, y = _wide_data(36_000, seed=1)
    base = _train_port(X, y, 40_000, rounds=2)
    text = base.model_to_string()
    assert base._gbdt.Xb.dtype == torch.int32
    st = _train_port(X, y, 40_000, rounds=2, tpu_residency="stream",
                     tpu_stream_shard_rows=8192)
    assert st._gbdt.residency == "stream"
    assert st.model_to_string() == text
    dv = _train_port(X.astype(np.float32), y, 40_000, rounds=2,
                     tpu_ingest="device")
    assert dv._gbdt._ingest_report is not None
    assert dv._gbdt.Xb.dtype == torch.int32
    assert torch.equal(dv._gbdt.Xb, base._gbdt.Xb)
    assert dv.model_to_string() == text
    va = _train_port(X, y, 40_000, rounds=2, valid=(X[:5000], y[:5000]))
    assert va.model_to_string() == text
    vs = va._gbdt.valid_sets[0]
    assert vs.Xb.dtype == torch.int32
    np.testing.assert_allclose(vs.score.numpy().reshape(-1),
                               va.predict(X[:5000], raw_score=True),
                               rtol=0, atol=1e-5)
