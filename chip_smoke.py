#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py [--trace DIR]

Phases (any failure exits non-zero and prints no result line):

1. card: ``nvidia-smi`` name and power limit;
2. build: compile ``lightgbm_tpu_torch/csrc/histogram.cu`` with nvcc
   (``-Xptxas -v``) and report the seconds;
3. kernel against its plain version at the slice's shapes (N=2,000,000
   rows, F=28, S=25 slots), in seven cases: ``full`` (25 slots holding every
   row, read through a leaf-contiguous partition: the grower's full wave),
   ``wrapper`` (the same histogram asked for without a partition: the
   wrapper derives the positions on the card), ``root`` (one slot, ``perm =
   arange``: the grower's first wave), ``compact`` (about 10% of the rows
   in 25 of 250 leaves), ``uint16`` (the ``full`` case with uint16 codes
   at B=512; B=256 elsewhere), ``f27`` (the ``full`` case with 27
   features, so that rows do not start on a 32-bit word) and ``sampled``
   (the ``full`` case on the sampled path's input: 80% of the rows in the
   bag with g = h = 0 outside it, a tenth of those with g and h scaled by
   8, as GOSS scales; required bit-equal). In each, counts
   must be equal, g/h within
   the stated tolerance (the two do the same fixed-point arithmetic, so they
   are expected bit-equal), and two launches bit-identical. Times (device
   time, see ``cuda_time_ms``): the kernel, the plain version, one
   ``torch.bincount`` computing the same histogram (timed only), and the
   memory bound. An eighth case, ``f137``, is ``full`` at 137 features
   (MS-LTR's width: four feature groups, rows off a 32-bit word), required
   bit-equal. A child process then feeds the kernel a bin code >= B and
   must see a device-side assert, not a silently dropped row;
4. main path at full width: a Higgs-shaped synthetic binary problem
   (2,000,000 x 28 f32, 5% NaN in two columns, a planted logit) through
   ``lgt.Dataset`` -> ``lgt.train`` (binary, 255 leaves, max_bin 255,
   lr 0.1, min_data_in_leaf 20, 10 rounds) -> ``Booster.predict`` ->
   ``model_to_string`` round trip, with the histogram kernel's launch count
   reset just before and read just after; a second training run on the
   same data must give the same model text byte for byte (determinism);
   the sha256 of the model text is printed, so that two trees can be
   compared on one card; then the same package on the CPU (every kernel's
   plain version) as the reference on a small input, with ``max_bin`` 255
   and with ``max_bin`` 511 (uint16 codes, which must launch the kernel);
5. profile: three more iterations of the second run timed on the host
   clock, three under ``torch.profiler`` (CPU + CUDA): wall time, device
   busy time and idle share, host time of each wave step (the
   ``wave.*`` ranges of ``grower.py``), CUDA launches per iteration, the
   histogram's device time (``hist_kernel`` and ``finalize_kernel``, and
   all memsets, one per pass among them), the check that the wrapper's
   launch count equals the passes in the profile, and the kernels that
   take the most device time.
   ``--trace DIR`` also writes the Chrome trace there;
6. the sampled and validated path at full width: phase 4's data and
   parameters plus the reference binary example's sampling
   (``feature_fraction=0.8, bagging_fraction=0.8, bagging_freq=5``), a
   500,000-row valid set (``higgs_like(500_000, SEED + 1)``), AUC and
   logloss every round, early stopping after 5, up to 40 rounds, with the
   kernel's launch count reset just before and read just after: ms per
   iteration, the share of valid scoring and eval, the valid AUC (held
   against ``Booster.predict``), the drawn bagging mask and a few
   ``prng.uniform`` draws bit-equal to the CPU's, the features allowed per
   tree, device operations of a resampling iteration beside the next one
   and of one draw, a second run with byte-identical model text; GOSS at
   full width (15 rounds: 10 of warm-up, then 5 sampled; its own launch
   count); the binary objective's gradients on the card against the CPU's;
   and four 20,000-row runs (bagging + valid set + early stopping, GOSS on
   L2, DART, RF) on the card against the same package on the CPU: the
   same splits, predictions within 1e-5, the same ``best_iteration``;
7. multiclass at full width: phase 4's features with labels from a planted
   5-class softmax, ``objective=multiclass, num_class=5``, phase 4's
   parameters, 5 rounds (25 trees) with a 500,000-row valid set and
   ``multi_logloss`` (must fall), B1's launches per tree, predictions that
   are probabilities, a second run with byte-identical model text, and
   ``multiclassova`` for 2 rounds;
8. categorical features at full width: the eight columns of the airline
   delay benchmark over the ASA Data Expo 2009 data (six of them
   categorical; Origin and Dest with 300 Zipf categories, so ``uint16``
   codes, ``int16`` on the card), 2,000,000 rows, binary, 10 rounds with a 500,000
   row valid set and AUC: the codes, how many splits are categorical, the
   device operations of the categorical scan of one wave, the valid AUC of
   ``Booster.predict`` (the host route for categorical forests) against the
   running valid score (within 1e-5), a second run byte-identical;
9. lambdarank at the MS-LTR shape (``bench.py``'s generator, copied):
   2,270,296 rows x 137 features in lognormal queries plus held-out
   queries, 255 leaves, ``min_data_in_leaf=100``, 5 rounds: ms per
   iteration, the gradient call's ms and device operations, valid
   ``ndcg@10`` (must rise), a second run byte-identical;
10. the card against the CPU at 20,000 rows for multiclass, multiclassova,
   categorical features (one column of 3 categories, so the one-hot mode
   runs), lambdarank, L1, Huber, Fair, Poisson, xentropy and xentlambda:
   the same splits and predictions within 1e-5, B1 launched; the cases in
   ``OBJECTIVE_ULP_CASES`` (ROADMAP C12) may differ only through the
   objective's arithmetic and must meet the bar with the CPU's gradients on
   both devices.

The card's line comes before the last two lines; the line before the last
is one JSON object describing every kernel of the path; the last line is
``{"ok": true, "device": {...}}``. The script needs one card, exits
non-zero without CUDA, and imports nothing of JAX or of ``lightgbm_tpu``.
"""
import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N, F, B, S = 2_000_000, 28, 256, 25
B16 = 512                          # the uint16 case: max_bin 511
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM f32, outside the tensor cores
# kernel vs plain version: the same fixed-point arithmetic, so g/h are
# expected bit-equal; the tolerance admits at most a last-bit difference of
# the f32 conversion (2^-22 relative to the largest |bin|)
REL_TOL = 2.0 ** -22
# about 25 ms of a spin kernel at the H100's clock: longer than the host
# takes to enqueue the timed calls of one measurement
SPIN_CYCLES = 50_000_000


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters, warmup=2):
    """Device ms per call of ``fn``: the card is held by a spin kernel while
    the host enqueues the calls, so that the events time the device and
    not the host's launch overhead (unless ``fn`` synchronises)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(mangled):
    """A readable name for a kernel of csrc/histogram.cu in ptxas output."""
    m = re.search(r"hist_kernelI([ht])Lb([01])E", mangled)
    if m:
        return (f"hist_kernel<{'uint8' if m.group(1) == 'h' else 'uint16'}, "
                f"{'aligned' if m.group(2) == '1' else 'unaligned'} rows>")
    return "finalize_kernel" if "finalize_kernel" in mangled else mangled


def card_line():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


CASES = ("full", "wrapper", "root", "compact", "uint16", "f27", "sampled",
         "f137")
F137 = 137                         # the MS-LTR width (phase 9)


def sampled_weights(g, h, gen):
    """The sampled path's input to the kernel: an 80% bagging mask, g = h =
    0 out of the bag, and a GOSS-like tenth of the in-bag rows with g and h
    scaled by 8."""
    import torch
    n = g.shape[0]
    inc = (torch.rand(n, generator=gen, device=g.device) < 0.8).float()
    goss = (torch.rand(n, generator=gen, device=g.device) < 0.1) & (inc > 0)
    w = torch.where(goss, 8.0, 1.0) * inc
    return g * w, h * w, inc


def _partition_kw(leaf_id, pending, num_leaves):
    """The grower's layout: rows grouped by leaf, ascending, and the pending
    leaves' segment tables."""
    import torch
    perm = torch.sort(leaf_id, stable=True).indices.to(torch.int32)
    counts = torch.bincount(leaf_id.long(), minlength=num_leaves)
    starts = torch.cumsum(counts, 0) - counts
    return dict(row_idx=perm, n_active=int(counts[pending].sum()),
                slot_counts=counts[pending].to(torch.int32).contiguous(),
                slot_starts=starts[pending].to(torch.int32).contiguous())


def case_inputs(name, dev, gen, X8):
    """(X, B, leaf_id, slot_of_leaf, kwargs) of one phase-3 case."""
    import torch
    L = 255
    slot_of_leaf = torch.full((L + 1,), -1, dtype=torch.int32, device=dev)
    if name == "root":
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        slot_of_leaf[0] = 0
        zeros = torch.zeros(S, dtype=torch.int32, device=dev)
        counts = zeros.clone()
        counts[0] = N
        kw = dict(row_idx=torch.arange(N, dtype=torch.int32, device=dev),
                  n_active=N, slot_counts=counts, slot_starts=zeros)
        return X8, B, leaf_id, slot_of_leaf, kw
    if name == "compact":
        # 250 leaves, the 25 pending ones hold ~10% of the rows
        leaf_id = torch.randint(0, 250, (N,), generator=gen, device=dev,
                                dtype=torch.int32)
        pending = torch.arange(0, 250, 10, device=dev)
        slot_of_leaf[pending] = torch.arange(S, dtype=torch.int32,
                                             device=dev)
        return X8, B, leaf_id, slot_of_leaf, _partition_kw(leaf_id, pending,
                                                           L + 1)
    # a wave whose 25 pending leaves hold every row
    leaf_id = torch.randint(0, S, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
    slot_of_leaf[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    kw = {} if name == "wrapper" else _partition_kw(
        leaf_id, torch.arange(S, device=dev), L + 1)
    if name == "uint16":
        X16 = torch.randint(0, B16, (N, F), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int16)
        return X16, B16, leaf_id, slot_of_leaf, kw
    if name == "f27":
        X27 = torch.randint(0, B, (N, F - 1), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
        return X27, B, leaf_id, slot_of_leaf, kw
    if name == "f137":
        X137 = torch.randint(0, B, (N, F137), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)
        return X137, B, leaf_id, slot_of_leaf, kw
    return X8, B, leaf_id, slot_of_leaf, kw


def kernel_phase(dev):
    """Phase 3: the histogram kernel against its plain version."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                                  histogram_scales, pass_rows)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X8 = torch.randint(0, B, (N, F), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    g = torch.randn(N, generator=gen, device=dev)
    h = torch.rand(N, generator=gen, device=dev) * 0.25
    ones = torch.ones(N, device=dev)
    results = {}
    for name in CASES:
        X, nb, leaf_id, slot_of_leaf, kw = case_inputs(name, dev, gen, X8)
        nf = X.shape[1]
        gw, hw, inc = sampled_weights(g, h, gen) if name == "sampled" \
            else (g, h, ones)
        scales = histogram_scales(gw, hw)
        args = (X, gw, hw, inc, leaf_id, slot_of_leaf, S, nb)
        plain = build_histograms(*args, scales=scales, **kw)
        before = build_histograms_cuda.launches
        out1 = build_histograms_cuda(*args, scales=scales, **kw)
        out2 = build_histograms_cuda(*args, scales=scales, **kw)
        torch.cuda.synchronize()
        if build_histograms_cuda.launches != before + 2:
            fail("the kernel wrapper did not count its launches")
        identical = bool(torch.equal(out1, out2))
        counts_equal = bool(torch.equal(out1[..., 2], plain[..., 2]))
        max_abs = float((out1[..., :2] - plain[..., :2]).abs().max())
        max_rel = max_abs / max(float(plain[..., :2].abs().max()), 1e-30)
        bit_equal = bool(torch.equal(out1, plain))
        print(f"  {name}: counts equal {counts_equal}, g/h max abs err "
              f"{max_abs:.3e}, max rel err {max_rel:.3e} (tol "
              f"{REL_TOL:.3e}), bit-equal to plain {bit_equal}, two "
              f"launches identical {identical}", flush=True)
        if not counts_equal:
            fail(f"{name}: counts differ from the plain version")
        if max_rel > REL_TOL:
            fail(f"{name}: g/h error {max_rel:.3e} above {REL_TOL:.3e}")
        if not identical:
            fail(f"{name}: two launches differ (not deterministic)")
        if name in ("sampled", "f137") and not bit_equal:
            fail(f"{name}: the kernel is not bit-equal to the plain version")
        if not bool(torch.isfinite(out1).all()):
            fail(f"{name}: non-finite histogram")
        del out1, out2
        ms = cuda_time_ms(
            lambda: build_histograms_cuda(*args, scales=scales, **kw), 20)
        plain_ms = cuda_time_ms(
            lambda: build_histograms(*args, scales=scales, **kw), 3, 1)
        # one PyTorch call computing the same (f32 atomics) histogram over a
        # precomputed flat (slot, feature, bin, channel) index
        rows, slot = pass_rows(leaf_id, slot_of_leaf, kw.get("row_idx"),
                               kw.get("n_active"), kw.get("slot_counts"),
                               kw.get("slot_starts"))
        feat = torch.arange(nf, device=dev)
        flat = ((slot[:, None] * nf + feat[None, :]) * nb
                + X[rows].long()).reshape(-1)
        flat3 = (flat[:, None] * 3 + torch.arange(3, device=dev)).reshape(-1)
        del flat
        w3 = torch.stack([gw[rows], hw[rows], inc[rows]], dim=-1)
        w3 = w3[:, None, :].expand(-1, nf, -1).reshape(-1).contiguous()
        lib_ms = cuda_time_ms(
            lambda: torch.bincount(flat3, weights=w3,
                                   minlength=S * nf * nb * 3), 5, 1)
        del flat3, w3
        n_rows = int(rows.numel())
        # each input byte the function needs, read once: codes and g/h/inc
        # of every row of the pass, plus its position (perm) or, without a
        # partition, every row's leaf id; the output written once
        row_bytes = nf * X.element_size() + 3 * 4
        where_bytes = N * 4 + (255 + 1) * 4 if name == "wrapper" \
            else n_rows * 4 + 2 * S * 4
        nbytes = n_rows * row_bytes + where_bytes + S * nf * nb * 3 * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 3.0 * n_rows * nf / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  {name} pass over {n_rows} rows (F={nf}, B={nb}): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, torch.bincount "
              f"{lib_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
              f"{bound_ms / ms * 100:.1f}% of the bound", flush=True)
        results[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            max_abs_err=max_abs, max_rel_err=max_rel, bit_equal=bit_equal,
            rows=n_rows, num_features=nf, num_bins=nb)
        del plain, rows, slot, X, leaf_id, kw, args, gw, hw, inc
        torch.cuda.empty_cache()
    malformed_input_check()
    return results


_MALFORMED_CHILD = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
dev = torch.device("cuda", 0)
n, f, s, b = 4096, 4, 2, 32
X = torch.randint(0, b, (n, f), device=dev, dtype=torch.int32).to(torch.uint8)
X[100, 2] = b
ones = torch.ones(n, device=dev)
leaf = torch.zeros(n, dtype=torch.int32, device=dev)
sol = torch.tensor([0, 1], dtype=torch.int32, device=dev)
try:
    build_histograms_cuda(X, ones, ones, ones, leaf, sol, s, b)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("device-side assert" in str(e), str(e).splitlines()[0])
    sys.exit(0 if "device-side assert" in str(e) else 1)
print("no error")
sys.exit(1)
"""


def malformed_input_check():
    """A bin code >= B must fail the kernel's device assert (in a child
    process: an assert leaves its CUDA context unusable)."""
    proc = subprocess.run([sys.executable, "-c", _MALFORMED_CHILD, HERE],
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout.strip()
    print(f"  bin code >= B in a child process: exit {proc.returncode}, "
          f"{out}", flush=True)
    if proc.returncode != 0:
        fail(f"the kernel did not assert on a bin code >= B: {out} "
             f"{proc.stderr.strip()[-500:]}")


def higgs_like(n, seed):
    """Higgs-shaped synthetic binary data: 28 dense f32 features (21
    low-level kinematic-like, 7 derived), 5% NaN in two columns, labels from
    a planted logit."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = np.empty((n, F), np.float32)
    X[:, :14] = rng.standard_normal((n, 14), dtype=np.float32)
    X[:, 14:21] = rng.exponential(1.0, (n, 7)).astype(np.float32)
    X[:, 21:] = (X[:, :7] * X[:, 14:21]
                 + 0.3 * rng.standard_normal((n, 7), dtype=np.float32))
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 3] + 0.6 * X[:, 21] * X[:, 1]
             + 0.5 * np.log1p(X[:, 15]) - 0.4 * np.abs(X[:, 5]) + 0.2)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    for col in (0, 22):
        X[rng.random(n) < 0.05, col] = np.nan
    return X, y


def auc_of(pred, y):
    """The package's own AUC metric of predictions ``pred`` for labels y."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.metrics import AUCMetric
    metric = AUCMetric(lgt.Config.from_params({"metric": "auc"}))
    meta = Metadata(len(y))
    meta.set_label(y)
    metric.init(meta, len(y))
    return metric.eval(pred[None, :])[0][1]


def same_trees(a, b):
    """Two boosters grew the same split features and thresholds."""
    import numpy as np
    return len(a.trees) == len(b.trees) and all(
        np.array_equal(ta.split_feature, tb.split_feature)
        and np.array_equal(ta.threshold, tb.threshold)
        for ta, tb in zip(a.trees, b.trees))


MAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}


def main_path_phase():
    """Phase 4: the port's main path at full width on the card."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda

    X, y = higgs_like(N, SEED)
    params = dict(MAIN_PARAMS)
    rounds = 10
    build_histograms_cuda.launches = 0          # the main path starts here
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params(params))
    t1 = time.perf_counter()
    bst = lgt.train(params, ds, num_boost_round=rounds)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pred = bst.predict(X)
    t3 = time.perf_counter()
    text = bst.model_to_string()
    launches = build_histograms_cuda.launches   # ... and ends here
    ms_per_iter = (t2 - t1) / rounds * 1e3
    digest = hashlib.sha256(text.encode()).hexdigest()
    auc = auc_of(pred, y)
    leaves = [t.num_leaves for t in bst.trees]
    print(f"  host binning {t1 - t0:.2f} s; train {t2 - t1:.3f} s for "
          f"{rounds} rounds = {ms_per_iter:.1f} ms per iteration; "
          f"predict {(t3 - t2) * 1e3:.1f} ms; leaves per tree {leaves}",
          flush=True)
    print(f"  histogram kernel launches on the main path: {launches}; "
          f"train AUC {auc:.5f}; predictions finite "
          f"{bool(np.isfinite(pred).all())}, shape {pred.shape}", flush=True)
    if launches <= 0:
        fail("the main path never launched the histogram kernel")
    if pred.shape != (N,) or not np.isfinite(pred).all():
        fail("predictions are not finite of shape (N,)")
    if not auc > 0.6:
        fail(f"train AUC {auc} not above 0.6")
    if len(bst.trees) != rounds or min(leaves) < 2:
        fail("training did not grow the expected trees")
    reloaded = lgt.Booster(model_str=text)
    # a loaded model has no bin mappers (feature_infos read "none"); every
    # tree must come back byte for byte
    if reloaded.model_to_string().split("Tree=0")[1] != text.split("Tree=0")[1]:
        fail("model text does not round-trip")
    if not np.array_equal(reloaded.predict(X), pred):
        fail("the reloaded model predicts differently")
    print("  model_to_string round trip: reloaded model predicts the same",
          flush=True)
    print(f"  model text sha256 {digest}", flush=True)
    # the same training run again: bit-identical model text (the histogram's
    # fixed-point sums are order-free); kept training for the profile phase
    again = lgt.train(params, ds, num_boost_round=rounds,
                      keep_training_booster=True)
    same_text = again.model_to_string() == text
    print(f"  second training run, same data and params: identical model "
          f"text {same_text}", flush=True)
    if not same_text:
        fail("two training runs on the same data gave different models")

    # reference on a small input: the same package on the CPU, where every
    # kernel runs its plain version; max_bin 511 gives uint16 codes
    Xs, ys = X[:20000], y[:20000]
    for max_bin in (255, 511):
        small = dict(params, num_leaves=63, max_bin=max_bin)
        before = build_histograms_cuda.launches
        cuda_bst = lgt.train(small, lgt.Dataset(Xs, label=ys),
                             num_boost_round=5, keep_training_booster=True)
        small_launches = build_histograms_cuda.launches - before
        codes = cuda_bst._gbdt.Xb.dtype
        cpu_bst = lgt.train(dict(small, device="cpu"),
                            lgt.Dataset(Xs, label=ys), num_boost_round=5)
        same_splits = same_trees(cuda_bst, cpu_bst)
        pdiff = float(np.abs(cuda_bst.predict(Xs)
                             - cpu_bst.predict(Xs)).max())
        print(f"  small input (20000 rows, 63 leaves, 5 rounds, max_bin "
              f"{max_bin}: {codes} codes on the card) CUDA vs CPU: "
              f"histogram kernel launches {small_launches}, same splits "
              f"{same_splits}, max prediction diff {pdiff:.3e} (tol 1e-5), "
              f"identical text "
              f"{cuda_bst.model_to_string() == cpu_bst.model_to_string()}",
              flush=True)
        if not same_splits or not pdiff <= 1e-5:
            fail(f"max_bin {max_bin}: the CUDA run disagrees with the CPU "
                 "reference")
        if small_launches <= 0:
            fail(f"max_bin {max_bin}: the histogram kernel never launched")
        if (max_bin > 255) != (codes == torch.int16):
            fail(f"max_bin {max_bin}: {codes} codes on the card")
    return dict(launches=launches, ms_per_iter=ms_per_iter, auc=auc,
                booster=again, data=(ds, X, y))


# the profiler ranges grower.py opens around each wave step
RANGES = ("wave.histogram", "wave.split", "wave.route", "wave.partition")
# the kernels of csrc/histogram.cu; each pass also memsets its accumulators,
# among the other memsets of the path
HIST_KERNELS = ("hist_kernel", "finalize_kernel")


def dev_us(e):
    """Device microseconds of a profiler event."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(events):
    """The profiler events of device work (the wave ranges also carry
    device spans)."""
    import torch
    return [e for e in events if dev_us(e) > 0 and e.key not in RANGES
            and e.device_type == torch.autograd.DeviceType.CUDA]


def profile_phase(booster, trace_dir, iters=3):
    """Phase 5: where a steady-state iteration spends its time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    gbdt = booster._gbdt
    walls = []                          # host clock, profiler off
    for _ in range(iters):
        t0 = time.perf_counter()
        gbdt.train_one_iter()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof_walls = []                     # the same, profiled
    launches = build_histograms_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(iters):
            t0 = time.perf_counter()
            gbdt.train_one_iter()
            torch.cuda.synchronize()
            prof_walls.append(time.perf_counter() - t0)
    launches = build_histograms_cuda.launches - launches
    wall_ms = sum(walls) / iters * 1e3
    prof_ms = sum(prof_walls) / iters * 1e3
    events = prof.key_averages()
    kernels = device_kernels(events)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / iters
    n_kernels = sum(e.count for e in kernels) / iters
    hist = [e for e in kernels if any(k in e.key for k in HIST_KERNELS)]
    hist_ms = sum(dev_us(e) for e in hist) / 1e3 / iters
    memsets = [e for e in kernels if "Memset" in e.key]
    memset_ms = sum(dev_us(e) for e in memsets) / 1e3 / iters
    n_memsets = sum(e.count for e in memsets) / iters
    print(f"  iteration wall {wall_ms:.2f} ms (per iteration: "
          f"{', '.join(f'{w * 1e3:.2f}' for w in walls)}); profiled "
          f"{prof_ms:.2f} ms, of which the device was busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / prof_ms:.3f}); {n_kernels:.0f} "
          f"device operations per iteration", flush=True)
    print(f"  histogram passes: {hist_ms:.3f} ms device per iteration "
          f"({hist_ms / busy_ms * 100:.1f}% of busy) in "
          + ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3 / iters:.3f} ms x "
                      f"{e.count / iters:.0f}" for e in hist)
          + f"; plus one memset each, among all memsets {memset_ms:.3f} ms x "
          f"{n_memsets:.0f}", flush=True)
    for name in RANGES:
        e = [e for e in events if e.key == name and e.cpu_time_total > 0]
        if e:
            print(f"  {name}: {e[0].cpu_time_total / 1e3 / iters:.2f} ms "
                  f"host per iteration over {e[0].count // iters} waves",
                  flush=True)
    print("  top device operations (ms per iteration, count per iteration):",
          flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(e) / 1e3 / iters:8.3f} ms  {e.count / iters:6.0f}  "
              f"{e.key[:90]}", flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "chip_smoke_trace.json")
        prof.export_chrome_trace(path)
        print(f"  trace: {path}", flush=True)
    if not hist:
        fail("the profile shows no histogram kernel on the device")
    # every pass the wrapper counted ran finalize_kernel on the card, and
    # no pass ran anywhere else
    passes = sum(e.count for e in hist if "finalize_kernel" in e.key)
    print(f"  wrapper launches in the profiled iterations: {launches}; "
          f"finalize_kernel launches in the profile: {passes}", flush=True)
    if launches != passes:
        fail("the wrapper's launch count differs from the passes in the "
             "profile")

NV = 500_000                       # phase 6's valid rows
SAMPLED_PARAMS = dict(MAIN_PARAMS, feature_fraction=0.8, bagging_fraction=0.8,
                      bagging_freq=5, metric=["auc", "binary_logloss"])
SAMPLED_ROUNDS, SAMPLED_STOP = 40, 5
GOSS_ROUNDS = 15                   # 10 warm-up rounds at lr 0.1, then 5


class IterClock:
    """An after-iteration callback: the host clock after the card has
    finished each iteration (train step, valid scoring and eval)."""

    def __init__(self):
        self.stamps = [time.perf_counter()]

    def __call__(self, env):
        import torch
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def ms(self, lo=0, hi=None):
        """Mean ms of iterations ``lo`` to ``hi`` (exclusive)."""
        d = [b - a for a, b in zip(self.stamps, self.stamps[1:])][lo:hi]
        return sum(d) / len(d) * 1e3


def device_ops(fn):
    """(device operations, kernel launches, device ms) of one call of
    ``fn`` under ``torch.profiler``: the device's events, and the host's
    ``cudaLaunchKernel`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = device_kernels(events)
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    return (sum(e.count for e in ops), launches,
            sum(dev_us(e) for e in ops) / 1e3)


def sync_ms(fn, iters=3):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def gradient_agreement(y, dev):
    """How far the binary objective's g and h on the card are from the
    CPU's for the same f32 scores (the two ``exp`` may round apart)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    obj = create_objective(lgt.Config.from_params(MAIN_PARAMS))
    meta = Metadata(len(y))
    meta.set_label(y)
    obj.init(meta, len(y))
    score = torch.randn(len(y), generator=torch.Generator().manual_seed(SEED))
    label = torch.as_tensor(y, dtype=torch.float32)
    on_cpu = obj.gradients(score, label, None)
    on_card = obj.gradients(score.to(dev), label.to(dev), None)
    for name, a, b in zip("gh", on_cpu, on_card):
        ulp = (a.view(torch.int32) - b.cpu().view(torch.int32)).abs()
        print(f"  binary {name} on {len(y)} random scores, card vs CPU: "
              f"{int((ulp > 0).sum())} values differ, by at most "
              f"{int(ulp.max())} ulp", flush=True)


def sampled_phase(ds, X, y, dev):
    """Phase 6: the sampled and validated path at full width."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    from lightgbm_tpu_torch.utils import prng

    Xv, yv = higgs_like(NV, SEED + 1)
    params = dict(SAMPLED_PARAMS)
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    evals = {}
    clock = IterClock()
    build_histograms_cuda.launches = 0          # the sampled path starts here
    bst = lgt.train(params, ds, num_boost_round=SAMPLED_ROUNDS,
                    valid_sets=[dv], valid_names=["valid"],
                    early_stopping_rounds=SAMPLED_STOP, evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = build_histograms_cuda.launches   # ... and ends here
    gbdt = bst._gbdt
    n_iter = gbdt.iter_
    best = bst.best_iteration
    aucs = evals["valid"]["auc"]
    best_auc = aucs[(best or n_iter) - 1]
    ms_iter = clock.ms(1)
    text = bst.model_to_string()
    vs = gbdt.valid_sets[0]
    walk_ms = sync_ms(lambda: gbdt._tree_contrib(gbdt.models[-1][0], vs.Xb))
    eval_ms = sync_ms(lambda: gbdt.eval_all())
    mask_mean = float(gbdt.bag_mask.mean())
    print(f"  train {n_iter} rounds (early stopping after {SAMPLED_STOP}): "
          f"first iteration {clock.ms(0, 1):.1f} ms, then {ms_iter:.2f} ms "
          f"per iteration; valid scoring {walk_ms:.2f} ms + eval "
          f"{eval_ms:.2f} ms = {(walk_ms + eval_ms) / ms_iter * 100:.1f}% "
          f"of an iteration", flush=True)
    stopped = f"best_iteration {best}" if best else \
        f"early stopping did not fire, all {n_iter} rounds kept"
    print(f"  histogram kernel launches on the sampled path: {launches}; "
          f"{stopped}; valid AUC there {best_auc:.5f} (after round 1 "
          f"{aucs[0]:.5f})", flush=True)
    if launches <= 0:
        fail("the sampled path never launched the histogram kernel")
    if not best_auc > 0.6 or not all(np.isfinite(aucs)):
        fail(f"valid AUC {best_auc} not above 0.6")
    vpred = bst.predict(Xv, num_iteration=best or n_iter)
    vauc = auc_of(vpred, yv)
    print(f"  valid AUC of Booster.predict at that iteration {vauc:.6f} "
          f"(the running valid score's {best_auc:.6f}, tol 1e-5)", flush=True)
    if vpred.shape != (NV,) or not np.isfinite(vpred).all() \
            or not abs(vauc - best_auc) <= 1e-5:
        fail("the valid set's predictions disagree with its running score")

    # the draws: the last bagging mask and a few uniform draws, card vs CPU
    last = n_iter - 1
    it0 = last - last % params["bagging_freq"]
    base = prng.prng_key(gbdt.config.seed or gbdt.config.bagging_seed)
    bkey, fkey = prng.split(prng.fold_in(prng.fold_in(base, it0), 0))
    cpu_mask = (prng.uniform(bkey, N) < torch.tensor(0.8)).float()
    mask_equal = bool(torch.equal(gbdt.bag_mask.cpu(), cpu_mask))
    draws_equal = True
    for seed, it in ((0, 0), (3, 7), (SEED, 39)):
        key = prng.fold_in(prng.prng_key(seed), it)
        for n in (N, F):
            draws_equal &= bool(torch.equal(
                prng.uniform(key, n, dev).cpu().view(torch.int32),
                prng.uniform(key, n).view(torch.int32)))
    _, fkey_last = prng.split(prng.fold_in(prng.fold_in(base, last), 0))
    n_feat = int(gbdt._feature_mask(fkey_last, 0).sum())
    print(f"  bagging mask of iteration {last} (drawn at {it0}): mean "
          f"{mask_mean:.6f}, bit-equal to the CPU's draw {mask_equal}; "
          f"uniform draws at N={N} and F={F} for (seed, it) in (0, 0), "
          f"(3, 7), ({SEED}, 39) bit-equal card vs CPU {draws_equal}; "
          f"features allowed per tree {n_feat} of {F} "
          f"(n_feature_sample {gbdt.n_feature_sample})", flush=True)
    if not (mask_equal and draws_equal):
        fail("the card's random draws differ from the CPU's")
    if n_feat != round(0.8 * F) or not 0.79 < mask_mean < 0.81:
        fail("the sampled fractions are off")

    # launches: one resampling iteration beside one that keeps the mask
    while gbdt.iter_ % params["bagging_freq"]:
        gbdt.train_one_iter()
    resample = device_ops(gbdt.train_one_iter)
    keep = device_ops(gbdt.train_one_iter)
    frac = torch.tensor(0.8, device=dev)
    draw = device_ops(lambda: (prng.uniform(bkey, N, dev) < frac).float())
    fdraw = device_ops(lambda: gbdt._feature_mask(fkey, 0))
    print(f"  device operations (kernel launches): resampling iteration "
          f"{resample[0]} ({resample[1]}, {resample[2]:.2f} ms busy), next "
          f"iteration {keep[0]} ({keep[1]}, {keep[2]:.2f} ms busy); one "
          f"bagging draw over {N} rows {draw[0]} ({draw[1]}, {draw[2]:.3f} "
          f"ms), one feature mask {fdraw[0]} ({fdraw[1]}, {fdraw[2]:.3f} "
          f"ms)", flush=True)
    del bst, gbdt, vs
    torch.cuda.empty_cache()

    # determinism: the same sampled run again, byte-identical model text
    again = lgt.train(params, ds, num_boost_round=SAMPLED_ROUNDS,
                      valid_sets=[dv], valid_names=["valid"],
                      early_stopping_rounds=SAMPLED_STOP, verbose_eval=False)
    again_text = again.model_to_string()
    digest = hashlib.sha256(text.encode()).hexdigest()
    print(f"  second sampled run: best_iteration {again.best_iteration}, "
          f"identical model text {again_text == text}; sampled model text "
          f"sha256 {digest}", flush=True)
    if again_text != text or again.best_iteration != best:
        fail("two sampled runs on the same data gave different models")
    del again, dv
    torch.cuda.empty_cache()

    # GOSS at full width: 10 warm-up rounds, then 5 sampled
    clock = IterClock()
    build_histograms_cuda.launches = 0          # GOSS starts here
    goss = lgt.train(dict(MAIN_PARAMS, boosting="goss"), ds,
                     num_boost_round=GOSS_ROUNDS, callbacks=[clock])
    goss_launches = build_histograms_cuda.launches   # ... and ends here
    warm = int(1.0 / MAIN_PARAMS["learning_rate"])
    gpred = goss.predict(X[:100_000])
    print(f"  GOSS {GOSS_ROUNDS} rounds: {clock.ms(1, warm):.2f} ms per "
          f"iteration in the warm-up, {clock.ms(warm):.2f} ms after it; "
          f"histogram kernel launches {goss_launches}; train AUC on the "
          f"first 100000 rows {auc_of(gpred, y[:100_000]):.5f}", flush=True)
    if goss_launches <= 0 or len(goss.trees) != GOSS_ROUNDS \
            or not np.isfinite(gpred).all():
        fail("GOSS at full width did not train")
    del goss
    torch.cuda.empty_cache()

    # the card against the CPU at 20000 rows, the same package on both
    Xs, ys = X[:20000], y[:20000]
    gradient_agreement(ys, dev)
    small = dict(MAIN_PARAMS, num_leaves=63)
    cases = {           # name: (params, early_stopping_rounds)
        "bagging+feature_fraction+valid+early stopping": (dict(
            small, feature_fraction=0.8, bagging_fraction=0.8,
            bagging_freq=5, metric=["auc", "binary_logloss"]), 1),
        "goss regression": (dict(small, objective="regression",
                                 boosting="goss", learning_rate=0.25), None),
        "dart": (dict(small, boosting="dart", drop_rate=0.3,
                      skip_drop=0.2), None),
        "rf": (dict(small, boosting="rf", bagging_fraction=0.8,
                    bagging_freq=1), None),
    }
    small_launches = 0
    for name, (p, stop) in cases.items():
        def run(device_params):
            d = lgt.Dataset(Xs, label=ys)
            v = lgt.Dataset(Xv[:5000], label=yv[:5000], reference=d)
            return lgt.train(dict(p, **device_params), d, num_boost_round=8,
                             valid_sets=[v], early_stopping_rounds=stop,
                             verbose_eval=False)
        before = build_histograms_cuda.launches
        on_card = run({})
        small_launches += build_histograms_cuda.launches - before
        on_cpu = run({"device": "cpu"})
        splits = same_trees(on_card, on_cpu)
        pdiff = float(np.abs(on_card.predict(Xs) - on_cpu.predict(Xs)).max())
        print(f"  20000 rows, {name}: same splits {splits} "
              f"({len(on_card.trees)} trees), max prediction diff "
              f"{pdiff:.3e} (tol 1e-5), best_iteration card "
              f"{on_card.best_iteration} cpu {on_cpu.best_iteration}",
              flush=True)
        if not splits or not pdiff <= 1e-5 \
                or on_card.best_iteration != on_cpu.best_iteration:
            fail(f"20000 rows, {name}: the card disagrees with the CPU")
    if small_launches <= 0:
        fail("the 20000-row runs never launched the histogram kernel")
    return dict(launches=launches, goss_launches=goss_launches,
                ms_per_iter=ms_iter)


NUM_CLASS = 5                      # phase 7, as the reference multiclass example
MULTI_ROUNDS = 5
CAT_ROUNDS = 10
RANK_ROWS, RANK_HOLD = 2_270_296, 227_029    # phase 9: bench.py's MS-LTR cut
RANK_ROUNDS = 5
SMALL = 20_000                     # phase 10's rows


def multiclass_like(n, seed):
    """Phase 4's features with labels drawn from a planted 5-class softmax."""
    import numpy as np
    X, _ = higgs_like(n, seed)
    rng = np.random.default_rng(seed + 100)
    Z = np.nan_to_num(X)
    logits = np.stack([1.2 * Z[:, 0], Z[:, 1] - 0.8 * Z[:, 3],
                       0.7 * Z[:, 21] * Z[:, 2], 0.9 * np.log1p(Z[:, 15]),
                       -0.6 * np.abs(Z[:, 5])], axis=1)
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    u = rng.random((n, 1))
    y = np.minimum((u > np.cumsum(p, axis=1)).sum(axis=1), NUM_CLASS - 1)
    return X, y.astype(np.float32)


def _zipf_choice(rng, k, n, a=1.1):
    """``n`` draws of ``k`` categories with Zipf weights 1 / rank^a."""
    import numpy as np
    p = 1.0 / np.arange(1, k + 1) ** a
    return rng.choice(k, size=n, p=p / p.sum())


def expo_like(n, seed):
    """The eight columns of the public airline-delay benchmark over the ASA
    Data Expo 2009 data: Month (12), DayofMonth (31), DayOfWeek (7),
    UniqueCarrier (22), Origin and Dest (300 each, Zipf), DepTime (hhmm)
    and Distance (miles); label: departure delay above 15 minutes, from a
    planted logit with an effect per category. The effects are the same
    for every ``seed`` (train and valid sets share one model); the rows
    differ."""
    import numpy as np
    rng = np.random.default_rng(seed)
    effects = np.random.default_rng(SEED)
    month = rng.integers(0, 12, n)
    dom = rng.integers(0, 31, n)
    dow = rng.integers(0, 7, n)
    carrier = _zipf_choice(rng, 22, n, 0.8)
    origin = _zipf_choice(rng, 300, n)
    dest = _zipf_choice(rng, 300, n)
    hour = np.clip(rng.normal(13.0, 4.5, n), 0, 23).astype(np.int64)
    dep = (hour * 100 + rng.integers(0, 60, n)).astype(np.float64)
    dist = np.clip(rng.lognormal(6.4, 0.6, n), 30, 4962).round()
    eff = {k: effects.normal(0.0, s, m) for k, s, m in
           (("month", 0.4, 12), ("dow", 0.3, 7), ("carrier", 0.6, 22),
            ("origin", 0.8, 300), ("dest", 0.7, 300))}
    logit = (eff["month"][month] + eff["dow"][dow] + eff["carrier"][carrier]
             + eff["origin"][origin] + eff["dest"][dest]
             + 0.15 * (hour - 13) - 1.3)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X = np.stack([month, dom, dow, carrier, origin, dest, dep, dist],
                 axis=1).astype(np.float32)
    return X, y


EXPO_CATEGORICAL = [0, 1, 2, 3, 4, 5]


def msltr_like(n_rows, n_features=F137, seed=1, avg_query=120):
    """MS-LTR-shaped ranking data, as ``bench.py``'s ``_msltr_like``
    generates it: lognormal query sizes (~120 documents), graded 0-4
    labels from a noisy latent relevance."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sizes = []
    total = 0
    while total < n_rows:
        q = max(8, int(rng.lognormal(np.log(avg_query), 0.6)))
        q = min(q, n_rows - total) if n_rows - total < 8 else q
        sizes.append(q)
        total += q
    sizes[-1] -= total - n_rows
    X = rng.rand(n_rows, n_features).astype(np.float32)
    latent = (X[:, 0] * 3 + X[:, 1] * X[:, 2] * 2 - X[:, 3]
              + np.square(X[:, 4]) * 1.5
              + rng.randn(n_rows).astype(np.float32) * 0.8)
    qs = np.quantile(latent, [0.55, 0.75, 0.9, 0.97])
    y = np.searchsorted(qs, latent).astype(np.float32)
    return X, y, np.array(sizes, dtype=np.int32)


def split_queries(sizes, n_rows):
    """(train queries, train rows): the queries that fit in ``n_rows``."""
    import numpy as np
    cum = np.cumsum(sizes)
    nq = int(np.searchsorted(cum, n_rows, side="right"))
    return nq, int(cum[nq - 1])


def text_digest(text):
    return hashlib.sha256(text.encode()).hexdigest()


def multiclass_phase():
    """Phase 7: multiclass (5 trees per iteration) at full width."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    X, y = multiclass_like(N, SEED + 7)
    Xv, yv = multiclass_like(NV, SEED + 8)
    params = dict(MAIN_PARAMS, objective="multiclass", num_class=NUM_CLASS,
                  metric="multi_logloss")
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    evals, clock = {}, IterClock()
    build_histograms_cuda.launches = 0          # the multiclass path starts
    bst = lgt.train(params, ds, num_boost_round=MULTI_ROUNDS,
                    valid_sets=[dv], valid_names=["valid"],
                    evals_result=evals, verbose_eval=False, callbacks=[clock])
    launches = build_histograms_cuda.launches   # ... and ends here
    text = bst.model_to_string()
    n_trees = len(bst.trees)
    losses = evals["valid"]["multi_logloss"]
    t0 = time.perf_counter()
    prob = bst.predict(Xv)
    pred_ms = (time.perf_counter() - t0) * 1e3
    print(f"  train {MULTI_ROUNDS} rounds = {n_trees} trees: first "
          f"iteration {clock.ms(0, 1):.1f} ms, then {clock.ms(1):.1f} ms "
          f"per iteration (5 trees, valid scoring and multi_logloss "
          f"included); histogram kernel launches {launches} = "
          f"{launches / max(n_trees, 1):.1f} passes per tree", flush=True)
    print(f"  valid multi_logloss by round "
          f"{', '.join(f'{v:.6f}' for v in losses)}; Booster.predict on "
          f"{NV} rows {pred_ms:.1f} ms, shape {prob.shape}, rows sum to 1 "
          f"within {float(np.abs(prob.sum(axis=1) - 1).max()):.2e}",
          flush=True)
    if launches <= 0 or n_trees != NUM_CLASS * MULTI_ROUNDS:
        fail("multiclass: the path did not launch the kernel or grow "
             f"{NUM_CLASS} trees per round")
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        fail("multiclass: the valid multi_logloss did not fall")
    if prob.shape != (NV, NUM_CLASS) or not np.isfinite(prob).all() \
            or float(np.abs(prob.sum(axis=1) - 1).max()) > 1e-6:
        fail("multiclass: predictions are not probabilities over 5 classes")
    again = lgt.train(params, ds, num_boost_round=MULTI_ROUNDS)
    same = again.model_to_string() == text
    print(f"  second run: identical model text {same}; sha256 "
          f"{text_digest(text)}", flush=True)
    if not same:
        fail("multiclass: two runs gave different models")
    del bst, again
    torch.cuda.empty_cache()
    ova = dict(params, objective="multiclassova")
    before = build_histograms_cuda.launches
    clock = IterClock()
    ova_bst = lgt.train(ova, ds, num_boost_round=2, callbacks=[clock])
    ova_launches = build_histograms_cuda.launches - before
    ova_prob = ova_bst.predict(Xv[:100_000])
    print(f"  multiclassova 2 rounds: {len(ova_bst.trees)} trees, "
          f"{clock.ms(0):.1f} ms per iteration, histogram kernel launches "
          f"{ova_launches}, predictions finite "
          f"{bool(np.isfinite(ova_prob).all())}", flush=True)
    if ova_launches <= 0 or len(ova_bst.trees) != 2 * NUM_CLASS \
            or ova_prob.shape != (100_000, NUM_CLASS) \
            or not np.isfinite(ova_prob).all():
        fail("multiclassova did not train")
    del ova_bst, ds, dv
    torch.cuda.empty_cache()
    return dict(launches=launches + ova_launches, ms_per_iter=clock.ms(0))


def categorical_phase(dev):
    """Phase 8: categorical features (uint16 codes) at full width."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.categorical import \
        per_feature_best_categorical
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    X, y = expo_like(N, SEED + 9)
    Xv, yv = expo_like(NV, SEED + 10)
    params = dict(MAIN_PARAMS, metric="auc")
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, categorical_feature=EXPO_CATEGORICAL)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    bin_s = time.perf_counter() - t0
    evals, clock = {}, IterClock()
    build_histograms_cuda.launches = 0          # the categorical path starts
    bst = lgt.train(params, ds, num_boost_round=CAT_ROUNDS, valid_sets=[dv],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = build_histograms_cuda.launches   # ... and ends here
    gbdt = bst._gbdt
    codes = gbdt.Xb.dtype
    nbins = gbdt.num_bins.cpu().tolist()
    text = bst.model_to_string()
    n_cat = sum(int((np.asarray(t.decision_type) & 1).sum())
                for t in bst.trees)
    n_split = sum(t.num_internal for t in bst.trees)
    aucs = evals["valid"]["auc"]
    print(f"  host binning {bin_s:.2f} s; codes on the card {codes}, bins "
          f"per feature {nbins} (padded to {gbdt.spec.num_bins_padded}); "
          f"train {CAT_ROUNDS} rounds: first iteration "
          f"{clock.ms(0, 1):.1f} ms, then {clock.ms(1):.1f} ms per "
          f"iteration; histogram kernel launches {launches}", flush=True)
    print(f"  categorical splits {n_cat} of {n_split}; valid AUC by round "
          f"{', '.join(f'{a:.5f}' for a in aucs)}", flush=True)
    if launches <= 0 or codes != torch.int16:
        fail("categorical: the path did not launch the kernel on int16 codes")
    if n_cat <= 0:
        fail("categorical: no categorical split")
    # the cat scan once, at the shape a wave gives it (2S touched leaves,
    # the categorical columns, the padded bins)
    S2 = 2 * gbdt.spec.hist_slots
    ci = torch.tensor(gbdt.spec.cat_features, device=dev)
    Bp = gbdt.spec.num_bins_padded
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hist = torch.rand((S2, len(ci), Bp, 3), generator=gen, device=dev)
    hist[..., 0] -= 0.5
    hist[..., 2] = torch.floor(hist[..., 2] * 400)
    hist = hist * (torch.arange(Bp, device=dev)[None, None, :, None]
                   < gbdt.num_bins[ci][None, :, None, None])
    par = [hist[:, 0, :, j].sum(dim=1) for j in range(3)]
    spec = gbdt.spec

    def cat_scan():
        per_feature_best_categorical(
            hist, *par, gbdt.num_bins[ci], gbdt.missing_code[ci],
            gbdt.is_cat[ci], **spec.hyperparams(), **spec.cat_hyperparams())
    scan = device_ops(cat_scan)
    print(f"  categorical scan of one wave ({S2} leaves x {len(ci)} "
          f"features x {Bp} bins): {scan[0]} device operations "
          f"({scan[1]} kernel launches), {scan[2]:.3f} ms device, "
          f"{sync_ms(cat_scan):.2f} ms host", flush=True)
    t0 = time.perf_counter()
    vpred = bst.predict(Xv)
    pred_ms = (time.perf_counter() - t0) * 1e3
    vauc = auc_of(vpred, yv)
    print(f"  Booster.predict on {NV} rows (host route: categorical "
          f"forest) {pred_ms:.1f} ms; its valid AUC {vauc:.6f}, the running "
          f"valid score's {aucs[-1]:.6f} (tol 1e-5)", flush=True)
    if not abs(vauc - aucs[-1]) <= 1e-5 or not aucs[-1] > 0.6:
        fail("categorical: Booster.predict disagrees with the valid score")
    del bst, gbdt, hist
    torch.cuda.empty_cache()
    again = lgt.train(params, ds, num_boost_round=CAT_ROUNDS)
    same = again.model_to_string() == text
    print(f"  second run: identical model text {same}; sha256 "
          f"{text_digest(text)}", flush=True)
    if not same:
        fail("categorical: two runs gave different models")
    del again, ds, dv
    torch.cuda.empty_cache()
    return dict(launches=launches, ms_per_iter=clock.ms(1),
                scan_ops=scan[0], X=X[:SMALL], y=y[:SMALL])


def ranking_phase():
    """Phase 9: lambdarank at the MS-LTR shape."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    Xr, yr, gr = msltr_like(RANK_ROWS + RANK_HOLD)
    nq, n_tr = split_queries(gr, RANK_ROWS)
    params = dict(objective="lambdarank", num_leaves=255, max_bin=255,
                  learning_rate=0.1, min_data_in_leaf=100, verbose=-1,
                  metric="ndcg", ndcg_eval_at=[10])
    t0 = time.perf_counter()
    ds = lgt.Dataset(Xr[:n_tr], label=yr[:n_tr], group=gr[:nq])
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xr[n_tr:], label=yr[n_tr:], group=gr[nq:],
                     reference=ds).construct()
    bin_s = time.perf_counter() - t0
    evals, clock = {}, IterClock()
    build_histograms_cuda.launches = 0          # the ranking path starts
    bst = lgt.train(params, ds, num_boost_round=RANK_ROUNDS, valid_sets=[dv],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = build_histograms_cuda.launches   # ... and ends here
    gbdt = bst._gbdt
    text = bst.model_to_string()
    ndcg = evals["valid"]["ndcg@10"]
    obj = gbdt.objective

    def grads():
        obj.gradients(gbdt.score, gbdt.label, gbdt.weight)
    gops = device_ops(grads)
    gms = sync_ms(grads)
    buckets = [(b["m"], len(b["doc_idx"])) for b in obj.buckets]
    print(f"  {n_tr} training rows in {nq} queries, {len(gr) - nq} held-out "
          f"queries ({len(yr) - n_tr} rows), {F137} features; host binning "
          f"{bin_s:.2f} s; query buckets (padded length, queries) "
          f"{buckets}", flush=True)
    print(f"  train {RANK_ROUNDS} rounds: first iteration "
          f"{clock.ms(0, 1):.1f} ms, then {clock.ms(1):.1f} ms per iteration "
          f"(valid ndcg@10 included); histogram kernel launches "
          f"{launches}; gradient call {gms:.2f} ms, {gops[0]} device "
          f"operations ({gops[1]} kernel launches, {gops[2]:.2f} ms device)",
          flush=True)
    print(f"  valid ndcg@10 by round {', '.join(f'{v:.5f}' for v in ndcg)}",
          flush=True)
    if launches <= 0:
        fail("lambdarank: the path never launched the histogram kernel")
    if not ndcg[-1] > ndcg[0] or not np.isfinite(ndcg).all():
        fail("lambdarank: the valid ndcg@10 did not rise")
    del bst, gbdt, obj
    torch.cuda.empty_cache()
    again = lgt.train(params, ds, num_boost_round=RANK_ROUNDS)
    same = again.model_to_string() == text
    print(f"  second run: identical model text {same}; sha256 "
          f"{text_digest(text)}", flush=True)
    if not same:
        fail("lambdarank: two runs gave different models")
    del again, ds, dv
    torch.cuda.empty_cache()
    return dict(launches=launches, ms_per_iter=clock.ms(1), grad_ops=gops,
                grad_ms=gms, X=Xr[:SMALL], y=yr[:SMALL],
                group=gr[:split_queries(gr, SMALL)[0]])


# Phase-10 cases that leave the CPU's result through the objective's
# transcendental functions alone (ROADMAP C12): torch's ``exp`` on the card
# and on the CPU round apart by an ulp or more (C2), and a split whose gain
# is 0 in exact arithmetic (a leaf whose rows share one g/h ratio, as the
# rows of one earlier leaf do) falls on either side of 0 by that rounding;
# L1's leaf values divide by a small sum of Gaussian hessians. Such a case
# must give the CPU's splits and predictions when both devices get the
# same gradients, computed on the CPU.
OBJECTIVE_ULP_CASES = ("multiclass", "regression_l1",
                       "categorical (sorted and one-hot)")


def host_gradient_fobj(params, label, group, n):
    """``fobj`` giving both devices the objective's gradients computed on
    the CPU (the same bits), so that only the training path differs."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    obj = create_objective(lgt.Config.from_params(params))
    meta = Metadata(n)
    meta.set_label(label)
    meta.set_group(group)
    obj.init(meta, n)
    lab = torch.as_tensor(np.asarray(label, np.float32))

    def fobj(preds, _dataset):
        score = torch.as_tensor(np.asarray(preds, np.float32).reshape(-1, n))
        g, h = obj.gradients(score, lab, None)
        return g.numpy().reshape(-1), h.numpy().reshape(-1)
    return fobj


def card_vs_cpu_phase(X, cat, rank):
    """Phase 10: the same package on the card and on the CPU, 20,000 rows:
    the same splits, predictions within 1e-5, the kernel launched."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
    Xs = X[:SMALL]
    Xm, ym = multiclass_like(SMALL, SEED + 11)
    z = np.nan_to_num(Xs[:, 0]) + 0.5 * np.nan_to_num(Xs[:, 3])
    rng = np.random.default_rng(SEED + 12)
    Xc = np.concatenate([cat["X"], (cat["X"][:, 2:3] % 3)], axis=1)
    nr = int(np.sum(rank["group"]))
    small = dict(MAIN_PARAMS, num_leaves=63)
    cases = {           # name: (params, X, label, Dataset kwargs)
        "multiclass": (dict(small, objective="multiclass", num_class=5),
                       Xm, ym, {}),
        "multiclassova": (dict(small, objective="multiclassova",
                               num_class=5), Xm, ym, {}),
        "categorical (sorted and one-hot)": (
            small, Xc, cat["y"],
            {"categorical_feature": EXPO_CATEGORICAL + [8]}),
        "lambdarank": (dict(small, objective="lambdarank",
                            min_data_in_leaf=100), rank["X"][:nr],
                       rank["y"][:nr], {"group": rank["group"]}),
        "regression_l1": (dict(small, objective="regression_l1"), Xs, z, {}),
        "huber": (dict(small, objective="huber"), Xs, z, {}),
        "fair": (dict(small, objective="fair"), Xs, z, {}),
        "poisson": (dict(small, objective="poisson"), Xs,
                    rng.poisson(np.exp(0.5 * np.tanh(z))).astype(np.float32),
                    {}),
        "xentropy": (dict(small, objective="xentropy"), Xs,
                     1.0 / (1.0 + np.exp(-z)), {}),
        "xentlambda": (dict(small, objective="xentlambda"), Xs,
                       1.0 / (1.0 + np.exp(-z)), {}),
    }
    total = 0
    for name, (p, Xc_, yc, kw) in cases.items():
        def run(device_params, fobj=None):
            return lgt.train(dict(p, **device_params),
                             lgt.Dataset(Xc_, label=yc, **kw),
                             num_boost_round=5, fobj=fobj)
        before = build_histograms_cuda.launches
        on_card = run({})
        launched = build_histograms_cuda.launches - before
        total += launched
        on_cpu = run({"device": "cpu"})
        splits = same_trees(on_card, on_cpu)
        pdiff = float(np.abs(on_card.predict(Xc_)
                             - on_cpu.predict(Xc_)).max())
        print(f"  {len(yc)} rows, {name}: same splits {splits} "
              f"({len(on_card.trees)} trees), max prediction diff "
              f"{pdiff:.3e} (tol 1e-5), histogram kernel launches "
              f"{launched}", flush=True)
        if launched <= 0:
            fail(f"{len(yc)} rows, {name}: the kernel never launched")
        if splits and pdiff <= 1e-5:
            continue
        if name not in OBJECTIVE_ULP_CASES:
            fail(f"{len(yc)} rows, {name}: the card disagrees with the CPU")
        # C12: the same case with the CPU's gradients on both devices
        hp = dict(p, objective="none",
                  num_class=on_card.num_model_per_iteration)
        fobj = host_gradient_fobj(dict(p, device="cpu"), yc, kw.get("group"),
                                  len(yc))
        card_h, cpu_h = run(dict(hp), fobj), run(dict(hp, device="cpu"), fobj)
        h_splits = same_trees(card_h, cpu_h)
        h_diff = float(np.abs(card_h.predict(Xc_, raw_score=True)
                              - cpu_h.predict(Xc_, raw_score=True)).max())
        print(f"    with the CPU's gradients on both (C12): same splits "
              f"{h_splits}, max raw prediction diff {h_diff:.3e}",
              flush=True)
        if not h_splits or not h_diff <= 1e-5:
            fail(f"{len(yc)} rows, {name}: the card disagrees with the CPU "
                 "on the same gradients")
    return dict(launches=total)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default="",
                    help="directory for the Chrome trace of phase 5")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "lightgbm_tpu_torch")):
        fail("run from a checkout: lightgbm_tpu_torch/ is not beside "
             "chip_smoke.py")
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch
    if not os.path.abspath(lightgbm_tpu_torch.__file__).startswith(HERE):
        fail(f"imported {lightgbm_tpu_torch.__file__}, not this checkout's")
    dev = torch.device("cuda", 0)

    print("phase 1: card", flush=True)
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    print("phase 2: build", flush=True)
    from lightgbm_tpu_torch.ops import cuda_histogram
    path, secs, log = cuda_histogram.build_library(verbose=True)
    print(f"  built {os.path.relpath(path, HERE)} in {secs:.2f} s", flush=True)
    for line in log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            print(f"  ptxas: {kernel_name(entry.group(1))}", flush=True)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas:   {line.split(':', 1)[-1].strip()}", flush=True)

    print(f"phase 3: histogram kernel vs plain version (N={N}, F={F}, "
          f"B={B} (uint16: {B16}), S={S})", flush=True)
    kres = kernel_phase(dev)

    print("phase 4: main path (Higgs-shaped 2M x 28 binary, 255 leaves, "
          "10 rounds)", flush=True)
    mres = main_path_phase()

    print("phase 5: profile of a steady-state iteration", flush=True)
    profile_phase(mres.pop("booster"), args.trace)

    print(f"phase 6: sampled and validated path (bagging 0.8 every 5, "
          f"feature_fraction 0.8, {NV} valid rows, early stopping; GOSS; "
          f"card vs CPU)", flush=True)
    sres = sampled_phase(*mres["data"], dev)
    print(f"phase 7: multiclass at full width (2M x 28, {NUM_CLASS} classes, "
          f"255 leaves, {MULTI_ROUNDS} rounds; multiclassova 2 rounds)",
          flush=True)
    cres = multiclass_phase()

    print(f"phase 8: categorical at full width (Expo-shaped 2M x 8, six "
          f"categorical columns, {CAT_ROUNDS} rounds, {NV} valid rows)",
          flush=True)
    gres = categorical_phase(dev)

    print(f"phase 9: lambdarank at the MS-LTR shape ({RANK_ROWS} rows x "
          f"{F137}, {RANK_ROUNDS} rounds)", flush=True)
    rres = ranking_phase()

    print(f"phase 10: card vs CPU, {SMALL} rows, the new objectives and "
          f"categorical features", flush=True)
    xres = card_vs_cpu_phase(mres["data"][1], gres, rres)
    print(f"  histogram kernel launches: phase 4 {mres['launches']}, phase 6 "
          f"sampled {sres['launches']} + GOSS {sres['goss_launches']}, "
          f"phase 7 {cres['launches']}, phase 8 {gres['launches']}, phase 9 "
          f"{rres['launches']}, phase 10 {xres['launches']}", flush=True)

    full = kres["full"]
    kernels = {"kernels": [{
        "name": "histogram (B1)", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/pallas_histogram.py:59",
        "launches": mres["launches"] + sres["launches"]
        + sres["goss_launches"] + cres["launches"] + gres["launches"]
        + rres["launches"] + xres["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kres.values()),
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
        "cases": {name: {k: r[k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err", "rows",
                          "num_features", "num_bins")}
                  for name, r in kres.items()},
    }]}
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
