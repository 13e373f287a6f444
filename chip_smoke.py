#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py [--trace DIR]

Phases (any failure exits non-zero and prints no result line):

1. card: ``nvidia-smi`` name and power limit;
2. build: compile ``lightgbm_tpu_torch/csrc/histogram.cu`` with nvcc
   (``-Xptxas -v``) and report the seconds;
3. kernel against its plain version at the slice's shapes (N=2,000,000
   rows, F=28, S=25 slots), in six cases: ``full`` (25 slots holding every
   row, read through a leaf-contiguous partition: the grower's full wave),
   ``wrapper`` (the same histogram asked for without a partition: the
   wrapper derives the positions on the card), ``root`` (one slot, ``perm =
   arange``: the grower's first wave), ``compact`` (about 10% of the rows
   in 25 of 250 leaves), ``uint16`` (the ``full`` case with uint16 codes
   at B=512; B=256 elsewhere) and ``f27`` (the ``full`` case with 27
   features, so that rows do not start on a 32-bit word). In each, counts
   must be equal, g/h within
   the stated tolerance (the two do the same fixed-point arithmetic, so they
   are expected bit-equal), and two launches bit-identical. Times (device
   time, see ``cuda_time_ms``): the kernel, the plain version, one
   ``torch.bincount`` computing the same histogram (timed only), and the
   memory bound. A child process then feeds the kernel a bin code >= B and
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
   ``--trace DIR`` also writes the Chrome trace there.

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


CASES = ("full", "wrapper", "root", "compact", "uint16", "f27")


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
    inc = torch.ones(N, device=dev)
    scales = histogram_scales(g, h)
    results = {}
    for name in CASES:
        X, nb, leaf_id, slot_of_leaf, kw = case_inputs(name, dev, gen, X8)
        nf = X.shape[1]
        args = (X, g, h, inc, leaf_id, slot_of_leaf, S, nb)
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
        w3 = torch.stack([g[rows], h[rows], inc[rows]], dim=-1)
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
        del plain, rows, slot, X, leaf_id, kw, args
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


def main_path_phase():
    """Phase 4: the port's main path at full width on the card."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import AUCMetric
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda

    X, y = higgs_like(N, SEED)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
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
    auc_metric = AUCMetric(lgt.Config.from_params(params))
    meta = Metadata(N)
    meta.set_label(y)
    auc_metric.init(meta, N)
    auc = auc_metric.eval(pred[None, :])[0][1]
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
        same_splits = all(
            np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold, b.threshold)
            for a, b in zip(cuda_bst.trees, cpu_bst.trees))
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
                booster=again)


# the profiler ranges grower.py opens around each wave step
RANGES = ("wave.histogram", "wave.split", "wave.route", "wave.partition")
# the kernels of csrc/histogram.cu; each pass also memsets its accumulators,
# among the other memsets of the path
HIST_KERNELS = ("hist_kernel", "finalize_kernel")


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device work only: the wave ranges also carry device spans
    kernels = [e for e in events if dev_us(e) > 0 and e.key not in RANGES
               and e.device_type == torch.autograd.DeviceType.CUDA]
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

    full = kres["full"]
    kernels = {"kernels": [{
        "name": "histogram (B1)", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/pallas_histogram.py:59",
        "launches": mres["launches"],
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
