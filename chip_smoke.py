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
   bit-equal; ``efb`` and ``efb_compact`` feed it bundled codes at the
   Bosch shape under EFB (1,184,000 rows x 121 bundled columns, B = 64; 25
   slots over every row, or about 10% of the rows in 25 of 250 leaves),
   required bit-equal. ``graph`` captures the kernel's launch (its pass
   size and scales read on the card, the grid sized for N) once in a CUDA
   graph and replays it with 25 leaves holding every row (n_active = N),
   25 empty leaves (n_active = 0) and 10% of the rows in 25 of 250 leaves,
   each replay required bit-equal to the plain version; the first layout's
   replay is timed. ``stream`` folds the ``wrapper`` case's pass over 8
   shards of 250,000 rows, each in a code buffer of its own, into one
   accumulator (B11: a memset, one ``hist_kernel`` per shard at its row
   offset, one ``finalize_kernel``), required bit-equal to the plain
   one-pass histogram and counted as one pass; its bound is the resident
   pass's (the accumulator is scratch held in L2). A child process then
   feeds the kernel a bin code >= B and must see a device-side assert, not
   a silently dropped row;
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
5. profile of the eager loop (the booster's ``_capture`` off): two more
   iterations of the second run timed on the host
   clock, two under ``torch.profiler`` (CPU + CUDA): wall time, device
   busy time and idle share, host time of each wave step (the
   ``wave.*`` ranges of ``grower.py``), CUDA launches per iteration, the
   histogram's device time (``hist_kernel`` and ``finalize_kernel``, and
   all memsets, one per pass among them), the check that the launch count
   (kept on the card: ``finalize_kernel`` adds one per pass, graph replays
   included) equals the passes in the profile, and the kernels that take
   the most device time.
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
   both devices. Six more cases at the same bar: EFB on a Bosch-shaped CSR
   cut at ``enable_bundle=auto``, EFB with a categorical column, EFB with
   ``max_conflict_rate=0.05`` on near-exclusive data, EFB with ``uint16``
   bundles (a 511-bin column), and linear leaves on L2 (``bench.py``'s
   piecewise-linear data) and on binary with NaN; each checks that bundling
   (or the linear fit) engaged on the card;
11. EFB at the Bosch shape (``bench.py``'s generator, copied): 1,184,000 x
   968 CSR, about 9% dense, binary, 255 leaves, the default
   ``enable_bundle=auto``, 10 rounds with a 200,000-row CSR valid set and
   AUC: the plan (121 bundles of 64 padded bins required) and the ``auto``
   decision, the code matrix's bytes bundled and unbundled, host binning
   seconds, ms per iteration, B1 passes per tree, the device operations of
   the bundle-space scan and of the bundled routing of one wave,
   ``Booster.predict`` on the CSR valid set (its AUC within 1e-5 of the
   running score's), a second run byte-identical; ``enable_bundle=false``
   on the same data (ms per iteration, and how many split features and
   thresholds differ from the bundled run on binary gradients); and on
   exact-arithmetic gradients (a 1/4 grid, unit hessians) the bundled and
   the unbundled run must give the same model text;
12. linear leaves at the main path's width: phase 4's data,
   ``linear_tree=true, linear_lambda=0.01``, 255 leaves, 10 rounds, the
   500,000-row valid set: ms per iteration, the fit's device operations and
   ms (moments and solve apart), linear and degraded leaves, train and
   valid AUC beside phase 4's constant leaves, ``Booster.predict`` of 2M
   rows on the device's linear walk and its largest difference from the
   host ``Tree.predict`` on 10,000 rows (within 1e-5), a second run
   byte-identical;
13. one dispatch per iteration: phase 4's data, 255 leaves, 16 rounds with
   a 500,000-row valid set and AUC at iterations 8 and 16, in three arms:
   eager on the card (``GBDT._capture`` off), captured with
   ``tree_batch=1`` and captured with ``tree_batch=8``. The three model
   texts must be byte-identical and their first 10 trees phase 4's; the
   K=8 eval history must equal K=1's. Each arm then runs 8 iterations in
   one ``train_batch`` call (ms per steady iteration; host syncs per tree:
   the runner's flag reads plus the calls ``torch.cuda.set_sync_debug_mode
   ("warn")`` flags; graph replays per iteration; capture and instantiate
   seconds) and 4 under the profiler (device busy ms and idle share; the
   passes counted on the card must equal ``finalize_kernel``'s launches in
   the profile, so the captured arms' counts are held against what ran). A
   captured sampled run (bagging 0.8 every 5, feature_fraction 0.8, the
   valid set, 10 rounds) and a captured multiclass run (5 classes, 3
   rounds) must be byte-identical to their eager runs. Phases 6, 8, 9, 11
   and 12 say how many trees were replayed from graphs;
14. serving: phase 4's data, 255 leaves, 500 rounds (the reference GPU
   benchmark's HIGGS setting) trained captured with ``tree_batch=8`` (B1's
   passes counted on the card), saved to text and served from the file by
   ``ServingEngine`` on the default ladder (1..4,096: 13 buckets). It
   prints the captures at warmup (13 required), per bucket the capture
   seconds, one replay's device ms, the host's encode, copy and f64
   accumulation ms per dispatch and the replayed leaves against the eager
   walk (bit-equal required); holds ``predict`` of 4,096 rows with NaN
   and zero cells bit-equal to ``Booster.predict(force_host_predict=
   True)``; drives ``MicroBatcher`` with 32 closed-loop clients (10,000
   requests of 1-64 rows) and a Poisson open loop at half their rate,
   every response held to the host prediction of its rows (requests/s,
   rows/s, p50/p99, dispatches, batch fill); hot-reloads the same file at
   ``num_iteration=250`` under the open loop, whose arrivals go on for a
   second after the reload returns (every response one of the two
   versions, both seen, version gauge 2, the live model's captures
   unchanged, the candidate's own 13; device memory before, with both
   models and after); fails on any ``serve.host_fallback``,
   ``serve.breaker_trips`` or a health other than ``ready``; and splits
   ``Booster.predict`` of 2M rows x 10 trees (phase 4's model) into host
   encode, H2D, walk and sum, with one host read per 65,536-row chunk.

15. device ingest, checkpoint/resume and ``nan_policy`` at the main
   path's width (phase 4's data and parameters). (a) ``tpu_ingest=device``
   against ``host``: the placed ``Xb`` ``torch.equal``, again with prefetch
   off (every chunk a counted stall), and on a 20,000-row cut with a
   categorical column; the ingest report (rows/s, chunks, chunk rows,
   stalls, stall fraction, H2D MB, ``compiles`` 1), the construct time
   split into mapper finding and binning for host and device, and the bin
   step (B7) alone on one chunk in device ms beside its bytes bound. (b)
   8 captured rounds at ``tree_batch=8`` with phase 13's valid set and AUC
   every 8, ``checkpoint_dir`` + ``checkpoint_interval=8``, then a fresh
   ``Dataset`` and ``Booster`` resumed (``resume_from="auto"``) to round
   16: model text byte-equal to phase 13's K=8 arm; save ms, file MB, load
   and restore ms, the first resumed (eager) iteration's ms. (c)
   ``nan_policy``: ``clip`` captured against eager on L2 with 0.01% of the
   labels +inf (equal model text, the clip warning logged); ``skip_iter``
   captured with every label +inf (``NonFiniteError`` "consecutive", the
   score buffer bit-equal to its value before training); ``raise`` through
   a ``fobj`` poisoned at iteration 2; 1.00 host syncs per replayed tree on
   the captured arms. Dense f32 data of 65,536 rows or more (the main
   path's, phase 9's) is binned on the card under the default
   ``tpu_ingest=auto`` in every phase, so phase 4's and phase 9's ``host
   binning`` lines time the mapper finding only.

16. the host front ends at the main path's width (phase 4's data and
   parameters). (a) ``Dataset.save_binary`` (host binning and write
   seconds apart, MB; the file's codes equal to those phase 4 trained
   from on the card), then ``task=train`` from a conf file naming the
   binary file, through ``cli.main`` in this process (B1's launches
   counted) and ``python -m lightgbm_tpu_torch`` in a child: both model
   texts must be phase 4's. (b) the first 200,000 rows written as a
   ``%.9g`` TSV (label first): pandas' reader (text files need it) and
   ``max |parsed - original|``; ``task=predict`` from phase 4's model
   whose ``output_result`` must equal, as printed, ``Booster.predict`` on
   the parsed array; ``task=train`` on the TSV with
   a 50,000-row ``valid_data`` for 2 rounds. (c) phase 4's model saved as
   ``.json`` and ``.proto``, each loaded by ``Booster`` and
   ``ServingEngine``: predictions on the 200,000 rows bit-equal to the
   text model's on the device walk and in the engine; ``task=serve_bench``
   on the ``.proto`` file (its JSON line). (d) the C shim
   (``csrc/lgbm_capi.c``) built with ``cc`` and loaded with ``ctypes``:
   ``LGBM_DatasetCreateFromFile`` on the binary file,
   ``LGBM_BoosterCreate`` with phase 4's parameters and no ``device`` key,
   ten ``LGBM_BoosterUpdateOneIter``, ``LGBM_BoosterSaveModel``: phase 4's
   model text, B1 launched; a missing ``Python.h`` fails the phase.

17. out-of-core training (``tpu_residency=stream|auto``, A14 and B11) on
   phase 4's data and parameters, 10 rounds. (a) ``tpu_residency=auto``
   with ``tpu_hbm_budget_bytes`` halfway between the booster's estimates
   of a streamed and a resident run (``observability/memory.py``; a
   streamed booster that trains nothing gives both): ``auto`` must choose
   stream, in its default 8 shards of 250,000 rows, and the model text
   must be phase 4's; then the resident arm. Each leg prints ms per
   iteration (the first apart), host flag reads per wave (1.00 required),
   the synchronizing calls ``set_sync_debug_mode`` flags in iterations
   2-10, the prefetcher's stalls, hits and H2D MB, B1's passes, and the
   peak allocated device memory, absolute and above what was allocated
   before (at most 64 MiB: library workspaces), beside the estimate; the
   peak above the base must lie within half and twice the estimate, and
   the streamed peak must be below the resident one. (b) the same with
   ``LGBM_TPU_STREAM_NO_PREFETCH=1`` (no hit allowed) and with
   ``tpu_stream_verify=false``. (c) 7 shards of 300,000 rows whose last
   holds 200,000 rows and padding, and 4 shards of 500,000. (d) ``max_bin=15``: ``u4`` shards, 3 rounds, text
   equal to the resident run's. (e) ``LGBM_TPU_CHAOS_FLIP_SHARD`` flips a
   shard when the store is built: the first update must raise
   ``ShardCorruptionError`` with no tree committed. Every leg's model text
   in (a)-(c) must be phase 4's.

18. multi-GPU training's comm layer (A16, B13) on the one card. (a) An
   NCCL process group of one on ``cuda:0``: B1's integer sums of phase 3's
   ``full`` case, and every comm class (data, feature, voting, and the
   bundled data and feature ones on single-feature bundles) over it: the
   reduced histogram, the split candidates, the root sums and the scales
   must equal ``SerialComm``'s; each collective's device ms at the main
   path's shapes is printed as "NCCL, world of one: a local copy, not a
   multi-GPU number", and no collective may stage through the host. Then
   two NCCL ranks on ``cuda:0`` are probed and NCCL's answer printed. (b)
   Two ranks on ``cuda:0`` over a group the ranks make themselves (gloo,
   or NCCL where the probe passed) — on a machine with several cards, a
   rank on each card over NCCL, no collective staged — phase 4's data and
   parameters, 10 rounds of ``tree_learner=data``, ``feature`` and
   ``voting``: each rank prints its B1 launches, setup s, ms per iteration
   and host-staged collective ms ("gloo over one card": no multi-GPU
   number); the data and feature texts must be phase 4's on every rank,
   voting's the same on every rank with the train AUC within 0.01 of
   phase 4's.

19. fault tolerance on the card (A16b, A17b): phase 4's dataset written
   once as a binary file, every training process a child running the
   command line (``cli.main``), this process only supervising. (a)
   ``Supervisor`` over a 10-round training with ``checkpoint_interval=2``
   whose first child SIGKILLs itself after its second checkpoint (gated by
   a marker, so the relaunch trains through): the relaunch resumes from
   iteration 4 and ends with phase 4's text; its MTTR and restarts. (b)
   The same with ``hang_timeout_s=5 hang_action=abort`` and
   ``LGBM_TPU_CHAOS_HANG`` parking the first child after iteration 4: it
   exits 142 leaving a dump with every thread's stack, and the relaunch
   ends with phase 4's text. (a) and (b) run at once. (c)
   ``FleetSupervisor`` over a data-parallel world (two ranks on ``cuda:0``
   over a gloo group the ranks make, or a rank per card over NCCL) with
   gang checkpoints every 2 iterations, whose rank 1 SIGKILLs itself after
   two manifests: rank 0 must exit 145 naming rank 1 within the lease
   timeout plus one hang threshold, the relaunched gang resumes epoch 2 on
   both ranks and both end with phase 4's text; each gang save's ms (shard
   write, exchange and manifest, commit barrier). Then one process resumes
   epoch 2 under ``elastic=true tpu_reshard_on_resume=true``: phase 4's
   text. (d) In the same world, ``tpu_residency=stream`` under ``data``
   (phase 4's text on every rank) and ``voting`` (phase 18 (b)'s voting
   text), B1's 140 launches per rank and learner, ms per iteration per
   rank.

20. training observability on the card (A17b): phase 4's data and
   parameters, 10 rounds on the captured iteration, with ``telemetry_dir``
   in a temporary directory, ``tpu_cost_analysis=true``,
   ``tpu_time_tag=true`` and ``tpu_profile_iters=3:6`` (after the graph
   capture), then again at ``0:3`` (over it). Each arm must give phase 4's
   model text with 140 B1 launches, no ``not captured:`` line, 1.00 host
   syncs per replayed tree (flag reads + calls ``set_sync_debug_mode``
   flags) and one more in the run's publish fetch; ``trace_<pid>.json``,
   ``events_<pid>.jsonl`` and ``snapshot_<pid>.json`` with 1 ``train``
   span, 10 ``iteration`` spans, derived ``wave`` spans summing to the
   ``tree.waves`` histogram and ``trees.trained`` 10; a profiler Chrome
   trace holding 14 ``finalize_kernel`` events per iteration of the
   batch-aligned window; the ``histogram.full.s25`` cost report's
   ``bytes_accessed`` equal to phase 3's ``full`` bound bytes;
   ``device_memory()["peak_bytes"]`` equal to
   ``torch.cuda.max_memory_allocated()``; the logged TIMETAG summary.
   Printed, not gated: ms per iteration inside and outside the window
   beside phase 13's captured K=1.

21. wide bins on the card (ROADMAP B1c): 200,000 x 8, every value
   distinct, exact-arithmetic L2 labels, 5 rounds at ``max_bin`` 16,383
   (``int16`` codes, two bin tiles per feature) and 40,000 (``int32``
   codes up to 39,999, four tiles): the card's model text must equal the
   CPU port's, B1 launched. Phase 3's ``wide`` (F = 8, B = 16,384,
   ``int16``) and ``wide32`` (F = 4, B = 40,008, ``int32``) cases hold
   the tiled kernel bit-equal to the plain version at 2M rows.

22. the capture guard and the op-trace tier on the card (A19), on phase
   4's data and parameters. (a) ``analysis.CaptureGuard`` around 10
   captured rounds with telemetry on, warm after the capture iteration:
   0 captures after warm, 1.00 host sync per steady tree (the runner's
   flag reads plus the calls ``set_sync_debug_mode`` flags) and the one
   publish fetch, phase 4's text, the report through
   ``PhaseBreakdown.attach_guard``; then the graphs dropped and one more
   iteration: the guard must raise ``GuardViolation``. (b) the guard over
   a ``ServingEngine`` of that model, 300 requests of 1-64 rows: 0
   captures after warm-up. (c) contracts T001, T004, T006 and T010
   evaluated on programs recorded on CUDA tensors (one tree's waves, one
   eager iteration's parts, the forest walk of 65,536 rows): no sort over
   rows, no host transfer, f64 only at its allowlisted sites, and exactly
   one B1 pass per wave by ``launch_count()``.

``--phases 3,11`` runs only the listed phases (and those they need: 5-7,
12-20 and 22 add phase 4); such a partial run prints no result lines and
exits 4.

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
import threading
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


def elapsed(t_start):
    """The script's host seconds so far, printed between phases (a phase's
    cost is the difference of the lines around it)."""
    print(f"  elapsed {time.perf_counter() - t_start:.1f} s", flush=True)


def kernel_name(mangled):
    """A readable name for a kernel of csrc/histogram.cu in ptxas output."""
    m = re.search(r"hist_kernelI([htj])Lb([01])ELb([01])E", mangled)
    if m:
        code = {"h": "uint8", "t": "uint16", "j": "int32"}[m.group(1)]
        return (f"hist_kernel<{code}, "
                f"{'aligned' if m.group(2) == '1' else 'unaligned'} rows, "
                f"{'bin tiles' if m.group(3) == '1' else 'untiled'}>")
    return "finalize_kernel" if "finalize_kernel" in mangled else mangled


def card_line():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


CASES = ("full", "wrapper", "root", "compact", "uint16", "f27", "sampled",
         "f137", "efb", "efb_compact", "stream")
STREAM_SHARDS = 8                  # the stream case's shards of N / 8 rows
F137 = 137                         # the MS-LTR width (phase 9)
# the Bosch shape under EFB (phase 11): 1,184,000 rows, 968 sparse features
# in 121 bundles of at most 57 codes (8 members x 7 values + code 0)
BOSCH_ROWS, BOSCH_F, BOSCH_G, BOSCH_BB = 1_184_000, 968, 121, 64


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
    return dict(row_idx=perm, n_active=counts[pending].sum(),
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
                  n_active=torch.full((), N, dtype=torch.int64, device=dev),
                  slot_counts=counts, slot_starts=zeros)
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


def efb_case_inputs(name, dev, gen):
    """(X, B, leaf_id, slot_of_leaf, kwargs) of the ``efb`` cases: bundled
    codes at the Bosch shape (code 0, every member at its default, in a
    quarter of the rows, else one of 56 member codes), 25 slots holding
    every row (``efb``) or about 10% of them in 25 of 250 leaves
    (``efb_compact``)."""
    import torch
    n = BOSCH_ROWS
    codes = torch.randint(1, 57, (n, BOSCH_G), generator=gen, device=dev,
                          dtype=torch.int32)
    codes[torch.rand((n, BOSCH_G), generator=gen, device=dev) < 0.25] = 0
    X = codes.to(torch.uint8)
    slot_of_leaf = torch.full((256,), -1, dtype=torch.int32, device=dev)
    if name == "efb":
        leaf_id = torch.randint(0, S, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        pending = torch.arange(S, device=dev)
    else:
        leaf_id = torch.randint(0, 250, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        pending = torch.arange(0, 250, 10, device=dev)
    slot_of_leaf[pending] = torch.arange(S, dtype=torch.int32, device=dev)
    return X, BOSCH_BB, leaf_id, slot_of_leaf, _partition_kw(leaf_id,
                                                             pending, 256)


def kernel_phase(dev):
    """Phase 3: the histogram kernel against its plain version."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        build_histograms_cuda, launch_count)
    from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                                  histogram_scales)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X8 = torch.randint(0, B, (N, F), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    g = torch.randn(N, generator=gen, device=dev)
    h = torch.rand(N, generator=gen, device=dev) * 0.25
    ones = torch.ones(N, device=dev)
    results = {}
    for name in CASES:
        if name == "stream":
            results[name] = stream_case(dev, gen, X8, g, h)
            continue
        if name.startswith("efb"):
            X, nb, leaf_id, slot_of_leaf, kw = efb_case_inputs(name, dev, gen)
        else:
            X, nb, leaf_id, slot_of_leaf, kw = case_inputs(name, dev, gen, X8)
        nf = X.shape[1]
        nx = X.shape[0]
        gw, hw, inc = sampled_weights(g, h, gen) if name == "sampled" \
            else (g[:nx], h[:nx], ones[:nx])
        scales = histogram_scales(gw, hw)
        args = (X, gw, hw, inc, leaf_id, slot_of_leaf, S, nb)
        plain = build_histograms(*args, scales=scales, **kw)
        before = launch_count()
        out1 = build_histograms_cuda(*args, scales=scales, **kw)
        out2 = build_histograms_cuda(*args, scales=scales, **kw)
        torch.cuda.synchronize()
        if launch_count() != before + 2:
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
        if name in ("sampled", "f137", "efb", "efb_compact") \
                and not bit_equal:
            fail(f"{name}: the kernel is not bit-equal to the plain version")
        if not bool(torch.isfinite(out1).all()):
            fail(f"{name}: non-finite histogram")
        del out1, out2
        ms = cuda_time_ms(
            lambda: build_histograms_cuda(*args, scales=scales, **kw), 20)
        results[name] = dict(
            pass_costs(name, args, scales, kw, ms), max_abs_err=max_abs,
            max_rel_err=max_rel, bit_equal=bit_equal)
        del plain, X, leaf_id, kw, args, gw, hw, inc
        torch.cuda.empty_cache()
    results["graph"] = graph_case(dev, gen, X8, g, h)
    results.update(wide_cases(dev, g, h))
    malformed_input_check()
    return results


WIDE_CASES = {   # name: (features, num_bins_padded, codes) — ROADMAP B1c
    "wide": (8, 16_384, "int16"),      # max_bin 16,383: two bin tiles
    "wide32": (4, 40_008, "int32"),    # max_bin 40,000: codes >= 2**15
}


def wide_cases(dev, g, h):
    """Phase 3's ``wide`` and ``wide32`` cases (B1c): the ``full`` wave
    (25 pending leaves holding every row, through the partition) at a
    width past one block's shared memory, so that each feature's bins are
    cut into tiles (``ops/cuda_histogram.bin_tiles``); ``wide32``'s codes
    reach past ``2**15`` as ``int32``. Each must be bit-equal to the plain
    version; a generator of their own keeps the earlier cases' inputs."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        bin_tiles, build_histograms_cuda, launch_count)
    from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                                  histogram_scales)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    L = 255
    leaf_id = torch.randint(0, S, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
    sol = torch.full((L + 1,), -1, dtype=torch.int32, device=dev)
    sol[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    kw = _partition_kw(leaf_id, torch.arange(S, device=dev), L + 1)
    ones = torch.ones(N, device=dev)
    scales = histogram_scales(g, h)
    results = {}
    for name, (nf, nb, code) in WIDE_CASES.items():
        X = torch.randint(0, nb, (N, nf), generator=gen, device=dev,
                          dtype=torch.int32).to(getattr(torch, code))
        args = (X, g, h, ones, leaf_id, sol, S, nb)
        plain = build_histograms(*args, scales=scales, **kw)
        before = launch_count()
        out1 = build_histograms_cuda(*args, scales=scales, **kw)
        out2 = build_histograms_cuda(*args, scales=scales, **kw)
        torch.cuda.synchronize()
        counted = launch_count() - before
        bit_equal = bool(torch.equal(out1, plain))
        identical = bool(torch.equal(out1, out2))
        max_abs = float((out1 - plain).abs().max())
        tile, tiles = bin_tiles(nb)
        top = int(X.max())
        print(f"  {name}: F={nf}, B={nb} in {tiles} bin tiles of {tile}, "
              f"{code} codes up to {top}: bit-equal to plain {bit_equal} "
              f"(max abs err {max_abs:.3e}), two launches identical "
              f"{identical}, passes counted {counted}", flush=True)
        if not bit_equal:
            fail(f"{name}: the kernel is not bit-equal to the plain version")
        if not identical or counted != 2:
            fail(f"{name}: two launches differ or counted {counted} passes")
        if code == "int32" and top < 2 ** 15:
            fail(f"{name}: no code of 2**15 or more was drawn")
        del out1, out2, plain
        ms = cuda_time_ms(
            lambda: build_histograms_cuda(*args, scales=scales, **kw), 10)
        results[name] = dict(pass_costs(name, args, scales, kw, ms),
                             max_abs_err=max_abs, max_rel_err=0.0,
                             bit_equal=True)
        del X, args
        torch.cuda.empty_cache()
    return results


def pass_costs(name, args, scales, kw, ms):
    """The plain version's and ``torch.bincount``'s device ms on one pass's
    inputs, and the pass's bound; printed beside the kernel's ``ms``."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import histogram_pass_cost
    from lightgbm_tpu_torch.ops.histogram import build_histograms, pass_rows
    X, gw, hw, inc, leaf_id, slot_of_leaf, _, nb = args
    dev = X.device
    nx, nf = X.shape
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
    # partition, every row's leaf id; the output written once — the
    # formula of the port's histogram cost report
    cost = histogram_pass_cost(
        n_rows, nf, nb, S, X.element_size(),
        derived_positions=name in ("wrapper", "stream"), total_rows=nx,
        slot_table=slot_of_leaf.numel())
    nbytes = cost["bytes"]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["operations"] / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  {name} pass over {n_rows} rows (F={nf}, B={nb}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, torch.bincount "
          f"{lib_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
          f"{bound_ms / ms * 100:.1f}% of the bound", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                rows=n_rows, num_features=nf, num_bins=nb, bytes=nbytes)


def stream_case(dev, gen, X8, g, h):
    """Phase 3's ``stream`` case (B11, ``tpu_residency=stream``): the
    ``wrapper`` case's pass (25 pending leaves holding every row, no
    partition) folded over ``STREAM_SHARDS`` shards of N / 8 rows, each in a
    code buffer of its own as the prefetcher's, into one accumulator: a
    memset, eight ``hist_kernel`` launches with the shard's row offset into
    g / h / counts and leaf ids, one ``finalize_kernel``. It must be
    bit-equal to the plain version's one pass and count one pass. Its bound
    is the resident pass's: the function reads the same inputs and writes
    the same output, and the ``[S, F, B]`` integer accumulator (3.6 MB) is
    scratch that stays in the card's 50 MB L2 between the folds."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import (HistogramAccumulator,
                                                       launch_count)
    from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                                  histogram_scales)
    L = 255
    R = N // STREAM_SHARDS
    leaf_id = torch.randint(0, S, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
    sol = torch.full((L + 1,), -1, dtype=torch.int32, device=dev)
    sol[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    inc = torch.ones(N, device=dev)
    scales = histogram_scales(g, h)
    shards = [X8[i * R:(i + 1) * R].clone() for i in range(STREAM_SHARDS)]
    acc = HistogramAccumulator(S, F, B, dev)

    def fold():
        acc.zero_()
        for i, Xs in enumerate(shards):
            acc.add(Xs, g, h, inc, leaf_id, sol, i * R, R, scales)
        return acc.finalize(scales)

    args = (X8, g, h, inc, leaf_id, sol, S, B)
    plain = build_histograms(*args, scales=scales)
    before = launch_count()
    out1 = fold()
    out2 = fold()
    torch.cuda.synchronize()
    counted = launch_count() - before
    identical = bool(torch.equal(out1, out2))
    bit_equal = bool(torch.equal(out1, plain))
    max_abs = float((out1 - plain).abs().max())
    print(f"  stream: {STREAM_SHARDS} shard folds of {R} rows + one "
          f"finalize, bit-equal to the plain one-pass histogram "
          f"{bit_equal} (max abs err {max_abs:.3e}), two folds identical "
          f"{identical}, passes counted on the card {counted} (2 folds)",
          flush=True)
    if not bit_equal:
        fail("stream: the folded pass is not bit-equal to the plain version")
    if not identical:
        fail("stream: two folded passes differ (not deterministic)")
    if counted != 2:
        fail(f"stream: two folded passes counted {counted} passes")
    del out1, out2, plain
    ms = cuda_time_ms(fold, 10)
    costs = pass_costs("stream", args, scales, {}, ms)
    del shards, acc
    torch.cuda.empty_cache()
    return dict(costs, max_abs_err=max_abs, max_rel_err=0.0, bit_equal=True)


def graph_case(dev, gen, X8, g, h):
    """Phase 3's ``graph`` case: B1's device-sized launch (``n_active`` the
    sum of the slot counts on the card, the scales a device tensor, the
    grid sized for N) captured once in a CUDA graph and replayed with three
    layouts written into the buffers it reads: 25 leaves holding every row
    (n_active = N), 25 empty leaves (n_active = 0) and about 10% of the rows
    in 25 of 250 leaves. Each replay must be bit-equal to the plain
    version; the replay of the first layout is timed."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        build_histograms_cuda, launch_count)
    from lightgbm_tpu_torch.ops.histogram import (build_histograms,
                                                  histogram_scales)
    L = 255
    inc = torch.ones(N, device=dev)
    scales = histogram_scales(g, h)
    leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
    sol = torch.full((L + 1,), -1, dtype=torch.int32, device=dev)
    perm = torch.arange(N, dtype=torch.int32, device=dev)
    counts = torch.zeros(S, dtype=torch.int32, device=dev)
    starts = torch.zeros(S, dtype=torch.int32, device=dev)
    kw = dict(row_idx=perm, slot_counts=counts, slot_starts=starts,
              scales=scales)
    args = (X8, g, h, inc, leaf_id, sol, S, B)

    def layout(kind):
        if kind == "full":
            leaf = torch.randint(0, S, (N,), generator=gen, device=dev,
                                 dtype=torch.int32)
            pending = torch.arange(S, device=dev)
        else:
            leaf = torch.randint(0, 230, (N,), generator=gen, device=dev,
                                 dtype=torch.int32)
            pending = torch.arange(0, 250, 10, device=dev) \
                if kind == "compact" else torch.arange(230, 255, device=dev)
        part = _partition_kw(leaf, pending, L + 1)
        leaf_id.copy_(leaf)
        sol.fill_(-1)
        sol[pending] = torch.arange(S, dtype=torch.int32, device=dev)
        perm.copy_(part["row_idx"])
        counts.copy_(part["slot_counts"])
        starts.copy_(part["slot_starts"])
        return int(part["n_active"])

    layout("full")
    build_histograms_cuda(*args, **kw)           # warm-up, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = launch_count()
    with torch.cuda.graph(graph):
        out = build_histograms_cuda(*args, **kw)
    if launch_count() != before:
        fail("graph: a capture counted a histogram pass it did not run")
    worst = 0.0
    for kind in ("full", "empty", "compact"):
        n_active = layout(kind)
        graph.replay()
        plain = build_histograms(*args, **kw)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, plain))
        err = float((out - plain).abs().max())
        worst = max(worst, err)
        print(f"  graph replay, {kind} layout (n_active {n_active}): "
              f"bit-equal to plain {equal}, max abs err {err:.3e}",
              flush=True)
        if not equal:
            fail(f"graph: the replayed pass ({kind}) is not bit-equal to "
                 "the plain version")
    replayed = launch_count() - before
    print(f"  graph: passes counted on the card over the three replays "
          f"{replayed}", flush=True)
    if replayed != 3:
        fail(f"graph: three replays counted {replayed} passes")
    layout("full")
    ms = cuda_time_ms(graph.replay, 20)
    costs = pass_costs("graph", args, scales,
                       dict(row_idx=perm, slot_counts=counts,
                            slot_starts=starts), ms)
    del graph, out
    torch.cuda.empty_cache()
    return dict(costs, max_abs_err=worst, max_rel_err=0.0, bit_equal=True)


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


def replay_note(gbdt):
    """How a booster's iterations ran on the card: replayed from CUDA
    graphs, or eagerly (a path with host work inside an iteration)."""
    r = gbdt._graphs
    if r is None:
        reason = gbdt._capture_blocker() or "not captured yet"
        print(f"  iterations ran eagerly on the card ({reason})", flush=True)
        return 0
    print(f"  {r.trees} trees replayed from CUDA graphs ({r.replays} "
          f"replays, {r.syncs} flag reads, {len(r.graphs)} graphs)",
          flush=True)
    return r.trees


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
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)

    X, y = higgs_like(N, SEED)
    params = dict(MAIN_PARAMS)
    rounds = 10
    reset_launch_count()          # the main path starts here
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
    launches = launch_count()   # ... and ends here
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
        before = launch_count()
        cuda_bst = lgt.train(small, lgt.Dataset(Xs, label=ys),
                             num_boost_round=5, keep_training_booster=True)
        small_launches = launch_count() - before
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
    # the codes the card trained from (device-ingested when the dataset
    # was deferred), for phase 16's binary file
    codes_digest = hashlib.sha256(
        again._gbdt.Xb.cpu().numpy().tobytes()).hexdigest()
    return dict(launches=launches, ms_per_iter=ms_per_iter, auc=auc,
                booster=again, data=(ds, X, y), text=text, digest=digest,
                codes_digest=codes_digest,
                ingested=again._gbdt._ingest_report is not None)


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
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    gbdt = booster._gbdt
    gbdt._capture = False               # the eager loop (phase 13: graphs)
    walls = []                          # host clock, profiler off
    for _ in range(iters):
        t0 = time.perf_counter()
        gbdt.train_one_iter()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof_walls = []                     # the same, profiled
    launches = launch_count()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(iters):
            t0 = time.perf_counter()
            gbdt.train_one_iter()
            torch.cuda.synchronize()
            prof_walls.append(time.perf_counter() - t0)
    launches = launch_count() - launches
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
    # the device counter (finalize_kernel adds to it) against the profile
    passes = sum(e.count for e in hist if "finalize_kernel" in e.key)
    print(f"  passes counted on the card in the profiled iterations: "
          f"{launches}; finalize_kernel launches in the profile: {passes}",
          flush=True)
    if launches != passes:
        fail("the device launch count differs from the passes in the "
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
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    from lightgbm_tpu_torch.utils import prng

    Xv, yv = higgs_like(NV, SEED + 1)
    params = dict(SAMPLED_PARAMS)
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    evals = {}
    clock = IterClock()
    reset_launch_count()          # the sampled path starts here
    bst = lgt.train(params, ds, num_boost_round=SAMPLED_ROUNDS,
                    valid_sets=[dv], valid_names=["valid"],
                    early_stopping_rounds=SAMPLED_STOP, evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = launch_count()   # ... and ends here
    gbdt = bst._gbdt
    replay_note(gbdt)
    n_iter = gbdt.iter_
    best = bst.best_iteration
    aucs = evals["valid"]["auc"]
    best_auc = aucs[(best or n_iter) - 1]
    ms_iter = clock.ms(1)
    text = bst.model_to_string()
    vs = gbdt.valid_sets[0]
    walk_ms = sync_ms(lambda: gbdt._valid_contrib(gbdt.models[-1][0], vs))
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
    reset_launch_count()          # GOSS starts here
    goss = lgt.train(dict(MAIN_PARAMS, boosting="goss"), ds,
                     num_boost_round=GOSS_ROUNDS, callbacks=[clock])
    goss_launches = launch_count()   # ... and ends here
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
        before = launch_count()
        on_card = run({})
        small_launches += launch_count() - before
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
# phase 10's rounds per case, card and CPU: 3 (not 5), so that the whole
# run stays near 700 s beside phase 19
CARD_CPU_ROUNDS = 3


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
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    X, y = multiclass_like(N, SEED + 7)
    Xv, yv = multiclass_like(NV, SEED + 8)
    params = dict(MAIN_PARAMS, objective="multiclass", num_class=NUM_CLASS,
                  metric="multi_logloss")
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    evals, clock = {}, IterClock()
    reset_launch_count()          # the multiclass path starts
    bst = lgt.train(params, ds, num_boost_round=MULTI_ROUNDS,
                    valid_sets=[dv], valid_names=["valid"],
                    evals_result=evals, verbose_eval=False, callbacks=[clock])
    launches = launch_count()   # ... and ends here
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
    before = launch_count()
    clock = IterClock()
    ova_bst = lgt.train(ova, ds, num_boost_round=2, callbacks=[clock])
    ova_launches = launch_count() - before
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
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    X, y = expo_like(N, SEED + 9)
    Xv, yv = expo_like(NV, SEED + 10)
    params = dict(MAIN_PARAMS, metric="auc")
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, categorical_feature=EXPO_CATEGORICAL)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    bin_s = time.perf_counter() - t0
    evals, clock = {}, IterClock()
    reset_launch_count()          # the categorical path starts
    bst = lgt.train(params, ds, num_boost_round=CAT_ROUNDS, valid_sets=[dv],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = launch_count()   # ... and ends here
    gbdt = bst._gbdt
    replay_note(gbdt)
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
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
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
    reset_launch_count()          # the ranking path starts
    bst = lgt.train(params, ds, num_boost_round=RANK_ROUNDS, valid_sets=[dv],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = launch_count()   # ... and ends here
    gbdt = bst._gbdt
    replay_note(gbdt)
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


def bosch_like(n_rows, n_features=BOSCH_F, group_size=8, p_active=0.75,
               seed=2):
    """Bosch-shaped wide sparse binary data (``bench.py``'s ``_bosch_like``,
    copied): the reference's Bosch workload is 1.184M x 968 and about 81%
    sparse (its ``docs/GPU-Performance.rst``). Features come in mutually
    exclusive blocks of ``group_size`` (station/sensor one-hot groups, the
    pattern EFB exists for), each row active in a block with probability
    ``p_active``; values are sensor codes k/8. Returns (CSR f32, labels)."""
    import numpy as np
    from scipy import sparse as sp
    rng = np.random.RandomState(seed)
    n_groups = n_features // group_size
    rows = np.arange(n_rows, dtype=np.int32)
    r_idx, c_idx, vals = [], [], []
    for g in range(n_groups):
        active = rng.rand(n_rows) < p_active
        member = rng.randint(0, group_size, n_rows)[active]
        r_idx.append(rows[active])
        c_idx.append((g * group_size + member).astype(np.int32))
        vals.append((rng.randint(1, 8, member.size) / 8.0).astype(np.float32))
    X = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(r_idx),
                                np.concatenate(c_idx))),
        shape=(n_rows, n_features))
    d0 = np.asarray(X[:, :3 * group_size].todense())
    latent = (d0[:, 0] * 3 + d0[:, group_size] * 2
              - d0[:, 2 * group_size] + d0[:, 1] * d0[:, group_size + 1] * 4)
    y = (latent + rng.randn(n_rows).astype(np.float32) * 0.4
         > np.median(latent)).astype(np.float32)
    return X, y


def near_exclusive(n_rows, n_features=30, seed=1):
    """One-hot rows of sensor codes k/8 over ``n_features`` with 2% of the
    rows dense, so that every pair of features conflicts on about 2% of
    the rows: bundling needs ``max_conflict_rate`` above that (the shape of
    the JAX package's ``tests/test_efb.py`` conflict case)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = np.zeros((n_rows, n_features), np.float32)
    picks = rng.randint(0, n_features, n_rows)
    X[np.arange(n_rows), picks] = rng.randint(1, 8, n_rows) / 8.0
    dense = rng.choice(n_rows, n_rows // 50, replace=False)
    X[dense] = rng.randint(1, 8, (len(dense), n_features)) / 8.0
    y = ((picks % 2) ^ (rng.rand(n_rows) < 0.1)).astype(np.float32)
    return X, y


def piecewise_linear_data(n_rows, f=8, seed=17):
    """``bench.py``'s ``_piecewise_linear_data`` (copied): the target's slope
    switches with the sign of feature 0, with 1% NaN cells."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = (rng.randn(n_rows, f) * 2.0).astype(np.float64)
    X[rng.rand(n_rows, f) < 0.01] = np.nan
    y = np.where(np.nan_to_num(X[:, 0]) > 0,
                 3.0 * np.nan_to_num(X[:, 1]) + 1.0,
                 -2.0 * np.nan_to_num(X[:, 2]) + 0.5) \
        + 0.05 * rng.randn(n_rows)
    return X, y


BOSCH_VALID = 200_000              # phase 11's valid rows
EFB_ROUNDS = 10
EXACT_ROUNDS = 5
LINEAR_ROUNDS = 10


def compare_splits(a, b):
    """(same splits, differing nodes, nodes, the first difference) of two
    boosters; a difference is (tree, node, feature and threshold in a,
    gain in a, feature and threshold in b, gain in b)."""
    import numpy as np
    n_diff = n_nodes = 0
    first = None
    for ti, (ta, tb) in enumerate(zip(a.trees, b.trees)):
        n = min(ta.num_internal, tb.num_internal)
        n_nodes += max(ta.num_internal, tb.num_internal)
        d = np.nonzero((ta.split_feature[:n] != tb.split_feature[:n])
                       | (ta.threshold[:n] != tb.threshold[:n]))[0]
        n_diff += len(d) + abs(ta.num_internal - tb.num_internal)
        if first is None and (len(d) or ta.num_internal != tb.num_internal):
            k = int(d[0]) if len(d) else n
            first = (ti, k,
                     [(int(t.split_feature[k]), float(t.threshold[k]),
                       float(t.split_gain[k])) if k < t.num_internal
                      else None for t in (ta, tb)])
    same = n_diff == 0 and len(a.trees) == len(b.trees)
    return same, n_diff, n_nodes, first


def quarter_residuals(preds, dataset):
    """Custom gradients on a grid of 1/4 with unit hessians: the sums of
    up to 2^22 rows stay exact in f32, in any order of addition."""
    import numpy as np
    y = dataset.get_label()
    g = np.clip(np.round((preds - y) * 4) / 4.0, -2.0, 2.0)
    return g.astype(np.float32), np.ones_like(g, dtype=np.float32)


def efb_phase(dev):
    """Phase 11: EFB at the Bosch shape, from CSR input, at the default
    ``enable_bundle=auto``."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.grower import _route_rows
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    from lightgbm_tpu_torch.parallel.comm import BlockMeta, find_block_splits
    t0 = time.perf_counter()
    X, y = bosch_like(BOSCH_ROWS, seed=2)
    Xv, yv = bosch_like(BOSCH_VALID, seed=3)
    gen_s = time.perf_counter() - t0
    params = dict(MAIN_PARAMS, metric="auc")
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    bin_s = time.perf_counter() - t0
    cd = ds.constructed
    evals, clock = {}, IterClock()
    reset_launch_count()          # the EFB path starts here
    bst = lgt.train(params, ds, num_boost_round=EFB_ROUNDS, valid_sets=[dv],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, callbacks=[clock],
                    keep_training_booster=True)
    launches = launch_count()   # ... and ends here
    gbdt = bst._gbdt
    replay_note(gbdt)
    plan = gbdt.efb_plan
    text = bst.model_to_string()
    aucs = evals["valid"]["auc"]
    n_trees = len(bst.trees)
    print(f"  data {X.shape[0]} x {X.shape[1]} CSR, {X.nnz} stored values "
          f"({X.nnz / X.shape[0] / X.shape[1] * 100:.2f}% dense), made in "
          f"{gen_s:.2f} s; host binning (train + {BOSCH_VALID} valid rows) "
          f"{bin_s:.2f} s; {cd.num_features} used features of "
          f"{cd.max_num_bin} bins at most", flush=True)
    if plan is None or gbdt.bundle is None:
        fail(f"EFB: the booster did not bundle (auto decision "
             f"{gbdt.efb_wins})")
    unb_bytes = cd.X_binned.nbytes
    b_bytes = gbdt.Xb.numel() * gbdt.Xb.element_size()
    print(f"  EFB plan: {cd.num_features} features -> {plan.num_groups} "
          f"bundles, max bundle bins {plan.max_bundle_bins} (padded to "
          f"{gbdt.spec.hist_bins}), codes {gbdt.Xb.dtype}; enable_bundle="
          f"auto resolved to {str(gbdt.efb_wins).lower()}; code matrix on the "
          f"card {b_bytes / 1e6:.1f} MB bundled against "
          f"{unb_bytes / 1e6:.1f} MB unbundled", flush=True)
    score = gbdt.score[0].cpu().numpy()
    train_auc = auc_of(1.0 / (1.0 + np.exp(-score.astype(np.float64))), y)
    print(f"  train {EFB_ROUNDS} rounds: first iteration {clock.ms(0, 1):.1f} "
          f"ms, then {clock.ms(1):.1f} ms per iteration (valid scoring and "
          f"AUC included); histogram kernel launches {launches} = "
          f"{launches / max(n_trees, 1):.1f} passes per tree; train AUC "
          f"{train_auc:.5f}; valid AUC by round "
          f"{', '.join(f'{a:.5f}' for a in aucs)}", flush=True)
    if plan.num_groups != BOSCH_G or gbdt.spec.hist_bins != BOSCH_BB:
        fail(f"EFB: {plan.num_groups} bundles of {gbdt.spec.hist_bins} bins, "
             f"not {BOSCH_G} of {BOSCH_BB}")
    if launches <= 0 or not aucs[-1] > 0.6 or not train_auc > 0.6:
        fail("EFB: the path did not launch the kernel or learn")
    # the bundle-space scan and the bundled routing of one wave, at the
    # wave's shape: 2S touched leaves, S split leaves
    spec = gbdt.spec
    S2 = 2 * spec.hist_slots
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hist = torch.floor(torch.rand((S2, plan.num_groups, spec.hist_bins, 3),
                                  generator=gen, device=dev) * 64) / 8
    hist[..., 0] -= 4
    hist = hist * (gbdt.bundle.code_feat >= 0)[None, :, :, None]
    par = [hist[:, 0, :, j].sum(dim=1) * 2 for j in range(3)]
    bm = BlockMeta(gbdt.feature_ok, gbdt.num_bins, gbdt.missing_code,
                   gbdt.default_bin, gbdt.is_cat, 0, None)

    def scan():
        find_block_splits(hist, *par, bm, spec, gbdt.bundle)
    scan_ops = device_ops(scan)
    L = spec.num_leaves
    lid = torch.randint(0, S2, (BOSCH_ROWS,), generator=gen, device=dev,
                        dtype=torch.int32)
    feats = torch.randint(0, cd.num_features, (spec.hist_slots,),
                          generator=gen, device=dev)
    bd = gbdt.bundle
    table = torch.zeros((L + 1, 11), dtype=torch.int32, device=dev)
    table[:, 0] = -1
    table[:, 2] = -1
    k = torch.arange(spec.hist_slots, device=dev)
    table[k] = torch.stack(
        [feats, torch.ones_like(feats), -torch.ones_like(feats),
         spec.hist_slots + k, torch.zeros_like(feats),
         torch.zeros_like(feats), bd.col[feats].long(), bd.lo[feats].long(),
         bd.hi[feats].long(), bd.off[feats].long(),
         gbdt.default_bin[feats].long()], dim=-1).to(torch.int32)

    def route():
        _route_rows(gbdt.Xb, lid, table)
    route_ops = device_ops(route)
    # the routing's device ms also from CUDA events (it never waits on the
    # host): the profiler has returned no device events for its few small
    # kernels in some calls
    print(f"  one wave at this shape: bundle-space scan ({S2} leaves x "
          f"{plan.num_groups} columns x {spec.hist_bins} bins) {scan_ops[0]} "
          f"device operations ({scan_ops[1]} kernel launches), "
          f"{scan_ops[2]:.3f} ms device, {sync_ms(scan):.2f} ms host; "
          f"bundled routing of {BOSCH_ROWS} rows {route_ops[0]} device "
          f"operations ({route_ops[1]} kernel launches), {route_ops[2]:.3f} "
          f"ms device ({cuda_time_ms(route, 10):.3f} by events), "
          f"{sync_ms(route):.2f} ms host", flush=True)
    del hist, lid, table
    t0 = time.perf_counter()
    vpred = bst.predict(Xv)
    pred_ms = (time.perf_counter() - t0) * 1e3
    vauc = auc_of(vpred, yv)
    print(f"  Booster.predict on the {BOSCH_VALID}-row CSR valid set "
          f"{pred_ms:.1f} ms; its AUC {vauc:.6f}, the running valid score's "
          f"{aucs[-1]:.6f} (tol 1e-5)", flush=True)
    if not abs(vauc - aucs[-1]) <= 1e-5:
        fail("EFB: Booster.predict disagrees with the valid score")
    del bst, gbdt
    torch.cuda.empty_cache()
    again = lgt.train(params, ds, num_boost_round=EFB_ROUNDS)
    same = again.model_to_string() == text
    print(f"  second run: identical model text {same}; sha256 "
          f"{text_digest(text)}", flush=True)
    if not same:
        fail("EFB: two runs gave different models")
    off_clock = IterClock()
    before = launch_count()
    off = lgt.train(dict(params, enable_bundle=False), ds,
                    num_boost_round=EFB_ROUNDS, callbacks=[off_clock],
                    keep_training_booster=True)
    off_launches = launch_count() - before
    off_bytes = off._gbdt.Xb.numel() * off._gbdt.Xb.element_size()
    same_splits, n_diff, n_nodes, first = compare_splits(again, off)
    print(f"  enable_bundle=false on the same data: {off._gbdt.Xb.shape[1]} "
          f"columns, {off_bytes / 1e6:.1f} MB of codes on the card; "
          f"{off_clock.ms(1):.1f} ms per iteration (without a valid set); "
          f"histogram kernel launches {off_launches}; binary gradients "
          f"(arbitrary floats): same split features and thresholds as the "
          f"bundled run {same_splits} ({n_diff} of {n_nodes} nodes differ; "
          f"first difference {first})", flush=True)
    del off
    torch.cuda.empty_cache()
    # exact arithmetic: gradients on a grid of 1/4 and unit hessians keep
    # every histogram sum exact in f32, so the bundled and the unbundled
    # scan must give the same model bit for bit (the JAX package's trio
    # bar, tests/test_efb_bundlespace.py)
    exact = dict(params, objective="none", boost_from_average=False,
                 metric="none")
    texts = []
    for eb in ("auto", "false"):
        before = launch_count()
        b = lgt.train(dict(exact, enable_bundle=eb), ds,
                      num_boost_round=EXACT_ROUNDS, fobj=quarter_residuals,
                      keep_training_booster=True)
        off_launches += launch_count() - before
        texts.append((b.model_to_string(), b._gbdt.bundle is not None,
                      sum(t.num_leaves for t in b.trees)))
        del b
    same_exact = texts[0][0] == texts[1][0]
    print(f"  exact-arithmetic gradients (1/4 grid), {EXACT_ROUNDS} rounds: "
          f"bundled ({texts[0][1]}) and enable_bundle=false ({texts[1][1]}) "
          f"identical model text {same_exact} ({texts[0][2]} leaves)",
          flush=True)
    if not same_exact or not texts[0][1] or texts[1][1]:
        fail("EFB: the bundled scan differs from the unbundled one on "
             "exact-arithmetic gradients")
    del again, ds, dv
    torch.cuda.empty_cache()
    return dict(launches=launches + off_launches, ms_per_iter=clock.ms(1),
                groups=plan.num_groups)


def linear_phase(mres, dev):
    """Phase 12: linear leaves at the main path's width."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    from lightgbm_tpu_torch.ops.linear import (accumulate_leaf_moments,
                                               fit_linear_leaves,
                                               leaf_path_features,
                                               solve_leaf_models)
    from lightgbm_tpu_torch.ops.predict import (forest_predict_raw,
                                                leaves_from_binned)
    _, X, y = mres["data"]
    Xv, yv = higgs_like(NV, SEED + 1)
    params = dict(MAIN_PARAMS, linear_tree=True, linear_lambda=0.01,
                  metric="auc")
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, params=params)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    bin_s = time.perf_counter() - t0
    evals, clock = {}, IterClock()
    reset_launch_count()          # the linear path starts here
    bst = lgt.train(params, ds, num_boost_round=LINEAR_ROUNDS,
                    valid_sets=[dv], valid_names=["valid"],
                    evals_result=evals, verbose_eval=False,
                    callbacks=[clock], keep_training_booster=True)
    launches = launch_count()   # ... and ends here
    gbdt = bst._gbdt
    replay_note(gbdt)
    text = bst.model_to_string()
    aucs = evals["valid"]["auc"]
    n_leaves = sum(t.num_leaves for t in bst.trees)
    n_linear = sum(sum(len(f) > 0 for f in t.leaf_features)
                   for t in bst.trees)
    n_degraded = int(sum(int(d) for d in gbdt.linear_degraded))
    score = gbdt.score[0].cpu().numpy().astype(np.float64)
    train_auc = auc_of(1.0 / (1.0 + np.exp(-score)), y)
    const = lgt.Booster(model_str=mres["text"])
    const_vauc = auc_of(const.predict(Xv), yv)
    # the fit of the last tree, timed apart: its inputs as the step gave them
    tree = gbdt.models[-1][0]
    leaves = leaves_from_binned(tree, gbdt.Xb, gbdt.num_bins,
                                gbdt.missing_code, gbdt.default_bin)
    g, h = gbdt._gradients(gbdt.score)
    mask = gbdt.pad_mask
    cfg = gbdt.config

    def fit():
        fit_linear_leaves(tree, *gbdt.raw, leaves, g[0], h[0], mask,
                          gbdt.is_cat, max_features=cfg.linear_max_features,
                          linear_lambda=cfg.linear_lambda)
    lf, hc, nf = leaf_path_features(tree, gbdt.is_cat,
                                    cfg.linear_max_features)

    def moments():
        return accumulate_leaf_moments(*gbdt.raw, leaves, lf, g[0], h[0],
                                       mask)
    mom = moments()

    def solve():
        solve_leaf_models(*mom[:2], lf, nf, hc, mom[2], cfg.linear_lambda)
    fit_ops, mom_ops, solve_ops = device_ops(fit), device_ops(moments), \
        device_ops(solve)
    fit_ms = sync_ms(fit)
    print(f"  host binning (train and {NV} valid rows, raw values kept) "
          f"{bin_s:.2f} s; train {LINEAR_ROUNDS} rounds: first iteration "
          f"{clock.ms(0, 1):.1f} ms, then {clock.ms(1):.1f} ms per iteration "
          f"(valid scoring and AUC included); histogram kernel launches "
          f"{launches}", flush=True)
    print(f"  linear fit of one tree: {fit_ms:.2f} ms host "
          f"({fit_ms / clock.ms(1) * 100:.1f}% of an iteration), "
          f"{fit_ops[0]} device operations ({fit_ops[1]} kernel launches), "
          f"{fit_ops[2]:.3f} ms device; of which moments {mom_ops[0]} "
          f"operations {mom_ops[2]:.3f} ms device, solve (one batched "
          f"Cholesky) {solve_ops[0]} operations {solve_ops[2]:.3f} ms "
          f"device", flush=True)
    print(f"  leaves {n_leaves}: linear {n_linear}, degraded {n_degraded}; "
          f"train AUC {train_auc:.5f} (phase 4's constant leaves "
          f"{mres['auc']:.5f}); valid AUC by round "
          f"{', '.join(f'{a:.5f}' for a in aucs)} (constant leaves "
          f"{const_vauc:.5f})", flush=True)
    if launches <= 0 or n_linear <= 0 or not aucs[-1] > 0.6:
        fail("linear: the path did not launch the kernel or fit linear "
             "leaves")
    t0 = time.perf_counter()
    pred = bst.predict(X, raw_score=True)
    pred_ms = (time.perf_counter() - t0) * 1e3
    n_host = 10_000
    dev_raw = forest_predict_raw(bst.trees, X[:n_host], X.shape[1], dev)
    host_raw = np.zeros(n_host)
    for t in bst.trees:
        host_raw += t.predict(np.asarray(X[:n_host], np.float64))
    pdiff = float(np.abs(dev_raw - host_raw).max())
    print(f"  Booster.predict of {X.shape[0]} rows (device linear walk) "
          f"{pred_ms:.1f} ms, finite {bool(np.isfinite(pred).all())}; on "
          f"{n_host} rows the device walk against the host Tree.predict: "
          f"max diff {pdiff:.3e} (tol 1e-5)", flush=True)
    if not np.isfinite(pred).all() or not pdiff <= 1e-5:
        fail("linear: the device walk disagrees with Tree.predict")
    del bst, gbdt, g, h, leaves, mom
    torch.cuda.empty_cache()
    again = lgt.train(params, ds, num_boost_round=LINEAR_ROUNDS)
    same = again.model_to_string() == text
    print(f"  second run: identical model text {same}; sha256 "
          f"{text_digest(text)}", flush=True)
    if not same:
        fail("linear: two runs gave different models")
    del again, ds, dv
    torch.cuda.empty_cache()
    return dict(launches=launches, ms_per_iter=clock.ms(1))


# Phase-10 cases that leave the CPU's result through the objective's
# transcendental functions alone (ROADMAP C12): torch's ``exp`` on the card
# and on the CPU round apart by an ulp or more (C2), and a split whose gain
# is 0 in exact arithmetic (a leaf whose rows share one g/h ratio, as the
# rows of one earlier leaf do) falls on either side of 0 by that rounding;
# L1's leaf values divide by a small sum of Gaussian hessians. Such a case
# must give the CPU's splits and predictions when both devices get the
# same gradients, computed on the CPU.
OBJECTIVE_ULP_CASES = ("multiclass", "regression_l1",
                       "categorical (sorted and one-hot)",
                       "EFB, max_conflict_rate 0.05")


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
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
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
                             num_boost_round=CARD_CPU_ROUNDS, fobj=fobj)
        before = launch_count()
        on_card = run({})
        launched = launch_count() - before
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


def linear_fit_agreement(bst, name):
    """The linear fit of the card's last tree, run on the card and on the
    CPU from the same inputs (the card's tree and leaves, gradients
    computed on the CPU): the same linear leaves, coefficients within 1e-5
    of their scale."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.grower import TreeArrays
    from lightgbm_tpu_torch.ops.linear import fit_linear_leaves
    from lightgbm_tpu_torch.ops.predict import leaves_from_binned
    g = bst._gbdt
    tree = g.models[-1][0]
    leaves = leaves_from_binned(tree, g.Xb, g.num_bins, g.missing_code,
                                g.default_bin)
    gc, hc = g.objective.gradients(g.score.cpu(), g.label.cpu(), None)
    cfg = g.config
    out = []
    for dev in (g.device, torch.device("cpu")):
        t = TreeArrays(*[None if a is None else a.to(dev) for a in tree])
        fitted, _ = fit_linear_leaves(
            t, *[a.to(dev) for a in g.raw], leaves.to(dev), gc[0].to(dev),
            hc[0].to(dev), g.pad_mask.to(dev), g.is_cat.to(dev),
            max_features=cfg.linear_max_features,
            linear_lambda=cfg.linear_lambda)
        out.append([fitted.leaf_feat.cpu().numpy(),
                    fitted.leaf_const.cpu().numpy(),
                    fitted.leaf_coeff.cpu().numpy()])
    same_feats = np.array_equal(out[0][0], out[1][0])
    scale = max(1.0, float(np.abs(out[1][2]).max()),
                float(np.abs(out[1][1]).max()))
    diff = max(float(np.abs(out[0][1] - out[1][1]).max()),
               float(np.abs(out[0][2] - out[1][2]).max()))
    print(f"    {name}: the last tree's fit on the same inputs, card vs "
          f"CPU: same linear leaves {same_feats} "
          f"({int((out[1][0][:, 0] >= 0).sum())} linear), max coefficient "
          f"diff {diff:.3e} (scale {scale:.3e}, tol 1e-5 of it)", flush=True)
    if not same_feats or not diff <= 1e-5 * scale:
        fail(f"{name}: the linear fit differs card vs CPU on the same "
             "inputs")


def linear_divergence_report(params, X, y, fobj, rounds=5):
    """Where a linear run on the card first leaves the CPU's: both trained
    iteration by iteration on the same gradients, the first iteration whose
    train scores differ, and how its tree differs."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    boosters = [lgt.Booster(params=dict(params, **d),
                            train_set=lgt.Dataset(X, label=y))
                for d in ({}, {"device": "cpu"})]
    for it in range(rounds):
        for b in boosters:
            b.update(fobj=fobj)
        card, cpu = (b._gbdt for b in boosters)
        sd = (card.score.cpu() - cpu.score).abs()
        if float(sd.max()) == 0.0:
            continue
        ta, tb = card.models[-1][0], cpu.models[-1][0]
        diffs = {name: float((getattr(ta, name).cpu().double()
                              - getattr(tb, name).double()).abs().max())
                 for name in ta._fields}
        rows = np.nonzero(sd.numpy()[0] > 0)[0]
        nan_rows = np.isnan(np.asarray(X)[rows]).any(axis=1).mean()
        print(f"    iteration {it}: train scores differ on {len(rows)} rows "
              f"(max {float(sd.max()):.3e}, {nan_rows * 100:.0f}% of them "
              f"with a NaN), the tree's differences by field {diffs}",
              flush=True)
        from lightgbm_tpu_torch.ops.predict import leaves_from_binned
        la = leaves_from_binned(ta, card.Xb, card.num_bins, card.missing_code,
                                card.default_bin).cpu().numpy()
        lb = leaves_from_binned(tb, cpu.Xb, cpu.num_bins, cpu.missing_code,
                                cpu.default_bin).numpy()
        lc = (ta.leaf_const.cpu() - tb.leaf_const).abs().numpy()
        bad = np.nonzero(lc > 0)[0]
        print(f"    walked leaves differ on {int((la != lb).sum())} rows; "
              f"leaves whose intercept differs {bad.tolist()[:8]}: their "
              f"rows {[int((lb == k).sum()) for k in bad[:8]]}, features "
              f"card {ta.leaf_feat.cpu().numpy()[bad[:4]].tolist()} CPU "
              f"{tb.leaf_feat.numpy()[bad[:4]].tolist()}, intercepts card "
              f"{ta.leaf_const.cpu().numpy()[bad[:4]].tolist()} CPU "
              f"{tb.leaf_const.numpy()[bad[:4]].tolist()}", flush=True)
        return
    print(f"    the train scores agree over {rounds} iterations", flush=True)


def card_vs_cpu_new_cases(Xh, yh):
    """Phase 10's cases for EFB and linear leaves: the same bar, the
    bundling or the linear fit checked engaged on the card."""
    import numpy as np
    from scipy import sparse as sp
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    Xb, yb = bosch_like(SMALL, seed=SEED + 13)
    rng = np.random.RandomState(SEED + 14)
    cat = rng.randint(0, 6, SMALL).astype(np.float32)
    ycat = np.where(cat >= 4, 1.0 - yb, yb).astype(np.float32)
    Xcat = sp.hstack([Xb, sp.csr_matrix(cat[:, None])]).tocsr()
    wide = np.round(rng.randn(SMALL) * 1000).astype(np.float32)
    Xwide = sp.hstack([Xb, sp.csr_matrix(wide[:, None])]).tocsr()
    Xn, yn = near_exclusive(SMALL, seed=SEED + 15)
    Xp, yp = piecewise_linear_data(SMALL)
    small = dict(MAIN_PARAMS, num_leaves=63)
    linear = dict(linear_tree=True, linear_lambda=0.01)
    cases = {   # name: (params, X, label, Dataset kwargs, what must engage)
        "EFB, Bosch-shaped CSR at auto": (small, Xb, yb, {}, "bundle"),
        "EFB + categorical": (
            dict(small, min_data_per_group=20), Xcat, ycat,
            {"categorical_feature": [BOSCH_F]}, "bundle"),
        "EFB, max_conflict_rate 0.05": (
            dict(small, max_conflict_rate=0.05), Xn, yn, {}, "bundle"),
        "EFB, uint16 bundles (max_bin 511)": (
            dict(small, max_bin=511), Xwide, yb, {}, "uint16"),
        "linear_tree, L2 piecewise-linear": (
            dict(small, objective="regression", **linear), Xp, yp, {},
            "linear"),
        "linear_tree, binary with NaN": (dict(small, **linear), Xh, yh, {},
                                          "linear"),
    }
    total = 0
    for name, (p, Xc_, yc, kw, engage) in cases.items():
        def run(device_params, fobj=None):
            return lgt.train(dict(p, **device_params),
                             lgt.Dataset(Xc_, label=yc, **kw),
                             num_boost_round=CARD_CPU_ROUNDS, fobj=fobj,
                             keep_training_booster=True)
        before = launch_count()
        on_card = run({})
        launched = launch_count() - before
        total += launched
        g = on_card._gbdt
        engaged = {"bundle": g.bundle is not None,
                   "uint16": g.bundle is not None
                   and str(g.Xb.dtype) == "torch.int16",
                   "linear": any(len(f) for t in on_card.trees
                                 for f in t.leaf_features or [])}[engage]
        detail = (f"{g.Xb.shape[1]} bundled columns, {g.Xb.dtype} codes"
                  if g.bundle is not None else f"{g.Xb.shape[1]} columns")
        on_cpu = run({"device": "cpu"})
        splits = same_trees(on_card, on_cpu)
        pdiff = float(np.abs(on_card.predict(Xc_)
                             - on_cpu.predict(Xc_)).max())
        print(f"  {len(yc)} rows, {name}: same splits {splits} "
              f"({len(on_card.trees)} trees; {detail}; {engage} engaged "
              f"{engaged}), max prediction diff {pdiff:.3e} (tol 1e-5), "
              f"histogram kernel launches {launched}", flush=True)
        if launched <= 0 or not engaged:
            fail(f"{len(yc)} rows, {name}: the kernel never launched or "
                 f"{engage} did not engage")
        if engage == "linear":
            linear_fit_agreement(on_card, name)
        if splits and pdiff <= 1e-5:
            continue
        print(f"    first difference (tree, node, [(feature, threshold, "
              f"gain) card, CPU]): {compare_splits(on_card, on_cpu)[3]}",
              flush=True)
        # as C12: the same case with the CPU's gradients on both devices
        hp = dict(p, objective="none", boost_from_average=False)
        fobj = host_gradient_fobj(dict(p, device="cpu"), yc, None, len(yc))
        if engage == "linear":
            linear_divergence_report(hp, Xc_, yc, fobj)
        if name not in OBJECTIVE_ULP_CASES:
            fail(f"{len(yc)} rows, {name}: the card disagrees with the CPU")
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
    return total


BATCH_ROUNDS = 16                  # phase 13's rounds per arm
BATCH_STEADY = 8                   # ... then iterations timed apart
BATCH_PROFILED = 4                 # ... and under the profiler


def _arm_stats(gbdt):
    """(replays, flag reads, trees) of a booster's captured iteration so
    far; zeros for an eager booster."""
    r = gbdt._graphs
    return (0, 0, 0) if r is None else (r.replays, r.syncs, r.trees)


def _steady_arm(bst, label):
    """ms per steady iteration, host syncs per tree and graph replays per
    iteration over ``BATCH_STEADY`` iterations of one batch call (the
    booster's own ``tree_batch``), then device busy ms and idle share from
    a profiler window of ``BATCH_PROFILED`` iterations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.analysis import CaptureGuard
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    gbdt = bst._gbdt
    K = gbdt.num_models
    r0, s0, t0_trees = _arm_stats(gbdt)
    # the guard counts the runner's flag reads and the calls
    # set_sync_debug_mode flags (analysis/guards.py)
    guard = CaptureGuard(label, fail=False, device="cuda")
    guard.register(gbdt._graphs, "iteration")
    torch.cuda.synchronize()
    with guard:
        guard.mark_warm()
        t0 = time.perf_counter()
        try:
            gbdt.train_batch(BATCH_STEADY)
            torch.cuda.synchronize()
        finally:
            t1 = time.perf_counter()
    r1, s1, t1_trees = _arm_stats(gbdt)
    debug_syncs = guard.host_syncs - (s1 - s0)
    trees = BATCH_STEADY * K
    ms = (t1 - t0) / BATCH_STEADY * 1e3
    reads = s1 - s0
    counted = launch_count()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        p0 = time.perf_counter()
        gbdt.train_batch(BATCH_PROFILED)
        torch.cuda.synchronize()
        p1 = time.perf_counter()
    counted = launch_count() - counted
    kernels = device_kernels(prof.key_averages())
    # the device counter against the passes the profile saw run, graph
    # replays included
    passes = sum(e.count for e in kernels if "finalize_kernel" in e.key)
    prof_ms = (p1 - p0) / BATCH_PROFILED * 1e3
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / BATCH_PROFILED
    n_ops = sum(e.count for e in kernels) / BATCH_PROFILED
    r = gbdt._graphs
    cap = (f"capture {r.capture_s:.2f} s, instantiate {r.instantiate_s:.2f}"
           f" s over {len(r.graphs)} graphs; " if r is not None else "")
    print(f"  {label}: {ms:.2f} ms per steady iteration ({BATCH_STEADY} "
          f"iterations in one train_batch call); host syncs per tree "
          f"{(reads + debug_syncs) / trees:.2f} ({reads} flag reads + "
          f"{debug_syncs} synchronizing calls flagged by "
          f"set_sync_debug_mode over {trees} trees); graph replays per "
          f"iteration {(r1 - r0) / BATCH_STEADY:.1f}; {cap}profiled "
          f"{prof_ms:.2f} ms per iteration, device busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / prof_ms:.3f}), {n_ops:.0f} device "
          f"operations per iteration; B1 passes counted on the card "
          f"{counted}, finalize_kernel launches in the profile {passes}",
          flush=True)
    if counted != passes or passes == 0:
        fail(f"{label}: the device launch count ({counted}) differs from "
             f"the passes in the profile ({passes})")
    if r is not None and t1_trees - t0_trees != trees:
        fail(f"{label}: {t1_trees - t0_trees} of {trees} trees replayed")
    return dict(ms=ms, busy_ms=busy_ms, prof_ms=prof_ms,
                syncs_per_tree=(reads + debug_syncs) / trees,
                replays_per_iter=(r1 - r0) / BATCH_STEADY)


def _eager_and_captured(label, params, ds, rounds, valid=None):
    """The model text of an eager and of a captured run on the card, which
    must be byte-identical."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    texts = []
    for capture in (False, True):
        GBDT._capture = capture
        try:
            t0 = time.perf_counter()
            bst = lgt.train(params, ds, num_boost_round=rounds,
                            valid_sets=[valid] if valid is not None else None,
                            verbose_eval=False, keep_training_booster=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            GBDT._capture = True
        runner = bst._gbdt._graphs
        if capture and (runner is None or runner.trees == 0):
            fail(f"{label}: the captured run replayed no tree")
        texts.append(bst.model_to_string())
        print(f"  {label}, {'captured' if capture else 'eager'}: {rounds} "
              f"rounds in {secs:.2f} s, sha256 "
              f"{text_digest(texts[-1])}", flush=True)
        del bst
        torch.cuda.empty_cache()
    same = texts[0] == texts[1]
    print(f"  {label}: captured model text identical to eager {same}",
          flush=True)
    if not same:
        fail(f"{label}: the captured run's model differs from the eager one")


def tree_batch_phase(mres):
    """Phase 13: one iteration as CUDA graph replays, and ``tree_batch``,
    at the main path's width, against the eager loop on the card."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    ds, X, y = mres["data"]
    # the alternative to speculative waves: guarded waves under conditional
    # graph nodes, where this torch has them (not used by the port)
    print(f"  torch {torch.__version__}: conditional graph nodes "
          f"(CUDAGraph.begin_capture_to_if_node) "
          f"{hasattr(torch._C._CUDAGraph, 'begin_capture_to_if_node')}",
          flush=True)
    Xv, yv = higgs_like(NV, SEED + 1)
    dv = lgt.Dataset(Xv, label=yv, reference=ds).construct()
    params = dict(MAIN_PARAMS, metric="auc", metric_freq=8)
    arms = (("eager", 1, False), ("captured K=1", 1, True),
            ("captured K=8", 8, True))
    texts, evals, stats = {}, {}, {}
    launches = 0
    for label, k, capture in arms:
        GBDT._capture = capture
        ev = {}
        try:
            reset_launch_count()   # the arm's path starts
            t0 = time.perf_counter()
            bst = lgt.train(dict(params, tree_batch=k), ds,
                            num_boost_round=BATCH_ROUNDS, valid_sets=[dv],
                            valid_names=["valid"], evals_result=ev,
                            verbose_eval=False, keep_training_booster=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            arm_launches = launch_count()   # ... ends here
            texts[label] = bst.model_to_string()
            # the first 10 trees' text: phase 4's up to the feature
            # importances, which count every tree of the model
            head = bst.model_to_string(num_iteration=10).split(
                "feature importances:")[0]
            evals[label] = ev["valid"]["auc"]
            print(f"  {label}: {BATCH_ROUNDS} rounds in {secs:.2f} s with "
                  f"valid AUC at iterations 8 and 16 {evals[label]}; "
                  f"histogram kernel launches {arm_launches} = "
                  f"{arm_launches / BATCH_ROUNDS:.1f} per tree; the first 10 "
                  f"trees are phase 4's (sha256 {mres['digest']}) "
                  f"{head == mres['text'].split('feature importances:')[0]}",
                  flush=True)
            if head != mres["text"].split("feature importances:")[0]:
                fail(f"{label}: the first 10 trees differ from phase 4's")
            if arm_launches <= 0:
                fail(f"{label}: the histogram kernel never launched")
            launches += arm_launches
            stats[label] = _steady_arm(bst, label)
        finally:
            GBDT._capture = True
        del bst
        torch.cuda.empty_cache()
    same = len({texts[a[0]] for a in arms}) == 1
    same_eval = evals["captured K=8"] == evals["captured K=1"] \
        == evals["eager"]
    print(f"  model text identical across the three arms {same}; K=8 eval "
          f"history equal to K=1's at iterations 8 and 16 {same_eval}",
          flush=True)
    if not same:
        fail("tree_batch: the arms' model texts differ")
    if not same_eval or len(evals["captured K=8"]) != 2:
        fail("tree_batch: the K=8 eval history differs from K=1's")
    _eager_and_captured(
        "sampled (bagging 0.8 every 5, feature_fraction 0.8, 10 rounds)",
        dict(SAMPLED_PARAMS, metric="auc"), ds, 10, valid=dv)
    Xm, ym = multiclass_like(N, SEED + 7)
    mparams = dict(MAIN_PARAMS, objective="multiclass", num_class=NUM_CLASS,
                   metric="multi_logloss")
    dm = lgt.Dataset(Xm, label=ym)
    dm.construct(lgt.Config.from_params(mparams))
    _eager_and_captured(f"multiclass ({NUM_CLASS} classes, 3 rounds)",
                        mparams, dm, 3)
    return dict(launches=launches, stats=stats,
                k8_text=texts["captured K=8"])


SERVE_ROUNDS = 500                 # the reference GPU benchmark's HIGGS run
SERVE_POOL = 8192                  # request rows, predicted once on the host
SERVE_CLIENTS = 32
SERVE_REQUESTS = 10_000            # closed-loop requests, all clients
SERVE_OPEN_S = 4.0                 # seconds of each open loop
SERVE_OPEN_MAX = 4                 # the longest open loop across a reload,
                                   # in multiples of SERVE_OPEN_S


def _serve_rows(X, seed):
    """A pool of request rows from phase 4's features, as f64, with zero
    cells planted beside the two NaN columns."""
    import numpy as np
    rng = np.random.default_rng(seed)
    P = np.array(X[:SERVE_POOL], np.float64)
    P[rng.random(P.shape) < 0.03] = 0.0
    P[rng.random(P.shape) < 0.02] = np.nan
    return P


def _closed_loop(mb, pool, expect, clients, requests, seed):
    """``clients`` threads, back to back, each request 1-64 rows of the
    pool at a random offset; every response is held to the host
    prediction of its own rows. Returns latencies (ms), rows, wall s and
    the mismatches."""
    import threading
    import numpy as np
    per = requests // clients
    lats = [[] for _ in range(clients)]
    rows = [0] * clients
    bad = []
    gate = threading.Barrier(clients + 1)

    def client(w):
        rng = np.random.default_rng(seed + w)
        gate.wait()
        for _ in range(per):
            n = int(rng.integers(1, 65))
            lo = int(rng.integers(0, len(pool) - n))
            t0 = time.perf_counter()
            out = mb.predict(pool[lo:lo + n])
            lats[w].append((time.perf_counter() - t0) * 1e3)
            rows[w] += n
            if not np.array_equal(out, expect[lo:lo + n]):
                bad.append((lo, n))

    threads = [threading.Thread(target=client, args=(w,), daemon=True)
               for w in range(clients)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return ([v for per_w in lats for v in per_w], sum(rows),
            time.perf_counter() - t0, bad)


def _open_loop(mb, pool, expects, rate, seconds, seed, during=None):
    """Poisson arrivals at ``rate`` requests/s for ``seconds`` (latency from
    the scheduled arrival, so queueing counts), each request 1-64 rows;
    every response must equal one of ``expects`` on its rows (the model
    versions that may serve). ``during`` runs on this thread after a
    quarter of the schedule, and arrivals then go on until a quarter of
    ``seconds`` after it returns (at most ``SERVE_OPEN_MAX`` times
    ``seconds`` in all), so traffic lies on both sides of it however long
    it takes. Returns latencies, rows, wall s, mismatches, the versions
    seen and what ``during`` returned."""
    import threading
    import numpy as np
    rng = np.random.default_rng(seed)
    horizon = seconds * (1 if during is None else SERVE_OPEN_MAX)
    n_req = max(1, int(rate * horizon))
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_req))
    sizes = rng.integers(1, 65, n_req)
    offs = rng.integers(0, len(pool) - 64, n_req)
    lats, bad, seen = [], [], set()
    rows = [0]
    lock = threading.Lock()
    nxt = [0]
    workers = max(8, min(64, int(rate * 0.02) + 8))
    start = [0.0]
    # the last arrival's time from the start: open until ``during`` returns
    end = [seconds if during is None else horizon]
    gate = threading.Barrier(workers + 1)

    def worker():
        gate.wait()
        while True:
            with lock:
                i = nxt[0]
                if i >= n_req or arrivals[i] > end[0]:
                    return
                nxt[0] += 1
            lo, n = int(offs[i]), int(sizes[i])
            t_sched = start[0] + arrivals[i]
            delay = t_sched - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
                with lock:
                    if arrivals[i] > end[0]:   # the end was set meanwhile
                        return
            out = mb.predict(pool[lo:lo + n])
            lat = (time.perf_counter() - t_sched) * 1e3
            match = [v for v, e in enumerate(expects)
                     if np.array_equal(out, e[lo:lo + n])]
            with lock:
                lats.append(lat)
                rows[0] += n
                if len(match) == 0:
                    bad.append((lo, n))
                seen.update(match)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    start[0] = time.perf_counter()
    gate.wait()
    ret = None
    if during is not None:
        time.sleep(seconds / 4)
        ret = during()
        with lock:
            end[0] = max(seconds, time.perf_counter() - start[0]
                         + seconds / 4)
    for t in threads:
        t.join()
    return lats, rows[0], time.perf_counter() - start[0], bad, seen, ret


def _print_traffic(label, lats, rows, wall, dispatches, fill, bad):
    from lightgbm_tpu_torch.serving.loadgen import latency_stats
    st = latency_stats(lats)
    print(f"  {label}: {len(lats)} requests, {rows} rows in {wall:.3f} s = "
          f"{len(lats) / wall:.1f} requests/s, {rows / wall:.1f} rows/s; "
          f"latency p50 {st['p50_ms']} ms, p99 {st['p99_ms']} ms, max "
          f"{st['max_ms']} ms; {dispatches} dispatches, mean batch fill "
          f"{fill:.3f}; responses equal to the host prediction of their "
          f"rows {not bad}", flush=True)
    if bad:
        fail(f"{label}: {len(bad)} responses differ from the host "
             f"prediction of their rows (first at {bad[0]})")
    return st


def _mem_delta(mem0):
    """Allocated and reserved device MiB above ``mem0`` (the pair before)."""
    import torch
    torch.cuda.synchronize()
    alloc = (torch.cuda.memory_allocated() - mem0[0]) / 2**20
    reserved = (torch.cuda.memory_reserved() - mem0[1]) / 2**20
    return f"allocated {alloc:.1f} MiB, reserved {reserved:.1f} MiB"


def _serve_counters():
    from lightgbm_tpu_torch import observability as obs
    snap = obs.snapshot()
    c = snap["counters"]
    fill = snap["histograms"].get("serve.batch_fill_frac", {})
    return (sum(v for k, v in c.items() if k.startswith("serve.bucket.")),
            fill.get("count", 0), fill.get("sum", 0.0))


def _bucket_table(eng, pool):
    """Per bucket of the live model: capture seconds, one replay's device
    ms, host encode ms, H2D + D2H ms and host f64 accumulation ms per
    dispatch, and the replayed leaves against the eager walk on the same
    device inputs (bit-equal required)."""
    import torch
    from lightgbm_tpu_torch.ops.predict import forest_walk_leaves
    from lightgbm_tpu_torch.serving.engine import accumulate_leaves
    m = eng.model_snapshot()
    forest = m.forests[0]
    rows = []
    for B in eng.buckets:
        bg = m.graphs[(0, B)]
        Xb = pool[:B]
        t0 = time.perf_counter()
        for _ in range(5):
            codes, is_nan, is_zero = forest.encode_rows(Xb)
        enc_ms = (time.perf_counter() - t0) / 5 * 1e3
        with m.lock:
            bg.h_codes[:] = codes
            bg.h_nan[:] = is_nan
            bg.h_zero[:] = is_zero

            def copies():
                bg.d_in.copy_(bg.h_in, non_blocking=True)
                bg.h_out.copy_(bg.d_out, non_blocking=True)
                torch.cuda.synchronize()
            copies()
            t0 = time.perf_counter()
            for _ in range(5):
                copies()
            copy_ms = (time.perf_counter() - t0) / 5 * 1e3
            replay_ms = cuda_time_ms(bg.graph.replay, 10)
            torch.cuda.synchronize()
            replayed = bg.d_out.clone()
            eager = forest_walk_leaves(*m.dev[0], *bg.inputs(),
                                       forest.max_depth)
            torch.cuda.synchronize()
            same = bool(torch.equal(replayed, eager))
            leaves = replayed.cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(5):
            accumulate_leaves(forest, leaves, Xb)
        acc_ms = (time.perf_counter() - t0) / 5 * 1e3
        rows.append(dict(bucket=B, capture_s=m.capture_s[(0, B)],
                         replay_ms=replay_ms, encode_ms=enc_ms,
                         copy_ms=copy_ms, accumulate_ms=acc_ms,
                         bit_equal=same))
        print(f"  bucket {B:5d}: capture {m.capture_s[(0, B)]:.4f} s; one "
              f"replay {replay_ms:.4f} ms device; host encode {enc_ms:.4f} "
              f"ms, H2D + D2H {copy_ms:.4f} ms, host f64 accumulation "
              f"{acc_ms:.4f} ms per dispatch; replayed leaves bit-equal to "
              f"the eager walk {same}", flush=True)
        if not same:
            fail(f"bucket {B}: the replayed walk differs from the eager one")
    return rows


def _b6_breakdown(text, X, dev):
    """B6: ``Booster.predict`` of 2M rows x 10 trees (phase 4's model), its
    time once with the stacking and again from the booster's cache, the
    host reads per chunk (``set_sync_debug_mode``), and the same chunks
    split into host encode, H2D, walk (device ms) and leaf sum plus D2H."""
    import warnings
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.predict import forest_walk_leaves
    bst = lgt.Booster(params={"device": dev.type}, model_str=text)
    t0 = time.perf_counter()
    first = bst.predict(X)
    t1 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t2 = time.perf_counter()
            again = bst.predict(X)
            t3 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # a read is a synchronizing call made from the port's code; any other
    # (torch's own Python) is printed beside it
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    port = os.path.join(HERE, "lightgbm_tpu_torch")
    where = {}
    for w in syncs:
        key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    reads = sum(os.path.abspath(w.filename).startswith(port) for w in syncs)
    others = {str(w.message)[:120] for w in syncs
              if not os.path.abspath(w.filename).startswith(port)}
    chunk = 1 << 16
    n_chunks = -(-X.shape[0] // chunk)
    forest = bst._stacked_forests(bst.trees, 1)[0]
    walk_args = forest.to(dev)
    lv = forest.leaf_tables(dev)[0]
    t_iota = torch.arange(forest.num_trees, device=dev)[None, :]
    enc = h2d = walk = tail = 0.0
    for lo in range(0, X.shape[0], chunk):
        c = np.asarray(X[lo:lo + chunk], np.float64)
        a = time.perf_counter()
        arrs = forest.encode_rows(c)
        b = time.perf_counter()
        ins = [torch.from_numpy(v).to(dev, non_blocking=True)
               for v in arrs]
        torch.cuda.synchronize()
        d = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        leaves = forest_walk_leaves(*walk_args, *ins, forest.max_depth)
        e1.record()
        torch.cuda.synchronize()
        e = time.perf_counter()
        lv[t_iota, leaves].sum(dim=1).cpu().numpy()
        f = time.perf_counter()
        enc += b - a
        h2d += d - b
        walk += e0.elapsed_time(e1)
        tail += f - e
    same = bool(np.array_equal(first, again))
    print(f"  B6, Booster.predict of {X.shape[0]} rows x {len(bst.trees)} "
          f"trees (phase 4's model): {(t1 - t0) * 1e3:.1f} ms with the "
          f"stacking, {(t3 - t2) * 1e3:.1f} ms from the booster's cache "
          f"(the per-level walk: 3,046.5 ms, PERF.md); {n_chunks} chunks, "
          f"host reads per chunk "
          f"{reads / n_chunks:.2f}; walk depth {forest.max_depth}; split: "
          f"host encode {enc * 1e3:.1f} ms, H2D {h2d * 1e3:.1f} ms, walk "
          f"{walk:.1f} ms device, leaf sum + D2H {tail * 1e3:.1f} ms; the "
          f"two calls equal {same}; synchronizing calls by line {where}"
          f"{'; outside the port: ' + repr(sorted(others)) if others else ''}",
          flush=True)
    if reads != n_chunks:
        fail(f"B6: {reads} host reads over {n_chunks} chunks (one each "
             f"required)")
    if not same:
        fail("B6: two predictions of the same rows differ")
    return dict(ms_first=(t1 - t0) * 1e3, ms=(t3 - t2) * 1e3,
                reads_per_chunk=reads / n_chunks)


def serving_phase(mres, dev):
    """Phase 14: ``ServingEngine`` at full width on the card. A 500-round
    model of phase 4's data (captured, ``tree_batch=8``) saved to text and
    served from the file on the default ladder: captures, per-bucket
    costs, bit-identity to ``Booster.predict``'s host route, closed- and
    open-loop traffic through ``MicroBatcher``, a hot reload under the
    open loop, and B6's breakdown of ``Booster.predict``."""
    import tempfile
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import observability as obs
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        launch_count, reset_launch_count)
    from lightgbm_tpu_torch.serving import MicroBatcher, ServingEngine
    ds, X, y = mres["data"]
    reset_launch_count()   # the phase's training starts
    t0 = time.perf_counter()
    bst = lgt.train(dict(MAIN_PARAMS, tree_batch=8), ds,
                    num_boost_round=SERVE_ROUNDS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_count()   # ... ends here
    print(f"  train {SERVE_ROUNDS} rounds captured (tree_batch=8) in "
          f"{train_s:.2f} s = {train_s / SERVE_ROUNDS * 1e3:.2f} ms per "
          f"iteration; B1 passes counted on the card {launches} = "
          f"{launches / SERVE_ROUNDS:.1f} per tree", flush=True)
    if launches <= 0:
        fail("phase 14: the histogram kernel never launched")
    obs.reset_for_tests()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "higgs_500.txt")
        bst.save_model(path)
        del bst
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        pool = _serve_rows(X, SEED + 14)
        torch.cuda.synchronize()
        mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        t0 = time.perf_counter()
        eng = ServingEngine(path, params={"device": dev.type, "verbose": -1})
        setup_s = time.perf_counter() - t0
        live = eng.model_snapshot()
        torch.cuda.synchronize()
        mem_warm = _mem_delta(mem0)
        caps = eng.captures()
        print(f"  ServingEngine from the model file: {len(live.trees)} "
              f"trees, walk depth {live.forests[0].max_depth}, buckets "
              f"{eng.buckets}; load, stack and warmup {setup_s:.2f} s; "
              f"captures after warmup {caps} "
              f"({sum(live.capture_s.values()):.2f} s); "
              f"device memory above the engine's start {mem_warm}",
              flush=True)
        if caps != len(eng.buckets):
            fail(f"phase 14: {caps} captures at warmup, {len(eng.buckets)} "
                 f"expected")
        _bucket_table(eng, pool)
        host = eng.booster
        expect = host.predict(pool, force_host_predict=True)
        expect_250 = host.predict(pool, num_iteration=250,
                                  force_host_predict=True)
        X4 = pool[:4096]
        served = eng.predict(X4)
        same = bool(np.array_equal(served, expect[:4096]))
        print(f"  engine.predict of 4096 rows (NaN and zero cells) equal to "
              f"Booster.predict(force_host_predict=True) bit for bit "
              f"{same}", flush=True)
        if not same:
            fail("phase 14: served predictions differ from the host's")
        # traffic through the micro-batcher
        d0, f0, s0 = _serve_counters()
        with MicroBatcher(eng) as mb:
            lats, rows, wall, bad = _closed_loop(
                mb, pool, expect, SERVE_CLIENTS, SERVE_REQUESTS, SEED)
            d1, f1, s1 = _serve_counters()
            closed = _print_traffic(
                f"closed loop ({SERVE_CLIENTS} clients, 1-64 rows)", lats,
                rows, wall, d1 - d0, (s1 - s0) / max(f1 - f0, 1), bad)
            rate = len(lats) / wall / 2
            lats, rows, wall, bad, seen, _ = _open_loop(
                mb, pool, [expect], rate, SERVE_OPEN_S, SEED + 1)
            d2, f2, s2 = _serve_counters()
            opened = _print_traffic(
                f"open loop (Poisson at {rate:.1f} requests/s)", lats, rows,
                wall, d2 - d1, (s2 - s1) / max(f2 - f1, 1), bad)

            def reload():
                t = time.perf_counter()
                v = eng.reload(path, params={"device": dev.type,
                                             "verbose": -1},
                               num_iteration=250)
                return v, time.perf_counter() - t

            lats, rows, wall, bad, seen, (ver, reload_s) = _open_loop(
                mb, pool, [expect, expect_250], rate, SERVE_OPEN_S,
                SEED + 2, during=reload)
            d3, f3, s3 = _serve_counters()
            reopened = _print_traffic(
                "open loop with a hot reload to num_iteration=250", lats,
                rows, wall, d3 - d2, (s3 - s2) / max(f3 - f2, 1), bad)
        cand = eng.model_snapshot()
        torch.cuda.synchronize()
        mem_reload = _mem_delta(mem0)
        snap = obs.snapshot()
        c, g = snap["counters"], snap["gauges"]
        print(f"  reload in {reload_s:.2f} s under traffic (the candidate's "
              f"13 captures {sum(cand.capture_s.values()):.2f} s of it): "
              f"version gauge "
              f"{g.get('serve.model_version')}, versions seen "
              f"{sorted(v + 1 for v in seen)}; live model captures "
              f"{live.captures} (after warmup {caps}), candidate's "
              f"{cand.captures}; device memory above the engine's start "
              f"with both models alive {mem_reload}; serve.host_fallback "
              f"{c.get('serve.host_fallback', 0)}, serve.breaker_trips "
              f"{c.get('serve.breaker_trips', 0)}, health {eng.health()}",
              flush=True)
        if ver != 2 or g.get("serve.model_version") != 2:
            fail("phase 14: the reload did not reach version 2")
        if seen != {0, 1}:
            fail(f"phase 14: the open loop saw versions {sorted(seen)} "
                 f"across the reload, not both")
        if live.captures != caps or cand.captures != len(eng.buckets):
            fail("phase 14: a capture on the live model after its warmup, "
                 "or a candidate without its own graphs")
        if c.get("serve.host_fallback", 0) or c.get("serve.breaker_trips",
                                                    0) or \
                eng.health() != "ready":
            fail("phase 14: the engine fell back to the host or degraded")
        eng.close()
        del eng, live, cand
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  closed and dropped: device memory above the engine's start "
              f"{_mem_delta(mem0)}", flush=True)
    b6 = _b6_breakdown(mres["text"], X, dev)
    return dict(launches=launches, closed=closed, open=opened,
                reload=reopened, b6=b6)


INGEST_SMALL = 20_000              # phase 15's categorical cut
CK_ROUNDS = 16                     # phase 15's resumed run: phase 13's K=8
POISON_FRAC = 1e-4                 # phase 15's share of +inf labels


def _timed(cls, name, store):
    """Wrap ``cls.name`` so that each call's wall seconds (the card
    synchronised before and after) are appended to ``store``; returns the
    undo."""
    import torch
    orig = getattr(cls, name)

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t0)
    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, orig)


def _ingest_report_line(label, rep):
    print(f"  {label}: {rep['rows']} rows in {rep['seconds']:.3f} s = "
          f"{rep['rows_per_s'] / 1e6:.2f} Mrow/s; {rep['n_chunks']} chunks "
          f"of {rep['chunk_rows']} rows; stalls {rep['stalls']} (stall "
          f"fraction {rep['stall_fraction']:.3f}, prefetch hits "
          f"{rep['prefetch_hits']}); H2D {rep['bytes_h2d'] / 1e6:.1f} MB; "
          f"compiles {rep['compiles']}", flush=True)


def ingest_checks(mres, dev):
    """Phase 15 (a): device ingest against host binning at the main
    path's data, with prefetch on and off, and a categorical cut."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.dataset import bin_dense_host
    from lightgbm_tpu_torch.ops.ingest import (DeviceIngestor,
                                               device_ingest_blocker)
    _, X, y = mres["data"]
    params = dict(MAIN_PARAMS)

    def booster(ingest, Xs, ys, extra=None, cats="auto"):
        p = dict(params, tpu_ingest=ingest, **(extra or {}))
        ds = lgt.Dataset(Xs, label=ys, params=p, categorical_feature=cats)
        t0 = time.perf_counter()
        ds.construct(lgt.Config.from_params(p))
        t1 = time.perf_counter()
        bst = lgt.Booster(params=p, train_set=ds)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return bst, ds, t1 - t0, t2 - t1

    bh, dsh, host_construct_s, _ = booster("host", X, y)
    bd, dsd, find_s, setup_s = booster("device", X, y)
    cd = dsd.constructed
    X64 = dsd.raw_data
    t0 = time.perf_counter()
    bin_dense_host(X64, cd.mappers, np.asarray(cd.real_feature_idx,
                                               np.int64), cd.num_data,
                   cd.code_dtype)
    host_bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    device_ingest_blocker(X64, cd.mappers)       # the f32-lossless check
    check_s = time.perf_counter() - t0
    rep = bd._gbdt._ingest_report
    same = torch.equal(bh._gbdt.Xb, bd._gbdt.Xb)
    print(f"  construct split, host: mapper finding "
          f"{host_construct_s - host_bin_s:.2f} s + host binning "
          f"{host_bin_s:.2f} s (construct with tpu_ingest=host "
          f"{host_construct_s:.2f} s); device: mapper finding "
          f"{find_s - check_s:.2f} s + eligibility check {check_s:.2f} s "
          f"(construct {find_s:.2f} s) + device ingest "
          f"{rep['seconds']:.3f} s (booster set-up {setup_s:.2f} s)",
          flush=True)
    _ingest_report_line("tpu_ingest=device, 2M x 28 f32", rep)
    print(f"  placed Xb equal to tpu_ingest=host (torch.equal, "
          f"{tuple(bd._gbdt.Xb.shape)} {bd._gbdt.Xb.dtype}) {same}",
          flush=True)
    if not same or rep is None or rep["compiles"] != 1:
        fail("device ingest: the codes differ from host binning")
    del bd
    bn, _, _, _ = booster("device", X, y, {"tpu_ingest_prefetch": 0})
    rep0 = bn._gbdt._ingest_report
    _ingest_report_line("prefetch off (tpu_ingest_prefetch=0)", rep0)
    same0 = torch.equal(bh._gbdt.Xb, bn._gbdt.Xb)
    print(f"  prefetch off: placed Xb equal to host {same0}", flush=True)
    if not same0 or rep0["stalls"] != rep0["n_chunks"]:
        fail("device ingest with prefetch off differs from host binning")
    del bn

    # B7's bin step alone on one chunk of the main path's shape
    C = cd.num_features
    R = rep["chunk_rows"]
    ing = DeviceIngestor(cd.mappers, num_cols=C, n_rows=cd.num_data,
                         out_dtype=cd.code_dtype, device=dev)
    chunk = torch.as_tensor(np.ascontiguousarray(
        X[:R, cd.real_feature_idx], np.float32), device=dev)
    ms = cuda_time_ms(lambda: ing.bin_chunk(chunk, 0), 20)
    bound = R * C * (4 + 1) / HBM_BYTES_PER_S * 1e3
    print(f"  B7 bin step, one {R} x {C} chunk: {ms:.4f} ms of device time "
          f"({R / ms / 1e3:.1f} Mrow/s), {ing.k_steps} lower-bound steps; "
          f"bytes bound {bound:.5f} ms", flush=True)

    # a categorical cut below the auto threshold, asked for explicitly
    Xc = np.array(X[:INGEST_SMALL], np.float32)
    Xc[:, 5] = np.floor(np.abs(Xc[:, 5]) * 4.0)
    Xc[::97, 5] = -1.0
    yc = y[:INGEST_SMALL]
    ch, _, _, _ = booster("host", Xc, yc, cats=[5])
    cdev, _, _, _ = booster("device", Xc, yc, cats=[5])
    samec = torch.equal(ch._gbdt.Xb, cdev._gbdt.Xb)
    print(f"  {INGEST_SMALL} rows with a categorical column "
          f"({int(Xc[:, 5].max()) + 1} categories, negatives): device codes "
          f"equal to host {samec}, deferred "
          f"{cdev._gbdt._ingest_report is not None}", flush=True)
    if not samec or cdev._gbdt._ingest_report is None:
        fail("device ingest of the categorical cut differs from host")
    del bh
    torch.cuda.empty_cache()
    return dict(rep=rep, rep0=rep0, chunk_ms=ms, chunk_bound=bound,
                find_s=find_s, check_s=check_s, host_bin_s=host_bin_s,
                host_construct_s=host_construct_s)


def checkpoint_checks(mres, k8_text):
    """Phase 15 (b): 8 captured rounds at tree_batch=8 with a snapshot at
    8, then a fresh Dataset and Booster resumed to round 16: phase 13's K=8
    model text."""
    import shutil
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.robustness.checkpoint import (CheckpointManager,
                                                          verify_checkpoint)
    _, X, y = mres["data"]
    Xv, yv = higgs_like(NV, SEED + 1)
    params = dict(MAIN_PARAMS, metric="auc", metric_freq=8, tree_batch=8)
    ck = os.path.join(HERE, "lightgbm_tpu_torch", "build", "phase15_ck")
    shutil.rmtree(ck, ignore_errors=True)
    ckp = dict(params, checkpoint_dir=ck, checkpoint_interval=8)
    saves, loads, eager = [], [], []
    undo = [_timed(lgt.Booster, "save_checkpoint", saves),
            _timed(lgt.Booster, "resume", loads)]
    try:
        def run(rounds, **kw):
            ds = lgt.Dataset(X, label=y)
            dv = lgt.Dataset(Xv, label=yv, reference=ds)
            ev = {}
            bst = lgt.train(ckp, ds, num_boost_round=rounds, valid_sets=[dv],
                            valid_names=["valid"], evals_result=ev,
                            verbose_eval=False, keep_training_booster=True,
                            **kw)
            torch.cuda.synchronize()
            return bst, ev
        first, _ = run(8)
        if first._gbdt._graphs is None:
            fail("checkpoint: the first run replayed no tree")
        path = CheckpointManager(ck).latest()
        ok, detail = verify_checkpoint(path)
        mb = os.path.getsize(path) / 1e6
        del first
        undo.append(_timed(GBDT, "_eager_iteration", eager))
        resumed, ev = run(CK_ROUNDS, resume_from="auto")
        text = resumed.model_to_string()
        # the first 10 trees' text: phase 4's up to the feature importances
        head = resumed.model_to_string(num_iteration=10).split(
            "feature importances:")[0] == \
            mres["text"].split("feature importances:")[0]
        r = resumed._gbdt._graphs
        replayed = r.trees if r is not None else 0
    finally:
        for u in undo:
            u()
        shutil.rmtree(ck, ignore_errors=True)
    same = text == k8_text
    print(f"  snapshot at iteration 8: save {saves[0] * 1e3:.1f} ms, file "
          f"{mb:.2f} MB, verify {ok} ({detail}); load + restore "
          f"{loads[0] * 1e3:.1f} ms; first resumed iteration (eager) "
          f"{eager[0] * 1e3:.1f} ms; then {replayed} trees replayed; valid "
          f"AUC at 16 {ev['valid']['auc']}", flush=True)
    print(f"  resumed to {CK_ROUNDS} rounds: sha256 {text_digest(text)}, "
          f"byte-equal to phase 13's K=8 arm {same}; its first 10 trees "
          f"phase 4's (sha256 {mres['digest']}) {head}", flush=True)
    # the resumed run writes its own snapshot at 16
    if not ok or len(saves) != 2 or len(loads) != 1 or not same or not head:
        fail("checkpoint/resume: the resumed model differs from phase 13's")
    if replayed != CK_ROUNDS - 8 - 1:
        fail(f"checkpoint/resume: {replayed} trees replayed after resume")
    return dict(save_ms=saves[0] * 1e3, mb=mb, load_ms=loads[0] * 1e3,
                eager_ms=eager[0] * 1e3)


class _Records:
    """Messages of the port's logger at ``level`` and above (warnings by
    default), collected."""

    def __init__(self, level=None):
        import logging
        self.logger = logging.getLogger("lightgbm_tpu_torch")
        self.handler = logging.Handler(
            logging.WARNING if level is None else level)
        self.handler.emit = lambda rec: self.messages.append(
            rec.getMessage())
        self.messages = []

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def nan_policy_checks(mres):
    """Phase 15 (c): clip captured against eager on +inf labels;
    skip_iter captured with every label poisoned; raise through a poisoned
    fobj."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.robustness.numeric import NonFiniteError
    _, X, _ = mres["data"]
    rng = np.random.default_rng(SEED + 15)
    yr = (2.0 * np.nan_to_num(X[:, 0]) + X[:, 3]).astype(np.float64)
    yr[rng.choice(N, int(N * POISON_FRAC), replace=False)] = np.inf
    params = dict(MAIN_PARAMS, objective="regression", metric="none",
                  boost_from_average=False, verbose=0, tree_batch=8)
    ds = lgt.Dataset(X, label=yr)
    ds.construct(lgt.Config.from_params(params))
    texts, syncs = {}, {}
    for capture in (False, True):
        GBDT._capture = capture
        try:
            with _Records() as msgs:
                bst = lgt.train(dict(params, nan_policy="clip"), ds,
                                num_boost_round=8, keep_training_booster=True)
        finally:
            GBDT._capture = True
        arm = "captured" if capture else "eager"
        texts[arm] = bst.model_to_string()
        clipped = sum("nan_policy=clip" in m for m in msgs)
        r = bst._gbdt._graphs
        if capture:
            if r is None or r.trees == 0:
                fail("nan_policy=clip: the captured run replayed no tree")
            syncs["clip"] = r.syncs / r.trees
        print(f"  clip, {arm}: {int(N * POISON_FRAC)} labels +inf, 8 rounds, "
              f"{len(bst.trees)} trees, clip warnings {clipped}"
              + (f", host syncs per replayed tree {syncs['clip']:.2f}"
                 if capture else ""), flush=True)
        if clipped == 0:
            fail("nan_policy=clip: no clip warning was logged")
        del bst
    same = texts["eager"] == texts["captured"]
    print(f"  clip: captured model text identical to eager {same}",
          flush=True)
    if not same:
        fail("nan_policy=clip: captured and eager models differ")

    ds.set_label(np.full(N, np.inf))
    bst = lgt.Booster(params=dict(params, nan_policy="skip_iter"),
                      train_set=ds)
    gb = bst._gbdt
    before = gb.score.clone()
    err = None
    try:
        for _ in range(4):
            gb.train_batch(8)
    except NonFiniteError as e:
        err = str(e)
    r = gb._graphs
    syncs["skip_iter"] = r.syncs / r.trees if r is not None and r.trees \
        else float("nan")
    kept = torch.equal(gb.score, before)
    print(f"  skip_iter, every label +inf, captured at tree_batch=8: "
          f"NonFiniteError after {gb.iter_} iterations "
          f"({'consecutive' in (err or '')}), models kept {len(gb.models)}, "
          f"score buffer bit-equal to its value before training {kept}, "
          f"host syncs per replayed tree {syncs['skip_iter']:.2f}",
          flush=True)
    if err is None or "consecutive" not in err or not kept or gb.models:
        fail(f"nan_policy=skip_iter: {err!r}, score kept {kept}")
    if r is None or r.trees == 0:
        fail("nan_policy=skip_iter: the captured run replayed no tree")
    del bst, gb

    yc = np.asarray(yr, np.float32).copy()
    yc[~np.isfinite(yc)] = 0.0
    calls = {"n": 0}

    def poisoned(preds, dataset):
        g = (np.asarray(preds, np.float32) - yc)
        if calls["n"] == 2:
            g[::1000] = np.nan
        calls["n"] += 1
        return g, np.ones_like(g)

    ds.set_label(yc)
    raised = None
    try:
        lgt.train(dict(params, objective="none", nan_policy="raise",
                       tree_batch=1), ds, num_boost_round=5, fobj=poisoned)
    except NonFiniteError as e:
        raised = str(e)
    print(f"  raise through a poisoned fobj at iteration 2: {raised}",
          flush=True)
    if raised is None or "iteration 2" not in raised:
        fail("nan_policy=raise: no NonFiniteError at iteration 2")
    for arm, s in syncs.items():
        if abs(s - 1.0) > 1e-9:
            fail(f"nan_policy={arm}: {s} host syncs per replayed tree")
    return dict(syncs=syncs)


def ingest_checkpoint_phase(mres, bres, dev):
    """Phase 15: device ingest, checkpoint/resume and nan_policy at the main
    path's width."""
    import torch
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    start = launch_count()
    print("  (a) device ingest", flush=True)
    ires = ingest_checks(mres, dev)
    print("  (b) checkpoint/resume", flush=True)
    k8 = bres["k8_text"] if bres is not None else None
    if k8 is None:
        k8 = _straight_k8(mres)
    cres = checkpoint_checks(mres, k8)
    print("  (c) nan_policy", flush=True)
    nres = nan_policy_checks(mres)
    launches = launch_count() - start
    print(f"  histogram kernel launches in phase 15: {launches}", flush=True)
    if launches <= 0:
        fail("phase 15 never launched the histogram kernel")
    torch.cuda.empty_cache()
    return dict(launches=launches, ingest=ires, checkpoint=cres,
                nan=nres)


def _straight_k8(mres):
    """Phase 13's K=8 arm's model text, when phase 13 did not run."""
    import lightgbm_tpu_torch as lgt
    _, X, y = mres["data"]
    Xv, yv = higgs_like(NV, SEED + 1)
    ds = lgt.Dataset(X, label=y)
    dv = lgt.Dataset(Xv, label=yv, reference=ds)
    bst = lgt.train(dict(MAIN_PARAMS, metric="auc", metric_freq=8,
                         tree_batch=8), ds, num_boost_round=CK_ROUNDS,
                    valid_sets=[dv], verbose_eval=False)
    text = bst.model_to_string()
    print(f"  uninterrupted K=8 run (phase 13 not run): sha256 "
          f"{text_digest(text)}", flush=True)
    return text


FRONT_ROWS = 200_000               # phase 16's text cut
FRONT_VALID = 50_000               # ... and its valid file


def _conf_file(path, params):
    with open(path, "w") as fh:
        for k, v in params.items():
            fh.write(f"{k} = {v}\n")


def _cli_in_process(argv):
    """``cli.main(argv)``: (exit code, seconds, B1 launches in the call)."""
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    before = launch_count()
    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    return rc, time.perf_counter() - t0, launch_count() - before


def _file_digest(path):
    with open(path) as fh:
        return text_digest(fh.read())


def _same_floats(a, b):
    """Bit-equal float arrays (NaN where the other has NaN)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def binary_and_cli_leg(mres, tmp):
    """(a) ``save_binary``, then ``task=train`` from the binary file through
    ``cli.main`` in this process and ``python -m lightgbm_tpu_torch`` in a
    child: both model texts must be phase 4's."""
    import lightgbm_tpu_torch as lgt
    _, X, y = mres["data"]
    bin_path = os.path.join(tmp, "train.bin")
    t0 = time.perf_counter()
    ds = lgt.Dataset(X, label=y)
    ds.construct(lgt.Config.from_params(MAIN_PARAMS))
    t1 = time.perf_counter()
    deferred = ds.constructed.deferred
    codes = ds.constructed.X_binned     # bins deferred rows on the host
    t2 = time.perf_counter()
    ds.save_binary(bin_path)
    t3 = time.perf_counter()
    mb = os.path.getsize(bin_path) / 1e6
    loaded = lgt.Dataset(bin_path)
    loaded.construct()
    t4 = time.perf_counter()
    file_codes = loaded.constructed.X_binned
    same_codes = hashlib.sha256(
        file_codes.tobytes()).hexdigest() == mres["codes_digest"]
    print(f"  save_binary: construct {t1 - t0:.2f} s (deferred {deferred}), "
          f"host binning {t2 - t1:.3f} s, write {t3 - t2:.3f} s, {mb:.2f} "
          f"MB; load {t4 - t3:.3f} s; file's {file_codes.dtype} codes "
          f"equal to the codes phase 4 trained from (device-ingested "
          f"{mres['ingested']}) {same_codes}", flush=True)
    if not same_codes:
        fail("the binary file's codes differ from phase 4's")
    del codes, file_codes
    del ds, loaded
    conf = os.path.join(tmp, "train.conf")
    _conf_file(conf, dict(MAIN_PARAMS, task="train", data=bin_path,
                          num_iterations=10,
                          output_model=os.path.join(tmp, "model.txt")))
    rc, secs, launches = _cli_in_process([f"config={conf}"])
    digest = _file_digest(os.path.join(tmp, "model.txt"))
    print(f"  cli.main(config=train.conf) in process: exit {rc}, {secs:.2f} s "
          f"(load + 10 rounds), B1 launches {launches}, model text sha256 "
          f"{digest}, phase 4's {digest == mres['digest']}", flush=True)
    if rc != 0 or digest != mres["digest"]:
        fail("the CLI's model from the binary file is not phase 4's")
    if launches <= 0:
        fail("the CLI's training never launched the histogram kernel")
    sub_model = os.path.join(tmp, "model_sub.txt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", f"config={conf}",
         f"output_model={sub_model}"], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    sub_digest = _file_digest(sub_model) if proc.returncode == 0 else None
    print(f"  python -m lightgbm_tpu_torch config=train.conf: exit "
          f"{proc.returncode}, {sub_s:.2f} s of process, phase 4's model "
          f"{sub_digest == mres['digest']}", flush=True)
    if proc.returncode != 0 or sub_digest != mres["digest"]:
        fail(f"python -m lightgbm_tpu_torch failed or trained another "
             f"model:\n{proc.stderr[-3000:]}")
    return dict(launches=launches, bin_path=bin_path, save_s=t3 - t2,
                bin_s=t2 - t1, construct_s=t1 - t0, load_s=t4 - t3, mb=mb,
                cli_s=secs, sub_s=sub_s)


def text_cli_leg(mres, tmp):
    """(b) a tab-separated cut: the reader's parse against the array,
    ``task=predict`` against ``Booster.predict`` on the reader's own array,
    and ``task=train`` with a 2-round ``valid_data``."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    import pandas
    from lightgbm_tpu_torch.io.file_io import load_data_file
    _, X, y = mres["data"]
    rows = FRONT_ROWS + FRONT_VALID
    tsv, vtsv = os.path.join(tmp, "cut.tsv"), os.path.join(tmp, "valid.tsv")
    t0 = time.perf_counter()
    for path, sl in ((tsv, slice(0, FRONT_ROWS)),
                     (vtsv, slice(FRONT_ROWS, rows))):
        np.savetxt(path, np.column_stack([y[sl], X[sl]]), fmt="%.9g",
                   delimiter="\t")
    t1 = time.perf_counter()
    Xp, yp, _ = load_data_file(tsv, {})
    t2 = time.perf_counter()
    orig = np.asarray(X[:FRONT_ROWS], np.float64)
    nan_same = bool(np.array_equal(np.isnan(Xp), np.isnan(orig)))
    err = float(np.nanmax(np.abs(Xp - orig)))
    print(f"  {FRONT_ROWS} x {X.shape[1]} written as %.9g TSV in "
          f"{t1 - t0:.2f} s; reader pandas {pandas.__version__}: parsed in "
          f"{t2 - t1:.3f} s, max |parsed - original| {err:.3e}, NaN cells "
          f"equal {nan_same}, labels equal "
          f"{bool(np.array_equal(yp, y[:FRONT_ROWS]))}", flush=True)
    if not nan_same or not err <= 1e-6 * float(np.nanmax(np.abs(orig))):
        fail("the text reader does not give back the written values")
    model = os.path.join(tmp, "model.txt")
    out = os.path.join(tmp, "pred.txt")
    rc, secs, _ = _cli_in_process([
        "task=predict", f"data={tsv}", f"input_model={model}",
        f"output_result={out}", "verbose=-1"])
    with open(out) as fh:
        printed = fh.read().splitlines()
    bst = lgt.Booster(model_file=model)
    want = [f"{v:.18g}" for v in bst.predict(Xp)]
    same = printed == want
    print(f"  cli task=predict: exit {rc}, {secs:.2f} s, output_result equal "
          f"to Booster.predict on the parsed array {same} ({len(printed)} "
          f"lines)", flush=True)
    if rc != 0 or not same:
        fail("task=predict differs from Booster.predict")
    text_model = os.path.join(tmp, "model_text.txt")
    rc, secs, launches = _cli_in_process([
        "task=train", f"data={tsv}", f"valid_data={vtsv}", "metric=auc",
        "num_iterations=2", f"output_model={text_model}",
        *(f"{k}={v}" for k, v in MAIN_PARAMS.items())])
    trees = lgt.Booster(model_file=text_model).num_trees()
    print(f"  cli task=train on the TSV with a {FRONT_VALID}-row valid_data, "
          f"2 rounds: exit {rc}, {secs:.2f} s, {trees} trees, B1 launches "
          f"{launches}", flush=True)
    if rc != 0 or trees != 2 or launches <= 0:
        fail("task=train on the text file failed")
    return dict(launches=launches, Xp=Xp, tsv=tsv,
                parse_s=t2 - t1, max_err=err)


def model_formats_leg(mres, tmp, tres):
    """(c) phase 4's model as .json and .proto: loaded by ``Booster`` and by
    ``ServingEngine``, predicting bit-equal to the text model; a short
    ``task=serve_bench`` on the .proto file."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.serving import ServingEngine
    Xp = tres["Xp"]
    text_path = os.path.join(tmp, "model.txt")
    base = lgt.Booster(model_file=text_path)
    t0 = time.perf_counter()
    want = base.predict(Xp)
    walk_ms = (time.perf_counter() - t0) * 1e3
    eng = ServingEngine(text_path)
    want_eng = eng.predict(Xp)
    eng.close()
    print(f"  text model: Booster.predict of {len(Xp)} rows {walk_ms:.1f} ms "
          f"(device walk), ServingEngine equal to it "
          f"{_same_floats(want, want_eng)}", flush=True)
    for ext in ("json", "proto"):
        path = os.path.join(tmp, f"model.{ext}")
        t0 = time.perf_counter()
        base.save_model(path)
        t1 = time.perf_counter()
        bst = lgt.Booster(model_file=path)
        t2 = time.perf_counter()
        walk = bst.predict(Xp)
        eng = ServingEngine(path)
        served = eng.predict(Xp)
        eng.close()
        ok = _same_floats(walk, want) and _same_floats(served, want_eng)
        print(f"  .{ext}: save {(t1 - t0) * 1e3:.1f} ms, "
              f"{os.path.getsize(path) / 1e6:.3f} MB, load "
              f"{(t2 - t1) * 1e3:.1f} ms; device walk bit-equal to the text "
              f"model {_same_floats(walk, want)}, ServingEngine bit-equal "
              f"{_same_floats(served, want_eng)}", flush=True)
        if not ok:
            fail(f"the .{ext} model predicts differently from the text model")
    rc, secs, _ = _cli_in_process([
        "task=serve_bench", f"input_model={os.path.join(tmp, 'model.proto')}",
        f"data={tres['tsv']}", "verbose=-1"])
    print(f"  cli task=serve_bench on model.proto: exit {rc}, {secs:.2f} s "
          f"(its JSON line above)", flush=True)
    if rc != 0:
        fail("task=serve_bench failed")


def c_api_leg(mres, bres):
    """(d) the port's C shim built with cc and loaded with ctypes:
    ``LGBM_DatasetCreateFromFile`` on the binary file, ``LGBM_BoosterCreate``
    with the main path's parameters (no ``device`` key),
    ``LGBM_BoosterUpdateOneIter`` x10, ``LGBM_BoosterSaveModel``."""
    import ctypes
    import sysconfig
    from lightgbm_tpu_torch import capi_shim
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    include = sysconfig.get_paths()["include"]
    print(f"  Python.h under {include}: "
          f"{os.path.exists(os.path.join(include, 'Python.h'))}; "
          f"python3-config {capi_shim.python_config()}", flush=True)
    try:
        path, secs = capi_shim.build_shim()
    except RuntimeError as e:
        fail(f"the C API shim does not build: {e}")
    lib = capi_shim.load_shim()
    print(f"  built {os.path.relpath(path, HERE)} in {secs:.2f} s",
          flush=True)

    def check(ret, what):
        if ret != 0:
            fail(f"{what}: {lib.LGBM_GetLastError().decode()}")

    model = os.path.join(os.path.dirname(bres["bin_path"]), "model_capi.txt")
    params = " ".join(f"{k}={v}" for k, v in MAIN_PARAMS.items()).encode()
    before = launch_count()
    t0 = time.perf_counter()
    ds, bst, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    check(lib.LGBM_DatasetCreateFromFile(bres["bin_path"].encode(), b"",
                                         None, ctypes.byref(ds)),
          "LGBM_DatasetCreateFromFile")
    check(lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)),
          "LGBM_BoosterCreate")
    for _ in range(10):
        check(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)),
              "LGBM_BoosterUpdateOneIter")
    check(lib.LGBM_BoosterSaveModel(bst, 0, model.encode()),
          "LGBM_BoosterSaveModel")
    secs = time.perf_counter() - t0
    launches = launch_count() - before
    check(lib.LGBM_BoosterFree(bst), "LGBM_BoosterFree")
    check(lib.LGBM_DatasetFree(ds), "LGBM_DatasetFree")
    digest = _file_digest(model)
    print(f"  C API (hosted, ctypes): dataset from train.bin, 10 "
          f"UpdateOneIter, SaveModel in {secs:.2f} s; B1 launches "
          f"{launches}; model text phase 4's {digest == mres['digest']}",
          flush=True)
    if digest != mres["digest"]:
        fail("the C API's model is not phase 4's")
    if launches <= 0:
        fail("the C API's training never launched the histogram kernel")
    return dict(launches=launches, secs=secs)


def front_end_phase(mres):
    """Phase 16: the host front ends at the main path's width."""
    import tempfile
    import torch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_16_")
    legs = {}
    for name, fn in (("a", lambda: binary_and_cli_leg(mres, tmp)),
                     ("b", lambda: text_cli_leg(mres, tmp)),
                     ("c", lambda: model_formats_leg(mres, tmp, legs["b"])),
                     ("d", lambda: c_api_leg(mres, legs["a"]))):
        print(f"  ({name})", flush=True)
        t0 = time.perf_counter()
        legs[name] = fn()
        print(f"  ({name}) took {time.perf_counter() - t0:.2f} s",
              flush=True)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = legs["a"]["launches"] + legs["b"]["launches"] \
        + legs["d"]["launches"]
    print(f"  histogram kernel launches in phase 16: {launches} (CLI "
          f"{legs['a']['launches']}, text train {legs['b']['launches']}, "
          f"C API {legs['d']['launches']})", flush=True)
    return dict(launches=launches)


STREAM_ROUNDS = 10                 # phase 17: phase 4's rounds
STREAM_U4_ROUNDS = 3               # ... and leg (d)'s
# allocated before a leg: what earlier phases keep besides their released
# tensors (library workspaces)
STREAM_BASE_MAX = 64 << 20


def _stream_leg(label, ds, params, rounds, expect):
    """Train ``rounds`` rounds of ``params`` on ``ds``; print ms per
    iteration (the first apart), flag reads per wave, the synchronizing
    calls ``set_sync_debug_mode`` flags in the iterations after the first
    (by source line), the prefetcher's stalls, hits and H2D MB, B1's
    passes and the peak allocated device memory, absolute and above the
    allocation before, beside the booster's estimate for its residency.
    Fails unless the model text's sha256 is ``expect``, unless what was
    allocated before is at most ``STREAM_BASE_MAX`` (earlier phases'
    tensors released), and unless the peak above it lies within half and
    twice the estimate."""
    import gc
    import warnings
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    gc.collect()             # earlier legs' boosters hold reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if base > STREAM_BASE_MAX:
        fail(f"{label}: {base / 2**20:.1f} MiB allocated before the leg")
    torch.cuda.reset_peak_memory_stats()
    before = launch_count()
    clock = IterClock()
    state = {}

    def debug_on(env):
        # iterations 2..rounds: from the first iteration's end to the
        # last's (the model's fetch after training is not an iteration's,
        # and the clock's own synchronize is not the port's)
        torch.cuda.set_sync_debug_mode(0)
        clock(env)
        if env.iteration == 0:
            state["caught"] = warnings.catch_warnings(record=True)
            state["list"] = state["caught"].__enter__()
            warnings.simplefilter("always")
        if env.iteration < rounds - 1:
            torch.cuda.set_sync_debug_mode("warn")
    try:
        bst = lgt.train(params, ds, num_boost_round=rounds,
                        keep_training_booster=True, callbacks=[debug_on])
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        if "caught" in state:
            state["caught"].__exit__(None, None, None)
    sites = {}
    for w in state.get("list", []):
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    flagged = sum(sites.values())
    peak_abs = torch.cuda.max_memory_allocated()
    peak = peak_abs - base
    launches = launch_count() - before
    g = bst._gbdt
    text = bst.model_to_string()
    digest = text_digest(text)
    est = g.residency_estimates[g.residency]["total_bytes"]
    first = clock.ms(0, 1)
    ms = clock.ms(1) if rounds > 1 else first
    line = (f"  {label}: residency {g.residency}; {ms:.1f} ms per "
            f"iteration after the first ({first:.1f}); B1 passes {launches}"
            f" ({launches / max(len(bst.trees), 1):.1f} per tree); peak "
            f"allocated {peak_abs / 2**20:.1f} MiB, {peak / 2**20:.1f} "
            f"above the {base / 2**20:.1f} before, estimate "
            f"{est / 2**20:.1f} MiB")
    out = dict(text=text, digest=digest, ms=ms, first_ms=first,
               launches=launches, peak=peak, peak_abs=peak_abs, estimate=est,
               residency=g.residency)
    top = ", ".join(f"{k} {v}" for k, v in sorted(
        sites.items(), key=lambda kv: -kv[1])[:4])
    if g.residency == "stream":
        rep = g._stream.report()
        gr = g._grower
        line += (f"; {rep['n_shards']} shards of "
                 f"{g._stream_store.shard_rows} rows "
                 f"({g._stream_store.code_mode}); host flag reads per wave "
                 f"{gr.flag_reads / gr.waves_run:.2f} ({gr.flag_reads} over "
                 f"{gr.waves_run} waves), {flagged} synchronizing calls "
                 f"flagged in the iterations after the first "
                 f"({flagged / max(rounds - 1, 1):.1f} per iteration: "
                 f"{top}); "
                 f"stalls {rep['stalls']} ({rep['stall_seconds']:.3f} s), "
                 f"prefetch hits {rep['prefetch_hits']}; H2D "
                 f"{rep['bytes_h2d'] / 1e6:.1f} MB "
                 f"({rep['bytes_h2d'] / 1e6 / rounds:.1f} per iteration); "
                 f"verify {rep['verify_enabled']}")
        out.update(rep, flag_reads=gr.flag_reads, waves=gr.waves_run,
                   flagged=flagged, code_mode=g._stream_store.code_mode)
        if gr.flag_reads != gr.waves_run:
            fail(f"{label}: {gr.flag_reads} flag reads over "
                 f"{gr.waves_run} waves")
    print(line + f"; model text sha256 {digest[:16]}..., as expected "
          f"{digest == expect}", flush=True)
    if digest != expect:
        fail(f"{label}: the model text differs from the resident run's")
    if launches <= 0:
        fail(f"{label}: the histogram kernel never launched")
    if not est / 2 <= peak <= 2 * est:
        fail(f"{label}: the peak above the base, {peak / 2**20:.1f} MiB, "
             f"is not within half and twice the estimate")
    del bst, g
    torch.cuda.empty_cache()
    return out


def stream_phase(mres):
    """Phase 17: out-of-core training (``tpu_residency=stream|auto``, A14
    and B11) on phase 4's data and parameters."""
    import tempfile
    from unittest import mock
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    from lightgbm_tpu_torch.ops.stream import ShardCorruptionError
    ds, X, y = mres["data"]
    start = launch_count()
    t_phase = time.perf_counter()
    # the two estimates of this run (the port's own model,
    # observability/memory.py), from a streamed booster that trains nothing
    t0 = time.perf_counter()
    probe = lgt.Booster(params=dict(MAIN_PARAMS, tpu_residency="stream"),
                        train_set=ds)
    setup_s = time.perf_counter() - t0
    ests = probe._gbdt.residency_estimates
    desc = probe._gbdt._stream_store.describe()
    del probe
    dev_b, st_b = (ests[r]["total_bytes"] for r in ("device", "stream"))
    budget = (dev_b + st_b) // 2
    print(f"  estimates: device {dev_b / 2**20:.1f} MiB "
          f"{ests['device']['components']}, stream {st_b / 2**20:.1f} MiB "
          f"{ests['stream']['components']}; budget halfway "
          f"{budget / 2**20:.1f} MiB; store {desc} (host binning of the "
          f"deferred rows, packing and CRC: {setup_s:.2f} s)", flush=True)
    if not st_b < budget < dev_b:
        fail("the streamed estimate is not below the resident one")
    expect = mres["digest"]
    print("  (a) tpu_residency=auto under the budget", flush=True)
    legs = {"auto": _stream_leg(
        "auto", ds, dict(MAIN_PARAMS, tpu_residency="auto",
                         tpu_hbm_budget_bytes=budget), STREAM_ROUNDS,
        expect)}
    if legs["auto"]["residency"] != "stream" or \
            legs["auto"]["n_shards"] != 8:
        fail("auto did not choose stream in 8 shards under the budget")
    legs["device"] = _stream_leg("resident arm", ds, dict(MAIN_PARAMS),
                                 STREAM_ROUNDS, expect)
    print(f"  peak allocated: streamed "
          f"{legs['auto']['peak'] / 2**20:.1f} MiB (estimate "
          f"{st_b / 2**20:.1f}), resident {legs['device']['peak'] / 2**20:.1f}"
          f" MiB (estimate {dev_b / 2**20:.1f}); streamed lower "
          f"{legs['auto']['peak'] < legs['device']['peak']}", flush=True)
    if not legs["auto"]["peak"] < legs["device"]["peak"]:
        fail("the streamed run's peak is not below the resident run's")
    stream = dict(MAIN_PARAMS, tpu_residency="stream")
    print("  (b) prefetch off, CRC off", flush=True)
    with mock.patch.dict(os.environ, {"LGBM_TPU_STREAM_NO_PREFETCH": "1"}):
        legs["no_prefetch"] = _stream_leg("prefetch off", ds, stream,
                                          STREAM_ROUNDS, expect)
    if legs["no_prefetch"]["prefetch_hits"] != 0:
        fail("prefetch off still hit prefetched shards")
    legs["no_verify"] = _stream_leg(
        "tpu_stream_verify=false", ds, dict(stream, tpu_stream_verify=False),
        STREAM_ROUNDS, expect)
    print("  (c) two shard sizes", flush=True)
    legs["shards7"] = _stream_leg(
        "tpu_stream_shard_rows 300000 (a tail of padding)", ds,
        dict(stream, tpu_stream_shard_rows=300_000), STREAM_ROUNDS, expect)
    legs["shards4"] = _stream_leg(
        "tpu_stream_shard_rows 500000", ds,
        dict(stream, tpu_stream_shard_rows=500_000), STREAM_ROUNDS, expect)
    print(f"  (d) max_bin 15 (u4 shards), {STREAM_U4_ROUNDS} rounds",
          flush=True)
    p15 = dict(MAIN_PARAMS, max_bin=15)
    t0 = time.perf_counter()
    ds15 = lgt.Dataset(X, label=y)
    ds15.construct(lgt.Config.from_params(p15))
    print(f"  construct at max_bin 15: {time.perf_counter() - t0:.2f} s",
          flush=True)
    # the resident run's text; its booster is released before the leg
    ref = text_digest(lgt.train(p15, ds15, num_boost_round=STREAM_U4_ROUNDS)
                      .model_to_string())
    legs["u4"] = _stream_leg("max_bin 15, stream", ds15,
                             dict(p15, tpu_residency="stream"),
                             STREAM_U4_ROUNDS, ref)
    if legs["u4"]["code_mode"] != "u4":
        fail(f"max_bin 15 streamed {legs['u4']['code_mode']} shards, not u4")
    del ds15
    print("  (e) a flipped shard", flush=True)
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(
            os.environ,
            {"LGBM_TPU_CHAOS_FLIP_SHARD": os.path.join(tmp, "marker")}):
        bst = lgt.Booster(params=stream, train_set=ds)
        try:
            bst.update()
            raised = None
        except ShardCorruptionError as e:
            raised = e
        committed = len(bst._gbdt.models)
        del bst
    print(f"  flipped shard: ShardCorruptionError raised "
          f"{raised is not None} ({str(raised)[:60]}...), trees committed "
          f"{committed}", flush=True)
    if raised is None or committed:
        fail("a flipped shard was not caught before a tree was committed")
    launches = launch_count() - start
    print(f"  histogram kernel launches in phase 17: {launches}; phase 17 "
          f"took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return dict(launches=launches, legs=legs, budget=budget,
                estimates={k: v["total_bytes"] for k, v in ests.items()})


# ---------------------------------------------------------------- phase 18

PAR_ROUNDS = 10                    # phase 18 (b): phase 4's rounds
PAR_DEADLINE_S = 600               # one world of ranks, then killed
PAR_PROBE_S = 120                  # the two-rank NCCL probe
PAR_AUC_TOL = 0.01                 # voting's train AUC beside phase 4's


def _free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script, world, deadline, extra=()):
    """Run ``python -c script rank world port *extra`` as ``world`` processes
    and return [(rc, stdout, stderr)]; past ``deadline`` seconds every rank
    is killed (rc None)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=HERE, PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port),
         *map(str, extra)], env=env, cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    out = []
    t_end = time.monotonic() + deadline
    for p in procs:
        try:
            so, se = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            out.append((p.returncode, so, se))
        except subprocess.TimeoutExpired:
            out.append((None, "", "killed at the deadline"))
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
    return out


_NCCL_PROBE = r"""
import datetime, json, os, sys
import torch, torch.distributed as dist
rank, world, port = map(int, sys.argv[1:4])
torch.cuda.set_device(0)
out = {"rank": rank}
try:
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.full((4,), float(rank + 1), device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    out.update(ok=True, sum=x.tolist())
except Exception as e:
    out.update(ok=False, error=f"{type(e).__name__}: {e}"[:600])
print(json.dumps(out), flush=True)
os._exit(0)
"""

_PAR_RANK = r"""
import datetime, hashlib, json, sys, time
import torch, torch.distributed as dist
rank, world, port = map(int, sys.argv[1:4])
backend, rounds = sys.argv[4], int(sys.argv[5])
import chip_smoke as cs
# a rank per card where there are several, else every rank on cuda:0
torch.cuda.set_device(rank % torch.cuda.device_count())
# the ranks make the group themselves: the port uses it as it stands
store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                      timeout=datetime.timedelta(seconds=300))
dist.init_process_group(backend, store=store, rank=rank, world_size=world)
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.cuda_histogram import (launch_count,
                                                   reset_launch_count)
X, y = cs.higgs_like(cs.N, cs.SEED)
ds = lgt.Dataset(X, label=y)
ds.construct(lgt.Config.from_params(cs.MAIN_PARAMS))
res = {"modules": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "lightgbm_tpu"))}
for tl in ("data", "feature", "voting"):
    reset_launch_count()                    # each learner's path starts
    t0 = time.perf_counter()
    bst = lgt.Booster(params=dict(cs.MAIN_PARAMS, tree_learner=tl),
                      train_set=ds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(rounds):
        bst.update()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    text = bst.model_to_string()
    launches = launch_count()               # ... and ends here
    g = bst._gbdt
    c = g.pctx.coll
    res[tl] = dict(
        digest=hashlib.sha256(text.encode()).hexdigest(),
        launches=launches, setup_s=t1 - t0,
        ms_per_iter=(t2 - t1) / rounds * 1e3, calls=c.calls,
        mbytes=c.bytes / 2**20, staged_calls=c.staged_calls,
        staged_ms=c.staged_s * 1e3, strategy=g.pctx.strategy,
        world=g.pctx.num_devices, backend=c.backend, rows=g.num_rows,
        device=str(g.device), trees=len(bst.trees),
        auc=cs.auc_of(bst.predict(X), y),
        eager=g._capture_blocker())
    del bst, g, c
    torch.cuda.empty_cache()
print(json.dumps(res), flush=True)
dist.destroy_process_group()
"""


def _identity_bundle(nb, dev):
    """EFB tables in which every feature is a bundle of its own (codes are
    bins, the default bin 0 rebuilt by subtraction): a bundled scan over
    the unbundled histogram."""
    import torch
    from lightgbm_tpu_torch.grower import BundleDecode
    Fn = nb.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    code_feat = torch.arange(Fn, **i32)[:, None].expand(Fn, B).contiguous()
    code_feat[:, 0] = -1
    unpack = torch.arange(B, **i32)[None, :].expand(Fn, B).contiguous()
    unpack[:, 0] = -1
    return BundleDecode(col=torch.arange(Fn, **i32),
                        lo=torch.zeros(Fn, **i32), hi=nb.clone(),
                        off=torch.zeros(Fn, **i32), unpack_bin=unpack,
                        code_feat=code_feat)


def nccl_world_of_one(dev):
    """Phase 18 (a): every comm class over an NCCL group of one on the
    card, on B1's integer sums of phase 3's ``full`` case, against
    ``SerialComm``. Returns B1's passes."""
    import dataclasses
    import datetime
    import torch
    import torch.distributed as dist
    from lightgbm_tpu_torch.grower import GrowerSpec
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        HistogramAccumulator, build_histograms_cuda, launch_count,
        reset_launch_count)
    from lightgbm_tpu_torch.ops.histogram import histogram_scales
    from lightgbm_tpu_torch.parallel import comm as pc

    store = dist.TCPStore("127.0.0.1", _free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    coll = pc.Collectives(dist.group.WORLD, 0, 1)
    # phase 3's full case, bit for bit: the same generator, the same draws
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X8 = torch.randint(0, B, (N, F), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    g = torch.randn(N, generator=gen, device=dev)
    h = torch.rand(N, generator=gen, device=dev) * 0.25
    ones = torch.ones(N, device=dev)
    X, nb_, leaf_id, slot_of_leaf, kw = case_inputs("full", dev, gen, X8)
    scales = histogram_scales(g, h)
    reset_launch_count()                  # phase 18 (a)'s passes start
    acc = HistogramAccumulator(S, F, B, dev)
    acc.zero_()
    build_histograms_cuda(X, g, h, ones, leaf_id, slot_of_leaf, S, B,
                          scales=scales, acc=acc, **kw)
    serial_hist = acc.finalize(scales)
    whole = build_histograms_cuda(X, g, h, ones, leaf_id, slot_of_leaf, S,
                                  B, scales=scales, **kw)
    if not torch.equal(whole, serial_hist):
        fail("phase 18: B1's accumulate + finalize differs from one pass")
    tot = serial_hist[:, 0].double().sum(dim=1).float()          # [S, 3]
    pg, ph, pcnt = tot[:, 0], tot[:, 1], tot[:, 2]
    spec = GrowerSpec(num_leaves=255, num_features=F, num_bins_padded=B,
                      hist_slots=S, wave_size=S, max_depth=-1,
                      lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
                      min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    spec_b = dataclasses.replace(spec, hist_bins=B)
    i32 = dict(dtype=torch.int32, device=dev)
    meta = (torch.ones(F, dtype=torch.bool, device=dev),
            torch.full((F,), B, **i32), torch.zeros(F, **i32),
            torch.zeros(F, **i32), torch.zeros(F, dtype=torch.bool,
                                              device=dev))
    bundle = _identity_bundle(meta[1], dev)
    serial = pc.SerialComm(F)

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    for name, c in (
            ("DataParallelComm", pc.DataParallelComm(coll, 1, F, N)),
            ("FeatureParallelComm", pc.FeatureParallelComm(coll, 1, F)),
            ("VotingParallelComm", pc.VotingParallelComm(coll, 1, F, 20, N)),
            ("DataParallelBundledComm",
             pc.DataParallelBundledComm(coll, 1, F, F, bundle.col, N)),
            ("FeatureParallelBundledComm",
             pc.FeatureParallelBundledComm(coll, 1, F, F, bundle.col))):
        bundled = name.endswith("BundledComm")
        if c.reduces_sums:
            out = HistogramAccumulator(S, c.block, B, dev)
            hist = c.reduce_sums(acc, out).finalize(scales)
        else:
            if not torch.equal(c.hist_X(X), X):
                fail(f"phase 18: {name}.hist_X is not the whole block")
            hist = c.reduce_hist(serial_hist)
        spec_c = spec_b if bundled else spec
        want = serial.find_splits(serial_hist, pg, ph, pcnt,
                                  serial.block_meta(*meta), spec_c,
                                  bundle if bundled else None)
        got = c.find_splits(hist, pg, ph, pcnt, c.block_meta(*meta), spec_c,
                            c.localize_bundle(bundle) if bundled else None)
        scal = same(c.root_sums(g, h, ones), serial.root_sums(g, h, ones)) \
            and same([c.histogram_scales(g, h)],
                     [serial.histogram_scales(g, h)])
        ok = bool(torch.equal(hist, serial_hist)) and same(got, want) \
            and scal
        print(f"  (a) {name} over NCCL (world of one): reduced histogram, "
              f"split candidates, root sums and scales equal to "
              f"SerialComm's {ok}", flush=True)
        if not ok:
            fail(f"phase 18: {name} over NCCL differs from SerialComm")

    # each collective's device ms on the main path's shapes
    dp = pc.DataParallelComm(coll, 1, F, N)
    out = HistogramAccumulator(S, F, B, dev)
    cand = serial.find_splits(serial_hist, pg, ph, pcnt,
                              serial.block_meta(*meta), spec)
    packed = pc._pack_candidates(cand, False)
    roots = torch.zeros(3, dtype=torch.float64, device=dev)
    votes = torch.zeros((2, 2 * S, F), dtype=torch.float64, device=dev)
    sel = torch.zeros((2 * S, F, B, 3), dtype=torch.float64, device=dev)
    calls0 = coll.calls
    for label, fn, nbytes in (
            ("reduce-scatter of B1's sums (u64 g, u64 h, u32 count)",
             lambda: dp.reduce_sums(acc, out), S * F * B * 20),
            ("all-gather of the split candidates (int32)",
             lambda: coll.all_gather(packed),
             packed.numel() * 4),
            ("all-reduce of the root sums (f64)",
             lambda: coll.all_reduce(roots), 24),
            ("all-reduce MAX of the scales (f64)",
             lambda: coll.all_reduce(roots[:2], "max"), 16),
            ("all-reduce of voting's votes and gains (f64)",
             lambda: coll.all_reduce(votes), votes.numel() * 8),
            ("all-reduce of voting's selected columns (f64, k2 = F)",
             lambda: coll.all_reduce(sel), sel.numel() * 8)):
        ms = cuda_time_ms(fn, 20)
        print(f"  (a) NCCL, world of one: a local copy, not a multi-GPU "
              f"number: {label}, {nbytes / 2**20:.3f} MiB: {ms:.4f} ms",
              flush=True)
    if coll.staged_calls:
        fail("phase 18: an NCCL group staged a collective through the host")
    print(f"  (a) collectives {coll.calls - calls0} timed, staged through "
          f"the host {coll.staged_calls}", flush=True)
    torch.cuda.synchronize()
    launches = launch_count()             # ... and end here
    dist.destroy_process_group()
    del acc, out, serial_hist, whole, X8, X, g, h, ones, leaf_id, kw, sel
    torch.cuda.empty_cache()
    return launches


def parallel_phase(mres, dev):
    """Phase 18: multi-GPU training's comm layer: on one card, or across
    the cards of a machine with several."""
    t0 = time.perf_counter()
    launches = nccl_world_of_one(dev)
    print(f"  (a) histogram kernel passes: {launches}", flush=True)
    probe = _run_ranks(_NCCL_PROBE, 2, PAR_PROBE_S)
    accepted = True
    for r, (rc, so, se) in enumerate(probe):
        line = so.strip().splitlines()[-1] if so.strip() else ""
        said = json.loads(line) if line.startswith("{") else \
            {"ok": False, "error": f"rc {rc}: {se.strip()[-400:]}"}
        accepted &= bool(said.get("ok"))
        print(f"  two NCCL ranks on cuda:0, rank {r}: "
              f"{'accepted, sum ' + str(said['sum']) if said.get('ok') else 'NCCL says: ' + said.get('error', '?')}",
              flush=True)
    import torch
    cards = torch.cuda.device_count()
    # several cards: a rank on each, over NCCL; one card: two ranks on it,
    # over NCCL only where the probe passed
    world = cards if cards > 1 else 2
    backend = "nccl" if cards > 1 or accepted else "gloo"
    label = "gloo over one card" if backend == "gloo" else (
        f"NCCL across {world} cards" if cards > 1
        else "NCCL, two ranks on one card")
    print(f"  (b) {world} ranks on {min(cards, world)} card(s) over "
          f"{backend} (the ranks' own group), phase 4's data and "
          f"parameters, {PAR_ROUNDS} rounds per learner", flush=True)
    ranks = _run_ranks(_PAR_RANK, world, PAR_DEADLINE_S,
                       extra=(backend, PAR_ROUNDS))
    res = []
    for r, (rc, so, se) in enumerate(ranks):
        lines = so.strip().splitlines()
        if rc != 0 or not lines:
            fail(f"phase 18 (b): rank {r} exited {rc}: {se.strip()[-3000:]}")
        res.append(json.loads(lines[-1]))
    for tl in ("data", "feature", "voting"):
        for r, out in enumerate(res):
            o = out[tl]
            launches += o["launches"]
            print(f"  (b) {tl}, rank {r} ({label}): {o['world']} ranks, "
                  f"{o['backend']}, {o['rows']} rows held, {o['device']}; "
                  f"setup {o['setup_s']:.2f} s, {o['ms_per_iter']:.1f} ms "
                  f"per iteration, B1 launches {o['launches']}, collectives "
                  f"{o['calls']} ({o['mbytes']:.1f} MiB), host-staged "
                  f"{o['staged_calls']} in {o['staged_ms']:.1f} ms; train "
                  f"AUC {o['auc']:.5f}; model text sha256 "
                  f"{o['digest'][:16]}; ran eagerly: {o['eager']}",
                  flush=True)
            if o["strategy"] != tl or o["world"] != world or o["trees"] != \
                    PAR_ROUNDS or o["launches"] <= 0:
                fail(f"phase 18 (b): {tl} rank {r} did not train a world "
                     f"of {world} through B1")
            if o["staged_calls"] != (o["calls"] if backend == "gloo" else 0):
                fail(f"phase 18 (b): {tl} rank {r}: {o['staged_calls']} of "
                     f"{o['calls']} collectives staged through the host "
                     f"under {backend}")
        digests = {o[tl]["digest"] for o in res}
        if len(digests) != 1:
            fail(f"phase 18 (b): {tl}: the ranks' model texts differ")
        digest = digests.pop()
        if tl in ("data", "feature"):
            same = digest == mres["digest"]
            print(f"  (b) {tl}: every rank's text is phase 4's "
                  f"({mres['digest'][:8]}…{mres['digest'][-5:]}) {same}",
                  flush=True)
            if not same:
                fail(f"phase 18 (b): {tl}'s text is not phase 4's")
        else:
            gap = abs(res[0][tl]["auc"] - mres["auc"])
            print(f"  (b) voting: every rank's text the same True; train "
                  f"AUC {res[0][tl]['auc']:.5f} against phase 4's "
                  f"{mres['auc']:.5f} (|diff| {gap:.5f}, tol {PAR_AUC_TOL})",
                  flush=True)
            if not gap <= PAR_AUC_TOL:
                fail("phase 18 (b): voting's AUC is off phase 4's")
            voting_digest = digest
    if any(o["modules"] for o in res):
        fail("phase 18 (b): a rank imported JAX or lightgbm_tpu")
    print(f"  histogram kernel launches in phase 18: {launches}; phase 18 "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=launches, voting_digest=voting_digest)


# ---------------------------------------------------------------- phase 19

FT_ROUNDS = 10                     # phase 19: phase 4's rounds
FT_DEADLINE_S = 300                # one supervised arm, then killed
FT_HANG_S = 5.0                    # (b)'s hang_timeout_s
FT_LEASE_S = 10.0                  # (c)'s gang_lease_timeout_s
FT_HANG_GANG_S = 20.0              # (c)'s hang_timeout_s

# a training child of phase 19: the command line (``cli.main``) on the
# tokens it is given, with its own tokens taken out: ``smoke_rank``,
# ``smoke_world``, ``smoke_port`` and ``smoke_backend`` (a world whose group
# this script makes, as phase 18's ranks do: two ranks on one card need
# gloo), ``smoke_kill_rank`` / ``smoke_kill_marker`` / ``smoke_kill_after``
# (that rank SIGKILLs itself after its n-th checkpoint or gang manifest
# unless the marker exists, and writes the marker with the time). It prints
# one JSON line: B1's launches, each checkpoint save's ms (gang: shard
# write, exchange and commit apart) and its wall seconds.
_FT_CHILD = r"""
import datetime, json, os, signal, sys, time
t_start = time.perf_counter()
own = {a.split("=", 1)[0][6:]: a.split("=", 1)[1] for a in sys.argv[1:]
       if a.startswith("smoke_")}
argv = [a for a in sys.argv[1:] if not a.startswith("smoke_")]
import torch
rank, world = int(own.get("rank", 0)), int(own.get("world", 1))
if world > 1:
    import torch.distributed as dist
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.TCPStore("127.0.0.1", int(own["port"]), world, rank == 0,
                          timeout=datetime.timedelta(seconds=120),
                          wait_for_workers=False)
    dist.init_process_group(own["backend"], store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
from lightgbm_tpu_torch.robustness import checkpoint as ck
from lightgbm_tpu_torch.robustness import distributed as gd
saves = []
for cls in (ck.CheckpointManager, gd.GangCheckpointCoordinator):
    def timed(self, payload, _orig=cls.save):
        t0 = time.perf_counter()
        path = _orig(self, payload)
        saves.append(dict({k: v * 1e3 for k, v in
                           getattr(self, "timings", {}).items()},
                          ms=(time.perf_counter() - t0) * 1e3,
                          iteration=payload.get("iteration")))
        return path
    cls.save = timed
ck_dir = [a.split("=", 1)[1] for a in argv if a.startswith("checkpoint_dir=")]
marker = own.get("kill_marker", "")
if rank == int(own.get("kill_rank", -1)) and marker \
        and not os.path.exists(marker):
    n_kill = int(own.get("kill_after", 2))
    train_fn = cli.train_fn

    def train(*a, callbacks=None, **kw):
        def kill(env):
            n = len(gd.list_manifests(ck_dir[0])) if world > 1 else \
                len(ck.CheckpointManager(ck_dir[0]).list_checkpoints())
            if n >= n_kill:
                with open(marker, "w") as fh:
                    fh.write(repr(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
        kill.order = 60                  # after the checkpoint callback
        return train_fn(*a, callbacks=list(callbacks or []) + [kill], **kw)
    cli.train_fn = train
rc = cli.main(argv)
if torch.cuda.is_available():
    torch.cuda.synchronize()
print(json.dumps({"rc": rc, "launches": launch_count(), "saves": saves,
                  "wall_s": time.perf_counter() - t_start,
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in
                                    ("jax", "lightgbm_tpu"))}), flush=True)
sys.stdout.flush()
os._exit(0)
"""

# phase 19 (d): a rank of a streamed world on phase 4's binary file
_FT_STREAM_RANK = r"""
import datetime, hashlib, json, sys, time
import torch, torch.distributed as dist
rank, world, port = map(int, sys.argv[1:4])
backend, rounds, bin_path = sys.argv[4], int(sys.argv[5]), sys.argv[6]
params = json.loads(sys.argv[7])
sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: 0)
if torch.cuda.is_available():
    torch.cuda.set_device(rank % torch.cuda.device_count())
store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                      timeout=datetime.timedelta(seconds=300))
dist.init_process_group(backend, store=store, rank=rank, world_size=world)
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.cuda_histogram import (launch_count,
                                                   reset_launch_count)
res = {}
for tl in ("data", "voting"):
    ds = lgt.Dataset(bin_path)
    reset_launch_count()                    # each learner's path starts
    t0 = time.perf_counter()
    bst = lgt.Booster(params=dict(params, tree_learner=tl,
                                  tpu_residency="stream"), train_set=ds)
    sync()
    t1 = time.perf_counter()
    bst.update()
    sync()
    t2 = time.perf_counter()
    for _ in range(rounds - 1):
        bst.update()
    sync()
    t3 = time.perf_counter()
    text = bst.model_to_string()
    launches = launch_count()               # ... and ends here
    g = bst._gbdt
    st = g._stream_store
    res[tl] = dict(
        digest=hashlib.sha256(text.encode()).hexdigest(),
        launches=launches, setup_s=t1 - t0, first_ms=(t2 - t1) * 1e3,
        ms_per_iter=(t3 - t2) / (rounds - 1) * 1e3,
        residency=g.residency, strategy=g.pctx.strategy,
        world=g.pctx.num_devices, rows=g.num_rows, shards=st.n_shards,
        shard_rows=st.shard_rows, trees=len(bst.trees),
        flag_reads=g._grower.flag_reads, waves=g._grower.waves_run,
        staged_calls=g.pctx.coll.staged_calls,
        staged_ms=g.pctx.coll.staged_s * 1e3)
    del bst, g, st, ds
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
res["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "lightgbm_tpu"))
print(json.dumps(res), flush=True)
dist.destroy_process_group()
"""


class _TimedProc:
    """A child whose exit the supervisors poll, with the wall time
    (``time.time()``) at which a poll first saw it gone."""

    def __init__(self, proc, out, err):
        self.proc, self.out, self.err = proc, out, err
        self.ended_at = None

    def poll(self):
        rc = self.proc.poll()
        if rc is not None and self.ended_at is None:
            self.ended_at = time.time()
        return rc

    def terminate(self):
        self.proc.terminate()

    def kill(self):
        self.proc.kill()

    def result(self):
        """(rc, the JSON line the child printed or None, stderr tail)."""
        self.proc.wait()
        for fh in (self.out, self.err):
            fh.flush()
            fh.seek(0)
        lines = [ln for ln in self.out.read().splitlines()
                 if ln.startswith("{")]
        return (self.proc.returncode,
                json.loads(lines[-1]) if lines else None, self.err.read())


def _ft_spawner(tmp, env_extra=None):
    """A ``spawn_fn`` for the supervisors: each child is ``_FT_CHILD`` on
    the given tokens, its output in files of ``tmp``."""
    import tempfile
    children = []
    env = dict(os.environ, PYTHONPATH=HERE, PYTHONUNBUFFERED="1",
               **(env_extra or {}))

    def spawn(argv):
        out = tempfile.TemporaryFile("w+", dir=tmp)
        err = tempfile.TemporaryFile("w+", dir=tmp)
        child = _TimedProc(subprocess.Popen(
            [sys.executable, "-c", _FT_CHILD, *argv], env=env, cwd=HERE,
            stdout=out, stderr=err, start_new_session=True), out, err)
        child.argv = list(argv)
        children.append(child)
        return child
    spawn.children = children
    return spawn


def _ft_train_args(bin_path, ck, out, extra=()):
    return ["task=train", f"data={bin_path}", "verbose=0",
            *(f"{k}={v}" for k, v in MAIN_PARAMS.items() if k != "verbose"),
            f"num_iterations={FT_ROUNDS}", f"checkpoint_dir={ck}",
            "checkpoint_interval=2", "checkpoint_keep_last_n=0",
            f"output_model={out}", *extra]


def _ft_reap(children):
    """Kill what a supervised arm left running past its deadline."""
    for c in children:
        if c.proc.poll() is None:
            try:
                os.killpg(c.proc.pid, 9)
            except ProcessLookupError:
                pass
            c.proc.wait()


def _first_ckpt_iteration_after(ck, ckpt_id):
    """The iteration of checkpoint ``ckpt_id + 1`` (the relaunch's first)."""
    from lightgbm_tpu_torch.robustness.checkpoint import CheckpointManager
    path = dict(CheckpointManager(ck).list_checkpoints()).get(ckpt_id + 1)
    if path is None:
        return None
    return CheckpointManager.load(path)["iteration"]


def _supervised_arm(label, tmp, bin_path, mres, extra, env_extra):
    """(a) / (b): ``Supervisor`` over a training child that fails once
    (``expect_first``), then trains through from its checkpoints."""
    from lightgbm_tpu_torch.robustness.supervisor import (Supervisor,
                                                           describe_exit)
    t0 = time.perf_counter()
    d = os.path.join(tmp, label)
    os.makedirs(d)
    ck, out = os.path.join(d, "ck"), os.path.join(d, "model.txt")
    spawn = _ft_spawner(d, env_extra)
    sup = Supervisor(_ft_train_args(bin_path, ck, out, extra),
                     spawn_fn=spawn, max_restarts=2, seed=SEED,
                     backoff_base_s=0.1, jitter=0.0, poll_interval_s=0.02)
    result = {}

    def run():
        result["rc"] = sup.run()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(FT_DEADLINE_S)
    _ft_reap(spawn.children)
    th.join(10)
    results = [c.result() for c in spawn.children]
    digest = _file_digest(out) if os.path.exists(out) else None
    resumed_at = _first_ckpt_iteration_after(ck, 2)
    wall = time.perf_counter() - t0
    rc = result.get("rc")
    first_rc = results[0][0] if results else None
    print(f"  ({label}) supervisor: exit {rc}, {sup.restarts} restart(s), "
          f"first child {describe_exit(first_rc) if first_rc is not None else '?'}"
          f", MTTR {[round(s, 3) for s in sup.recovery_seconds]} s; the "
          f"relaunch's first checkpoint at iteration {resumed_at} (resumed "
          f"from 4); model text sha256 {(digest or '?')[:16]}, phase 4's "
          f"{digest == mres['digest']}; {wall:.1f} s", flush=True)
    return dict(rc=rc, sup=sup, results=results, digest=digest, wall=wall,
                resumed_at=resumed_at, ck=ck, first_rc=first_rc)


def _check_supervised(label, arm, mres, expect_first):
    if arm["rc"] != 0 or arm["digest"] != mres["digest"]:
        fail(f"phase 19 ({label}): the supervised run did not end with "
             f"phase 4's text (exit {arm['rc']}):\n"
             f"{arm['results'][-1][2][-3000:] if arm['results'] else ''}")
    if arm["first_rc"] != expect_first or arm["sup"].restarts != 1:
        fail(f"phase 19 ({label}): the first child exited "
             f"{arm['first_rc']}, not {expect_first}, or restarts "
             f"{arm['sup'].restarts} != 1:\n{arm['results'][0][2][-3000:]}")
    if arm["resumed_at"] != 6 or len(arm["sup"].recovery_seconds) != 1:
        fail(f"phase 19 ({label}): the relaunch did not resume from "
             f"iteration 4 (first checkpoint at {arm['resumed_at']})")
    last = arm["results"][-1][1]
    if not last or last["launches"] <= 0 or last["modules"]:
        fail(f"phase 19 ({label}): the relaunch never launched B1, or "
             f"imported JAX")
    return last


def _gang_arm(tmp, bin_path, mres, world, backend, label):
    """(c): ``FleetSupervisor`` over a data-parallel world whose rank 1
    kills itself after two manifests; then one process resumes epoch 2
    under ``elastic=true tpu_reshard_on_resume=true``."""
    import shutil
    from lightgbm_tpu_torch.robustness import distributed as gd
    from lightgbm_tpu_torch.robustness.supervisor import FleetSupervisor
    t0 = time.perf_counter()
    d = os.path.join(tmp, "c")
    os.makedirs(d)
    ck = os.path.join(d, "ck")
    marker = os.path.join(d, "kill.marker")
    template = _ft_train_args(
        bin_path, ck, os.path.join(d, "model_{rank}.txt"),
        ["tree_learner=data", "gang_heartbeat_interval_s=0.5",
         f"gang_lease_timeout_s={FT_LEASE_S}",
         f"hang_timeout_s={FT_HANG_GANG_S}", "hang_action=abort",
         "smoke_rank={rank}", "smoke_world={world}",
         f"smoke_backend={backend}", "smoke_kill_rank=1",
         f"smoke_kill_marker={marker}"])
    spawn = _ft_spawner(d)
    fleet = FleetSupervisor(
        template, world, max_restarts=2, seed=SEED, backoff_base_s=0.1,
        jitter=0.0, poll_interval_s=0.02, reap_grace_s=60.0,
        pre_launch_fn=lambda w, g: [f"smoke_port={_free_port()}"],
        spawn_fn=spawn)
    result = {}

    def run():
        result["rc"] = fleet.run()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(FT_DEADLINE_S)
    _ft_reap(spawn.children)
    th.join(10)
    gang_s = time.perf_counter() - t0
    ch = spawn.children
    res = [c.result() for c in ch]
    gen0 = res[:world]
    killed_at = float(open(marker).read()) if os.path.exists(marker) \
        else None
    detect_s = (ch[0].ended_at - killed_at) if killed_at and \
        ch[0].ended_at else None
    named = bool(re.search(r"lost peer rank 1\b", gen0[0][2], re.I))
    digests = [_file_digest(os.path.join(d, f"model_{r}.txt"))
               if os.path.exists(os.path.join(d, f"model_{r}.txt")) else None
               for r in range(world)]
    manifests = gd.list_manifests(ck)
    iters = [gd.load_manifest(p)["iteration"] for _, p in manifests]
    saves = [dict(s, rank=r) for r, (_, out, _) in enumerate(res[world:])
             if out for s in out["saves"]]
    print(f"  (c) fleet of {world} ranks over {backend} ({label}): exit "
          f"{result.get('rc')}, gang exit codes "
          f"{fleet.gang_exit_codes}, rank 0 of generation 0 exited "
          f"{gen0[0][0]} naming rank 1 {named}, "
          f"{detect_s if detect_s is None else round(detect_s, 3)} s after "
          f"rank 1's SIGKILL (lease {FT_LEASE_S:g} s, hang threshold "
          f"{FT_HANG_GANG_S:g} s); fleet MTTR "
          f"{[round(s, 3) for s in fleet.recovery_seconds]} s; manifests' "
          f"iterations {iters}; {gang_s:.1f} s", flush=True)
    for s in saves:
        print(f"  (c) rank {s['rank']}, gang checkpoint at iteration "
              f"{s['iteration']}: "
              f"{s['ms']:.1f} ms (shard write {s.get('shard_write_s', 0):.1f}"
              f", exchange + manifest {s.get('exchange_s', 0):.1f}, commit "
              f"barrier {s.get('commit_s', 0):.1f} ms)", flush=True)
    ok_text = all(dg == mres["digest"] for dg in digests)
    print(f"  (c) the relaunched gang resumed the same epoch on every rank "
          f"(manifests at iterations {iters}) and every rank's text is "
          f"phase 4's {ok_text}", flush=True)
    if result.get("rc") != 0 or not ok_text or fleet.restarts != 1:
        fail(f"phase 19 (c): the gang did not end with phase 4's text "
             f"after one relaunch (exit {result.get('rc')}, restarts "
             f"{fleet.restarts}):\n{res[-1][2][-3000:]}")
    want_rcs = [-9 if r == 1 else 145 for r in range(world)]
    if [r[0] for r in gen0] != want_rcs or not named:
        fail(f"phase 19 (c): generation 0 exited {[r[0] for r in gen0]}, "
             f"not {want_rcs} (rank 0 must exit 145 naming rank 1):\n"
             f"{gen0[0][2][-3000:]}")
    if detect_s is None or detect_s > FT_LEASE_S + FT_HANG_GANG_S:
        fail(f"phase 19 (c): rank 0 took {detect_s} s to leave")
    if iters != [2, 4, 6, 8, 10]:
        fail(f"phase 19 (c): the relaunch did not resume epoch 2 "
             f"(manifests at {iters})")
    if any(out is None or out["launches"] <= 0 or out["modules"]
           for _, out, _ in res[world:]):
        fail("phase 19 (c): a relaunched rank never launched B1, or "
             "imported JAX")
    # one process resumes epoch 2 of the gang (iteration 4)
    e_dir = os.path.join(d, "elastic")
    os.makedirs(e_dir)
    for name in os.listdir(ck):
        if name in ("manifest_0000000002.json",) or \
                name.startswith("shard_0000000002_"):
            shutil.copy(os.path.join(ck, name), e_dir)
    return dict(d=d, e_dir=e_dir, res=res, fleet=fleet, saves=saves,
                detect_s=detect_s, gang_s=gang_s, world=world)


def _elastic_start(gang, bin_path):
    """(c): the single-process elastic resume, started (it runs while (d)
    does)."""
    e_out = os.path.join(gang["d"], "model_elastic.txt")
    args = _ft_train_args(bin_path, gang["e_dir"], e_out,
                          ["tree_learner=data", "resume_from=auto",
                           "elastic=true", "tpu_reshard_on_resume=true"])
    spawn = _ft_spawner(gang["d"])
    return spawn(args), e_out, time.perf_counter()


def _elastic_finish(child, e_out, t0, mres):
    rc, out, err = child.result()
    digest = _file_digest(e_out) if os.path.exists(e_out) else None
    print(f"  (c) one process resumed the gang's epoch 2 (world 2 -> 1, "
          f"elastic=true tpu_reshard_on_resume=true): exit {rc}, B1 "
          f"launches {out and out['launches']}, text phase 4's "
          f"{digest == mres['digest']}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if rc != 0 or digest != mres["digest"] or not out or \
            out["launches"] <= 0:
        fail(f"phase 19 (c): the elastic resume did not give phase 4's "
             f"text:\n{err[-3000:]}")
    return out["launches"]


def _stream_world(bin_path, mres, pres, world, backend, label):
    """(d): streamed data and voting in a world on phase 4's data."""
    t0 = time.perf_counter()
    ranks = _run_ranks(_FT_STREAM_RANK, world, PAR_DEADLINE_S,
                       extra=(backend, FT_ROUNDS, bin_path,
                              json.dumps(MAIN_PARAMS)))
    res = []
    for r, (rc, so, se) in enumerate(ranks):
        lines = so.strip().splitlines()
        if rc != 0 or not lines:
            fail(f"phase 19 (d): rank {r} exited {rc}: {se.strip()[-3000:]}")
        res.append(json.loads(lines[-1]))
    launches = 0
    for tl in ("data", "voting"):
        for r, out in enumerate(res):
            o = out[tl]
            launches += o["launches"]
            print(f"  (d) streamed {tl}, rank {r} ({label}): {o['world']} "
                  f"ranks, {o['rows']} rows in {o['shards']} shards of "
                  f"{o['shard_rows']}; setup {o['setup_s']:.2f} s, first "
                  f"iteration {o['first_ms']:.1f} ms, then "
                  f"{o['ms_per_iter']:.1f} ms per iteration; B1 launches "
                  f"{o['launches']}; flag reads per wave "
                  f"{o['flag_reads'] / max(o['waves'], 1):.2f}; host-staged "
                  f"collectives {o['staged_calls']} in "
                  f"{o['staged_ms']:.1f} ms", flush=True)
            if o["residency"] != "stream" or o["strategy"] != tl or \
                    o["trees"] != FT_ROUNDS or o["launches"] != 140:
                fail(f"phase 19 (d): {tl} rank {r} did not stream a world "
                     f"of {world} through B1 (140 launches expected)")
        digests = {o[tl]["digest"] for o in res}
        if len(digests) != 1:
            fail(f"phase 19 (d): {tl}: the ranks' model texts differ")
        digest = digests.pop()
        want = mres["digest"] if tl == "data" else pres.get("voting_digest")
        same = digest == want if want else None
        print(f"  (d) streamed {tl}: every rank's text "
              f"{'phase 4' if tl == 'data' else 'phase 18 (b) voting'}'s "
              f"{same}", flush=True)
        if want and not same:
            fail(f"phase 19 (d): streamed {tl}'s text is not the resident "
                 f"one's")
    if any(o["modules"] for o in res):
        fail("phase 19 (d): a rank imported JAX or lightgbm_tpu")
    print(f"  (d) {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def fault_tolerance_phase(mres, pres):
    """Phase 19: robustness on the card: supervised kill, watchdog abort,
    gang kill with the elastic resume, streaming in a world. Every
    training process is a child; this process only supervises."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_19_")
    try:
        bin_path = os.path.join(tmp, "train.bin")
        ds, _, _ = mres["data"]
        ds.save_binary(bin_path)
        print(f"  phase 4's dataset as a binary file "
              f"({os.path.getsize(bin_path) / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cards = torch.cuda.device_count()
        world = cards if cards > 1 else 2
        backend = "nccl" if cards > 1 else "gloo"
        label = (f"NCCL across {world} cards" if cards > 1
                 else "gloo over one card: no multi-GPU number")

        # (a) and (b) at once: two supervisors, two children on the card
        arms = {}
        hang_marker = os.path.join(tmp, "hang.marker")
        kill_marker = os.path.join(tmp, "kill.marker")
        jobs = {
            "a": (["smoke_kill_rank=0", f"smoke_kill_marker={kill_marker}"],
                  {}, -9),
            "b": ([f"hang_timeout_s={FT_HANG_S}", "hang_action=abort"],
                  {"LGBM_TPU_CHAOS_HANG": "4:120",
                   "LGBM_TPU_CHAOS_HANG_MARKER": hang_marker}, 142)}

        def arm(k):
            extra, env, _ = jobs[k]
            arms[k] = _supervised_arm(k, tmp, bin_path, mres, extra, env)
        ths = [threading.Thread(target=arm, args=(k,)) for k in jobs]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        launches = 0
        for k in ("a", "b"):
            if k not in arms:
                fail(f"phase 19 ({k}) did not run")
            last = _check_supervised(k, arms[k], mres, jobs[k][2])
            launches += last["launches"]
            for s in last["saves"]:
                print(f"  ({k}) checkpoint at iteration {s['iteration']}: "
                      f"{s['ms']:.1f} ms", flush=True)
        dumps = [f for f in os.listdir(arms["b"]["ck"])
                 if f.startswith("watchdog_dump_")]
        stacks = {}
        if dumps:
            stacks = json.load(open(os.path.join(
                arms["b"]["ck"], dumps[0])))["thread_stacks"]
        main_hung = any("_hang" in "".join(v) for v in stacks.values())
        print(f"  (b) watchdog dump {dumps[:1]}: {len(stacks)} thread "
              f"stacks, the training thread parked in the injected hang "
              f"{main_hung}", flush=True)
        if len(dumps) != 1 or len(stacks) < 2 or not main_hung:
            fail("phase 19 (b): no watchdog dump with every thread's stack")

        # (c) the gang, then its elastic resume beside (d)
        gang = _gang_arm(tmp, bin_path, mres, world, backend, label)
        launches += sum(out["launches"] for _, out, _ in
                        gang["res"][world:])
        child, e_out, te = _elastic_start(gang, bin_path)
        launches += _stream_world(bin_path, mres, pres, world, backend,
                                  label)
        launches += _elastic_finish(child, e_out, te, mres)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  histogram kernel launches in phase 19 (the children that ran "
          f"to their end): {launches}; phase 19 took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=launches,
                mttr=[arms[k]["sup"].recovery_seconds for k in ("a", "b")]
                + [gang["fleet"].recovery_seconds])


OBS_ROUNDS = 10                     # phase 20: phase 4's rounds
OBS_WINDOWS = ("3:6", "0:3")        # after the graph capture, and over it
B1_PER_TREE = 14                    # phase 4's 140 passes over 10 trees


def _observability_arm(mres, window, kres):
    """One arm of phase 20: phase 4's training with every telemetry knob
    on and the profiler window at ``window``; returns its facts."""
    import logging
    import shutil
    import tempfile
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import observability as obs
    from lightgbm_tpu_torch.analysis import CaptureGuard
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.observability.export import read_jsonl
    from lightgbm_tpu_torch.observability.memory import device_memory
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        histogram_pass_cost, launch_count, reset_launch_count)
    from lightgbm_tpu_torch.utils.timer import TIMERS
    ds, X, _ = mres["data"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_20_")
    obs.reset_for_tests()
    TIMERS.reset()
    params = dict(MAIN_PARAMS, verbose=1, telemetry_dir=tmp,
                  tpu_profile_iters=window, tpu_cost_analysis=True,
                  tpu_time_tag=True)
    stamps = []
    reads = {}
    orig_publish = GBDT.publish_telemetry
    # the steady iterations' syncs (the runner's flag reads and the calls
    # set_sync_debug_mode flags) and the run's one publish fetch, each
    # counted by a guard (analysis/guards.py), as phases 13 and 22 count
    guard = CaptureGuard(f"phase 20 {window}", fail=False, device="cuda")
    publish = CaptureGuard("publish", fail=False, device="cuda")

    def stamp(env):
        # host clock at each iteration's end; the guard's window runs from
        # the capture (iteration 1) to the last iteration
        stamps.append(time.perf_counter())
        r = env.model._gbdt._graphs
        if env.iteration == 1:
            reads["0"] = (r.syncs, r.trees) if r else (0, 0)
            guard.register(r, "iteration")
            guard.__enter__()
            guard.mark_warm()
        elif env.iteration == OBS_ROUNDS - 1 and guard.active:
            reads["1"] = (r.syncs, r.trees) if r else (0, 0)
            guard.__exit__(None, None, None)

    def counted_publish(self):
        with publish:
            orig_publish(self)

    try:
        with _Records(logging.DEBUG) as logs:
            GBDT.publish_telemetry = counted_publish
            reset_launch_count()            # the arm's path starts
            t0 = time.perf_counter()
            bst = lgt.train(params, ds, num_boost_round=OBS_ROUNDS,
                            callbacks=[stamp], keep_training_booster=True)
            pred = bst.predict(X[:100_000])
            text = bst.model_to_string()
            launches = launch_count()       # ... and ends here
            secs = time.perf_counter() - t0
    finally:
        GBDT.publish_telemetry = orig_publish
        if guard.active:
            guard.__exit__(None, None, None)
    gbdt = bst._gbdt
    runner = gbdt._graphs
    replayed = runner.trees if runner is not None else 0
    (reads0, trees0), (reads1, trees1) = (reads.get("0", (0, 0)),
                                          reads.get("1", (0, 0)))
    steady = trees1 - trees0
    flagged = guard.host_syncs - (reads1 - reads0)
    syncs_per_tree = guard.host_syncs / max(steady, 1) \
        if runner is not None else float("nan")
    where = guard.sync_sites
    publish = {"syncs": publish.host_syncs}
    digest = text_digest(text)
    not_captured = [m for m in logs if m.startswith("not captured:")]
    timetag = [m for m in logs if m.startswith("TIMETAG phase summary")]
    print(f"  tpu_profile_iters={window}: {OBS_ROUNDS} rounds in {secs:.2f} s "
          f"(predict and model text included); model text sha256 {digest}, "
          f"phase 4's {digest == mres['digest']}; B1 launches {launches}; "
          f"{replayed} trees replayed from CUDA graphs; host syncs per "
          f"tree after the capture {syncs_per_tree:.2f} over {steady} trees "
          f"({reads1 - reads0} flag reads + {flagged} "
          f"flagged calls {where}), the publish fetch "
          f"{publish.get('syncs')} sync(s); 'not captured:' lines "
          f"{len(not_captured)}; predictions finite "
          f"{bool(torch.isfinite(torch.as_tensor(pred)).all())}", flush=True)
    if digest != mres["digest"]:
        fail(f"phase 20 ({window}): the model text is not phase 4's")
    if launches != B1_PER_TREE * OBS_ROUNDS:
        fail(f"phase 20 ({window}): {launches} B1 launches, not "
             f"{B1_PER_TREE * OBS_ROUNDS}")
    if not_captured or runner is None or replayed != OBS_ROUNDS - 1:
        fail(f"phase 20 ({window}): the iterations were not captured "
             f"({not_captured})")
    if f"{syncs_per_tree:.2f}" != "1.00" or publish.get("syncs") != 1:
        fail(f"phase 20 ({window}): {syncs_per_tree:.2f} host syncs per "
             f"tree, {publish.get('syncs')} in the publish fetch")

    # ---- the telemetry files -------------------------------------------
    pid = os.getpid()
    files = {k: os.path.join(tmp, f"{k}_{pid}.{x}") for k, x in
             (("trace", "json"), ("events", "jsonl"), ("snapshot", "json"))}
    missing = [k for k, f in files.items() if not os.path.exists(f)]
    if missing:
        fail(f"phase 20 ({window}): no {missing} file in {os.listdir(tmp)}")
    trace = json.load(open(files["trace"]))["traceEvents"]
    events = read_jsonl(files["events"])
    snap = json.load(open(files["snapshot"]))
    names = {}
    for e in trace:
        names[e["name"]] = names.get(e["name"], 0) + 1
    waves_hist = snap["histograms"].get("tree.waves", {})
    print(f"  trace_{pid}.json: {names.get('train', 0)} train, "
          f"{names.get('tree_batch', 0)} tree_batch, "
          f"{names.get('iteration', 0)} iteration, {names.get('wave', 0)} "
          f"derived wave spans (tree.waves sum {waves_hist.get('sum')}); "
          f"events_{pid}.jsonl {len(events)} records; snapshot_{pid}.json "
          f"trees.trained {snap['counters'].get('trees.trained')}, "
          f"rows.routed {snap['counters'].get('rows.routed')}, cost reports "
          f"{sorted(snap.get('cost_reports', {}))}", flush=True)
    if names.get("train") != 1 or names.get("iteration") != OBS_ROUNDS \
            or names.get("wave") != waves_hist.get("sum") \
            or snap["counters"].get("trees.trained") != OBS_ROUNDS:
        fail(f"phase 20 ({window}): the spans or counters are wrong")

    # ---- the profiler window --------------------------------------------
    start = [e for e in trace if e["name"] == "profiler_window_start"]
    stop = [e for e in trace if e["name"] == "profiler_window_stop"]
    if len(start) != 1 or len(stop) != 1:
        fail(f"phase 20 ({window}): no profiler window in the trace")
    first, end = start[0]["args"]["iteration"], stop[0]["args"]["iteration"]
    prof_path = stop[0]["args"]["trace"]
    prof = json.load(open(prof_path))["traceEvents"]
    kernels = [e for e in prof if e.get("cat") == "kernel"]
    fin = sum("finalize_kernel" in e.get("name", "") for e in kernels)
    hist = sum("hist_kernel" in e.get("name", "") for e in kernels)
    covered = end - first
    print(f"  profiler window {window}: iterations {first}:{end} "
          f"({covered} batch-aligned), {os.path.getsize(prof_path) / 1e6:.1f} "
          f"MB Chrome trace, {len(kernels)} kernel events, finalize_kernel "
          f"{fin} = {B1_PER_TREE} x {covered} {fin == B1_PER_TREE * covered}"
          f", hist_kernel {hist}", flush=True)
    if fin != B1_PER_TREE * covered or hist < fin:
        fail(f"phase 20 ({window}): the profile holds {fin} B1 passes for "
             f"{covered} iterations")

    # ---- the cost report and device memory -------------------------------
    rep = snap["cost_reports"].get(f"histogram.full.s{S}", {})
    want = kres["full"]["bytes"] if "full" in kres \
        else histogram_pass_cost(N, F, B, S)["bytes"]
    step = snap["cost_reports"].get("train_step.k1", {})
    dm = device_memory()
    peak = torch.cuda.max_memory_allocated()
    print(f"  cost report histogram.full.s{S}: bytes_accessed "
          f"{rep.get('bytes_accessed')}, flops {rep.get('flops')}, temp "
          f"{rep.get('temp_bytes')}; phase 3's full bound bytes {want} "
          f"{rep.get('bytes_accessed') == want}; train_step.k1: arguments "
          f"{step.get('argument_bytes')}, temps across the capture "
          f"{step.get('temp_bytes')}, peak {step.get('peak_hbm_bytes')}; "
          f"device_memory peak_bytes {dm.get('peak_bytes')} == "
          f"max_memory_allocated {peak} {dm.get('peak_bytes') == peak}, "
          f"capacity {dm.get('capacity_bytes')}", flush=True)
    if rep.get("bytes_accessed") != want:
        fail(f"phase 20 ({window}): the histogram report's bytes are not "
             f"phase 3's bound's")
    if dm.get("peak_bytes") != peak or not step.get("argument_bytes"):
        fail(f"phase 20 ({window}): device memory or the step report is "
             f"wrong")
    if not timetag:
        fail(f"phase 20 ({window}): no TIMETAG summary was logged")
    print("  " + timetag[-1].replace("\n", "\n  "), flush=True)

    # ms per iteration (host clock between iteration ends; the tree's
    # flag read waits for the card): the window's first iteration holds the
    # profiler's start, its last the stop and the trace's export; the
    # captured iterations between them against those outside the window
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]   # its 1..9

    def at(i):
        return ms[i - 1] if 1 <= i <= len(ms) else None
    inside = [ms[i - 1] for i in range(max(first + 1, 2), end - 1)
              if 1 <= i <= len(ms)]
    outside = [ms[i - 1] for i in range(2, OBS_ROUNDS)
               if not first <= i < end]
    del bst, gbdt, runner
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    obs.reset_for_tests()
    return dict(launches=launches, ms=ms, window=(first, end),
                start_ms=at(first), stop_ms=at(end - 1),
                inside=sum(inside) / len(inside) if inside else None,
                n_inside=len(inside),
                outside=sum(outside) / len(outside) if outside else None)


def observability_phase(mres, bres, kres):
    """Phase 20: training observability on the card (A17b)."""
    t0 = time.perf_counter()
    arms = {w: _observability_arm(mres, w, kres) for w in OBS_WINDOWS}
    k1 = (bres or {}).get("stats", {}).get("captured K=1", {}).get("ms")

    def fmt(v):
        return "n/a" if v is None else f"{v:.2f}"

    for w, a in arms.items():
        print(f"  {w}: ms of iterations 1-9 (1 captures the graphs) "
              f"{', '.join(f'{m:.1f}' for m in a['ms'])}; the window's "
              f"first (profiler start) {fmt(a['start_ms'])}, last (stop "
              f"and export) {fmt(a['stop_ms'])}, captured between them "
              f"{fmt(a['inside'])} (mean of {a['n_inside']}), captured "
              f"outside it {fmt(a['outside'])}; phase 13's captured K=1 "
              f"steady "
              f"{fmt(k1)} ms", flush=True)
    launches = sum(a["launches"] for a in arms.values())
    print(f"  histogram kernel launches in phase 20: {launches}; phase 20 "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=launches)


WIDE_ROWS, WIDE_F, WIDE_ROUNDS = 200_000, 8, 5     # phase 21
WIDE_MAX_BINS = (16_383, 40_000)
WIDE_PARAMS = {"objective": "regression", "num_leaves": 15,
               "min_data_in_leaf": 20, "min_data_in_bin": 1,
               "boost_from_average": False, "learning_rate": 0.5,
               "metric": "none", "verbose": -1}


def wide_data(n, f, seed):
    """Every value distinct (each column a permutation of the rows, on a
    1/64 grid, exact in f32), so that ``max_bin`` bins are found; L2
    labels on a 1/4 grid (exact arithmetic)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = np.stack([rng.permutation(n) for _ in range(f)], 1) \
        .astype(np.float32) / 64.0
    y = (np.floor(X[:, 0] * 256.0 / n) / 4.0 + (X[:, 1] > n / 128.0) * 0.5
         - (X[:, 2] > n / 100.0) * 0.25).astype(np.float32)
    return X, y


def wide_bins_phase():
    """Phase 21: wide bins on the card (ROADMAP B1c). 200,000 x 8, every
    value distinct, exact-arithmetic L2 labels, 5 rounds at ``max_bin``
    16,383 (``int16`` codes, two bin tiles) and 40,000 (``int32`` codes,
    four tiles): the card's model text must equal the CPU port's, B1
    launched on the card, the codes of the card's dtype."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        bin_tiles, launch_count, reset_launch_count)
    X, y = wide_data(WIDE_ROWS, WIDE_F, SEED + 21)
    launches = 0
    for max_bin in WIDE_MAX_BINS:
        params = dict(WIDE_PARAMS, max_bin=max_bin)
        reset_launch_count()
        t0 = time.perf_counter()
        card = lgt.train(params, lgt.Dataset(X, label=y),
                         num_boost_round=WIDE_ROUNDS,
                         keep_training_booster=True)
        text = card.model_to_string()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = launch_count()
        launches += n
        g = card._gbdt
        nb = g.spec.num_bins_padded
        dtype = g.Xb.dtype
        top = int(g.Xb.max())
        cpu = lgt.train(dict(params, device="cpu"), lgt.Dataset(X, label=y),
                        num_boost_round=WIDE_ROUNDS)
        t2 = time.perf_counter()
        equal = cpu.model_to_string() == text
        tile, tiles = bin_tiles(nb)
        print(f"  max_bin {max_bin}: num_bins_padded {nb} ({tiles} bin "
              f"tiles of {tile}), {dtype} codes up to {top} on the card, "
              f"ingest {'device' if g._ingest_report else 'host'}; "
              f"{WIDE_ROUNDS} rounds on the card {t1 - t0:.2f} s (binning "
              f"included), B1 launches {n}, {len(card.trees)} trees; the "
              f"CPU port {t2 - t1:.2f} s; model text equal to the CPU "
              f"port's {equal}; sha256 {text_digest(text)}", flush=True)
        if not equal:
            fail(f"phase 21: max_bin {max_bin}: the card's model text is "
                 "not the CPU port's")
        if n < WIDE_ROUNDS or len(card.trees) != WIDE_ROUNDS:
            fail(f"phase 21: max_bin {max_bin}: {n} B1 launches, "
                 f"{len(card.trees)} trees")
        want = torch.int32 if max_bin > 2 ** 15 else torch.int16
        if dtype != want or tiles < 2 or (want == torch.int32
                                          and top < 2 ** 15):
            fail(f"phase 21: max_bin {max_bin}: {dtype} codes up to {top}, "
                 f"{tiles} tiles")
        del card, cpu, g
        torch.cuda.empty_cache()
    return dict(launches=launches)


GUARD_ROUNDS = 10                   # phase 22 (a): phase 4's rounds
GUARD_REQUESTS = 300                # phase 22 (b): requests of 1-64 rows
CARD_CONTRACTS = ("T001", "T004", "T006", "T010")


def _guarded_training(mres):
    """Phase 22 (a): ``CaptureGuard`` over phase 4's training, captured,
    with telemetry on. The guard's window is the steady iterations: it is
    entered after the capture iteration (iteration 1) and left after the
    last, so the set-up, the warm-up and the model fetch after training lie
    outside it, as in phase 20's count; a second guard counts the run's
    one publish fetch. Then a planted recapture that the guard must
    refuse."""
    import tempfile
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import observability as obs
    from lightgbm_tpu_torch.analysis import CaptureGuard, GuardViolation
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.observability.phases import PhaseBreakdown
    from lightgbm_tpu_torch.ops.cuda_histogram import (launch_count,
                                                       reset_launch_count)
    ds, X, _ = mres["data"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_22_")
    obs.reset_for_tests()
    guard = CaptureGuard("train", device="cuda")
    publish = CaptureGuard("publish", device="cuda")
    steady = {}

    def window(env):
        # iteration 0 runs eagerly, iteration 1 captures the graphs
        if env.iteration == 1:
            graphs = env.model._gbdt._graphs
            guard.register(graphs, "iteration")
            guard.__enter__()
            guard.mark_warm()
            steady["trees0"] = graphs.trees
        elif env.iteration == GUARD_ROUNDS - 1:
            steady["trees"] = env.model._gbdt._graphs.trees \
                - steady["trees0"]
            guard.__exit__(None, None, None)

    orig_publish = GBDT.publish_telemetry

    def counted_publish(self):
        with publish:
            orig_publish(self)
    reset_launch_count()
    t0 = time.perf_counter()
    GBDT.publish_telemetry = counted_publish
    try:
        bst = lgt.train(dict(MAIN_PARAMS, telemetry_dir=tmp), ds,
                        num_boost_round=GUARD_ROUNDS, callbacks=[window],
                        keep_training_booster=True)
    finally:
        GBDT.publish_telemetry = orig_publish
        if guard.active:                      # a failure inside the window
            guard.__exit__(None, None, None)
    secs = time.perf_counter() - t0
    text = bst.model_to_string()
    graphs = bst._gbdt._graphs
    rep = guard.report()
    trees = steady.get("trees", 0)
    per_tree = rep["host_syncs"] / max(trees, 1)
    fetch = publish.report()["host_syncs"]
    pb = PhaseBreakdown("guarded")
    pb.attach_guard(rep)
    print(f"  (a) CaptureGuard over the steady iterations of {GUARD_ROUNDS} "
          f"captured rounds ({secs:.2f} s): report {rep}; captures after "
          f"warm {rep['post_warmup_cache_misses']}; host syncs per tree "
          f"{per_tree:.2f} over {trees} steady trees (flagged sites "
          f"{guard.sync_sites}); the publish fetch {fetch} sync(s) "
          f"({publish.sync_sites}); model text phase 4's "
          f"{text_digest(text) == mres['digest']}; B1 launches "
          f"{launch_count()}; PhaseBreakdown.attach_guard -> "
          f"{pb.to_dict()}", flush=True)
    if rep["post_warmup_cache_misses"] != 0 or not rep["warm_marked"]:
        fail("phase 22 (a): the guarded training captured after warm-up")
    if f"{per_tree:.2f}" != "1.00" or fetch != 1 or trees < 1:
        fail(f"phase 22 (a): {per_tree:.2f} host syncs per tree, "
             f"{fetch} in the publish fetch")
    if text_digest(text) != mres["digest"]:
        fail("phase 22 (a): the guarded run's model text is not phase 4's")
    # a planted recapture: the graphs dropped, the next iteration captures
    # them again, and the guard must raise on exit
    planted = CaptureGuard("planted", device="cuda")
    planted.register(graphs, "iteration")
    raised = None
    try:
        with planted:
            planted.mark_warm()
            graphs.graphs.clear()
            bst.update()
    except GuardViolation as e:
        raised = str(e)
    print(f"  (a) planted recapture (graphs dropped, one more iteration): "
          f"GuardViolation raised {raised is not None}: {raised}",
          flush=True)
    if raised is None:
        fail("phase 22 (a): the guard did not refuse a recapture")
    obs.reset_for_tests()
    return bst, text, launch_count()


def _guarded_serving(text, X):
    """Phase 22 (b): ``CaptureGuard`` around a ``ServingEngine`` of phase
    4's model over a few hundred requests: no capture after warm-up."""
    import tempfile
    import numpy as np
    from lightgbm_tpu_torch.analysis import CaptureGuard
    from lightgbm_tpu_torch.serving import ServingEngine
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_22_"),
                        "model.txt")
    with open(path, "w") as fh:
        fh.write(text)
    eng = ServingEngine(path, params={"device": "cuda", "verbose": -1})
    rng = np.random.default_rng(SEED + 22)
    guard = CaptureGuard("serve", device="cuda")
    guard.register(eng, "engine")
    sizes = rng.integers(1, 65, GUARD_REQUESTS)
    t0 = time.perf_counter()
    with guard:
        guard.mark_warm()
        for n in sizes:
            lo = int(rng.integers(0, X.shape[0] - 64))
            eng.predict(X[lo:lo + int(n)])
    secs = time.perf_counter() - t0
    rep = guard.report()
    print(f"  (b) CaptureGuard over ServingEngine ({eng.captures()} captures "
          f"at warmup, buckets {eng.buckets}): {GUARD_REQUESTS} requests of "
          f"1-64 rows in {secs:.2f} s; captures after warm "
          f"{rep['post_warmup_cache_misses']}; host syncs flagged "
          f"{rep['host_syncs']} ({rep['host_syncs'] / GUARD_REQUESTS:.2f} "
          f"per request; sites {sorted(set(guard.sync_sites))})",
          flush=True)
    if rep["post_warmup_cache_misses"] != 0:
        fail("phase 22 (b): the serving engine captured after warm-up")
    eng.close()


def _contracts_on_the_card(bst, X):
    """Phase 22 (c): T001, T004, T006 and T010 recorded on CUDA tensors at
    phase 4's shape: one tree's waves, one eager iteration's parts and the
    forest walk, with B1's passes counted on the card."""
    import torch
    from lightgbm_tpu_torch.analysis.contracts import (CONTRACTS,
                                                       TracedProgram,
                                                       evaluate)
    from lightgbm_tpu_torch.analysis.contracts import entries as E
    from lightgbm_tpu_torch.ops.cuda_histogram import launch_count
    gbdt = bst._gbdt
    progs = {}
    t0 = time.perf_counter()
    before = launch_count()
    trace = E.record_waves(gbdt._grower, *E._tree_inputs(gbdt))
    torch.cuda.synchronize()
    passes = launch_count() - before
    wave = TracedProgram("grower.wave", "card", trace,
                         kernel_launches=passes, expected_launches=trace.waves)
    progs["T001"] = progs["T004"] = wave
    before = launch_count()
    it_trace = E.record_iteration(gbdt)
    torch.cuda.synchronize()
    progs["T006"] = TracedProgram(
        "boosting.iteration", "card", it_trace,
        kernel_launches=launch_count() - before,
        expected_launches=it_trace.waves)
    progs["T010"] = TracedProgram(
        "predict.forest_walk", "card",
        E.record_walk(bst, X[:65_536], device="cuda"))
    secs = time.perf_counter() - t0
    sorts = [(r.numel, r.site) for r in trace.ops if r.name == "sort"]
    bad = {}
    for cid in CARD_CONTRACTS:
        c = CONTRACTS[cid]
        p = progs[cid]
        bad[cid] = evaluate(c, c.targets[0], p)
    print(f"  (c) recorded on the card in {secs:.2f} s: one tree's "
          f"{trace.waves} waves ({len(trace.ops)} aten operations on "
          f"{sorted({d for r in trace.ops for d in r.devices})}, host "
          f"transfers {len(trace.host_transfers())}, sorts {sorts}), B1 "
          f"passes counted on the card {passes} = waves {trace.waves} "
          f"{passes == trace.waves}; one iteration's parts "
          f"{len(it_trace.ops)} operations, host transfers "
          f"{len(it_trace.host_transfers())}, B1 passes "
          f"{progs['T006'].kernel_launches} for {it_trace.waves} waves; the "
          f"forest walk {len(progs['T010'].trace.ops)} operations",
          flush=True)
    for cid, findings in bad.items():
        print(f"  (c) {cid} {CONTRACTS[cid].title}: "
              f"{'clean' if not findings else findings}", flush=True)
    if any(bad.values()):
        fail(f"phase 22 (c): contracts broken on the card: "
             f"{ {k: v for k, v in bad.items() if v} }")
    if passes != trace.waves or trace.waves < 1:
        fail(f"phase 22 (c): {passes} B1 passes for {trace.waves} waves")
    return passes + progs["T006"].kernel_launches


def guard_phase(mres):
    """Phase 22: the capture guard and the op-trace tier on the card."""
    import torch
    t0 = time.perf_counter()
    _, X, _ = mres["data"]
    bst, text, launches = _guarded_training(mres)
    _guarded_serving(text, X)
    launches += _contracts_on_the_card(bst, X)
    del bst
    torch.cuda.empty_cache()
    print(f"  histogram kernel launches in phase 22: {launches}; phase 22 "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=launches)


PHASES = tuple(range(1, 23))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default="",
                    help="directory for the Chrome trace of phase 5")
    ap.add_argument("--phases", default="",
                    help="comma list of phases to run (default: all); a "
                         "partial run prints no result lines and exits 4")
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
    want = set(PHASES) if not args.phases else \
        {int(p) for p in args.phases.split(",")}
    # phases 5-7, 12-20 and 22 run on phase 4's data and booster
    if want & {5, 6, 7, 12, 13, 14, 15, 16, 17, 18, 19, 20, 22}:
        want.add(4)

    t_start = time.perf_counter()
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

    none = dict(launches=0)
    kres, mres, sres, cres, gres, rres = {}, None, None, none, None, None
    if 3 in want:
        elapsed(t_start)
        print(f"phase 3: histogram kernel vs plain version (N={N}, F={F}, "
              f"B={B} (uint16: {B16}), S={S}; efb: {BOSCH_ROWS} x "
              f"{BOSCH_G} bundled codes, B={BOSCH_BB})", flush=True)
        kres = kernel_phase(dev)

    if 4 in want:
        elapsed(t_start)
        print("phase 4: main path (Higgs-shaped 2M x 28 binary, 255 leaves, "
              "10 rounds)", flush=True)
        mres = main_path_phase()

    if 5 in want:
        elapsed(t_start)
        print("phase 5: profile of a steady-state eager iteration (the wave "
              "steps' host time)", flush=True)
        profile_phase(mres.pop("booster"), args.trace)
    elif mres is not None:
        mres.pop("booster")

    if 6 in want:
        elapsed(t_start)
        print(f"phase 6: sampled and validated path (bagging 0.8 every 5, "
              f"feature_fraction 0.8, {NV} valid rows, early stopping; GOSS; "
              f"card vs CPU)", flush=True)
        sres = sampled_phase(*mres["data"], dev)
    if 7 in want:
        elapsed(t_start)
        print(f"phase 7: multiclass at full width (2M x 28, {NUM_CLASS} "
              f"classes, 255 leaves, {MULTI_ROUNDS} rounds; multiclassova 2 "
              f"rounds)", flush=True)
        cres = multiclass_phase()

    if 8 in want:
        elapsed(t_start)
        print(f"phase 8: categorical at full width (Expo-shaped 2M x 8, six "
              f"categorical columns, {CAT_ROUNDS} rounds, {NV} valid rows)",
              flush=True)
        gres = categorical_phase(dev)

    if 9 in want:
        elapsed(t_start)
        print(f"phase 9: lambdarank at the MS-LTR shape ({RANK_ROWS} rows x "
              f"{F137}, {RANK_ROUNDS} rounds)", flush=True)
        rres = ranking_phase()

    xres = dict(launches=0)
    if 10 in want:
        elapsed(t_start)
        print(f"phase 10: card vs CPU, {SMALL} rows, the new objectives, "
              f"categorical features, EFB and linear leaves", flush=True)
        if mres is not None and gres is not None and rres is not None:
            xres = card_vs_cpu_phase(mres["data"][1], gres, rres)
        Xh, yh = (mres["data"][1][:SMALL], mres["data"][2][:SMALL]) \
            if mres is not None else higgs_like(SMALL, SEED)
        xres["launches"] += card_vs_cpu_new_cases(Xh, yh)

    eres = lres = none
    if 11 in want:
        elapsed(t_start)
        print(f"phase 11: EFB at the Bosch shape ({BOSCH_ROWS} x {BOSCH_F} "
              f"CSR, binary, 255 leaves, enable_bundle=auto, {EFB_ROUNDS} "
              f"rounds, {BOSCH_VALID} valid rows)", flush=True)
        eres = efb_phase(dev)
    if 12 in want:
        elapsed(t_start)
        print(f"phase 12: linear leaves at the main path's width (2M x 28, "
              f"linear_lambda 0.01, 255 leaves, {LINEAR_ROUNDS} rounds, {NV} "
              f"valid rows)", flush=True)
        lres = linear_phase(mres, dev)

    bres = none
    if 13 in want:
        elapsed(t_start)
        print(f"phase 13: one dispatch per iteration (2M x 28 binary, 255 "
              f"leaves, {BATCH_ROUNDS} rounds, {NV} valid rows): eager, "
              f"captured K=1, captured K=8; sampled and multiclass captured "
              f"against eager", flush=True)
        bres = tree_batch_phase(mres)

    vres = none
    if 14 in want:
        elapsed(t_start)
        print(f"phase 14: serving at full width (2M x 28 binary, 255 "
              f"leaves, {SERVE_ROUNDS} rounds from a text model file; "
              f"ServingEngine on the default ladder, MicroBatcher traffic, "
              f"a hot reload; B6)", flush=True)
        vres = serving_phase(mres, dev)

    nres = none
    if 15 in want:
        elapsed(t_start)
        print("phase 15: device ingest, checkpoint/resume and nan_policy at "
              "the main path's width (2M x 28, 255 leaves)", flush=True)
        nres = ingest_checkpoint_phase(mres, bres if 13 in want else None,
                                       dev)

    fres = none
    if 16 in want:
        elapsed(t_start)
        print(f"phase 16: the host front ends at the main path's width "
              f"(2M x 28, 255 leaves): binary dataset and the CLI, a "
              f"{FRONT_ROWS}-row TSV, JSON and proto models, the C API",
              flush=True)
        fres = front_end_phase(mres)

    tres = none
    if 17 in want:
        elapsed(t_start)
        print(f"phase 17: out-of-core training at the main path's width (2M "
              f"x 28, 255 leaves, {STREAM_ROUNDS} rounds from host shards: "
              f"auto under a budget, prefetch and CRC off, two shard sizes, "
              f"u4 shards, a flipped shard)", flush=True)
        tres = stream_phase(mres)

    pres = none
    if 18 in want:
        elapsed(t_start)
        print(f"phase 18: multi-GPU training's comm layer: (a) every comm "
              f"class over an NCCL group of one; (b) data / feature / "
              f"voting, {PAR_ROUNDS} rounds, from two ranks on one card (a "
              f"rank per card where there are several)", flush=True)
        pres = parallel_phase(mres, dev)

    rbres = none
    if 19 in want:
        elapsed(t_start)
        print(f"phase 19: fault tolerance on the card (phase 4's data and "
              f"parameters, {FT_ROUNDS} rounds, from a binary file, every "
              f"training process a child): (a) supervised kill, (b) "
              f"watchdog abort, (c) gang kill under the fleet supervisor "
              f"and an elastic resume on one process, (d) streamed data and "
              f"voting in a world", flush=True)
        rbres = fault_tolerance_phase(mres, pres)

    ores = none
    if 20 in want:
        elapsed(t_start)
        print(f"phase 20: training observability at the main path's width "
              f"(2M x 28, 255 leaves, {OBS_ROUNDS} rounds captured, "
              f"telemetry_dir, tpu_cost_analysis, tpu_time_tag; "
              f"tpu_profile_iters {' and '.join(OBS_WINDOWS)})", flush=True)
        ores = observability_phase(mres, bres if 13 in want else None,
                                   kres)

    wres = none
    if 21 in want:
        elapsed(t_start)
        print(f"phase 21: wide bins on the card ({WIDE_ROWS} x {WIDE_F}, "
              f"exact-arithmetic L2 labels, {WIDE_ROUNDS} rounds at max_bin "
              f"{' and '.join(map(str, WIDE_MAX_BINS))}; card vs the CPU "
              f"port)", flush=True)
        wres = wide_bins_phase()

    gdres = none
    if 22 in want:
        elapsed(t_start)
        print(f"phase 22: the capture guard and the op-trace tier on the card "
              f"(phase 4's data: (a) {GUARD_ROUNDS} captured rounds guarded, "
              f"a planted recapture; (b) ServingEngine, {GUARD_REQUESTS} "
              f"requests; (c) {', '.join(CARD_CONTRACTS)} recorded on CUDA "
              f"tensors)", flush=True)
        gdres = guard_phase(mres)

    elapsed(t_start)
    if want != set(PHASES):
        print(f"partial run of phases {sorted(want)}: no result lines",
              flush=True)
        return 4

    print(f"  histogram kernel launches: phase 4 {mres['launches']}, phase 6 "
          f"sampled {sres['launches']} + GOSS {sres['goss_launches']}, "
          f"phase 7 {cres['launches']}, phase 8 {gres['launches']}, phase 9 "
          f"{rres['launches']}, phase 10 {xres['launches']}, phase 11 "
          f"{eres['launches']}, phase 12 {lres['launches']}, phase 13 "
          f"{bres['launches']}, phase 14 {vres['launches']}, phase 15 "
          f"{nres['launches']}, phase 16 {fres['launches']}, phase 17 "
          f"{tres['launches']}, phase 18 {pres['launches']}, phase 19 "
          f"{rbres['launches']}, phase 20 {ores['launches']}, phase 21 "
          f"{wres['launches']}, phase 22 {gdres['launches']}", flush=True)

    full = kres["full"]
    kernels = {"kernels": [{
        "name": "histogram (B1)", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/pallas_histogram.py:59",
        "launches": mres["launches"] + sres["launches"]
        + sres["goss_launches"] + cres["launches"] + gres["launches"]
        + rres["launches"] + xres["launches"] + eres["launches"]
        + lres["launches"] + bres["launches"] + vres["launches"]
        + nres["launches"] + fres["launches"] + tres["launches"]
        + pres["launches"] + rbres["launches"] + ores["launches"]
        + wres["launches"] + gdres["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kres.values()),
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
        "cases": {name: {k: r[k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err", "rows",
                          "num_features", "num_bins")}
                  for name, r in kres.items()},
        "launches_by_phase": {
            "4": mres["launches"],
            "6": sres["launches"] + sres["goss_launches"],
            "7": cres["launches"], "8": gres["launches"],
            "9": rres["launches"], "10": xres["launches"],
            "11": eres["launches"], "12": lres["launches"],
            "13": bres["launches"], "14": vres["launches"],
            "15": nres["launches"], "16": fres["launches"],
            "17": tres["launches"], "18": pres["launches"],
            "19": rbres["launches"], "20": ores["launches"],
            "21": wres["launches"], "22": gdres["launches"]},
    }]}
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
