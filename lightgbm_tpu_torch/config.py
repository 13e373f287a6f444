"""Parameter/config system — a copy of ``lightgbm_tpu/config.py``.

Mirrors the reference's string-map driven config pipeline so that LightGBM
parameter dicts and `train.conf` files work unchanged:

- full parameter surface of LightGBM v2.0.10 with identical defaults
  (reference: include/LightGBM/config.h:94-300),
- alias resolution with the same priority rule — longest name wins, ties
  alphabetical (reference: include/LightGBM/config.h:358-514),
- conf-file parsing `key = value` with `#` comments
  (reference: src/application/application.cpp:48-81),
- conflict checks (reference: src/io/config.cpp OverallConfig::CheckParamConflict).

PyTorch port additions (bottom of the file): :func:`resolve_device` maps the
``device`` key onto a ``torch.device`` — CUDA for ``tpu``/``gpu``/``cuda``
(the default), the CPU only for ``device=cpu`` — and
:func:`check_port_supported` raises on every configuration this port does
not cover yet, naming the ROADMAP queue item that will port it. The
``tpu_*`` tuning keys that mean nothing on the card are accepted and logged
as no-ops (:data:`TPU_ONLY_KEYS`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils.log import Log

# Alias -> canonical parameter name (reference: config.h:360-445).
PARAMETER_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "random_seed": "seed",
    "num_thread": "num_threads",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "training_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "contrib": "is_predict_contrib",
    "predict_contrib": "is_predict_contrib",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
    "bagging_fraction_seed": "bagging_seed",
    "workers": "machines",
    "nodes": "machines",
}

# Historical misspelling kept by the reference (config.h:466 "poission_...").
PARAMETER_ALIASES["poission_max_delta_step"] = "poisson_max_delta_step"
# Reference accepts both spellings of the machine list file param.
PARAMETER_ALIASES["machine_list_filename"] = "machine_list_file"
PARAMETER_ALIASES["data_filename"] = "data"
PARAMETER_ALIASES["valid_data_filenames"] = "valid_data"


def _parse_bool(value: Any, name: str) -> bool:
    if isinstance(value, bool):
        return value
    v = str(value).lower()
    if v in ("false", "-", "0"):
        return False
    if v in ("true", "+", "1"):
        return True
    Log.fatal('Parameter %s should be "true"/"+" or "false"/"-", got "%s"', name, value)


def _parse_int_list(value: Any) -> List[int]:
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    return [int(v) for v in str(value).split(",") if v != ""]


def _parse_float_list(value: Any) -> List[float]:
    if isinstance(value, (list, tuple)):
        return [float(v) for v in value]
    return [float(v) for v in str(value).split(",") if v != ""]


def _parse_str_list(value: Any) -> List[str]:
    if isinstance(value, (list, tuple)):
        return [str(v) for v in value]
    return [v for v in str(value).split(",") if v != ""]


@dataclass
class Config:
    """Flat config holding the whole reference parameter surface.

    Defaults match include/LightGBM/config.h:94-300 exactly; the grouping into
    IO/Objective/Metric/Tree/Boosting/Network structs is collapsed — every
    consumer reads the fields it needs (the reference nests copies of e.g.
    num_class into four structs; one field here).
    """

    # --- task / device -----------------------------------------------------
    task: str = "train"                       # train | predict | convert_model | refit
    device: str = "tpu"                       # tpu | gpu | cuda -> CUDA; cpu -> CPU
    seed: int = 0
    num_threads: int = 0
    verbose: int = 1

    # --- IO (config.h:94-160) ---------------------------------------------
    max_bin: int = 255
    num_class: int = 1
    data_random_seed: int = 1
    data: str = ""
    valid_data: List[str] = field(default_factory=list)
    init_score_file: str = ""
    valid_init_score_file: List[str] = field(default_factory=list)
    snapshot_freq: int = -1
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    convert_model: str = "gbdt_prediction.cpp"
    convert_model_language: str = ""
    input_model: str = ""
    model_format: str = "text"                # text | proto (fork addition: proto/model.proto)
    num_iteration_predict: int = -1
    is_pre_partition: bool = False
    is_enable_sparse: bool = True
    sparse_threshold: float = 0.8
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    enable_load_from_binary_file: bool = True
    bin_construct_sample_cnt: int = 200000
    is_predict_leaf_index: bool = False
    is_predict_contrib: bool = False
    is_predict_raw_score: bool = False
    min_data_in_bin: int = 3
    max_conflict_rate: float = 0.0
    # EFB (exclusive feature bundling, efb.py): "auto" (the default)
    # resolves per shape class — bundle iff the plan actually shrinks the
    # histogram work (the BundlePlan win ratio, boosting/gbdt.py), the way
    # tpu_hist_kernel=auto resolves per shape class; "true" bundles
    # whenever any plan exists; "false" disables. Since the bundle-space
    # split-finding redesign the scan, the collectives, and row routing all
    # run on bundled bins natively (ops/split_finder.py
    # per_feature_best_bundled) — the round-5 "EFB hurts on TPU" regression
    # this knob used to warn about is gone on the default arm.
    enable_bundle: str = "auto"
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    zero_as_missing: bool = False
    use_missing: bool = True

    # --- objective (config.h:163-184) --------------------------------------
    objective: str = "regression"
    sigmoid: float = 1.0
    huber_delta: float = 1.0
    fair_c: float = 1.0
    gaussian_eta: float = 1.0
    poisson_max_delta_step: float = 0.7
    label_gain: List[float] = field(default_factory=list)
    max_position: int = 20
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0

    # --- metric (config.h:187-196) ------------------------------------------
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_training_metric: bool = False
    ndcg_eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])

    # --- tree (config.h:200-233) --------------------------------------------
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    num_leaves: int = 31
    feature_fraction_seed: int = 2
    feature_fraction: float = 1.0
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    top_k: int = 20
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    # --- piecewise-linear leaves (ops/linear.py, docs/Linear-Trees.md) ------
    # fit a linear model per leaf over the leaf's path features instead of a
    # constant (arXiv 1802.05640; later-LightGBM linear_tree). The per-leaf
    # ridge solves run INSIDE the training step as one batched Cholesky —
    # zero extra dispatches. Changes the model: fingerprinted for
    # checkpoint/resume, like linear_lambda / linear_max_features.
    linear_tree: bool = False
    # ridge term added to the coefficient diagonal of every leaf's normal
    # equations (never the intercept); 0 = plain least squares with loud
    # degradation to constant leaves on singular systems
    linear_lambda: float = 0.0
    # cap on distinct numerical path features per leaf (leaf-to-root order:
    # the nearest splits enter first)
    linear_max_features: int = 8
    # warn (once per train()) when leaves degrade to constant output
    # (categorical path / too few rows / ill-conditioned solve) — loudness
    # knob only, never the math: VOLATILE_CONFIG_FIELDS
    tpu_linear_warn_fallback: bool = True

    # --- boosting (config.h:236-260) ----------------------------------------
    boosting_type: str = "gbdt"               # gbdt | dart | goss | rf
    output_freq: int = 1
    num_iterations: int = 100
    learning_rate: float = 0.1
    bagging_fraction: float = 1.0
    bagging_seed: int = 3
    bagging_freq: int = 0
    early_stopping_round: int = 0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    boost_from_average: bool = True
    # serial | feature | data | voting, plus the TPU addition "auto":
    # resolve the strategy (and hence which dataset dimension the device
    # mesh shards — rows vs features) from the training matrix's shape
    # class per the reference's Parallel-Learning-Guide table
    # (parallel/comm.py choose_tree_learner); tpu_mesh_axis overrides the
    # axis side of that choice
    tree_learner: str = "serial"

    # --- network (config.h:264-272) — mapped onto jax.distributed -----------
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""
    machines: str = ""

    # --- TPU-specific knobs (no reference equivalent) -----------------------
    # mesh-axis override for tree_learner=auto: "rows" constrains the
    # resolution to the row-sharded strategies (data/voting), "features"
    # forces feature-parallel, "auto" lets the shape class decide. Ignored
    # (with a warning when inconsistent) when tree_learner is explicit.
    tpu_mesh_axis: str = "auto"
    # resume a checkpoint written on a DIFFERENT device count: off (the
    # default) rejects loudly at restore time — sharded state does not
    # silently re-layout; true re-shards the global training state onto
    # this booster's mesh deliberately (single-process only; pre-partitioned
    # snapshots never re-shard). See docs/Fault-Tolerance.md.
    tpu_reshard_on_resume: bool = False
    # leaf splits applied per device-side wave; 0 = auto (frontier-wide,
    # leaf-wise order preserved near the leaf budget), 1 = exact LightGBM
    # one-leaf-at-a-time growth.
    tpu_wave_size: int = 0
    # row-chunk length for the histogram one-hot matmul pass
    tpu_hist_chunk: int = 32768
    # accumulate g/h as bf16 hi+lo pairs (~f32 precision) vs plain bf16
    tpu_hist_hilo: bool = True
    # High-precision histogram accumulation: full-f32 weight columns
    # contracted at Precision.HIGHEST (exact products) + Kahan-compensated
    # chunk carry — the role of the reference's double HistogramBinEntry
    # (bin.h:29-31). Measured ~30x tighter bin sums vs the bf16 hi/lo
    # default (tests/test_hist_packing.py::test_hist_f64_precision). The
    # split SCAN still runs in f32, so near-tie node flips vs the reference
    # (test_tree_parity.py) are narrowed, not guaranteed closed. Forces the
    # xla kernel.
    tpu_hist_f64: bool = False
    # number of leaf slots whose histograms are built in one pass
    tpu_hist_slots: int = 0                   # 0 = auto
    # row compaction: each wave histograms only rows in pending leaves via a
    # prefix-compacted index gather (the analog of the reference's
    # smaller-leaf histogramming, serial_tree_learner.cpp:354-362)
    tpu_row_compact: bool = True
    tpu_compact_frac: float = 0.25            # compact passes below this
                                              # active-row fraction
    # incremental leaf partition (grower.py GrowState.perm — the reference's
    # DataPartition, data_partition.hpp:94): the slot-grouped row permutation
    # is maintained ACROSS waves by a cumsum-based stable counting-sort over
    # the split leaves' segments, so the wave body carries no full-N stable
    # argsort / [N,S] count reduction / slot table_lookup. false = the
    # legacy per-wave argsort rebuild (bit-identical — the A/B + parity pin,
    # tests/test_incremental_partition.py)
    tpu_incremental_partition: bool = True
    # LEGACY EFB scan arm: unpack bundle-space histograms into full
    # [T, F, B, 3] feature space before split finding and route rows
    # through the per-row bundle-decode gather — the pre-redesign layout
    # that measured 3.5x SLOWER on the round-5 Bosch-shaped sparse bench
    # (1.1 vs 3.8 Mrow-tree/s; docs/TPU-Performance.md). Kept as the A/B +
    # parity arm for the native bundle-space scan
    # (tests/test_efb_bundlespace.py); requires enable_bundle != false.
    tpu_efb_unpack: bool = False
    # --- out-of-core streaming (ops/stream.py, docs/TPU-Performance.md) ----
    # where the binned code matrix LIVES during training:
    #   device — fully HBM-resident (the historical behavior)
    #   stream — host-resident packed row shards, double-buffered H2D
    #            through the wave loop; gradients/scores/partition state
    #            stay on device. Bit-identical to device residency (which
    #            it forces tpu_row_compact=false to match), unlocks
    #            datasets far beyond HBM.
    #   auto   — stream iff the analytic HBM pre-flight estimate exceeds
    #            the per-device budget (tpu_hbm_budget_bytes or the
    #            reported device capacity), else device.
    tpu_residency: str = "auto"
    # rows per host shard PER DEVICE (rounded to a divisor of the padded
    # per-device row count that is a multiple of tpu_hist_chunk — shard
    # size never changes the math, so any value resumes any checkpoint);
    # 0 = auto (~8 shards)
    tpu_stream_shard_rows: int = 0
    # --- device-side ingest (ops/ingest.py, docs/TPU-Performance.md) -------
    # where raw float rows are BINNED into the packed code matrix:
    #   host   — the classical path: BinMapper.value_to_bin column loop on
    #            host, then one bulk H2D placement
    #   device — defer binning: raw f32 chunks stream H2D double-buffered
    #            and a jit kernel bins + packs in-trace, writing straight
    #            into the sharded residency buffers. BIT-identical to host
    #            binning (tests/test_ingest.py pins it) or it falls back
    #            with a logged reason (f32-lossy f64 input, sparse,
    #            oversized categoricals, stream residency, multi-process)
    #   auto   — device iff eligible AND num_data is large enough for the
    #            deferral to pay (dataset._AUTO_DEFER_MIN_ROWS)
    # checkpoint-VOLATILE: it changes WHERE binning runs, never the codes
    tpu_ingest: str = "auto"
    # raw rows per ingest chunk; 0 = auto (~64 MiB of f32 chunk + threshold
    # working set, clamped to [4096, 131072], rounded to a multiple of 256)
    tpu_ingest_chunk_rows: int = 0
    # ingest H2D prefetch depth (chunks in flight ahead of the bin kernel);
    # 0 disables overlap — the stall-accounting A/B arm of bench --ingest
    tpu_ingest_prefetch: int = 1
    # artificial per-device HBM budget in bytes for the residency auto-
    # decision and the engine.train budget line; 0 = use the capacity the
    # backend reports (env LGBM_TPU_HBM_BUDGET overrides both)
    tpu_hbm_budget_bytes: int = 0
    # histogram kernel: "auto" resolves to "mixed" (XLA streaming passes +
    # pallas-512 compacted passes — the round-5 pass-level measured best,
    # 18.0 vs 22.1 ms at 25% active) on a real TPU whose on-chip gate has
    # validated this kernel shape class, and to "xla" everywhere else; see
    # boosting/gbdt.py kernel-resolution block. "xla" one-hot matmul |
    # "pallas" fused VMEM-accumulator kernel (ops/pallas_histogram.py, the
    # OpenCL histogram256.cl analog) | "mixed" (pallas for compacted passes
    # only). Explicit pallas/mixed on a never-gated shape class runs with a
    # warning (exp/pallas_onchip_check.py records the trust markers)
    tpu_hist_kernel: str = "auto"
    # per-phase wall-clock accumulators (reference TIMETAG) printed after
    # training; tpu_profile_dir wraps training in a jax.profiler trace
    tpu_time_tag: bool = False
    tpu_profile_dir: str = ""
    # jax.profiler capture WINDOW "start:stop" over boosting iterations
    # (batch-boundary aligned under tree_batch) — the deep-profiling leg of
    # the telemetry contract; output under tpu_profile_dir, or
    # <telemetry_dir>/xprof when only telemetry_dir is set. See
    # docs/Observability.md.
    tpu_profile_iters: str = ""

    # --- observability (lightgbm_tpu/observability, docs/Observability.md) --
    # telemetry output directory: JSONL event stream (events_<pid>.jsonl) +
    # Perfetto-loadable Chrome trace (trace_<pid>.json). Also settable via
    # env LGBM_TPU_TELEMETRY_DIR; empty + no env = span recording disabled
    # (the metrics registry is always live)
    telemetry_dir: str = ""
    # compile-time cost capture (observability/costs.py): lower+compile each
    # dispatch site once with the live arguments and publish
    # cost_analysis()/memory_analysis() — FLOPs, bytes accessed, argument/
    # temp HBM — as cost.<site>.* gauges, into snapshot(), and as Perfetto
    # trace metadata. Off by default (it duplicates trace work and, without
    # the persistent compile cache, the XLA compile); env
    # LGBM_TPU_COST_ANALYSIS=1 also enables. bench.py --smoke runs with it
    # on and pins the fused step's FLOPs/bytes to golden values.
    tpu_cost_analysis: bool = False
    # write observability.snapshot() (counters/gauges/histograms + cost and
    # memory reports) to this JSON file at train end; "" = off — but with
    # telemetry_dir set a snapshot_<pid>.json always lands there. CLI:
    # --dump-snapshot[=FILE].
    dump_snapshot: str = ""
    # boosting iterations fused into ONE jit dispatch via lax.scan (built-in
    # objectives only): score updates, tree growth, and leaf application for
    # K trees never leave HBM, and the host loop pays dispatch + sync cost
    # once per K trees instead of per tree. Metric eval, callbacks, and
    # checkpoints land on batch boundaries; dart/goss and custom objectives
    # fall back to 1 (loudly). See docs/TPU-Performance.md.
    tree_batch: int = 1

    # --- serving (lightgbm_tpu/serving, docs/Serving.md) --------------------
    # largest rows-per-dispatch the serving engine compiles for; also the
    # micro-batcher's coalescing budget and the top of the auto bucket
    # ladder. Requests beyond it are chunked.
    serve_max_batch_rows: int = 4096
    # micro-batcher coalescing window: a queued request waits at most this
    # long past its arrival for companions before dispatching
    serve_max_wait_ms: float = 2.0
    # batch-size bucket ladder (comma list, strictly ascending) the engine
    # AOT-compiles and pads requests into; "" = powers of two
    # 1,2,4,...,serve_max_batch_rows (padding never exceeds 2x)
    serve_buckets: str = ""
    # --- serving resilience (serving/resilience.py, docs/Serving.md) --------
    # admission bound: rows the micro-batcher queue may hold; a request
    # that would overflow it is SHED with ServerOverloadedError instead of
    # queued (0 = unbounded — the pre-resilience behavior)
    serve_max_queue_rows: int = 32768
    # default per-request deadline: past it a queued request is dropped at
    # dequeue (never dispatched) and a waiting caller unblocks, both with
    # DeadlineExceededError; 0 = no deadline. Per-call deadline_ms wins.
    serve_deadline_ms: float = 0.0
    # circuit breaker: this many device-dispatch failures inside
    # serve_breaker_window_s trip the engine to `degraded` (host-predictor
    # fallback, bit-identical answers) until the device probe succeeds;
    # 0 disables the breaker
    serve_breaker_failures: int = 5
    serve_breaker_window_s: float = 30.0
    # seconds between background device re-warm probes while degraded
    serve_probe_interval_s: float = 1.0

    # --- fault tolerance (robustness/, docs/Fault-Tolerance.md) -------------
    # directory of atomic booster snapshots (ckpt_<id>.pkl); empty = off
    checkpoint_dir: str = ""
    # save a snapshot every N iterations during train() (0 = only on demand)
    checkpoint_interval: int = 0
    # snapshots retained after each save (0 = keep everything)
    checkpoint_keep_last_n: int = 3
    # checkpoint file/dir to resume from; "auto" = latest in checkpoint_dir
    # if any exist, else start fresh (the preemption-restart idiom: rerun
    # the identical command line)
    resume_from: str = ""
    # non-finite gradient/hessian/leaf-output guard compiled into the
    # training step: none (off) | raise | skip_iter | clip
    nan_policy: str = "none"
    # --- self-healing (robustness/watchdog.py, robustness/supervisor.py) ----
    # hang watchdog: fire when no dispatch boundary is seen for
    # max(hang_timeout_s, hang_median_factor * trailing-median iteration
    # time). 0 = watchdog off (the default).
    hang_timeout_s: float = 0.0
    # adaptive multiple of the trailing median iteration time (0 = fixed
    # hang_timeout_s only)
    hang_median_factor: float = 8.0
    # on firing: "dump" writes the diagnostic snapshot (thread stacks +
    # observability.snapshot()) and keeps waiting; "abort" additionally
    # exits 142 so a supervisor restarts from the last checkpoint
    hang_action: str = "dump"
    # verify each host code shard's CRC32 before its H2D transfer under
    # tpu_residency=stream (ops/stream.py); detected corruption raises
    # ShardCorruptionError (CLI exit 144) instead of training on rot
    tpu_stream_verify: bool = True
    # --- distributed fault tolerance (robustness/distributed.py) ------------
    # seconds between per-rank heartbeat-lease writes to the coordination-
    # service KV store (beaten at the same dispatch boundaries the hang
    # watchdog uses); also rate-limits the pre-wave liveness probe
    gang_heartbeat_interval_s: float = 2.0
    # a peer whose lease has not advanced for this long (by the OBSERVER's
    # monotonic clock — cross-host clock skew is irrelevant) is declared
    # lost: typed PeerLostError naming the rank, exit 145 at top level.
    # 0 = peer failure detection off.
    gang_lease_timeout_s: float = 30.0
    # permit resume on a DIFFERENT world size than the gang checkpoint
    # manifest records (the fleet supervisor's shrink path; pair with
    # tpu_reshard_on_resume for the device re-layout). Off = loud refusal.
    elastic: bool = False

    def __post_init__(self):
        self._check()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]] = None, **kwargs) -> "Config":
        """Build a Config from a LightGBM-style parameter dict (aliases ok)."""
        merged = dict(params or {})
        merged.update(kwargs)
        resolved = resolve_aliases(merged)
        return cls(**_coerce_fields(resolved))

    @classmethod
    def from_conf_file(cls, path: str, overrides: Optional[Dict[str, Any]] = None) -> "Config":
        """Parse a reference-style `train.conf` (application.cpp:48-81)."""
        params = parse_conf_file(path)
        params.update(overrides or {})
        return cls.from_params(params)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kwargs) -> "Config":
        resolved = resolve_aliases(kwargs)
        return dataclasses.replace(self, **_coerce_fields(resolved))

    # -- validation ----------------------------------------------------------

    def _check(self) -> None:
        """Parameter conflict checks (reference: OverallConfig::CheckParamConflict)."""
        if self.num_leaves < 2:
            Log.fatal("num_leaves must be >= 2, got %d", self.num_leaves)
        if self.max_bin < 2:
            Log.fatal("max_bin must be >= 2, got %d", self.max_bin)
        if not 0.0 < self.feature_fraction <= 1.0:
            Log.fatal("feature_fraction must be in (0, 1], got %g", self.feature_fraction)
        if not 0.0 < self.bagging_fraction <= 1.0:
            Log.fatal("bagging_fraction must be in (0, 1], got %g", self.bagging_fraction)
        if self.boosting_type not in ("gbdt", "gbrt", "dart", "goss", "rf", "random_forest"):
            Log.fatal("Unknown boosting type %s", self.boosting_type)
        if self.tree_learner not in ("serial", "feature", "data", "voting",
                                     "auto"):
            Log.fatal("Unknown tree learner type %s", self.tree_learner)
        if self.tpu_mesh_axis not in ("auto", "rows", "features"):
            Log.fatal("Unknown tpu_mesh_axis %s (auto|rows|features)",
                      self.tpu_mesh_axis)
        if self.tpu_mesh_axis != "auto" and self.tree_learner not in \
                ("auto", "serial"):
            expected = "features" if self.tree_learner == "feature" else "rows"
            if self.tpu_mesh_axis != expected:
                Log.warning("tpu_mesh_axis=%s is ignored: tree_learner=%s "
                            "shards the %s axis by definition (the knob only "
                            "constrains tree_learner=auto)",
                            self.tpu_mesh_axis, self.tree_learner, expected)
        # enable_bundle is a tri-state: bools and their string spellings
        # normalize onto "true"/"false", everything else must be "auto"
        eb = str(self.enable_bundle).lower()
        if eb in ("true", "+", "1"):
            eb = "true"
        elif eb in ("false", "-", "0"):
            eb = "false"
        if eb not in ("auto", "true", "false"):
            Log.fatal('Parameter enable_bundle should be "auto", "true" or '
                      '"false", got "%s"', self.enable_bundle)
        self.enable_bundle = eb
        if not 0.0 <= self.max_conflict_rate < 1.0:
            # the conflict budget is a row FRACTION (reference
            # max_conflict_rate, dataset.cpp:152): 1.0+ would admit bundles
            # whose members collide on every sampled row, and negative
            # values silently disable bundling through an int() truncation
            Log.fatal("max_conflict_rate must be in [0, 1), got %g",
                      self.max_conflict_rate)
        if self.tpu_efb_unpack and self.enable_bundle == "false":
            # reject loudly instead of silently ignoring the knob: the
            # legacy unpack arm only exists as the A/B + parity arm OF
            # bundling — asking for it with bundling off is a contradiction
            Log.fatal("tpu_efb_unpack=true requires enable_bundle=auto|true "
                      "(the unpack arm is the legacy layout OF bundling; "
                      "with enable_bundle=false there is nothing to unpack)")
        if self.tpu_hist_kernel not in ("auto", "xla", "pallas", "mixed"):
            Log.fatal("Unknown tpu_hist_kernel %s (auto|xla|pallas|mixed)",
                      self.tpu_hist_kernel)
        if self.tpu_residency not in ("auto", "device", "stream"):
            Log.fatal("Unknown tpu_residency %s (auto|device|stream)",
                      self.tpu_residency)
        if self.tpu_stream_shard_rows < 0:
            Log.fatal("tpu_stream_shard_rows must be >= 0 (0 = auto), got %d",
                      self.tpu_stream_shard_rows)
        if self.tpu_ingest not in ("auto", "host", "device"):
            Log.fatal("Unknown tpu_ingest %s (auto|host|device)",
                      self.tpu_ingest)
        if self.tpu_ingest_chunk_rows < 0:
            Log.fatal("tpu_ingest_chunk_rows must be >= 0 (0 = auto), got %d",
                      self.tpu_ingest_chunk_rows)
        if self.tpu_ingest_prefetch < 0:
            Log.fatal("tpu_ingest_prefetch must be >= 0 (0 = no overlap), "
                      "got %d", self.tpu_ingest_prefetch)
        if self.tpu_hbm_budget_bytes < 0:
            Log.fatal("tpu_hbm_budget_bytes must be >= 0 (0 = device "
                      "capacity), got %d", self.tpu_hbm_budget_bytes)
        if not 0.0 < self.tpu_compact_frac <= 1.0:
            # <=0 silently disables compaction; >1 forces the argsort+gather
            # path on every pass (n_active < frac*N is always true)
            Log.fatal("tpu_compact_frac must be in (0, 1], got %g — values "
                      "<= 0 disable row compaction entirely and values > 1 "
                      "force the compacted argsort+gather path on every "
                      "histogram pass", self.tpu_compact_frac)
        if self.tree_batch < 1:
            Log.fatal("tree_batch must be >= 1, got %d", self.tree_batch)
        if self.boosting_type in ("rf", "random_forest"):
            # reference: rf.hpp:18-29 — bagging is mandatory for random forest
            if not (self.bagging_freq > 0 and self.bagging_fraction < 1.0):
                Log.fatal("Random forest needs bagging_freq > 0 and bagging_fraction < 1.0")
        if self.objective in ("multiclass", "multiclassova", "softmax", "ova") and self.num_class <= 1:
            Log.fatal("Number of classes should be > 1 for multiclass training")
        if self.top_rate + self.other_rate > 1.0:
            Log.fatal("top_rate + other_rate cannot be larger than 1.0 for GOSS")
        if self.serve_max_batch_rows < 1:
            Log.fatal("serve_max_batch_rows must be >= 1, got %d",
                      self.serve_max_batch_rows)
        if self.serve_max_wait_ms < 0:
            Log.fatal("serve_max_wait_ms must be >= 0, got %g",
                      self.serve_max_wait_ms)
        if self.serve_buckets:
            try:
                ladder = [int(v) for v in
                          str(self.serve_buckets).split(",") if v]
            except ValueError:
                ladder = []
            if not ladder or any(b < 1 for b in ladder) or \
                    any(b >= c for b, c in zip(ladder, ladder[1:])):
                Log.fatal("serve_buckets must be a comma list of strictly "
                          "ascending positive ints, got %r",
                          self.serve_buckets)
            elif ladder[-1] > self.serve_max_batch_rows:
                Log.fatal("serve_buckets top entry %d exceeds "
                          "serve_max_batch_rows=%d (the largest "
                          "rows-per-dispatch the engine compiles for)",
                          ladder[-1], self.serve_max_batch_rows)
        if self.serve_max_queue_rows < 0:
            Log.fatal("serve_max_queue_rows must be >= 0 (0 = unbounded), "
                      "got %d", self.serve_max_queue_rows)
        if self.serve_deadline_ms < 0:
            Log.fatal("serve_deadline_ms must be >= 0 (0 = no deadline), "
                      "got %g", self.serve_deadline_ms)
        if self.serve_breaker_failures < 0:
            Log.fatal("serve_breaker_failures must be >= 0 (0 = breaker "
                      "off), got %d", self.serve_breaker_failures)
        if self.serve_breaker_window_s <= 0:
            Log.fatal("serve_breaker_window_s must be > 0, got %g",
                      self.serve_breaker_window_s)
        if self.serve_probe_interval_s <= 0:
            Log.fatal("serve_probe_interval_s must be > 0, got %g",
                      self.serve_probe_interval_s)
        if self.nan_policy not in ("none", "raise", "skip_iter", "clip"):
            Log.fatal("Unknown nan_policy %s (none|raise|skip_iter|clip)",
                      self.nan_policy)
        if self.checkpoint_interval < 0:
            Log.fatal("checkpoint_interval must be >= 0, got %d",
                      self.checkpoint_interval)
        if self.checkpoint_keep_last_n < 0:
            Log.fatal("checkpoint_keep_last_n must be >= 0, got %d",
                      self.checkpoint_keep_last_n)
        if self.checkpoint_interval > 0 and not self.checkpoint_dir:
            Log.fatal("checkpoint_interval=%d needs checkpoint_dir to be set",
                      self.checkpoint_interval)
        if self.hang_timeout_s < 0:
            Log.fatal("hang_timeout_s must be >= 0 (0 = watchdog off), "
                      "got %g", self.hang_timeout_s)
        if self.hang_median_factor < 0:
            Log.fatal("hang_median_factor must be >= 0 (0 = fixed timeout "
                      "only), got %g", self.hang_median_factor)
        if self.hang_action not in ("dump", "abort"):
            Log.fatal("Unknown hang_action %s (dump|abort)", self.hang_action)
        if self.gang_heartbeat_interval_s < 0:
            Log.fatal("gang_heartbeat_interval_s must be >= 0, got %g",
                      self.gang_heartbeat_interval_s)
        if self.gang_lease_timeout_s < 0:
            Log.fatal("gang_lease_timeout_s must be >= 0 (0 = peer failure "
                      "detection off), got %g", self.gang_lease_timeout_s)
        if 0 < self.gang_lease_timeout_s <= self.gang_heartbeat_interval_s:
            # a lease shorter than the beat cadence declares every healthy
            # peer dead between two writes
            Log.fatal("gang_lease_timeout_s (%g) must exceed "
                      "gang_heartbeat_interval_s (%g)",
                      self.gang_lease_timeout_s,
                      self.gang_heartbeat_interval_s)
        if self.linear_lambda < 0:
            Log.fatal("linear_lambda must be >= 0, got %g", self.linear_lambda)
        if self.linear_max_features < 1:
            Log.fatal("linear_max_features must be >= 1, got %d",
                      self.linear_max_features)
        if self.linear_tree and self.boosting_normalized in ("dart", "rf"):
            # dart replays/subtracts dropped trees through the constant-leaf
            # table path and rf transforms leaf outputs through the
            # objective — neither composes with per-leaf linear models;
            # reject at config time, never train silently-wrong coefficients
            Log.fatal("linear_tree=true is not supported with boosting=%s "
                      "(use gbdt or goss)", self.boosting_type)
        if self.linear_tree and self.tpu_residency == "stream":
            Log.fatal("linear_tree=true needs the raw feature slice "
                      "device-resident and is not supported with "
                      "tpu_residency=stream (use device)")
        if self.boosting_normalized == "dart" and (self.checkpoint_dir
                                                   or self.resume_from):
            # reject at config time, not at the first save: otherwise the
            # interval/SIGTERM checkpoint machinery kills a dart run mid-
            # flight instead of protecting it (host-side drop state is not
            # captured by checkpoints)
            Log.fatal("checkpoint/resume (checkpoint_dir/resume_from) is "
                      "not supported with boosting=dart")

    # -- derived -------------------------------------------------------------

    @property
    def max_leaves_by_depth(self) -> int:
        """max_depth caps leaves at 2**max_depth (config.h:216-219)."""
        if self.max_depth > 0:
            return min(self.num_leaves, 2 ** self.max_depth)
        return self.num_leaves

    @property
    def boosting_normalized(self) -> str:
        return {"gbrt": "gbdt", "random_forest": "rf"}.get(self.boosting_type, self.boosting_type)


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
_LIST_INT_FIELDS = {"ndcg_eval_at"}
_LIST_FLOAT_FIELDS = {"label_gain"}
_LIST_STR_FIELDS = {"valid_data", "valid_init_score_file", "metric"}
_KNOWN_DROPPED = {"config_file", "machine_list_filename"}  # handled out-of-band


def resolve_aliases(params: Dict[str, Any]) -> Dict[str, Any]:
    """Apply the alias table with the reference's priority rule.

    When multiple aliases of one parameter appear, the one with the longest
    name wins; ties break alphabetically (config.h:479-513). A canonical name
    always beats its aliases.
    """
    out: Dict[str, Any] = {}
    alias_source: Dict[str, str] = {}
    canonical_names = set(_FIELD_TYPES)
    for key, value in params.items():
        canon = PARAMETER_ALIASES.get(key)
        if canon is None:
            if key in canonical_names:
                out[key] = value
            elif key in _KNOWN_DROPPED:
                continue
            else:
                Log.warning("Unknown parameter: %s", key)
            continue
        prev = alias_source.get(canon)
        if prev is None or (len(key), key) > (len(prev), prev):
            alias_source[canon] = key
            if canon not in params:  # canonical name in input always wins
                out[canon] = value
        if prev is not None:
            Log.warning("%s is set by aliases %s and %s; using %s", canon, prev, key,
                        alias_source[canon])
    return out


def _coerce_fields(params: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce string values (from conf files / CLI) to field types."""
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if name in _LIST_INT_FIELDS:
            out[name] = _parse_int_list(value)
        elif name in _LIST_FLOAT_FIELDS:
            out[name] = _parse_float_list(value)
        elif name in _LIST_STR_FIELDS:
            out[name] = _parse_str_list(value)
        else:
            ftype = str(_FIELD_TYPES.get(name, "str"))
            if "bool" in ftype:
                out[name] = _parse_bool(value, name)
            elif "int" in ftype:
                out[name] = int(float(value)) if not isinstance(value, int) else value
            elif "float" in ftype:
                out[name] = float(value)
            else:
                out[name] = str(value)
    return out


def parse_conf_file(path: str) -> Dict[str, str]:
    """Parse `key = value` lines, `#` comments (application.cpp:60-77)."""
    params: Dict[str, str] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            params[key.strip()] = value.strip()
    return params


# ---------------------------------------------------------------------------
# PyTorch port: device resolution and the slice's coverage gate
# ---------------------------------------------------------------------------

# ``device`` values that select the card; only ``cpu`` selects the host
_CUDA_DEVICE_NAMES = ("tpu", "gpu", "cuda")


def resolve_device(config: "Config"):
    """``torch.device`` for a config's ``device`` key.

    ``tpu`` (the default), ``gpu`` and ``cuda`` select CUDA device 0 and
    raise when no card is present — nothing on the port's path carries on
    on the CPU in their place. ``cpu`` selects the host (the CPU tests)."""
    import torch
    name = str(config.device).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in _CUDA_DEVICE_NAMES:
        Log.fatal("Unknown device %s (tpu|gpu|cuda select CUDA, cpu the "
                  "host)", config.device)
    if not torch.cuda.is_available():
        Log.fatal("device=%s selects CUDA, but torch.cuda.is_available() is "
                  "false; pass device=cpu to run on the host", config.device)
    return torch.device("cuda", 0)


# tpu_* tuning keys whose meaning is a TPU layout or dispatch choice: the
# port accepts them and logs that they do nothing. The tpu_* keys the port
# does honour are tpu_wave_size, tpu_hist_slots and tpu_row_compact (grower
# wave shape), tpu_residency (stream raises) and tpu_ingest,
# tpu_ingest_chunk_rows and tpu_ingest_prefetch (device ingest); every
# pass is compacted, so tpu_compact_frac has no meaning here, and there is
# one card, so neither has tpu_reshard_on_resume.
TPU_ONLY_KEYS = (
    "tpu_compact_frac",
    "tpu_hist_chunk", "tpu_hist_hilo", "tpu_hist_f64", "tpu_hist_kernel",
    "tpu_incremental_partition", "tpu_efb_unpack", "tpu_hbm_budget_bytes",
    "tpu_time_tag", "tpu_profile_dir", "tpu_profile_iters",
    "tpu_cost_analysis", "tpu_stream_shard_rows", "tpu_stream_verify",
    "tpu_mesh_axis", "tpu_reshard_on_resume", "tpu_linear_warn_fallback",
)


def _unported(what: str, item: str) -> None:
    Log.fatal("%s is not ported to lightgbm_tpu_torch yet (ROADMAP %s)",
              what, item)


def check_port_supported(config: "Config") -> None:
    """Raise on every configuration the port does not cover yet.

    The port covers ``boosting=gbdt|goss|dart|rf`` with every objective of
    the JAX package (or custom gradients, ``objective=none``), query groups,
    bagging and feature_fraction, EFB (``enable_bundle``), linear leaves,
    ``tree_learner=serial``, dense or sparse numerical and categorical
    features, resident data binned on the host or the device
    (``tpu_ingest``), batches of iterations (``tree_batch``), single-device
    checkpoint/resume (``checkpoint_dir``, ``resume_from``) and
    ``nan_policy``.
    Each refusal names the ROADMAP queue item
    that will port it; none of these settings is ever silently ignored."""
    if config.linear_tree and config.tree_learner != "serial":
        # the JAX package's own refusal (boosting/gbdt.py:712-732): the
        # moments are not reduced across devices
        Log.fatal("linear_tree=true is single-device for now "
                  "(tree_learner=%s): the per-leaf moment accumulation is "
                  "not wired through the mesh collectives yet",
                  config.tree_learner)
    if config.tree_learner != "serial":
        _unported(f"tree_learner={config.tree_learner}", "A16")
    if config.tpu_residency == "stream":
        _unported("tpu_residency=stream", "A14")
    defaults = Config.__dataclass_fields__
    for key in TPU_ONLY_KEYS:
        if getattr(config, key) != defaults[key].default:
            Log.info("%s=%s has no meaning on the card; ignored", key,
                     getattr(config, key))
