"""GBDT boosting driver: the serial, device-resident path.

Port of ``lightgbm_tpu/boosting/gbdt.py`` for one device: the constructor's
device placement, the per-iteration step (``_make_step``/``step_body`` at
gbdt.py:1263-1432) with boost-from-average (:770), bagging and
feature_fraction (:1152-1191), valid sets (:1114, :1217), metric eval
(:2073-2147), custom gradients, continued training, rollback and
``reset_config`` (:1878-2059), and the factory ``create_boosting``
(reference src/boosting/gbdt.cpp:225-518). The JAX package compiles each
iteration into one jitted program, and ``tree_batch`` iterations into one
``lax.scan`` (``train_batch``, gbdt.py:1742-1803 there). Here an iteration
is PyTorch on the booster's device, in parts that update fixed buffers in
place: gradients -> sampling -> per model, the tree's prologue, its waves
(``grower.TreeGrower``) and its epilogue (shrinkage, train and valid score
updates). On the card the parts are captured once in CUDA graphs and
replayed (``_IterationGraphs``), with one host read per tree; the first
iteration, the CPU, and paths with host work inside an iteration (linear
leaves, a custom ``fobj``, GOSS, DART) run the same parts eagerly.
``train_batch(n)`` runs ``n`` iterations back to back; the engine evals on
batch boundaries.

Random draws reproduce ``jax.random``'s bits (``utils/prng.py``): the base
key is ``PRNGKey(seed or bagging_seed)``; iteration ``it`` uses ``key =
fold_in(base, it)`` and ``bkey, fkey = split(fold_in(key, 0))``; the
bagging mask and GOSS draw from ``bkey`` over the N rows, model ``k``'s
feature mask from ``fold_in(fkey, k)`` over the F features. The JAX package
draws over its padded rows and features; a draw is prefix-stable, so the
first N (F) values are the same.

EFB (``enable_bundle=auto|true``, gbdt.py:184-330 and :435-460 there): the
plan is made from a row sample of the bin matrix (``efb.plan_bundles``);
``auto`` keeps it by the JAX package's rule (it shrinks the histogram's
``columns x bins`` by a tenth, or halves the columns without growing it by
more than a quarter), and then the booster holds the ``[N, G]`` bundled
codes and the ``BundleDecode`` tables on the device and grows every tree in
bundle space. Valid sets stay unbundled, as in the JAX package, so that
their walk is exact whatever the conflicts.

Linear leaves (``linear_tree``, gbdt.py:701-752 there): the booster holds
the training rows' raw f32 values (NaN set to 0) and their missing plane on
the device, each valid set its own; each tree's leaves are fitted after
growth and before shrinkage (``ops/linear.py``), and the score updates add
the leaves' linear outputs.

Device ingest (gbdt.py:455-490 and :1087-1110 there): when the dataset's
binning is deferred, the code matrix is binned on the device
(``ops/ingest.py``) and EFB plans from host-binned sample rows; the data
fingerprint hashes host-oracle codes either way.

Out-of-core streaming (``tpu_residency=stream|auto``, gbdt.py:358-556
and :916-1021 there): resolved before the code matrix is placed; ``auto``
streams when the port's estimate of a resident run
(``observability/memory.py``) exceeds the budget. A streamed booster keeps
the (possibly bundled) host codes in packed pinned shards
(``ops/stream.HostShardStore``; deferred binning falls back to the host)
and grows through ``grower.StreamedGrower`` eagerly, one flag read per
wave; the trees are a resident run's. ``tree_batch`` falls back to 1,
``rollback_one_iter`` refuses, DART and linear leaves refuse stream.

Distributed learners (``tree_learner=data|feature|voting`` in a world of
more than one process, ``parallel/comm.py``; gbdt.py:103-180, :395-433 and
:1023-1053 there): under data and voting, rank ``r`` holds the JAX
package's row block ``r`` of the padded rows (``_setup_rows``; under
``is_pre_partition`` its own rows at the head of its block, with the
world's metadata gathered host-side, ``_world_metadata``); under feature
every rank holds every row. Per-row state (codes, labels, scores, masks)
is the rank's block; bagging, GOSS and the feature mask draw over the
world's rows, a structured objective (lambdarank) and ``fobj`` see the
world's scores, and the training metrics run on the world's scores on the
host. The iteration runs eagerly (collectives between the parts).

``nan_policy`` (gbdt.py:1194-1215, :1335-1410, :1514-1562 and :1804-1875
there): the iteration's gradient, hessian and leaf-output flags go into
``_nf``; under raise/skip_iter the last model's epilogue gates the scores,
valid scores and bagging mask back to pre-step copies, and the host pops
a poisoned iteration's bookkeeping; clip sanitises g/h and leaf values.
On the card the flags are read with the grower's, once per tree.
``checkpoint_state`` / ``restore_checkpoint_state`` (gbdt.py:2153-2290
there) carry the training state as builtins and numpy, the world's per-row
state gathered into its padded layout, so a resume at another world size
re-lays it out under ``tpu_reshard_on_resume``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_port_supported
from ..dataset import ConstructedDataset, Metadata, MetadataDuckTyping
from ..grower import (BundleDecode, GrowerSpec, StreamedGrower, TreeArrays,
                      TreeGrower, waves_for_tree)
from ..metrics import Metric, _PointwiseRegressionMetric, create_metrics
from ..objectives import create_objective
from ..ops.cuda_histogram import histogram_cost_report
from ..ops.histogram import device_code_dtype
from ..ops.linear import (fit_linear_leaves, linear_cost_report,
                          linear_leaf_scores)
from ..ops.predict import leaves_from_binned
from ..robustness import allowed_host_sync
from ..robustness.numeric import (FLAG_NAMES, NonFiniteError, clip_nonfinite,
                                  nonfinite_flag)
from ..parallel.comm import make_parallel_context
from ..tree import Tree, tree_from_device_arrays
from .. import observability as obs
from ..analysis.contracts.registry import trace_entry
from ..observability import costs as obs_costs
from ..utils import prng
from ..utils.log import Log
from ..utils.timer import TIMERS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _class_major(init_score, K: int, n: int) -> np.ndarray:
    """An init score as ``[K, n]`` f32: ``K * n`` values in class-major
    order, or ``n`` values given to every class (gbdt.py:776-782)."""
    arr = np.asarray(init_score, np.float32).reshape(-1)
    if len(arr) == K * n:
        return arr.reshape(K, n)
    return np.tile(arr.reshape(1, n), (K, 1))


class ValidSet(MetadataDuckTyping):
    """A validation set on the booster's device: binned codes, labels,
    metrics and its running raw scores ``[K, n]``. The mixin gives user
    fevals the reference Dataset's getters."""

    def __init__(self, name: str, Xb: torch.Tensor, metadata: Metadata,
                 metrics: List[Metric], num_data: int):
        self.name = name
        self.Xb = Xb
        # linear leaves: (NaN-sanitised raw f32 values, missing plane)
        self.raw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.metadata = metadata
        self.metrics = metrics
        self.num_data = num_data
        self.score: Optional[torch.Tensor] = None
        self.label_dev: Optional[torch.Tensor] = None
        self.weight_dev: Optional[torch.Tensor] = None


def _codes_tensor(codes: np.ndarray, device, num_bins: int) -> torch.Tensor:
    """Host codes on ``device`` in :func:`ops.histogram.device_code_dtype`
    for features of at most ``num_bins`` bins: ``uint16`` codes are viewed
    as ``int16`` (PyTorch gathers ``int16`` but not ``uint16``), or widened
    to ``int32`` where a feature has more than 32,768 bins, so that a code
    of ``2**15`` or more keeps its value (ROADMAP B1c)."""
    codes = np.ascontiguousarray(codes)
    if codes.dtype == np.uint16:
        if device_code_dtype(num_bins) == torch.int32:
            codes = codes.astype(np.int32)
        else:
            codes = codes.view(np.int16)
    return torch.as_tensor(codes, device=device)


def _raw_tensors(raw: np.ndarray, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Raw feature values for linear leaves on ``device``: f32 with NaN set
    to 0 and +-inf to the f32 extremes, beside the NaN plane."""
    raw = np.array(raw, np.float32)
    miss = np.isnan(raw)
    np.nan_to_num(raw, copy=False, nan=0.0)
    return (torch.as_tensor(raw, device=device),
            torch.as_tensor(miss, device=device))


def _data_fingerprint(codes: Optional[np.ndarray],
                      train_set: ConstructedDataset, label) -> str:
    """The checkpoint's data fingerprint (gbdt.py:471-490 there): a strided
    row sample of the (possibly bundled) host codes and the labels. Under
    deferred binning the same rows are binned by the host oracle
    (``bin_rows``), so the fingerprint does not depend on where binning
    runs and ``tpu_ingest`` stays checkpoint-volatile."""
    fp = hashlib.sha256()
    N = train_set.num_data
    if codes is None:
        n0, n1 = train_set.num_data, train_set.num_features
        fp.update(np.int64([N, n0, n1]).tobytes())
        fp.update(train_set.bin_rows(
            np.arange(0, n0, max(1, n0 // 256))).tobytes())
    else:
        fp.update(np.int64([N, codes.shape[0], codes.shape[1]]).tobytes())
        stride = max(1, codes.shape[0] // 256)
        fp.update(np.ascontiguousarray(codes[::stride]).tobytes())
    fp.update(np.asarray(label, np.float32).tobytes())
    return fp.hexdigest()


class GBDT:
    """Boosting driver (reference class GBDT, src/boosting/gbdt.h:25)."""

    average_output = False  # RF overrides (boosting.h average_output_)
    # batches of iterations (tree_batch > 1) need every per-iteration hook
    # on the device; DART and GOSS override to False and fall back to 1
    supports_tree_batch = True
    # capture the iteration on the card where the path allows; False (on
    # the class or a booster) runs it eagerly there too, for comparison
    _capture = True

    def __init__(self, config: Config, train_set: ConstructedDataset):
        check_port_supported(config)
        self.config = config
        self.train_set = train_set
        # the world and this process's place in it (parallel/comm.py); a
        # world of one is serial on one device
        self.pctx = make_parallel_context(
            config, shape=(train_set.num_data, train_set.num_features))
        self.device = self.pctx.device
        self.objective = create_objective(config)   # None: objective=none
        self.num_models = self.objective.num_models if self.objective \
            else max(config.num_class, 1)
        K = self.num_models
        F = train_set.num_features
        md = self._meta_global = self._world_metadata(config, train_set)
        N = self.num_data
        self._setup_rows(config)
        if self.pctx.multi_process:
            self._refuse_in_world(config)
        if self.objective is not None:
            self.objective.init(md, N)
            if self._block_counts is not None and \
                    hasattr(self.objective, "set_row_layout"):
                self.objective.set_row_layout(self._real_rows(),
                                              self.num_data_padded)

        meta = train_set.feature_meta_arrays()
        F_pad = self.pctx.pad_features_to(max(F, 1))
        self.spec = self._make_spec(config, F_pad, train_set.max_num_bin,
                                    meta["is_categorical"])
        dev = self.device
        self._num_bundles_padded = 0
        # None: the codes are binned on the device from the deferred raw
        # rows (device ingest, gbdt.py:455-470 there)
        codes = self._plan_bundles(config, train_set, meta)
        if codes is None and self.pctx.multi_process:
            Log.info("deferred ingest falls back to host binning (%d-process "
                     "layout)", self.pctx.num_devices)
            codes = train_set.X_binned
        # the data fingerprint of the world's rows (every rank holds them
        # here, except under is_pre_partition), so that a checkpoint
        # resumes at another world size
        fp_codes = codes
        if codes is not None and self.pctx.num_devices > 1:
            codes = self._world_codes(codes)
        self.comm = self.pctx.make_comm(
            F_pad, N, num_bundles=self._num_bundles_padded,
            bundle_col=None if self.bundle is None else self.bundle.col)
        # ---- residency (gbdt.py:358-382 there), before any placement ----
        self.residency = self._resolve_residency(config, train_set, codes)
        if self.residency == "stream" and config.tpu_row_compact:
            # the effective semantics (full streaming passes, no
            # compaction), so that the checkpoint fingerprint covers what
            # trains: a streamed run resumes into tpu_residency=device with
            # tpu_row_compact=false (and, the sums being order-free here,
            # into compaction too)
            config = config.replace(tpu_row_compact=False)
            self.config = config
            self.spec = dataclasses.replace(self.spec, row_compact=False)
        if self.residency == "stream" and codes is None:
            Log.info("deferred ingest falls back to host binning (stream "
                     "residency)")
            codes = fp_codes = train_set.X_binned
        self._data_fingerprint = _data_fingerprint(fp_codes, train_set,
                                                   md.label)
        del fp_codes
        self._ingest_report = None
        self._stream_store = self._stream = None
        if self.residency == "stream":
            self._setup_stream(config, codes)
            self.Xb = None
        else:
            # the dataset's placement: codes copied to the device, or raw
            # rows binned there (construct's own spans end on the host)
            with obs.span("construct.place", rows=N,
                          ingest=codes is None):
                self.Xb = self._ingest_device(train_set) if codes is None \
                    else _codes_tensor(codes, dev, self.spec.hist_bins
                                       or self.spec.num_bins_padded)
        del codes
        self._setup_linear(config, train_set)
        self.label = self._rows_tensor(md.label)
        self.weight = None if md.weight is None else self._rows_tensor(
            md.weight)
        self.pad_mask = self._rows_tensor(np.ones(N, np.float32))
        # padding features (the block strategies' F % D) never split
        fpad = F_pad - F
        self.num_bins = torch.as_tensor(
            np.pad(meta["num_bins"], (0, fpad), constant_values=1),
            device=dev)
        self.missing_code = torch.as_tensor(
            np.pad(meta["missing_code"], (0, fpad)), device=dev)
        self.default_bin = torch.as_tensor(
            np.pad(meta["default_bin"], (0, fpad)), device=dev)
        self.is_cat = torch.as_tensor(
            np.pad(meta["is_categorical"], (0, fpad)), device=dev)
        self.feature_ok = torch.as_tensor(np.arange(F_pad) < F, device=dev)
        self.num_features_real = F

        # feature_fraction: number of features used per tree (gbdt.py:756)
        self.n_feature_sample = max(1, int(round(config.feature_fraction * F)))
        self.use_feature_fraction = (config.feature_fraction < 1.0
                                     and self.n_feature_sample < F)

        self.train_metrics = create_metrics(config, self._objective_name())
        for m in self.train_metrics:
            m.init(md, N)
        self.valid_sets: List[ValidSet] = []
        # a query's rows may lie in several ranks' blocks: the labels and
        # weights of the world's rows, placed once here (never inside a
        # captured part)
        self._world_label = self._world_weight = None
        if self._row_sharded and self.objective is not None \
                and not self.objective.pointwise:
            self._world_label = torch.as_tensor(
                self._row_layout(np.asarray(md.label, np.float32)),
                device=self.device)
            if md.weight is not None:
                self._world_weight = torch.as_tensor(self._row_layout(
                    np.asarray(md.weight, np.float32)), device=self.device)

        # ---- initial scores (boost_from_average, gbdt.cpp:357-377) ------
        self.init_score_value = 0.0
        has_init = md.init_score is not None
        if config.boost_from_average and not has_init and K == 1 \
                and self.objective is not None:
            avg = self.objective.boost_from_average_score()
            if avg is not None and abs(avg) > 1e-15:
                self.init_score_value = float(avg)
        base = np.full((K, N), self.init_score_value, dtype=np.float32)
        if has_init:
            base += _class_major(md.init_score, K, N)
        self.score = self._rows_tensor(base)

        self.models: List[List[TreeArrays]] = []
        # per iteration, the K trees' leaf counts: an i32 [K] device tensor
        self._num_leaves: List[torch.Tensor] = []
        self.iter_ = 0
        # telemetry high-water mark: iterations already counted into the
        # monotonic trees.trained / rows.routed counters
        # (publish_telemetry); a checkpoint restore and repeated train()
        # calls on one booster raise it, so nothing is counted twice
        self._telemetry_iters_base = 0
        # monotonic forest-content counter: iter_ alone collides after a
        # rollback followed by a retrain
        self.mutations_ = 0
        # the scores the last iteration replaced, so that rolling it back
        # restores them bit for bit (a subtraction would round)
        self._undo: Optional[Tuple[torch.Tensor, List[torch.Tensor]]] = None

        self._rng_key = prng.prng_key(config.seed if config.seed
                                      else config.bagging_seed)
        self.bagging_on = config.bagging_freq > 0 \
            and config.bagging_fraction < 1.0
        # updated in place by every iteration
        self.bag_mask = self.pad_mask.clone()

        # ---- iterations in batches (tree_batch, gbdt.py:826-865 there) --
        tb = max(1, config.tree_batch)
        if tb > 1 and not self.supports_tree_batch:
            Log.warning(
                "tree_batch=%d is not supported with boosting=%s (the "
                "per-iteration pipeline is not fully device-resident); "
                "falling back to tree_batch=1", tb,
                config.boosting_normalized)
            tb = 1
        if tb > 1 and self.pctx.multi_process:
            # the collectives run between the graphs' parts: an iteration is
            # eager, one at a time, as a streamed one is
            Log.info("tree_batch=%d falls back to 1 under tree_learner=%s "
                     "across %d ranks (collectives outside the graphs, "
                     "ROADMAP A16b)", tb, self.pctx.strategy,
                     self.pctx.num_devices)
            tb = 1
        if tb > 1 and self.residency == "stream":
            # the shard loop is driven by the host wave by wave
            # (gbdt.py:841-850 there)
            Log.warning(
                "tree_batch=%d is not supported with tpu_residency=stream "
                "(the shard prefetch loop is host-driven); falling back "
                "to tree_batch=1", tb)
            tb = 1
        if (tb > 1 and self.average_output
                and config.nan_policy in ("raise", "skip_iter")):
            # RF's running average weighs by the iteration number, which
            # goes on through a batch: a gated no-op inside a batch would
            # leave a phantom iteration in it (gbdt.py:852-863 there)
            Log.warning(
                "tree_batch=%d with nan_policy=%s cannot compose with a "
                "mid-batch skip/rollback under boosting=rf (scores are "
                "running averages weighted by the iteration counter); "
                "falling back to tree_batch=1", tb, config.nan_policy)
            tb = 1
        self.tree_batch = tb
        self._grower: Optional[TreeGrower] = None
        self._graphs: Optional[_IterationGraphs] = None
        self._stack = None
        self._custom_gh = None
        self._eager_logged: Optional[str] = None
        # waves the last eager tree of each model needed (the first guess
        # of a replayed tree's wave count)
        self._waves_seen = [1] * K

        # the non-finite guard (robustness/numeric.py): flags of the
        # gradients, hessians and leaf outputs of every iteration
        self.nan_policy = config.nan_policy
        self._consecutive_skips = 0
        self.best_iteration = 0

        # telemetry (gbdt.py:866-912 there): the booster's kernel route
        # and dispatch shape, the world, and the analytic per-wave
        # collective bytes (parallel/comm.py); host facts at construction
        self.kernel_route = "cuda" if dev.type == "cuda" else "plain"
        reg = obs.get_registry()
        reg.counter(f"booster.kernel.{self.kernel_route}").inc()
        reg.counter(f"booster.residency.{self.residency}").inc()
        reg.gauge("booster.tree_batch").set(tb)
        reg.gauge("booster.wave_size").set(self.spec.wave_size)
        reg.gauge("booster.hist_slots").set(self.spec.hist_slots)
        if self._stream_store is not None:
            reg.gauge("stream.n_shards").set(self._stream_store.n_shards)
            reg.gauge("stream.shard_bytes").set(
                self._stream_store.shard_bytes)
        obs.event("booster_init", kernel=self.kernel_route, tree_batch=tb,
                  rows=int(N), features=int(F),
                  num_leaves=int(self.spec.num_leaves),
                  strategy=self.pctx.strategy, nan_policy=self.nan_policy,
                  mesh_axis=self.pctx.axis_kind,
                  n_devices=self.pctx.num_devices, residency=self.residency)
        if self._stream_store is not None:
            obs.event("stream_init", **self._stream_store.describe())
        reg.gauge("comm.world_size").set(self.pctx.num_devices)
        reg.gauge("comm.mesh.n_devices").set(self.pctx.num_devices)
        reg.gauge("comm.mesh.rows_sharded").set(
            1 if self.pctx.axis_kind == "rows" else 0)
        reg.counter(f"booster.tree_learner.{self.pctx.strategy}").inc()
        if self.pctx.multi_process:
            obs.event("mesh_axes", **self.pctx.describe())
        comm_bytes = self.comm.collective_bytes(
            self.spec.hist_slots, self.spec.num_bins_padded,
            use_categorical=self.spec.use_categorical,
            hist_bins=self.spec.hist_bins or None)
        for cname, nbytes in comm_bytes.items():
            reg.gauge(f"comm.bytes_per_wave.{cname}").set(nbytes)
        if comm_bytes:
            obs.event("comm_cost", strategy=self.pctx.strategy, **comm_bytes)

    @staticmethod
    def _make_spec(config: Config, F: int, max_num_bin: int,
                   is_categorical: np.ndarray) -> GrowerSpec:
        num_leaves = config.max_leaves_by_depth
        slots = config.tpu_hist_slots or max(1, min(25, num_leaves - 1))
        slots = max(1, min(slots, num_leaves))
        wave = config.tpu_wave_size or slots
        return GrowerSpec(
            num_leaves=num_leaves,
            num_features=F,
            num_bins_padded=max(8, _round_up(max_num_bin, 8)),
            hist_slots=slots,
            wave_size=min(wave, slots),
            max_depth=config.max_depth,
            lambda_l1=config.lambda_l1,
            lambda_l2=config.lambda_l2,
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            row_compact=config.tpu_row_compact,
            cat_features=tuple(int(i) for i in np.nonzero(is_categorical)[0]),
            cat_smooth=config.cat_smooth,
            cat_l2=config.cat_l2,
            max_cat_threshold=config.max_cat_threshold,
            max_cat_to_onehot=config.max_cat_to_onehot,
            min_data_per_group=float(config.min_data_per_group),
        )

    # out-of-core streaming (tpu_residency=stream): every per-iteration
    # step must run through the host's shard loop; DART opts out (its drop
    # set is replayed over the resident code matrix)
    supports_stream = True

    def _stream_support(self, config: Config) -> Tuple[bool, str]:
        """(supported, why not) for ``tpu_residency=stream`` (gbdt.py:922-945
        there): a forced stream refuses, ``auto`` never picks it."""
        if not self.supports_stream:
            return False, (f"boosting={config.boosting_normalized} keeps "
                           f"host-side per-tree state that reads the "
                           f"resident code matrix")
        if config.linear_tree:
            return False, ("linear_tree=true keeps the raw feature slice "
                           "device-resident (the per-leaf fits read raw "
                           "values every tree)")
        # tree_learner=feature is refused with its own reason before this
        # (config.check_port_supported); under data and voting each rank
        # streams a store of its own row block (_setup_stream)
        if config.is_pre_partition:
            return False, "is_pre_partition holds per-process row blocks"
        return True, ""

    def _shard_geometry(self, config: Config, train_set: ConstructedDataset,
                        cols: int, code_itemsize: int) -> Dict:
        """The store a streamed run of this booster would build: padded
        rows, shard rows and code mode (ops/stream.py)."""
        from ..ops.histogram import code_mode_for
        from ..ops.stream import shard_geometry
        # a row-sharded rank streams its block (num_rows, padding included)
        padded, rows = shard_geometry(self.num_rows,
                                      config.tpu_stream_shard_rows)
        max_code = self.efb_plan.max_bundle_bins if self.bundle is not None \
            else train_set.max_num_bin
        return dict(n_rows_padded=padded, shard_rows=rows,
                    code_mode=code_mode_for(int(max_code), code_itemsize))

    def _resolve_residency(self, config: Config,
                           train_set: ConstructedDataset,
                           codes: Optional[np.ndarray]) -> str:
        """``tpu_residency`` resolved before the code matrix is placed
        (gbdt.py:947-1021 there). ``auto`` streams when the estimate of the
        resident run (``observability/memory.py``) exceeds the budget
        (``LGBM_TPU_HBM_BUDGET``, ``tpu_hbm_budget_bytes`` or the card's
        memory) and streaming is supported. Both estimates are kept in
        ``residency_estimates``."""
        from ..observability.memory import (estimate_residency,
                                            hbm_budget_bytes)
        from ..ops.histogram import code_bytes_total
        cols = train_set.num_features if codes is None else codes.shape[1]
        itemsize = np.dtype(train_set.code_dtype if codes is None
                            else codes.dtype).itemsize
        geo = self._stream_geo = self._shard_geometry(config, train_set,
                                                      cols, itemsize)
        spec = self.spec
        dims = dict(rows=self.num_rows, cols=cols, code_itemsize=itemsize,
                    num_models=self.num_models, num_leaves=spec.num_leaves,
                    hist_bins=spec.hist_bins or spec.num_bins_padded,
                    slots=spec.hist_slots,
                    has_weight=train_set.metadata.weight is not None)
        self.residency_estimates = {
            "device": estimate_residency(**dims),
            "stream": estimate_residency(
                **dims, shard_rows=geo["shard_rows"],
                shard_bytes=geo["shard_rows"] * code_bytes_total(
                    cols, geo["code_mode"]),
                unpack=geo["code_mode"] in ("u4", "u6"))}
        requested = config.tpu_residency
        if requested == "device":
            return "device"
        supported, why = self._stream_support(config)
        if requested == "stream":
            if not supported:
                Log.fatal("tpu_residency=stream is not supported here: %s",
                          why)
            return "stream"
        budget = hbm_budget_bytes(config, self.device)
        need = self.residency_estimates["device"]["total_bytes"]
        if budget is None or need <= budget:
            return "device"
        gb = float(1 << 30)
        if not supported:
            Log.warning(
                "HBM pre-flight: estimated device residency %.3g GB "
                "exceeds the %.3g GB budget but tpu_residency=stream is "
                "unavailable (%s) — staying device-resident; expect an "
                "OOM at first dispatch", need / gb, budget / gb, why)
            return "device"
        Log.warning(
            "HBM pre-flight: estimated device residency %.3g GB exceeds "
            "the %.3g GB budget — auto-selecting tpu_residency=stream: the "
            "binned codes stay in host-resident packed shards and are "
            "copied to the card double-buffered through the wave loop",
            need / gb, budget / gb)
        return "stream"

    def _setup_stream(self, config: Config, codes: np.ndarray) -> None:
        """The host shard store of the (possibly bundled) codes, in the
        geometry ``_resolve_residency`` chose, pinned on the card, and its
        prefetcher (gbdt.py:511-556 there). Under data and voting ``codes``
        is this rank's row block (``_world_codes``, its tail padding rows
        zero and never included): at the JAX package's geometry shard ``i``
        is, byte for byte, the device-``r`` sub-block of the JAX store's
        interleaved shard ``i`` (``HostShardStore(n_devices=D)``)."""
        from ..ops.stream import HostShardStore, ShardPrefetcher, log_store
        from ..robustness.chaos import maybe_corrupt_shard_from_env
        store = HostShardStore(codes, num_cols=codes.shape[1],
                               pin=self.device.type == "cuda",
                               **self._stream_geo)
        # a one-shot bit flip for the chaos harness; a no-op without its
        # environment variable
        maybe_corrupt_shard_from_env(store)
        self._stream_store = store
        self._stream = ShardPrefetcher(store, self.device,
                                       verify=config.tpu_stream_verify)
        log_store(store)

    def _plan_bundles(self, config: Config, train_set: ConstructedDataset,
                      meta) -> np.ndarray:
        """EFB set-up (gbdt.py:184-275 and :435-460 there): plan, decide,
        and when bundling, put the ``BundleDecode`` tables on the device and
        set ``spec.hist_bins``. Returns the host code matrix to train on, or
        None when the dataset's binning is deferred and stays so (the
        codes are then binned on the device)."""
        from ..efb import (build_code_feat, materialize_bundles,
                           plan_bundles, sample_row_indices)
        self.bundle: Optional[BundleDecode] = None
        self.efb_plan = None          # the kept plan, its codes dropped
        self.efb_wins = None          # whether a plan won the rule
        F, N = train_set.num_features, train_set.num_data
        deferred = train_set.deferred
        unbundled = None if deferred else train_set.X_binned
        if config.enable_bundle == "false" or F < 2:
            return unbundled
        if self.pctx.strategy == "voting" and meta["is_categorical"].any():
            # the JAX package keeps its unpack arm here (gbdt.py:209-220
            # there), which this port does not have; unbundled voting gives
            # that arm's trees on exact-arithmetic gradients (ROADMAP C14)
            Log.warning("tree_learner=voting with categorical features "
                        "trains unbundled (enable_bundle ignored)")
            return unbundled
        nb = meta["num_bins"].astype(np.int64)
        db = meta["default_bin"].astype(np.int64)
        if self._block_counts is not None:
            # pre-partitioned: every rank plans from the same gathered
            # sample of every rank's rows (gbdt.py:227-233 there)
            from ..efb import _SAMPLE_ROWS, sample_rows
            from ..parallel.comm import host_allgather
            per_rank = max(1, _SAMPLE_ROWS // len(self._block_counts))
            parts = host_allgather(sample_rows(train_set.X_binned, per_rank),
                                   "efb_sample")
            plan = plan_bundles(train_set.X_binned, nb, db, config,
                                sample=np.concatenate(parts, axis=0),
                                num_data=self.num_data)
        elif deferred:
            # plan from a host-binned row sample (the plan is a function of
            # the sample, and bin_rows bins the rows sample_rows would take)
            plan = plan_bundles(None, nb, db, config,
                                sample=train_set.bin_rows(
                                    sample_row_indices(N)),
                                num_data=N)
        else:
            plan = plan_bundles(train_set.X_binned, nb, db, config)
        if plan is None:
            return unbundled
        Bpad = self.spec.num_bins_padded
        Bb_pad = max(8, _round_up(plan.max_bundle_bins, 8))
        G = plan.num_groups
        # the JAX package's rule: bundling wins when it shrinks the
        # histogram's columns x bins, or halves the columns without growing
        # it by more than a quarter
        shrinks_matmul = G * Bb_pad < 0.9 * F * Bpad
        shrinks_cols = G * 2 <= F and G * Bb_pad <= 1.25 * F * Bpad
        wins = shrinks_matmul or shrinks_cols
        if config.enable_bundle == "auto":
            Log.debug("enable_bundle=auto resolved to %s (%d features -> %d "
                      "bundles, matmul %d vs %d columns)",
                      "true" if wins else "false", F, G, G * Bb_pad,
                      F * Bpad)
        self.efb_wins = wins
        if not (wins or config.enable_bundle == "true"):
            return unbundled
        if plan.X_bundled is None:
            # the plan won under deferral: bundling needs the host codes
            # after all (device ingest serves the unbundled layout only)
            plan.X_bundled = materialize_bundles(plan, train_set.X_binned, db)
        codes = plan.X_bundled
        plan.X_bundled = None
        self.efb_plan = plan
        dev = self.device
        # the block strategies partition bundled columns: G % D == 0, and
        # the tables are padded to the padded feature count
        G_pad = self.pctx.pad_features_to(G)
        if self.pctx.strategy in ("data", "feature"):
            self._num_bundles_padded = G_pad
        fpad = self.spec.num_features - F
        ub = np.pad(plan.unpack_bin,
                    ((0, fpad), (0, Bpad - plan.unpack_bin.shape[1])),
                    constant_values=-1)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)

        def padf(a):
            return put(np.pad(a, (0, fpad)))
        self.bundle = BundleDecode(
            col=padf(plan.col), lo=padf(plan.lo), hi=padf(plan.hi),
            off=padf(plan.off), unpack_bin=put(ub),
            code_feat=put(build_code_feat(plan, G_pad, Bb_pad, db)))
        self.spec = dataclasses.replace(self.spec, hist_bins=Bb_pad)
        Log.info("EFB: %d features bundled into %d columns (%d max bundle "
                 "bins, %s codes), scan=bundle-space", F, G,
                 plan.max_bundle_bins, codes.dtype)
        return codes

    # ------------------------------------------------- the world's rows

    def _world_metadata(self, config: Config,
                        train_set: ConstructedDataset) -> Metadata:
        """The metadata of the world's rows (gbdt.py:103-165 there): the
        dataset's own, or under ``is_pre_partition`` across processes, the
        concatenation of every rank's labels, weights, query sizes and
        init scores, gathered host-side (each rank loaded only its rows).
        Sets ``num_data`` (the world's rows) and ``_block_counts``."""
        md = train_set.metadata
        self.num_data = train_set.num_data
        self._block_counts: Optional[List[int]] = None
        if not (config.is_pre_partition and self.pctx.multi_process
                and self.pctx.strategy in ("data", "voting")):
            return md
        from ..parallel.comm import host_allgather
        n = int(train_set.num_data)
        blocks = host_allgather(
            dict(n=n, label=np.asarray(md.label, np.float32),
                 weight=None if md.weight is None
                 else np.asarray(md.weight, np.float32),
                 qsizes=None if md.query_boundaries is None
                 else np.diff(md.query_boundaries).astype(np.int64),
                 init_score=None if md.init_score is None
                 else np.asarray(md.init_score, np.float32)),
            "pre_partition_meta")
        self._block_counts = [int(b["n"]) for b in blocks]
        N = self.num_data = int(sum(self._block_counts))
        out = Metadata(N)
        out.set_label(np.concatenate([b["label"] for b in blocks]))

        def _all_or_none(key, what):
            have = sum(b[key] is not None for b in blocks)
            if have not in (0, len(blocks)):
                Log.fatal("is_pre_partition: %d of %d shards have %s — "
                          "every shard must provide them or none",
                          have, len(blocks), what)
            return bool(have)

        if _all_or_none("weight", "weights"):
            out.set_weight(np.concatenate([b["weight"] for b in blocks]))
        if _all_or_none("qsizes", "query/group data"):
            # each shard holds whole queries, in rank order
            out.set_group(np.concatenate([b["qsizes"] for b in blocks]))
        if _all_or_none("init_score", "init_score"):
            k = max(len(blocks[0]["init_score"]) // max(blocks[0]["n"], 1),
                    1)
            if any(len(b["init_score"]) != k * b["n"] for b in blocks):
                Log.fatal("is_pre_partition: init_score length must be the "
                          "same per-row multiple on every shard")
            out.set_init_score(np.concatenate(
                [b["init_score"].reshape(k, b["n"]) for b in blocks],
                axis=1).reshape(-1))
        Log.info("pre-partitioned data: %d rows across %d processes %s", N,
                 len(blocks), self._block_counts)
        return out

    def _setup_rows(self, config: Config) -> None:
        """The padded row layout of the world and this rank's block of it
        (gbdt.py:171-180 and :395-424 there): under data/voting across D
        ranks the rows are padded to ``Npad = round_up(per_target, 256) *
        D`` and rank ``r`` holds row block ``r`` (tail padding included;
        under ``is_pre_partition`` every block starts with its rank's
        rows). Up to 32768 rows a rank (the JAX package's default
        ``tpu_hist_chunk``) these are the JAX package's row blocks; above
        it the JAX package pads each block to its chunk, which B1 does not
        need. Otherwise every rank holds the N rows."""
        N = self.num_data
        D = self.pctx.pad_rows_multiple()
        self._row_sharded = D > 1
        if not self._row_sharded:
            self.num_data_padded = self.num_rows = N
            self._row0 = 0
            return
        n_for_pad = N if self._block_counts is None else \
            max(self._block_counts) * len(self._block_counts)
        per_target = max((n_for_pad + D - 1) // D, 1)
        self.num_rows = _round_up(per_target, 256)
        self.num_data_padded = self.num_rows * D
        self._row0 = self.pctx.rank * self.num_rows

    def _real_rows(self) -> np.ndarray:
        """Positions of the world's real rows in the padded layout, in
        global row order (gbdt.py:1023-1032 there)."""
        if self._block_counts is None:
            return np.arange(self.num_data)
        bp = self.num_data_padded // len(self._block_counts)
        return np.concatenate([np.arange(c) + p * bp
                               for p, c in enumerate(self._block_counts)])

    def _row_layout(self, arr) -> np.ndarray:
        """Host array of the world's rows on its last axis -> the padded
        layout (gbdt.py:1034-1053 there)."""
        arr = np.asarray(arr)
        if not self._row_sharded:
            return arr
        out = np.zeros(arr.shape[:-1] + (self.num_data_padded,), arr.dtype)
        out[..., self._real_rows()] = arr
        return out

    def _rows_tensor(self, arr) -> torch.Tensor:
        """This rank's block of a host array of the world's rows (last
        axis), on the device; f32."""
        lay = self._row_layout(np.asarray(arr, np.float32))
        r0 = self._row0
        return torch.as_tensor(np.ascontiguousarray(
            lay[..., r0:r0 + self.num_rows]), device=self.device)

    def _world_codes(self, codes: np.ndarray) -> np.ndarray:
        """This rank's code rows, columns padded to the strategy's width:
        its block of the padded rows under data/voting (its own rows under
        ``is_pre_partition``), every row otherwise."""
        if self.bundle is not None:
            cols = self._num_bundles_padded or codes.shape[1]
        else:
            cols = self.spec.num_features
        if self._row_sharded:
            if self._block_counts is not None:
                rows = codes
            else:
                rows = codes[self._row0:self._row0 + self.num_rows]
            out = np.zeros((self.num_rows, cols), codes.dtype)
            out[:rows.shape[0], :codes.shape[1]] = rows
            return out
        if cols == codes.shape[1]:
            return codes
        return np.pad(codes, ((0, 0), (0, cols - codes.shape[1])))

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of a ``[..., num_rows]`` tensor, as the
        world's padded layout ``[..., num_data_padded]`` (an all-gather)."""
        g = self.pctx.coll.all_gather(t)                # [D, ..., rows]
        return g.movedim(0, -2).reshape(*t.shape[:-1], -1)

    def _local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a tensor in the world's padded layout."""
        return t[..., self._row0:self._row0 + self.num_rows]

    def _world_scores(self) -> torch.Tensor:
        """The training scores ``[K, N]`` of the world's real rows, in
        global row order, on every rank."""
        if not self._row_sharded:
            return self.score
        real = torch.as_tensor(self._real_rows(), device=self.device)
        return self._gather_rows(self.score)[:, real]

    def _refuse_in_world(self, config: Config) -> None:
        """What a world of more than one process does not run: the JAX
        package's own refusal."""
        if config.linear_tree:
            # the JAX package's own reason (gbdt.py:717-721 there)
            Log.fatal("linear_tree=true is single-device for now (%d "
                      "devices requested): the per-leaf moment accumulation "
                      "is not wired through the mesh collectives yet",
                      self.pctx.num_devices)

    def _ingest_device(self, train_set: ConstructedDataset) -> torch.Tensor:
        """The deferred raw rows binned on the device (``ops/ingest.py``,
        gbdt.py:1087-1110 there): the same shape, dtype and bytes as
        ``_codes_tensor`` of the host codes."""
        from ..ops.ingest import device_ingest
        cfg = self.config
        N, F = train_set.num_data, train_set.num_features
        codes, report = device_ingest(
            train_set.deferred_raw(), train_set.mappers,
            np.asarray(train_set.real_feature_idx),
            n_rows=N, n_rows_padded=N, num_cols=F,
            out_dtype=train_set.code_dtype, device=self.device,
            chunk_rows=int(cfg.tpu_ingest_chunk_rows),
            prefetch_depth=int(cfg.tpu_ingest_prefetch))
        self._ingest_report = report
        Log.info("device ingest: %d rows binned+packed on device "
                 "(%.2f Mrow/s, %d chunks, stall fraction %.2f)",
                 N, (report["rows_per_s"] or 0.0) / 1e6, report["n_chunks"],
                 report["stall_fraction"])
        return codes

    def _setup_linear(self, config: Config,
                      train_set: ConstructedDataset) -> None:
        """Linear leaves (gbdt.py:701-752 there): the training rows' raw
        values on the device (``_raw_tensors``)."""
        self.linear_tree = bool(config.linear_tree)
        self.raw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.linear_degraded: List[torch.Tensor] = []
        if not self.linear_tree:
            return
        raw = getattr(train_set, "X_raw", None)
        if raw is None:
            Log.fatal("linear_tree=true needs the dataset's raw feature "
                      "slice, which this dataset was constructed without "
                      "— rebuild the Dataset with linear_tree=true in its "
                      "params")
        self.raw = _raw_tensors(raw, self.device)
        Log.info("linear_tree: per-leaf ridge solves on (lambda=%g, "
                 "max_features=%d); raw slice %.2f MB + %.2f MB missing "
                 "plane on the device", config.linear_lambda,
                 config.linear_max_features,
                 self.raw[0].numel() * 4 / (1 << 20),
                 self.raw[1].numel() / (1 << 20))

    def _objective_name(self) -> Optional[str]:
        return self.objective.name if self.objective is not None else None

    def add_valid(self, name: str, binned: np.ndarray, metadata: Metadata,
                  raw: Optional[np.ndarray] = None) -> None:
        """Attach a valid set: its codes (binned with the training set's
        mappers, not bundled) and, with linear leaves, its raw values."""
        nv = binned.shape[0]
        metrics = create_metrics(self.config, self._objective_name())
        for m in metrics:
            m.init(metadata, nv)
        with obs.span("construct.place", rows=nv, valid=name):
            Xb = _codes_tensor(binned, self.device, self.spec.num_bins_padded)
        vs = ValidSet(name, Xb, metadata, metrics, nv)
        if self.linear_tree:
            if raw is None:
                Log.fatal("linear_tree=true: valid set %r needs its raw "
                          "feature values (construct it with "
                          "free_raw_data=False)", name)
            vs.raw = _raw_tensors(raw, self.device)
        base = np.full((self.num_models, nv), self.init_score_value,
                       dtype=np.float32)
        if metadata.init_score is not None:
            base += _class_major(metadata.init_score, self.num_models, nv)
        vs.score = torch.as_tensor(base, device=self.device)
        self.valid_sets.append(vs)
        self._undo = None
        self._grower = None           # its rows are routed by the grower

    # ------------------------------------------------------- step hooks

    def _gradients(self, score):
        """Hook: RF overrides (gradients at zero scores)."""
        if self.objective is None:
            Log.fatal("objective=none needs custom gradients: pass fobj to "
                      "train() or Booster.update()")
        if self._row_sharded and not self.objective.pointwise:
            # the gradients of the world's rows, then this rank's block
            g, h = self.objective.gradients(self._gather_rows(score),
                                            self._world_label,
                                            self._world_weight)
            return self._local_rows(g), self._local_rows(h)
        return self.objective.gradients(score, self.label, self.weight)

    def _bag_mask_for_iter(self, key, it: int, prev_mask):
        """The bagging mask, drawn anew every ``bagging_freq`` iterations
        (gbdt.cpp:225-270; mask-based Bernoulli, as the JAX package)."""
        if not self._draws_bag(it):
            return prev_mask if self.bagging_on else self.pad_mask
        # this rank's block of the draw over the world's padded rows
        u = prng.uniform(key, self.num_rows, self.device, offset=self._row0)
        frac = torch.full((), self.config.bagging_fraction,
                          dtype=torch.float32, device=self.device)
        return (u < frac).to(torch.float32) * self.pad_mask

    def _sampling(self, g, h, bag_mask, key, it: int):
        """Row-sampling hook: ``(mask, g, h)``. Base = bagging; GOSS
        overrides (goss.hpp:86-131)."""
        return self._bag_mask_for_iter(key, it, bag_mask), g, h

    def _draws_bag(self, it: int) -> bool:
        """Whether iteration ``it`` draws a new bagging mask: the two
        variants of a captured iteration."""
        return self.bagging_on and it % self.config.bagging_freq == 0

    def _feature_mask(self, fkey, k: int):
        """Per-model feature_fraction mask (serial_tree_learner.cpp:240)."""
        return self._feature_mask_of(prng.fold_in(fkey, k))

    def _feature_mask_of(self, key):
        """The feature_fraction mask drawn from model ``k``'s key
        ``fold_in(fkey, k)``."""
        if not self.use_feature_fraction:
            return self.feature_ok
        # drawn over the real features (a draw is prefix-stable; the JAX
        # package draws padding features below every real one)
        noise = prng.uniform(key, self.num_features_real, self.device)
        top = prng.top_k_indices(noise, self.n_feature_sample)
        fmask = torch.zeros(self.spec.num_features, dtype=torch.bool,
                            device=self.device)
        fmask.index_fill_(0, top, True)
        return fmask & self.feature_ok

    def _tree_output_transform(self, tree: TreeArrays) -> TreeArrays:
        """Hook: RF converts leaf outputs via the objective (rf.hpp:160)."""
        return tree

    def _score_update(self, old_score_k, contrib):
        """Hook: base adds; RF keeps a running average of the iterations
        (rf.hpp:117-121), read from the device iteration counter."""
        return old_score_k + contrib

    def _step_shrinkage(self) -> float:
        """Hook: per-tree shrinkage (RF overrides to 1.0, rf.hpp:44-45)."""
        return self.config.learning_rate

    def _shrink(self, tree: TreeArrays, shrinkage) -> TreeArrays:
        """Tree::Shrinkage (tree.h:137-142), internal values and a linear
        leaf's intercept and coefficients included, then the output
        transform. ``shrinkage`` is a 0-d f32 tensor on the device."""
        s = shrinkage
        tree = tree._replace(leaf_value=tree.leaf_value * s,
                             internal_value=tree.internal_value * s)
        if tree.leaf_const is not None:
            tree = tree._replace(leaf_const=tree.leaf_const * s,
                                 leaf_coeff=tree.leaf_coeff * s)
        return self._tree_output_transform(tree)

    def _leaf_outputs(self, tree: TreeArrays, leaves: torch.Tensor, raw):
        """The tree's output for rows in ``leaves``: the leaf value, or the
        linear leaf model over the rows' raw values ``raw``."""
        if self.linear_tree:
            return linear_leaf_scores(tree, leaves, *raw)
        return tree.leaf_value[leaves.long()]

    def _train_contrib(self, tree: TreeArrays):
        """One tree's output for every training row, by a walk of the
        (possibly bundled) training codes."""
        leaves = leaves_from_binned(tree, self.Xb, self.num_bins,
                                    self.missing_code, self.default_bin,
                                    self.bundle,
                                    has_cat=self.spec.use_categorical)
        return self._leaf_outputs(tree, leaves, self.raw)

    def _valid_contrib(self, tree: TreeArrays, vs: ValidSet):
        """One tree's output for every row of a valid set."""
        leaves = leaves_from_binned(tree, vs.Xb, self.num_bins,
                                    self.missing_code, self.default_bin,
                                    has_cat=self.spec.use_categorical)
        return self._leaf_outputs(tree, leaves, vs.raw)

    # ------------------------------------------------ one iteration, in parts
    #
    # An iteration runs as four parts on buffers that keep their addresses:
    # ``_part_start`` (gradients and row sampling), then for every model k
    # ``_part_tree(k)`` (the tree's prologue), waves of the grower, and
    # ``_part_tree_end(k)`` (epilogue, shrinkage, train and valid score
    # updates, the tree written into the batch's stacked buffers). Each
    # reads its iteration's number, keys and shrinkage from ``_in_i`` /
    # ``_in_f``, which the host fills by one device copy per iteration, and
    # none reads a device value on the host (but the linear fit), so on the
    # card each is captured once in a CUDA graph and replayed
    # (``_IterationGraphs``). Eagerly they are the same calls.

    def _prepare(self) -> None:
        """The grower and the iteration's buffers, made once per booster
        (and again after ``add_valid`` or ``reset_config``)."""
        if self._grower is not None:
            return
        dev, K, N = self.device, self.num_models, self.num_rows
        route = [vs.Xb for vs in self.valid_sets]
        if self.residency == "stream":
            self._grower = StreamedGrower(
                self._stream, self.is_cat, self.num_bins, self.missing_code,
                self.default_bin, self.spec, self.comm, self.bundle,
                route=route)
        else:
            self._grower = TreeGrower(
                self.Xb, self.is_cat, self.num_bins, self.missing_code,
                self.default_bin, self.spec, self.comm, self.bundle,
                route=route)
        self._g = torch.zeros((K, N), dtype=torch.float32, device=dev)
        self._h = torch.zeros((K, N), dtype=torch.float32, device=dev)
        # iteration, batch slot, bagging key (2 words), per-model feature
        # keys (2 words each); the shrinkage
        self._in_i = torch.zeros(4 + 2 * K, dtype=torch.int64, device=dev)
        self._in_f = torch.zeros(1, dtype=torch.float32, device=dev)
        # the iteration's non-finite flags (gradients, hessians, leaf
        # outputs), and under raise/skip_iter the state it may be gated to
        self._nf = torch.zeros(3, dtype=torch.bool, device=dev)
        if self._gates:
            self._pre_score = torch.empty_like(self.score)
            self._pre_valid = [torch.empty_like(vs.score)
                               for vs in self.valid_sets]
            self._pre_bag = torch.empty_like(self.bag_mask)
        self._stack = None
        self._graphs = None
        self._publish_cost_reports()

    def _batch_inputs(self, its: List[int], shrinkage: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-iteration inputs of a batch, on the device in one copy:
        int64 ``[n, 4 + 2K]`` rows (see ``_in_i``) and f32 ``[n]``."""
        rows = []
        for j, it in enumerate(its):
            key = prng.fold_in(self._rng_key, it)
            bkey, fkey = prng.split(prng.fold_in(key, 0))
            row = [it, j, *bkey]
            for k in range(self.num_models):
                row += list(prng.fold_in(fkey, k))
            rows.append(row)
        tab_i = torch.tensor(rows, dtype=torch.int64)
        tab_f = torch.full((len(its),), shrinkage, dtype=torch.float32)
        if self.device.type == "cuda":
            # pinned, so the copies do not wait; the caching host allocator
            # keeps each buffer until its copy has run
            tab_i, tab_f = (t.pin_memory().to(self.device, non_blocking=True)
                            for t in (tab_i, tab_f))
        return tab_i, tab_f

    @property
    def _guarded(self) -> bool:
        return self.nan_policy != "none"

    @property
    def _gates(self) -> bool:
        """raise / skip_iter gate a poisoned iteration's outputs back to
        their values before it."""
        return self.nan_policy in ("raise", "skip_iter")

    @trace_entry("boosting.part_start")
    def _part_start(self, it: int) -> None:
        """Gradients and row sampling; the bagging mask is kept in
        ``bag_mask``, the masked models' inputs in ``_g`` / ``_h``. Under
        ``nan_policy`` the gradients' and hessians' flags are taken before
        any clip (gbdt.py:1335-1345 there)."""
        ii = self._in_i
        if self._gates:
            self._pre_score.copy_(self.score)
            for pre, vs in zip(self._pre_valid, self.valid_sets):
                pre.copy_(vs.score)
            self._pre_bag.copy_(self.bag_mask)
        g, h = self._custom_gh if self._custom_gh is not None \
            else self._gradients(self.score)
        if self._guarded:
            self._nf[0].copy_(nonfinite_flag(g))
            self._nf[1].copy_(nonfinite_flag(h))
            self._nf[2].fill_(False)
            if self.nan_policy == "clip":
                g, h = clip_nonfinite(g), clip_nonfinite(h)
        mask, g, h = self._sampling(g, h, self.bag_mask, (ii[2], ii[3]), it)
        self._g.copy_(g)
        self._h.copy_(h)
        if mask is not self.bag_mask:
            self.bag_mask.copy_(mask)

    @trace_entry("boosting.part_tree")
    def _part_tree(self, k: int) -> None:
        """Model ``k``'s tree prologue."""
        ii = self._in_i
        fmask = self._feature_mask_of((ii[4 + 2 * k], ii[5 + 2 * k]))
        mask = self.bag_mask
        self._grower.begin(self._g[k] * mask, self._h[k] * mask, mask, fmask)

    @trace_entry("boosting.part_tree_end")
    def _part_tree_end(self, k: int) -> None:
        """Model ``k``'s tree epilogue: (linear fit,) shrinkage, the train
        score by the grower's leaf ids, every valid score by the leaf ids
        its rows were routed to, and the shrunk tree into slot ``j * K +
        k`` of the batch's stacked buffers."""
        K = self.num_models
        grower = self._grower
        tree, leaf_ids = grower.finish()
        if self.linear_tree:
            # on the masked g/h the tree grew on, before shrinkage
            # (gbdt.py:1369-1380 there)
            tree, n_degraded = fit_linear_leaves(
                tree, *self.raw, leaf_ids, grower.grad, grower.hess,
                grower.included, self.is_cat,
                max_features=self.config.linear_max_features,
                linear_lambda=self.config.linear_lambda)
            self.linear_degraded.append(n_degraded)
        tree = self._shrink(tree, self._in_f[0])
        if self._guarded:
            self._nf[2].logical_or_(nonfinite_flag(tree.leaf_value))
            if self.nan_policy == "clip":
                tree = tree._replace(
                    leaf_value=clip_nonfinite(tree.leaf_value),
                    internal_value=clip_nonfinite(tree.internal_value))
        self.score[k].copy_(self._score_update(
            self.score[k], self._leaf_outputs(tree, leaf_ids, self.raw)))
        for vs, lid in zip(self.valid_sets, grower.state.valid_leaf):
            vs.score[k].copy_(self._score_update(
                vs.score[k], self._leaf_outputs(tree, lid, vs.raw)))
        if self._stack is None:       # first eager tree: never in a capture
            cap = self.tree_batch * K
            self._stack = [None if f is None else torch.empty(
                (cap, *f.shape), dtype=f.dtype, device=f.device)
                for f in tree]
        slot = self._in_i[1:2] * K + k
        for buf, f in zip(self._stack, tree):
            if buf is not None:
                buf.index_copy_(0, slot, f.unsqueeze(0))
        if self._gates and k == K - 1:
            # a poisoned iteration leaves the scores and the bagging mask
            # bit-identical to their values before it (gbdt.py:1398-1410
            # there); its trees stay in the stacked buffers and the host
            # pops their bookkeeping
            bad = self._nf.any()
            self.score.copy_(torch.where(bad, self._pre_score, self.score))
            for pre, vs in zip(self._pre_valid, self.valid_sets):
                vs.score.copy_(torch.where(bad, pre, vs.score))
            self.bag_mask.copy_(torch.where(bad, self._pre_bag,
                                            self.bag_mask))

    def _nan_flags_now(self) -> torch.Tensor:
        """The iteration's flags as the captured runner reads them with
        the grower's, after the last wave of the current tree and before
        its epilogue: the tree's own leaf flag is taken from the grower's
        leaf values, shrunk and transformed as the epilogue will (int64
        [3], eager operations between replays)."""
        tr = self._grower.state.tree
        lv = tr.leaf_value[:self.spec.num_leaves] * self._in_f[0]
        leaf = nonfinite_flag(self._tree_output_transform(
            tr._replace(leaf_value=lv)).leaf_value) | self._nf[2]
        return torch.stack([self._nf[0], self._nf[1], leaf]).long()

    @allowed_host_sync("the nan_policy flag fetch: one read of the "
                       "iteration's non-finite flags, after its trees")
    def _eager_iteration(self, it: int) -> Optional[List[int]]:
        """One iteration eagerly: the parts, and the wave loop reading
        ``done`` after each wave. Returns the iteration's non-finite flags
        under ``nan_policy`` (one more host read), else None."""
        self._part_start(it)
        for k in range(self.num_models):
            self._part_tree(k)
            self._waves_seen[k] = self._grower.run_waves()
            self._part_tree_end(k)
        return [int(f) for f in self._nf.tolist()] if self._guarded \
            else None

    def _capture_blocker(self) -> Optional[str]:
        """Why this booster's iterations run eagerly on the card (None:
        they are captured). The CPU always runs eagerly."""
        if not self._capture:
            return "the eager arm was asked for"
        if self.pctx.multi_process:
            return (f"tree_learner={self.pctx.strategy} across "
                    f"{self.pctx.num_devices} ranks: collectives outside "
                    f"the graphs (ROADMAP A16b)")
        if self.residency == "stream":
            return "tpu_residency=stream: the shard copies are driven from " \
                   "the host"
        if self._custom_gh is not None:
            return ("custom fobj: the gradients come from the host every "
                    "iteration")
        if not self.supports_tree_batch:
            return (f"boosting={self.config.boosting_normalized} keeps host "
                    f"work inside an iteration")
        if self.linear_tree:
            return ("linear_tree: the linear fit walks each leaf's path on "
                    "the host (ops/linear.py:70)")
        return None

    def _run_batch(self, n: int, shrinkage: Optional[float] = None) -> None:
        """``n`` iterations back to back (``n <= tree_batch``): replays of
        the captured parts where the path is captured and an eager
        iteration has run, else eager iterations, each in an ``iteration``
        span. The trees are the same either way; they are pushed after the
        batch."""
        self._prepare()
        K = self.num_models
        its = list(range(self.iter_, self.iter_ + n))
        tab_i, tab_f = self._batch_inputs(
            its, self._step_shrinkage() if shrinkage is None else shrinkage)
        flags = []
        for j, it in enumerate(its):
            with obs.span("iteration", iteration=it):
                if j == n - 1:
                    self._record_undo()
                self._in_i.copy_(tab_i[j])
                self._in_f.copy_(tab_f[j])
                graphs = self._graphs_for_batch()
                if graphs is None:
                    flags.append(self._eager_iteration(it))
                else:
                    flags.append(graphs.iteration(it))
        # the batch's trees: one copy of the stacked buffers, sliced lazily
        frozen = TreeArrays(*[None if f is None else f[:n * K].clone()
                              for f in self._stack])
        for j in range(n):
            self.models.append([TreeArrays(*[
                None if f is None else f[j * K + k] for f in frozen])
                for k in range(K)])
            self._num_leaves.append(frozen.num_leaves[j * K:(j + 1) * K])
        base_iter, base_len = self.iter_, len(self.models) - n
        self.iter_ += n
        self.mutations_ += n
        if self._guarded:
            if n == 1:
                self._apply_nan_policy(flags[0])
            else:
                self._apply_nan_policy_batch(np.array(flags, bool),
                                             base_iter, base_len, n)

    def _graphs_for_batch(self) -> Optional["_IterationGraphs"]:
        """The captured iteration to replay, bound to the booster's
        current scores; None runs the iteration eagerly: on the CPU, on a path
        with host work inside an iteration (logged once), and for the
        first iteration, which also warms every kernel up before any
        capture."""
        if self.device.type != "cuda":
            return None
        reason = self._capture_blocker()
        if reason is not None:
            if reason != self._eager_logged:
                Log.info("not captured: %s; iterations run eagerly", reason)
                self._eager_logged = reason
            return None
        if self._stack is None:
            return None
        if self._graphs is None:
            self._graphs = _IterationGraphs(self)
        self._graphs.bind()
        return self._graphs

    def _record_undo(self) -> None:
        # the scores an iteration replaces, copied: it updates them in place
        self._undo = (self.score.clone(),
                      [vs.score.clone() for vs in self.valid_sets])

    def train_batch(self, n: int) -> None:
        """``n`` boosting iterations (tree_batch; the JAX package's
        ``train_batch``): on a captured path ``n`` replays of the iteration
        back to back, else ``n`` eager iterations, with the same trees.
        Eval and callbacks are the caller's, on batch boundaries.

        Telemetry: a batch of ``m`` is one ``tree_batch`` span holding the
        ``m`` ``iteration`` spans ``_run_batch`` records, where the JAX
        package slices its fused batch evenly (gbdt.py:1760-1770 there)."""
        if self.tree_batch <= 1:      # DART and GOSS keep their own step
            for _ in range(n):
                self.train_one_iter()
            return
        while n > 0:
            m = min(n, self.tree_batch)
            if m == 1:
                self.train_one_iter()
            else:
                with TIMERS("train_step"), obs.span("tree_batch", k=m):
                    self._run_batch(m)
                self._publish_step_cost(m)
            n -= m

    def train_one_iter(self) -> None:
        """One boosting iteration: gradients -> sampling -> grow -> shrink
        -> score updates; one ``tree_batch`` span holding one ``iteration``
        span (gbdt.py:1568-1569 there)."""
        with TIMERS("train_step"), obs.span("tree_batch", k=1):
            self._run_batch(1)
        self._publish_step_cost(1)

    def train_one_iter_custom(self, fobj) -> None:
        """One iteration with user-supplied gradients (reference
        LGBM_BoosterUpdateOneIterCustom, c_api.cpp:892): fobj(preds, dataset)
        -> (grad, hess) as numpy [K*N] in class-major order."""
        K, N = self.num_models, self.num_data
        if self._block_counts is not None:
            # gbdt.py:1883-1886 there
            Log.fatal("custom objectives are not supported with "
                      "is_pre_partition (host gradients need the full score "
                      "vector on every process)")
        with obs.span("tree_batch", k=1, custom_fobj=True):
            preds = self._world_scores().cpu().numpy().reshape(-1)
            grad, hess = fobj(preds, self.train_set)
            self._custom_gh = tuple(
                self._rows_tensor(np.asarray(a, np.float32).reshape(K, N))
                for a in (grad, hess))
            try:
                self._run_batch(1, shrinkage=self.config.learning_rate)
            finally:
                self._custom_gh = None

    def add_base_score(self, raw_scores: np.ndarray,
                       valid_raw: Optional[List[np.ndarray]] = None) -> None:
        """Seed scores with a loaded model's predictions — continued training
        (reference application.cpp:90-93 / boosting.h:281-284)."""
        K, N = self.num_models, self.num_data
        raw = np.asarray(raw_scores, np.float32)
        if self._block_counts is not None:
            # this rank's rows only: the head of its block
            raw = raw.reshape(K, -1)
            add = np.zeros((K, self.num_rows), np.float32)
            add[:, :raw.shape[1]] = raw
            add = torch.as_tensor(add, device=self.device)
        else:
            add = self._rows_tensor(raw.reshape(K, N))
        self.score = self.score + add
        for vi, vs in enumerate(self.valid_sets):
            if valid_raw is not None and vi < len(valid_raw):
                vs.score = vs.score + torch.as_tensor(
                    np.asarray(valid_raw[vi], np.float32).reshape(
                        K, vs.num_data), device=self.device)
        self._undo = None

    def rollback_one_iter(self) -> None:
        """Reference GBDT::RollbackOneIter (gbdt.cpp:475-491): pop the last
        iteration's trees and take their contribution out of every score.
        The last trained iteration restores the scores it replaced bit for
        bit; an earlier one subtracts its trees' walk, as the JAX package
        does."""
        if self.average_output:
            Log.fatal("rollback_one_iter is not supported for rf boosting "
                      "(scores are running averages, not additive)")
        if self.residency == "stream":
            # gbdt.py:1927-1935 there: an earlier iteration's walk needs the
            # resident code matrix; the nan_policy path needs no rollback
            Log.fatal("rollback_one_iter is not supported with "
                      "tpu_residency=stream (no resident code matrix to "
                      "replay leaf assignments from)")
        if not self.models:
            return
        trees = self.models.pop()
        self._num_leaves.pop()
        self.iter_ -= 1
        self.mutations_ += 1
        if self._undo is not None:
            self.score, valid = self._undo
            for vs, v in zip(self.valid_sets, valid):
                vs.score = v
            self._undo = None
            return
        new_scores = []
        for k, tree in enumerate(trees):
            new_scores.append(self.score[k] - self._train_contrib(tree))
            for vs in self.valid_sets:
                vs.score = vs.score.clone()
                vs.score[k] = vs.score[k] + (-self._valid_contrib(tree, vs))
        self.score = torch.stack(new_scores)

    def reset_config(self, new_config: Config) -> None:
        """Apply per-iteration tunable parameters (reference
        LGBM_BoosterResetParameter): learning rate, sampling and the split
        constraints take effect on the next tree; the JAX package retraces
        its step, this port rebuilds its ``GrowerSpec``."""
        check_port_supported(new_config)
        old = self.config
        self.config = new_config
        self.bagging_on = (new_config.bagging_freq > 0
                           and new_config.bagging_fraction < 1.0)
        changes = {}
        for field in ("lambda_l1", "lambda_l2", "min_gain_to_split",
                      "min_sum_hessian_in_leaf", "cat_smooth", "cat_l2",
                      "max_cat_threshold", "max_cat_to_onehot"):
            if getattr(old, field) != getattr(new_config, field):
                changes[field] = getattr(new_config, field)
        for field in ("min_data_in_leaf", "min_data_per_group"):
            if getattr(old, field) != getattr(new_config, field):
                changes[field] = float(getattr(new_config, field))
        if changes:
            self.spec = dataclasses.replace(self.spec, **changes)
        if old.feature_fraction != new_config.feature_fraction:
            F = self.train_set.num_features
            self.n_feature_sample = max(
                1, int(round(new_config.feature_fraction * F)))
            self.use_feature_fraction = (new_config.feature_fraction < 1.0
                                         and self.n_feature_sample < F)
        # the captured parts keep these as constants: capture them anew
        # (the learning rate is an input of every iteration)
        if changes or any(getattr(old, f) != getattr(new_config, f) for f in (
                "feature_fraction", "bagging_fraction", "bagging_freq")):
            self._grower = None

    def _pop_last_iteration(self) -> None:
        """Drop the last iteration's bookkeeping WITHOUT score arithmetic
        (the no-splits pop: its trees contributed nothing)."""
        self.models.pop()
        self._num_leaves.pop()
        self.iter_ -= 1
        self.mutations_ += 1
        self._undo = None

    # ---------------------------------------------------- nan_policy

    def _record_nan_event(self, what: str, iteration: int) -> None:
        """Counters and a trace event per poisoned iteration
        (gbdt.py:1514-1525 there)."""
        from .. import observability as obs
        reg = obs.get_registry()
        reg.counter("nan.events").inc()
        reg.counter({"clip": "nan.clipped", "raise": "nan.raised",
                     "skip_iter": "nan.skipped_iters"}.get(
                         self.nan_policy, "nan.other")).inc()
        obs.event("nan_policy", policy=self.nan_policy, what=what,
                  iteration=int(iteration))

    def _apply_nan_policy(self, flags: List[int]) -> bool:
        """The host leg of the guard for one iteration (gbdt.py:1527-1562
        there): the step already gated its outputs, so recovery pops the
        iteration's bookkeeping. Returns True iff it was dropped."""
        if not any(flags):
            self._consecutive_skips = 0
            return False
        what = ", ".join(n for n, f in zip(FLAG_NAMES, flags) if f)
        self._record_nan_event(what, self.iter_ - 1)
        if self.nan_policy == "clip":
            Log.warning("nan_policy=clip: non-finite %s at iteration %d "
                        "were sanitized (NaN->0, Inf->+/-cap)", what,
                        self.iter_ - 1)
            self._consecutive_skips = 0
            return False
        self._pop_last_iteration()
        if self.nan_policy == "raise":
            raise NonFiniteError(
                f"non-finite {what} detected at iteration {self.iter_} "
                f"(nan_policy=raise); booster state is rolled back to the "
                f"last clean iteration and remains checkpointable")
        self._consecutive_skips += 1
        Log.warning("nan_policy=skip_iter: dropped iteration %d "
                    "(non-finite %s); %d consecutive skip(s)", self.iter_,
                    what, self._consecutive_skips)
        if self._consecutive_skips >= 10:
            raise NonFiniteError(
                f"nan_policy=skip_iter: {self._consecutive_skips} "
                f"consecutive iterations produced non-finite {what} — the "
                f"poison is deterministic, aborting instead of spinning")
        return True

    def _apply_nan_policy_batch(self, flags: np.ndarray, base_iter: int,
                                base_len: int, n: int) -> None:
        """The host leg for a batch of ``n > 1`` iterations
        (gbdt.py:1804-1875 there): a poisoned iteration was gated to a
        no-op; ``skip_iter`` drops its entry but keeps ``iter_`` advanced
        (its draw is consumed), ``raise`` rolls the batch back to the last
        clean iteration."""
        if not flags.any():
            self._consecutive_skips = 0
            return

        def _what(i):
            return ", ".join(nm for nm, f in zip(FLAG_NAMES, flags[i]) if f)

        bad = [int(i) for i in np.nonzero(flags.any(axis=1))[0]]
        for i in bad:
            self._record_nan_event(_what(i), base_iter + i)
        if self.nan_policy == "clip":
            for i in bad:
                Log.warning("nan_policy=clip: non-finite %s at iteration %d "
                            "were sanitized (NaN->0, Inf->+/-cap)",
                            _what(i), base_iter + i)
            self._consecutive_skips = 0
            return
        if self.nan_policy == "raise":
            i = bad[0]
            what = _what(i)
            # trailing clean iterations are rolled back (their trees trained
            # from the gated state and are subtracted); trailing poisoned
            # ones were no-ops whose trees may hold non-finite values, so
            # they are popped without arithmetic; then the first poisoned
            for j in range(n - 1, i, -1):
                if flags[j].any():
                    self._pop_last_iteration()
                else:
                    self.rollback_one_iter()
            self._pop_last_iteration()
            raise NonFiniteError(
                f"non-finite {what} detected at iteration {base_iter + i} "
                f"(nan_policy=raise, tree_batch={n}); booster state is "
                f"rolled back to the last clean iteration and remains "
                f"checkpointable")
        for i in reversed(bad):
            Log.warning("nan_policy=skip_iter: dropped iteration %d "
                        "(non-finite %s)", base_iter + i, _what(i))
            del self.models[base_len + i]
            del self._num_leaves[base_len + i]
        self.mutations_ += 1
        self._undo = None             # the last entry is another iteration
        for i in range(n):
            if flags[i].any():
                self._consecutive_skips += 1
                if self._consecutive_skips >= 10:
                    raise NonFiniteError(
                        f"nan_policy=skip_iter: {self._consecutive_skips} "
                        f"consecutive iterations produced non-finite values "
                        f"— the poison is deterministic, aborting instead "
                        f"of spinning")
            else:
                self._consecutive_skips = 0

    # ------------------------------------------------------ checkpoint

    @allowed_host_sync("checkpoint_state's fetch of the per-row state, "
                       "once per checkpoint")
    def _world_rows_host(self, t: torch.Tensor) -> np.ndarray:
        """A ``[..., num_rows]`` per-row tensor as the world's padded layout
        ``[..., num_data_padded]`` on the host (an all-gather of the ranks'
        blocks under data / voting; the tensor itself otherwise)."""
        if self._row_sharded:
            t = self._gather_rows(t)
        return t.cpu().numpy().astype(np.float32)

    def checkpoint_state(self) -> Dict:
        """Every array and counter an iteration reads or writes, as host
        values of builtins and numpy (gbdt.py:2153-2184 there): scores, the
        bagging mask, the raw threefry key, the forest as one dict of
        arrays per tree, the leaf counts, the counters and the valid
        scores, with the world it was written in (``n_devices``,
        ``tree_learner``, ``block_layout``). Per-row state is the world's
        padded layout on every rank: in a world the ranks' blocks are
        all-gathered (a collective, so every rank calls this at the same
        boundary), so each rank's gang shard holds the global scores and a
        resume at another world size re-lays them out from any one shard."""
        def tree_dict(t: TreeArrays) -> Dict:
            return {f: None if a is None else a.cpu().numpy()
                    for f, a in zip(t._fields, t)}
        return {
            "iter": int(self.iter_),
            "data_fingerprint": self._data_fingerprint,
            "mutations": int(self.mutations_),
            "consecutive_skips": int(self._consecutive_skips),
            "num_data": int(self.num_data),
            "num_data_padded": int(self.num_data_padded),
            "num_models": int(self.num_models),
            "n_devices": int(self.pctx.num_devices),
            "tree_learner": self.pctx.strategy,
            "block_layout": (None if self._block_counts is None
                             else list(self._block_counts)),
            "init_score_value": float(self.init_score_value),
            "score": self._world_rows_host(self.score),
            "bag_mask": self._world_rows_host(self.bag_mask),
            "rng_key": np.asarray(self._rng_key, np.uint32),
            "models": [[tree_dict(t) for t in it_trees]
                       for it_trees in self.models],
            "num_leaves": [nl.cpu().numpy() for nl in self._num_leaves],
            "valid_scores": {vs.name: vs.score.cpu().numpy()
                             for vs in self.valid_sets},
            "best_iteration": int(self.best_iteration),
        }

    def restore_checkpoint_state(self, state: Dict) -> None:
        """Replay a snapshot into this booster (gbdt.py:2186-2290 there).
        A snapshot of another world size is refused loudly unless
        ``tpu_reshard_on_resume`` (and, for a gang directory, ``elastic``)
        allows the re-layout: the state is the world's (scores and masks in
        the padded layout of all rows, trees replicated), so its real rows
        are laid out onto this world's row blocks and this rank takes its
        block. A strategy change at the same world size, a pre-partitioned
        snapshot at another, and another shape or dataset are refused.
        Scores, valid scores and the bagging mask are copied into the
        booster's buffers (captured graphs replay fixed addresses), and the
        next iteration runs as a booster's first: eagerly, then captured."""
        D = int(self.pctx.num_devices)
        saved_d = state.get("n_devices")
        reshard = saved_d is not None and int(saved_d) != D
        if reshard:
            if not self.config.tpu_reshard_on_resume:
                Log.fatal(
                    "checkpoint/mesh mismatch: the snapshot was written on "
                    "%d device(s) (tree_learner=%s) but this booster runs "
                    "on %d (%s) — sharded training state does not resume "
                    "across device counts. Rerun on the original world, or "
                    "set tpu_reshard_on_resume=true to re-lay the global "
                    "state out deliberately", int(saved_d),
                    state.get("tree_learner", "?"), D, self.pctx.strategy)
            if state.get("block_layout") or self._block_counts is not None:
                Log.fatal(
                    "tpu_reshard_on_resume: pre-partitioned snapshots hold "
                    "per-process row blocks and cannot re-shard — resume on "
                    "the original process count")
            Log.warning("tpu_reshard_on_resume: re-laying out checkpoint "
                        "state written on %d device(s) onto %d (%s)",
                        int(saved_d), D, self.pctx.strategy)
        saved_tl = state.get("tree_learner")
        if saved_tl is not None and saved_tl != self.pctx.strategy \
                and not reshard:
            Log.fatal(
                "checkpoint/learner mismatch: the snapshot was written "
                "under tree_learner=%s but this booster runs %s on the "
                "same device count — resume needs the same tree_learner "
                "(a strategy change is only honored through an elastic "
                "reshard: device count change + tpu_reshard_on_resume=true)",
                saved_tl, self.pctx.strategy)
        checks = [("num_data", self.num_data),
                  ("num_models", self.num_models)]
        if not reshard:
            checks.append(("num_data_padded", self.num_data_padded))
        for name, mine in checks:
            if int(state[name]) != int(mine):
                Log.fatal("checkpoint/booster mismatch: %s is %d in the "
                          "snapshot but %d here — resume needs the same "
                          "dataset and training config", name,
                          int(state[name]), int(mine))
        fp = state.get("data_fingerprint")
        if fp and fp != self._data_fingerprint:
            Log.fatal("checkpoint/dataset mismatch: the snapshot was written "
                      "against different training data (binned-code/label "
                      "fingerprint differs) — a shape-compatible but "
                      "different dataset would silently corrupt the resumed "
                      "model")

        def local_rows(arr) -> np.ndarray:
            # the world's padded layout -> this rank's block; under a
            # reshard the real rows (at the head: pre-partitioned layouts
            # were refused above) are laid out anew, padding zero (padding
            # rows carry no signal: they are never included)
            arr = np.asarray(arr, np.float32)
            if arr.shape[-1] != self.num_data_padded:
                arr = self._row_layout(arr[..., :self.num_data])
            r0 = self._row0
            return np.ascontiguousarray(arr[..., r0:r0 + self.num_rows])

        dev = self.device

        def put(a):
            return torch.as_tensor(np.asarray(a), device=dev)
        self.score.copy_(put(local_rows(state["score"])))
        self.bag_mask.copy_(put(local_rows(state["bag_mask"])))
        self._rng_key = tuple(int(w) for w in np.asarray(state["rng_key"]))
        self.models = [[TreeArrays(**{f: None if a is None else put(a)
                                      for f, a in t.items()})
                        for t in it_trees] for it_trees in state["models"]]
        self._num_leaves = [put(nl) for nl in state["num_leaves"]]
        self.iter_ = int(state["iter"])
        # restored iterations were trained (and counted) by the run that
        # wrote the snapshot: telemetry counts only what this run adds
        self._telemetry_iters_base = len(self.models)
        self.mutations_ = int(state["mutations"])
        self._consecutive_skips = int(state.get("consecutive_skips", 0))
        self.init_score_value = float(state["init_score_value"])
        self.best_iteration = int(state.get("best_iteration", 0))
        self._undo = None
        restored = state.get("valid_scores", {})
        for vs in self.valid_sets:
            if vs.name in restored:
                vs.score.copy_(put(np.asarray(restored[vs.name],
                                              np.float32)))
            else:
                Log.warning("checkpoint has no saved scores for valid set "
                            "%r — its eval scores restart from the initial "
                            "model", vs.name)
        # rebuilt at the next iteration, which runs eagerly and captures
        self._grower = None

    @allowed_host_sync("at an eval boundary: the last iterations' leaf "
                       "counts, read beside the metrics")
    def _check_no_splits(self) -> bool:
        """Reference gbdt.cpp:465-471: pop the trailing iterations whose
        trees could not split and report whether training should stop. The
        leaf counts stay on the device until this reads them."""
        popped = False
        while self._num_leaves and \
                all(n <= 1 for n in self._num_leaves[-1].tolist()):
            self._pop_last_iteration()
            popped = True
        if popped:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements.")
        return popped

    # -------------------------------------------------------------- eval

    def _convert(self, score):
        if self.objective is None or self.average_output:
            # RF scores are already averages of converted outputs (rf.hpp)
            return score
        return self.objective.convert_output(score)

    def eval_all(self, force_training: bool = False,
                 only: Optional[str] = None
                 ) -> List[Tuple[str, str, float, bool]]:
        """``_eval_all`` in an ``eval`` span (gbdt.py:2077 there)."""
        with TIMERS("metric_eval"), obs.span("eval", only=only):
            return self._eval_all(force_training, only)

    @allowed_host_sync("the metric values, one fetch per eval boundary")
    def _eval_all(self, force_training: bool = False,
                  only: Optional[str] = None
                  ) -> List[Tuple[str, str, float, bool]]:
        """Metric values of the training set (when ``is_training_metric``
        or ``force_training``) and every valid set; ``only`` names one
        dataset. The pointwise family reduces on the device in f32 and
        fetches one scalar per metric (all in one transfer); AUC and the
        other metrics fetch the converted scores and run on the host. Each
        fetch runs in an ``eval.fetch`` span, each host metric in an
        ``eval.metric`` span."""
        out: List[list] = []
        pending: List[Tuple[int, torch.Tensor]] = []

        def eval_dataset(dname, metrics, score, label, weight, fetch_conv):
            conv_dev = conv_host = None
            for m in metrics:
                if (isinstance(m, _PointwiseRegressionMetric)
                        and self.num_models == 1):
                    if conv_dev is None:
                        conv_dev = self._convert(score)
                    loss = m.loss(conv_dev[0], label)
                    val = loss.mean() if weight is None \
                        else (loss * weight).sum() / weight.sum()
                    out.append([dname, m.name, None, m.is_higher_better, m])
                    pending.append((len(out) - 1, val))
                else:
                    if conv_host is None:
                        with obs.span("eval.fetch"):
                            conv_host = fetch_conv()
                    with obs.span("eval.metric", metric=m.name):
                        vals = m.eval(conv_host)
                    for name, value, hib in vals:
                        out.append([dname, name, value, hib, None])

        train_eval = (self.config.is_training_metric or force_training) \
            and self.train_metrics and only in (None, "training")
        if train_eval and self._row_sharded:
            # the world's scores on every rank, every metric on the host in
            # f64, so that every rank takes the same decisions
            with obs.span("eval.fetch"):
                conv = self._convert(self._world_scores()).cpu().numpy()
            for m in self.train_metrics:
                with obs.span("eval.metric", metric=m.name):
                    vals = m.eval(conv)
                for name, value, hib in vals:
                    out.append(["training", name, value, hib, None])
        elif train_eval:
            # the JAX package weighs the training rows by its padding mask
            w = self.pad_mask if self.weight is None \
                else self.weight * self.pad_mask
            eval_dataset("training", self.train_metrics, self.score,
                         self.label, w,
                         lambda: self._convert(self.score).cpu().numpy())
        for vs in self.valid_sets:
            if only is not None and vs.name != only:
                continue
            if vs.label_dev is None:
                vs.label_dev = torch.as_tensor(vs.metadata.label,
                                               dtype=torch.float32,
                                               device=self.device)
                w = vs.metadata.weight
                vs.weight_dev = None if w is None else torch.as_tensor(
                    w, dtype=torch.float32, device=self.device)
            eval_dataset(vs.name, vs.metrics, vs.score, vs.label_dev,
                         vs.weight_dev,
                         lambda vs=vs: self._convert(vs.score).cpu().numpy())
        if pending:
            with obs.span("eval.fetch"):
                fetched = torch.stack([v for _, v in pending]).cpu().tolist()
            for (i, _), raw in zip(pending, fetched):
                out[i][2] = out[i][4].transform(float(raw))
        return [(d, n, v, h) for (d, n, v, h, _m) in out]

    # ------------------------------------------------------------- telemetry

    @allowed_host_sync("publish_telemetry's leaf-count fetch, once per "
                       "run")
    def publish_telemetry(self) -> None:
        """This booster's per-run training facts into the telemetry
        subsystem (gbdt.py:2305-2345 there; ``engine.train`` calls it once,
        after the loop): ``trees.trained`` / ``rows.routed`` always; with
        span recording on, ONE batched fetch of the new iterations' leaf
        counts derives each tree's wave count (``grower.waves_for_tree``)
        into the ``wave`` children of the recorded ``iteration`` spans and
        the ``tree.waves`` / ``tree.leaves`` histograms. The captured
        iteration's part times still pending and its replay counts go to
        the registry (``_IterationGraphs.publish``)."""
        reg = obs.get_registry()
        if self._graphs is not None:
            self._graphs.publish()
        base = min(self._telemetry_iters_base, len(self.models))
        n_new = len(self.models) - base
        self._telemetry_iters_base = len(self.models)
        if n_new:
            reg.counter("trees.trained").inc(n_new * self.num_models)
            reg.counter("rows.routed").inc(
                n_new * self.num_models * self.num_data)
        if not obs.enabled() or not n_new:
            return
        leaves = torch.stack(self._num_leaves[base:]).cpu().numpy()
        wave_hist = reg.histogram("tree.waves")
        leaf_hist = reg.histogram("tree.leaves")
        counts = []
        for nl in leaves:
            # the K trees of an iteration grow one after the other; the
            # iteration's count is the deepest tree's, as the JAX package
            # records it
            counts.append(max(waves_for_tree(int(v), self.spec.wave_size,
                                             self.spec.hist_slots)
                              for v in nl))
            wave_hist.observe(counts[-1])
            for v in nl:
                leaf_hist.observe(int(v))
        obs.get_tracer().derive_children("iteration", "wave", counts)

    def _publish_cost_reports(self) -> None:
        """The analytic cost reports of this booster's shape classes
        (``observability/costs.py``), once each, host arithmetic: B1's
        full wave (``histogram.full.s<S>``) and, with linear leaves, the
        fit (``linear.fit.k<K>``). Gated on ``costs.enabled()``."""
        if not obs_costs.enabled():
            return
        g = self._grower
        X = g.X_hist if self.residency != "stream" else None
        F = X.shape[1] if X is not None else self._stream_store.num_cols
        cb = X.element_size() if X is not None \
            else np.dtype(self._stream_store.dtype).itemsize
        histogram_cost_report(self.num_rows, F, g.B_hist,
                              self.spec.hist_slots, cb,
                              route=self.kernel_route, force=False)
        if self.linear_tree:
            linear_cost_report(self.num_rows, self.raw[0].shape[1],
                               self.spec.num_leaves,
                               self.config.linear_max_features,
                               route=self.kernel_route, force=False)

    def _publish_step_cost(self, batch: int) -> None:
        """The iteration's report, ``train_step.k<batch>``: arguments the
        per-row state an iteration reads, outputs the stacked trees of the
        batch, temps the bytes the allocator reserved across the capture
        of the CUDA graphs (None where nothing was captured). Republished
        when a capture adds graphs; no device traffic."""
        if not obs_costs.enabled() or self._grower is None:
            return
        r = self._graphs
        fp = (batch, 0 if r is None else len(r.graphs),
              0 if r is None else r.pool_bytes)

        def make():
            args = obs_costs.tensor_bytes(
                self.Xb, self.label, self.weight, self.pad_mask,
                self.bag_mask, self.score, self._g, self._h,
                *[t for vs in self.valid_sets for t in (vs.Xb, vs.score)])
            out = obs_costs.tensor_bytes(*[f for f in (self._stack or ())
                                           if f is not None])
            out = out * batch // max(self.tree_batch, 1)
            return obs_costs.analytic_report(
                f"train_step.k{batch}",
                dict(rows=int(self.num_data), rows_padded=int(
                    self.num_data_padded),
                     features=int(self.spec.num_features),
                     num_leaves=int(self.spec.num_leaves),
                     hist_slots=int(self.spec.hist_slots),
                     tree_batch=int(batch), num_models=int(self.num_models),
                     kernel=self.kernel_route, strategy=self.pctx.strategy,
                     n_devices=int(self.pctx.num_devices),
                     captured_graphs=fp[1]),
                argument_bytes=args, output_bytes=out,
                temp_bytes=None if r is None else r.pool_bytes)
        obs_costs.capture(f"train_step.k{batch}", make, fingerprint=fp)

    # ------------------------------------------------------------- model

    def finalize_model(self) -> List[List[Tree]]:
        """Fetch the device trees to host Trees; fold the boost-from-average
        bias into the first iteration's trees (gbdt.cpp:445-447)."""
        mappers = self.train_set.mappers
        rfi = self.train_set.real_feature_idx
        with TIMERS("finalize_fetch"):
            host = [[TreeArrays(*[None if f is None else f.cpu().numpy()
                                  for f in t]) for t in it_trees]
                    for it_trees in self.models]
        forest: List[List[Tree]] = []
        for it_trees in host:
            forest.append([tree_from_device_arrays(t, mappers, rfi)
                           for t in it_trees])
        if forest and abs(self.init_score_value) > 1e-15:
            for t in forest[0]:
                t.add_bias(self.init_score_value)
        return forest


class _IterationGraphs:
    """A booster's iteration on the card as CUDA graphs, captured at first
    use into one private memory pool and replayed: ``start`` (two variants:
    with and without a bagging draw), per model ``tree`` and ``end``, and
    one ``wave``. Every tensor a graph reads or writes lives outside the
    pool, in buffers that keep their addresses (the booster's scores and
    bagging mask, ``_in_i`` / ``_in_f``, ``_g`` / ``_h``, the grower's
    state, the stacked trees), so graphs may share the pool and replay in
    any order.

    The waves of a tree are replayed speculatively: as many as the model's
    last tree needed, then the host reads the grower's ``flags`` (leaves,
    done, waves) through a pinned buffer, its one sync per tree, and
    replays more while the tree is not done. A wave after ``done`` applies
    nothing, so no wave count is assumed for correctness.

    While spans are recorded (``observability.enabled()``), each replayed
    iteration's parts are timed on the device by ``_PartClock``: ``start``
    (gradients and sampling), per tree its ``prologue``, its rounds of
    ``waves`` and its ``epilogue``. The flag reads run in
    ``iteration.flags`` spans."""

    # the counts ``publish`` mirrors into the registry
    MIRRORED = ("waves_run", "waves_needed", "trees")

    def __init__(self, gbdt: "GBDT"):
        self.gbdt = gbdt
        self.pool = None
        self.graphs = {}
        self.guess = list(gbdt._waves_seen)
        self.flags_host = None
        self.ready = None
        self.clock = _PartClock()
        self._timing = False          # the current iteration is timed
        # the scores the graphs bind to
        self.score = gbdt.score.clone()
        self.valid_scores = [vs.score.clone() for vs in gbdt.valid_sets]
        # measurements read by chip_smoke.py
        self.capture_s = 0.0          # Python capture of every graph
        self.instantiate_s = 0.0      # cudaGraphInstantiate at capture end
        # device bytes the caching allocator reserved across the captures
        # (the graphs' private pool): the captured iteration's temps in
        # its cost report; read from the allocator's stats, no device sync
        self.pool_bytes = 0
        self.replays = 0
        self.captures = 0             # graphs captured (analysis.guards)
        self.syncs = 0
        self.trees = 0
        self.waves_run = 0            # wave replays, no-op waves included
        self.waves_needed = 0         # waves the trees needed
        self._published = dict.fromkeys(self.MIRRORED, 0)

    def bind(self) -> None:
        """Point the booster at the graphs' buffers, copying in whatever
        replaced them since (a rollback, a continued-training seed)."""
        gb = self.gbdt
        if gb.score is not self.score:
            self.score.copy_(gb.score)
            gb.score = self.score
        for vs, buf in zip(gb.valid_sets, self.valid_scores):
            if vs.score is not buf:
                buf.copy_(vs.score)
                vs.score = buf

    def _capture(self, key, fn):
        """Capture ``fn`` into a CUDA graph (nothing runs) and return it."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        dev = self.gbdt.device
        reserved0 = torch.cuda.memory_stats(dev).get(
            "reserved_bytes.all.current", 0)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(g, pool=self.pool):
                fn()
                t1 = time.perf_counter()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the iteration's "
                               f"{key} part failed: {e}") from e
        self.capture_s += t1 - t0
        self.instantiate_s += time.perf_counter() - t1
        self.pool_bytes += max(0, torch.cuda.memory_stats(dev).get(
            "reserved_bytes.all.current", 0) - reserved0)
        self.captures += 1
        return g

    @allowed_host_sync("the captured iteration's one flag read per tree")
    def _read_flags(self, flags: torch.Tensor) -> List[int]:
        """The grower's flags (and under ``nan_policy`` the iteration's
        non-finite flags) on the host: the tree's one sync. Its ``ready``
        event closes the round of waves on the part clock, which reads its
        pending times behind the wait."""
        with obs.span("iteration.flags"):
            if self.flags_host is None or \
                    self.flags_host.numel() != flags.numel():
                self.flags_host = torch.empty(flags.numel(),
                                              dtype=torch.int64,
                                              pin_memory=True)
                self.ready = torch.cuda.Event(enable_timing=True)
            self.flags_host.copy_(flags, non_blocking=True)
            self.ready.record()
            self._mark("waves", event=self.ready)
            self.ready.synchronize()
            self.clock.drain()
            return self.flags_host.tolist()

    def _replay(self, key, fn) -> None:
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, fn)
        g.replay()
        self.replays += 1

    def iteration(self, it: int) -> Optional[List[int]]:
        """Replay one iteration; returns its non-finite flags under
        ``nan_policy`` (read with the last tree's flags), else None."""
        gb = self.gbdt
        K = gb.num_models
        # a graph keeps what its capture saw: the variant of ``it``, ``k``
        start = ("start", gb._draws_bag(it))
        # timed only where every part replays without a capture, whose
        # host seconds would land in its segment
        self._timing = obs.enabled() and gb.device.type == "cuda" and \
            start in self.graphs and "wave" in self.graphs and \
            all(("tree", k) in self.graphs and ("end", k) in self.graphs
                for k in range(K))
        self._mark(None)
        self._replay(start, functools.partial(gb._part_start, it))
        self._mark("start")
        nan_flags = None
        for k in range(K):
            self._replay(("tree", k), functools.partial(gb._part_tree, k))
            self._mark("prologue")
            nan_flags = self._waves(k)
            self._mark(None)                  # past the flag read's wait
            self._replay(("end", k), functools.partial(gb._part_tree_end, k))
            self._mark("epilogue", end=k == K - 1)
        return nan_flags

    def _mark(self, part: Optional[str], end: bool = False,
              event=None) -> None:
        """The part clock's mark after a replay, in a timed iteration."""
        if self._timing:
            self.clock.mark(part, end, event)

    def _waves(self, k: int) -> Optional[List[int]]:
        gb = self.gbdt
        flags = gb._grower.state.flags
        n = self.guess[k]
        while True:
            self._mark(None)                  # the round's start
            for _ in range(n):
                self._replay("wave", gb._grower.wave)
            self.waves_run += n
            read = flags if not gb._guarded else torch.cat(
                [flags, gb._nan_flags_now()])
            vals = self._read_flags(read)
            self.syncs += 1
            _, done, waves = vals[:3]
            if done:
                break
            n = max(1, self.guess[k] // 4)
        self.guess[k] = waves
        self.waves_needed += waves
        self.trees += 1
        return [int(f) for f in vals[3:]] if gb._guarded else None

    def publish(self) -> None:
        """At a run's end: the part times still pending, and this
        booster's new replay counts as the ``iteration.waves_run`` /
        ``.waves_needed`` / ``.trees`` counters, which outlive it."""
        self.clock.finish()
        reg = obs.get_registry()
        for name in self.MIRRORED:
            now = getattr(self, name)
            reg.counter(f"iteration.{name}").inc(now - self._published[name])
            self._published[name] = now


class _PartClock:
    """Device milliseconds of the captured iteration's parts, from timing
    events recorded on the stream between the replays, never inside a
    graph. Each mark closes the segment from the mark before it: a part's
    segment adds to that part, a ``None`` one (the host's time past a flag
    read, the next iteration's inputs) to nothing. Events are read only
    where the host has already waited past them: after a flag read
    (``drain``) and after the run (``finish``), so timing adds no host
    sync to the iteration. An iteration's ``end`` mark publishes it as one
    observation of each ``iteration.device_ms.<part>`` histogram and one
    ``iteration.timed``. The clock's own events return to a small pool; a
    mark may instead adopt an event its caller recorded (the flag read's
    ``ready``)."""

    PARTS = ("start", "prologue", "waves", "epilogue")

    def __init__(self):
        self._free: List[torch.cuda.Event] = []
        # (part or None, event, end, pooled), oldest first
        self._chain: List[tuple] = []
        self._iter = dict.fromkeys(self.PARTS, 0.0)

    def mark(self, part: Optional[str] = None, end: bool = False,
             event=None) -> None:
        pooled = event is None
        if pooled:
            event = self._free.pop() if self._free \
                else torch.cuda.Event(enable_timing=True)
            event.record()
        self._chain.append((part, event, end, pooled))

    def drain(self) -> None:
        """Add every segment of the chain, whose marks the host has waited
        past. The mark after a drain is a ``None`` one, so no segment
        spans a drain."""
        chain = self._chain
        for (_, a, _, _), (part, b, end, _) in zip(chain, chain[1:]):
            if part is not None:
                self._iter[part] += a.elapsed_time(b)
            if end:
                reg = obs.get_registry()
                for p, ms in self._iter.items():
                    reg.histogram(f"iteration.device_ms.{p}").observe(ms)
                reg.counter("iteration.timed").inc()
                self._iter = dict.fromkeys(self.PARTS, 0.0)
        self._free.extend(ev for _, ev, _, pooled in chain if pooled)
        self._chain = []

    @allowed_host_sync("the part clock's last event, once per run")
    def finish(self) -> None:
        """Read what is still pending: the last iteration's epilogue."""
        if self._chain:
            self._chain[-1][1].synchronize()
            self.drain()


def create_boosting(config: Config, train_set: ConstructedDataset) -> GBDT:
    """Factory (reference: boosting.cpp:42-66)."""
    btype = config.boosting_normalized
    if btype == "gbdt":
        return GBDT(config, train_set)
    if btype == "goss":
        from .goss import GOSS
        return GOSS(config, train_set)
    if btype == "dart":
        from .dart import DART
        return DART(config, train_set)
    if btype == "rf":
        from .rf import RF
        return RF(config, train_set)
    Log.fatal("Unknown boosting type %s", config.boosting_type)
