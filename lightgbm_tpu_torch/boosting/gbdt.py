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
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_port_supported, resolve_device
from ..dataset import ConstructedDataset, Metadata, MetadataDuckTyping
from ..grower import BundleDecode, GrowerSpec, TreeArrays, TreeGrower
from ..metrics import Metric, _PointwiseRegressionMetric, create_metrics
from ..objectives import create_objective
from ..ops.cuda_histogram import feature_groups
from ..ops.linear import fit_linear_leaves, linear_leaf_scores
from ..ops.predict import leaves_from_binned
from ..parallel.comm import SerialComm
from ..tree import Tree, tree_from_device_arrays
from ..utils import prng
from ..utils.log import Log


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


def _codes_tensor(codes: np.ndarray, device) -> torch.Tensor:
    codes = np.ascontiguousarray(codes)
    if codes.dtype == np.uint16:
        # PyTorch gathers int16 but not uint16. On the card every code is
        # below the kernel's bin limit (checked in GBDT.__init__), far below
        # 2**15; on the CPU the plain version refuses a code of 2**15 or more.
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
        self.device = resolve_device(config)
        self.objective = create_objective(config)   # None: objective=none
        self.num_models = self.objective.num_models if self.objective \
            else max(config.num_class, 1)
        K = self.num_models
        N = train_set.num_data
        F = train_set.num_features
        self.num_data = N
        md = train_set.metadata
        if self.objective is not None:
            self.objective.init(md, N)

        meta = train_set.feature_meta_arrays()
        self.spec = self._make_spec(config, F, train_set.max_num_bin,
                                    meta["is_categorical"])
        self.comm = SerialComm(F)
        dev = self.device
        codes = self._plan_bundles(config, train_set, meta)
        if dev.type == "cuda":
            try:            # the histogram kernel's shared-memory limit
                feature_groups(codes.shape[1], self.spec.hist_bins
                               or self.spec.num_bins_padded)
            except ValueError as e:
                Log.fatal("max_bin=%d: %s; not ported to lightgbm_tpu_torch "
                          "yet (ROADMAP B1)", config.max_bin, e)
        self.Xb = _codes_tensor(codes, dev)
        del codes
        self._setup_linear(config, train_set)
        self.label = torch.as_tensor(md.label, dtype=torch.float32,
                                     device=dev)
        self.weight = None if md.weight is None else torch.as_tensor(
            md.weight, dtype=torch.float32, device=dev)
        self.pad_mask = torch.ones(N, dtype=torch.float32, device=dev)
        self.num_bins = torch.as_tensor(meta["num_bins"], device=dev)
        self.missing_code = torch.as_tensor(meta["missing_code"], device=dev)
        self.default_bin = torch.as_tensor(meta["default_bin"], device=dev)
        self.is_cat = torch.as_tensor(meta["is_categorical"], device=dev)
        self.feature_ok = torch.ones(F, dtype=torch.bool, device=dev)

        # feature_fraction: number of features used per tree (gbdt.py:756)
        self.n_feature_sample = max(1, int(round(config.feature_fraction * F)))
        self.use_feature_fraction = (config.feature_fraction < 1.0
                                     and self.n_feature_sample < F)

        self.train_metrics = create_metrics(config, self._objective_name())
        for m in self.train_metrics:
            m.init(md, N)
        self.valid_sets: List[ValidSet] = []

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
        self.score = torch.as_tensor(base, device=dev)

        self.models: List[List[TreeArrays]] = []
        # per iteration, the K trees' leaf counts: an i32 [K] device tensor
        self._num_leaves: List[torch.Tensor] = []
        self.iter_ = 0
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
        self.tree_batch = tb
        self._grower: Optional[TreeGrower] = None
        self._graphs: Optional[_IterationGraphs] = None
        self._stack = None
        self._custom_gh = None
        self._eager_logged: Optional[str] = None
        # waves the last eager tree of each model needed (the first guess
        # of a replayed tree's wave count)
        self._waves_seen = [1] * K

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

    def _plan_bundles(self, config: Config, train_set: ConstructedDataset,
                      meta) -> np.ndarray:
        """EFB set-up (gbdt.py:184-275 and :435-460 there): plan, decide,
        and when bundling, put the ``BundleDecode`` tables on the device and
        set ``spec.hist_bins``. Returns the code matrix to train on."""
        from ..efb import build_code_feat, plan_bundles
        self.bundle: Optional[BundleDecode] = None
        self.efb_plan = None          # the kept plan, its codes dropped
        self.efb_wins = None          # whether a plan won the rule
        F = train_set.num_features
        if config.enable_bundle == "false" or F < 2:
            return train_set.X_binned
        nb = meta["num_bins"].astype(np.int64)
        db = meta["default_bin"].astype(np.int64)
        plan = plan_bundles(train_set.X_binned, nb, db, config)
        if plan is None:
            return train_set.X_binned
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
            return train_set.X_binned
        codes = plan.X_bundled
        plan.X_bundled = None
        self.efb_plan = plan
        dev = self.device
        ub = np.pad(plan.unpack_bin,
                    ((0, 0), (0, Bpad - plan.unpack_bin.shape[1])),
                    constant_values=-1)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev)
        self.bundle = BundleDecode(
            col=put(plan.col), lo=put(plan.lo), hi=put(plan.hi),
            off=put(plan.off), unpack_bin=put(ub),
            code_feat=put(build_code_feat(plan, G, Bb_pad, db)))
        self.spec = dataclasses.replace(self.spec, hist_bins=Bb_pad)
        Log.info("EFB: %d features bundled into %d columns (%d max bundle "
                 "bins, %s codes), scan=bundle-space", F, G,
                 plan.max_bundle_bins, codes.dtype)
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
        vs = ValidSet(name, _codes_tensor(binned, self.device), metadata,
                      metrics, nv)
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
        return self.objective.gradients(score, self.label, self.weight)

    def _bag_mask_for_iter(self, key, it: int, prev_mask):
        """The bagging mask, drawn anew every ``bagging_freq`` iterations
        (gbdt.cpp:225-270; mask-based Bernoulli, as the JAX package)."""
        if not self._draws_bag(it):
            return prev_mask if self.bagging_on else self.pad_mask
        u = prng.uniform(key, self.num_data, self.device)
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
        noise = prng.uniform(key, self.spec.num_features, self.device)
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
        dev, K, N = self.device, self.num_models, self.num_data
        self._grower = TreeGrower(
            self.Xb, self.is_cat, self.num_bins, self.missing_code,
            self.default_bin, self.spec, self.comm, self.bundle,
            route=[vs.Xb for vs in self.valid_sets])
        self._g = torch.zeros((K, N), dtype=torch.float32, device=dev)
        self._h = torch.zeros((K, N), dtype=torch.float32, device=dev)
        # iteration, batch slot, bagging key (2 words), per-model feature
        # keys (2 words each); the shrinkage
        self._in_i = torch.zeros(4 + 2 * K, dtype=torch.int64, device=dev)
        self._in_f = torch.zeros(1, dtype=torch.float32, device=dev)
        self._stack = None
        self._graphs = None

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

    def _part_start(self, it: int) -> None:
        """Gradients and row sampling; the bagging mask is kept in
        ``bag_mask``, the masked models' inputs in ``_g`` / ``_h``."""
        ii = self._in_i
        g, h = self._custom_gh if self._custom_gh is not None \
            else self._gradients(self.score)
        mask, g, h = self._sampling(g, h, self.bag_mask, (ii[2], ii[3]), it)
        self._g.copy_(g)
        self._h.copy_(h)
        if mask is not self.bag_mask:
            self.bag_mask.copy_(mask)

    def _part_tree(self, k: int) -> None:
        """Model ``k``'s tree prologue."""
        ii = self._in_i
        fmask = self._feature_mask_of((ii[4 + 2 * k], ii[5 + 2 * k]))
        mask = self.bag_mask
        self._grower.begin(self._g[k] * mask, self._h[k] * mask, mask, fmask)

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

    def _eager_iteration(self, it: int) -> None:
        """One iteration eagerly: the parts, and the wave loop reading
        ``done`` after each wave."""
        self._part_start(it)
        for k in range(self.num_models):
            self._part_tree(k)
            self._waves_seen[k] = self._grower.run_waves()
            self._part_tree_end(k)

    def _capture_blocker(self) -> Optional[str]:
        """Why this booster's iterations run eagerly on the card (None:
        they are captured). The CPU always runs eagerly."""
        if not self._capture:
            return "the eager arm was asked for"
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
        iteration has run, else eager iterations. The trees are the same
        either way; they are pushed after the batch."""
        self._prepare()
        K = self.num_models
        its = list(range(self.iter_, self.iter_ + n))
        tab_i, tab_f = self._batch_inputs(
            its, self._step_shrinkage() if shrinkage is None else shrinkage)
        for j, it in enumerate(its):
            if j == n - 1:
                self._record_undo()
            self._in_i.copy_(tab_i[j])
            self._in_f.copy_(tab_f[j])
            graphs = self._graphs_for_batch()
            if graphs is None:
                self._eager_iteration(it)
            else:
                graphs.iteration(it)
        # the batch's trees: one copy of the stacked buffers, sliced lazily
        frozen = TreeArrays(*[None if f is None else f[:n * K].clone()
                              for f in self._stack])
        for j in range(n):
            self.models.append([TreeArrays(*[
                None if f is None else f[j * K + k] for f in frozen])
                for k in range(K)])
            self._num_leaves.append(frozen.num_leaves[j * K:(j + 1) * K])
        self.iter_ += n
        self.mutations_ += n

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
        Eval and callbacks are the caller's, on batch boundaries."""
        if self.tree_batch <= 1:      # DART and GOSS keep their own step
            for _ in range(n):
                self.train_one_iter()
            return
        while n > 0:
            m = min(n, self.tree_batch)
            self._run_batch(m)
            n -= m

    def train_one_iter(self) -> None:
        """One boosting iteration: gradients -> sampling -> grow -> shrink
        -> score updates."""
        self._run_batch(1)

    def train_one_iter_custom(self, fobj) -> None:
        """One iteration with user-supplied gradients (reference
        LGBM_BoosterUpdateOneIterCustom, c_api.cpp:892): fobj(preds, dataset)
        -> (grad, hess) as numpy [K*N] in class-major order."""
        K, N = self.num_models, self.num_data
        preds = self.score.cpu().numpy().reshape(-1)
        grad, hess = fobj(preds, self.train_set)
        self._custom_gh = tuple(
            torch.as_tensor(np.asarray(a, np.float32).reshape(K, N),
                            device=self.device) for a in (grad, hess))
        try:
            self._run_batch(1, shrinkage=self.config.learning_rate)
        finally:
            self._custom_gh = None

    def add_base_score(self, raw_scores: np.ndarray,
                       valid_raw: Optional[List[np.ndarray]] = None) -> None:
        """Seed scores with a loaded model's predictions — continued training
        (reference application.cpp:90-93 / boosting.h:281-284)."""
        K, N = self.num_models, self.num_data
        self.score = self.score + torch.as_tensor(
            np.asarray(raw_scores, np.float32).reshape(K, N),
            device=self.device)
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
        """Metric values of the training set (when ``is_training_metric``
        or ``force_training``) and every valid set; ``only`` names one
        dataset. The pointwise family reduces on the device in f32 and
        fetches one scalar per metric (all in one transfer); AUC and the
        other metrics fetch the converted scores and run on the host."""
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
                        conv_host = fetch_conv()
                    for name, value, hib in m.eval(conv_host):
                        out.append([dname, name, value, hib, None])

        if (self.config.is_training_metric or force_training) \
                and self.train_metrics and only in (None, "training"):
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
            fetched = torch.stack([v for _, v in pending]).cpu().tolist()
            for (i, _), raw in zip(pending, fetched):
                out[i][2] = out[i][4].transform(float(raw))
        return [(d, n, v, h) for (d, n, v, h, _m) in out]

    # ------------------------------------------------------------- model

    def finalize_model(self) -> List[List[Tree]]:
        """Fetch the device trees to host Trees; fold the boost-from-average
        bias into the first iteration's trees (gbdt.cpp:445-447)."""
        mappers = self.train_set.mappers
        rfi = self.train_set.real_feature_idx
        forest: List[List[Tree]] = []
        for it_trees in self.models:
            forest.append([tree_from_device_arrays(
                TreeArrays(*[None if f is None else f.cpu().numpy()
                             for f in t]), mappers, rfi)
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
    nothing, so no wave count is assumed for correctness."""

    def __init__(self, gbdt: "GBDT"):
        self.gbdt = gbdt
        self.pool = None
        self.graphs = {}
        self.guess = list(gbdt._waves_seen)
        self.flags_host = None
        self.ready = None
        # the scores the graphs bind to
        self.score = gbdt.score.clone()
        self.valid_scores = [vs.score.clone() for vs in gbdt.valid_sets]
        # measurements read by chip_smoke.py
        self.capture_s = 0.0          # Python capture of every graph
        self.instantiate_s = 0.0      # cudaGraphInstantiate at capture end
        self.replays = 0
        self.syncs = 0
        self.trees = 0
        self.waves_run = 0            # wave replays, no-op waves included
        self.waves_needed = 0         # waves the trees needed

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
        return g

    def _read_flags(self, flags: torch.Tensor) -> List[int]:
        """The grower's flags on the host: the tree's one sync."""
        if self.flags_host is None:
            self.flags_host = torch.empty(3, dtype=torch.int64,
                                          pin_memory=True)
            self.ready = torch.cuda.Event()
        self.flags_host.copy_(flags, non_blocking=True)
        self.ready.record()
        self.ready.synchronize()
        return self.flags_host.tolist()

    def _replay(self, key, fn) -> None:
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, fn)
        g.replay()
        self.replays += 1

    def iteration(self, it: int) -> None:
        gb = self.gbdt
        # a graph keeps what its capture saw: the variant of ``it``, ``k``
        self._replay(("start", gb._draws_bag(it)),
                     functools.partial(gb._part_start, it))
        for k in range(gb.num_models):
            self._replay(("tree", k), functools.partial(gb._part_tree, k))
            self._waves(k)
            self._replay(("end", k), functools.partial(gb._part_tree_end, k))

    def _waves(self, k: int) -> None:
        flags = self.gbdt._grower.state.flags
        n = self.guess[k]
        while True:
            for _ in range(n):
                self._replay("wave", self.gbdt._grower.wave)
            self.waves_run += n
            _, done, waves = self._read_flags(flags)
            self.syncs += 1
            if done:
                break
            n = max(1, self.guess[k] // 4)
        self.guess[k] = waves
        self.waves_needed += waves
        self.trees += 1


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
