"""GBDT boosting driver: the serial, device-resident path.

Port of ``lightgbm_tpu/boosting/gbdt.py`` for one device: the constructor's
device placement, the per-iteration step (``_make_step``/``step_body`` at
gbdt.py:1263-1432) with boost-from-average (:770), bagging and
feature_fraction (:1152-1191), valid sets (:1114, :1217), metric eval
(:2073-2147), custom gradients, continued training, rollback and
``reset_config`` (:1878-2059), and the factory ``create_boosting``
(reference src/boosting/gbdt.cpp:225-518). The JAX package compiles each
iteration into one jitted program; here an iteration is eager PyTorch on
the booster's device: gradients -> sampling -> ``grow_tree`` per model ->
shrinkage -> train and valid score updates.

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
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_port_supported, resolve_device
from ..dataset import ConstructedDataset, Metadata, MetadataDuckTyping
from ..grower import BundleDecode, GrowerSpec, TreeArrays, grow_tree
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
        self._num_leaves: List[List[int]] = []
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
        self.bag_mask = self.pad_mask

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
            compact_frac=config.tpu_compact_frac,
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
        if not self.bagging_on:
            return self.pad_mask
        if it % self.config.bagging_freq != 0:
            return prev_mask
        u = prng.uniform(key, self.num_data, self.device)
        frac = torch.tensor(self.config.bagging_fraction,
                            dtype=torch.float32, device=self.device)
        return (u < frac).to(torch.float32) * self.pad_mask

    def _sampling(self, g, h, bag_mask, key, it: int):
        """Row-sampling hook: ``(mask, g, h)``. Base = bagging; GOSS
        overrides (goss.hpp:86-131)."""
        return self._bag_mask_for_iter(key, it, bag_mask), g, h

    def _feature_mask(self, fkey, k: int):
        """Per-model feature_fraction mask (serial_tree_learner.cpp:240)."""
        if not self.use_feature_fraction:
            return self.feature_ok
        noise = prng.uniform(prng.fold_in(fkey, k), self.spec.num_features,
                             self.device)
        top = prng.top_k_indices(noise, self.n_feature_sample)
        fmask = torch.zeros(self.spec.num_features, dtype=torch.bool,
                            device=self.device)
        fmask[top] = True
        return fmask & self.feature_ok

    def _tree_output_transform(self, tree: TreeArrays) -> TreeArrays:
        """Hook: RF converts leaf outputs via the objective (rf.hpp:160)."""
        return tree

    def _score_update(self, old_score_k, contrib, it: int):
        """Hook: base adds; RF keeps a running average (rf.hpp:117-121)."""
        return old_score_k + contrib

    def _step_shrinkage(self) -> float:
        """Hook: per-tree shrinkage (RF overrides to 1.0, rf.hpp:44-45)."""
        return self.config.learning_rate

    def _shrink(self, tree: TreeArrays, shrinkage: float) -> TreeArrays:
        """Tree::Shrinkage (tree.h:137-142), internal values and a linear
        leaf's intercept and coefficients included, then the output
        transform."""
        s = torch.tensor(shrinkage, dtype=torch.float32, device=self.device)
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
                                    self.bundle)
        return self._leaf_outputs(tree, leaves, self.raw)

    def _valid_contrib(self, tree: TreeArrays, vs: ValidSet):
        """One tree's output for every row of a valid set."""
        leaves = leaves_from_binned(tree, vs.Xb, self.num_bins,
                                    self.missing_code, self.default_bin)
        return self._leaf_outputs(tree, leaves, vs.raw)

    def _tree_score_updates(self, score_k, valid_k, tree, leaf_ids, it):
        """Apply one (shrunk) tree to the train score (by the grower's leaf
        ids) and to every valid score (by a walk of its codes)."""
        new_score_k = self._score_update(
            score_k, self._leaf_outputs(tree, leaf_ids, self.raw), it)
        new_valid_k = [self._score_update(v, self._valid_contrib(tree, vs),
                                          it)
                       for v, vs in zip(valid_k, self.valid_sets)]
        return new_score_k, new_valid_k

    # ---------------------------------------------------------- training

    def _run_step(self, score, shrinkage: float, custom_gh=None):
        """One boosting iteration from ``score`` and the valid sets' current
        scores: returns the new train score and per-valid score lists; the
        trees are appended. The JAX package's ``step_body``."""
        it = self.iter_
        key = prng.fold_in(self._rng_key, it)
        g, h = self._gradients(score) if custom_gh is None else custom_gh
        bkey, fkey = prng.split(prng.fold_in(key, 0))
        mask, g, h = self._sampling(g, h, self.bag_mask, bkey, it)
        trees, new_scores = [], []
        new_valid = [[vs.score[k] for k in range(self.num_models)]
                     for vs in self.valid_sets]
        for k in range(self.num_models):
            fmask = self._feature_mask(fkey, k)
            gk, hk = g[k] * mask, h[k] * mask
            tree, leaf_ids = grow_tree(
                self.Xb, gk, hk, mask, fmask, self.is_cat,
                self.num_bins, self.missing_code, self.default_bin,
                self.spec, self.comm, self.bundle)
            if self.linear_tree:
                # on the masked g/h the tree grew on, before shrinkage
                # (gbdt.py:1369-1380 there)
                tree, n_degraded = fit_linear_leaves(
                    tree, *self.raw, leaf_ids, gk, hk, mask, self.is_cat,
                    max_features=self.config.linear_max_features,
                    linear_lambda=self.config.linear_lambda)
                self.linear_degraded.append(n_degraded)
            tree = self._shrink(tree, shrinkage)
            new_score_k, new_valid_k = self._tree_score_updates(
                score[k], [nv[k] for nv in new_valid], tree, leaf_ids, it)
            new_scores.append(new_score_k)
            for nv, v in zip(new_valid, new_valid_k):
                nv[k] = v
            trees.append(tree)
        self.bag_mask = mask
        self.models.append(trees)
        self._num_leaves.append([int(t.num_leaves) for t in trees])
        self.iter_ += 1
        self.mutations_ += 1
        return torch.stack(new_scores), new_valid

    def _commit(self, score, new_valid) -> None:
        self.score = score
        for vs, nv in zip(self.valid_sets, new_valid):
            vs.score = torch.stack(nv)

    def _record_undo(self) -> None:
        # the step builds new tensors, so the old ones are the record
        self._undo = (self.score, [vs.score for vs in self.valid_sets])

    def train_one_iter(self) -> None:
        """One boosting iteration: gradients -> sampling -> grow -> shrink
        -> score updates."""
        self._record_undo()
        self._commit(*self._run_step(self.score, self._step_shrinkage()))

    def train_one_iter_custom(self, fobj) -> None:
        """One iteration with user-supplied gradients (reference
        LGBM_BoosterUpdateOneIterCustom, c_api.cpp:892): fobj(preds, dataset)
        -> (grad, hess) as numpy [K*N] in class-major order."""
        K, N = self.num_models, self.num_data
        preds = self.score.cpu().numpy().reshape(-1)
        grad, hess = fobj(preds, self.train_set)
        gh = tuple(torch.as_tensor(np.asarray(a, np.float32).reshape(K, N),
                                   device=self.device) for a in (grad, hess))
        self._record_undo()
        self._commit(*self._run_step(self.score, self.config.learning_rate,
                                     custom_gh=gh))

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
        trees could not split and report whether training should stop."""
        popped = False
        while self._num_leaves and all(n <= 1 for n in self._num_leaves[-1]):
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
