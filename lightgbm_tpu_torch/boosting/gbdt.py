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
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_port_supported, resolve_device
from ..dataset import ConstructedDataset, Metadata, MetadataDuckTyping
from ..grower import GrowerSpec, TreeArrays, grow_tree
from ..metrics import Metric, _PointwiseRegressionMetric, create_metrics
from ..objectives import create_objective
from ..ops.cuda_histogram import feature_groups
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
        if dev.type == "cuda":
            try:            # the histogram kernel's shared-memory limit
                feature_groups(F, self.spec.num_bins_padded)
            except ValueError as e:
                Log.fatal("max_bin=%d: %s; not ported to lightgbm_tpu_torch "
                          "yet (ROADMAP B1)", config.max_bin, e)
        self.Xb = _codes_tensor(train_set.X_binned, dev)
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

    def _objective_name(self) -> Optional[str]:
        return self.objective.name if self.objective is not None else None

    def add_valid(self, name: str, binned: np.ndarray,
                  metadata: Metadata) -> None:
        nv = binned.shape[0]
        metrics = create_metrics(self.config, self._objective_name())
        for m in metrics:
            m.init(metadata, nv)
        vs = ValidSet(name, _codes_tensor(binned, self.device), metadata,
                      metrics, nv)
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
        """Tree::Shrinkage (tree.h:137-142), internal values included, then
        the output transform."""
        s = torch.tensor(shrinkage, dtype=torch.float32, device=self.device)
        tree = tree._replace(leaf_value=tree.leaf_value * s,
                             internal_value=tree.internal_value * s)
        return self._tree_output_transform(tree)

    def _tree_contrib(self, tree: TreeArrays, Xb: torch.Tensor):
        """One tree's leaf value for every row of a binned matrix."""
        leaves = leaves_from_binned(tree, Xb, self.num_bins,
                                    self.missing_code, self.default_bin)
        return tree.leaf_value[leaves.long()]

    def _tree_score_updates(self, score_k, valid_k, tree, leaf_ids, it):
        """Apply one (shrunk) tree to the train score (by the grower's leaf
        ids) and to every valid score (by a walk of its codes)."""
        new_score_k = self._score_update(
            score_k, tree.leaf_value[leaf_ids.long()], it)
        new_valid_k = [self._score_update(v, self._tree_contrib(tree, vs.Xb),
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
            tree, leaf_ids = grow_tree(
                self.Xb, g[k] * mask, h[k] * mask, mask, fmask, self.is_cat,
                self.num_bins, self.missing_code, self.default_bin,
                self.spec, self.comm)
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
            new_scores.append(self.score[k] - self._tree_contrib(tree,
                                                                 self.Xb))
            for vs in self.valid_sets:
                vs.score = vs.score.clone()
                vs.score[k] = vs.score[k] + (-self._tree_contrib(tree, vs.Xb))
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
                TreeArrays(*[f.cpu().numpy() for f in t]), mappers, rfi)
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
