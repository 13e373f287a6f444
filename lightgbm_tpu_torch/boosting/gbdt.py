"""GBDT boosting driver: the serial, device-resident path.

Port of ``lightgbm_tpu/boosting/gbdt.py`` for the slice — the constructor's
device placement, ``_make_step``/``step_body`` (gbdt.py:1263-1432) with
boost-from-average (:770), ``train_one_iter`` and ``finalize_model``
(reference src/boosting/gbdt.cpp:379-473). The JAX package compiles each
iteration into one jitted program; here an iteration is eager PyTorch on
the booster's device: gradients -> ``grow_tree`` -> shrinkage -> score
update. Bagging, feature_fraction, valid sets, DART/GOSS/RF and the other
strategies raise in ``config.check_port_supported`` with their ROADMAP
item.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config, check_port_supported, resolve_device
from ..dataset import ConstructedDataset
from ..grower import GrowerSpec, TreeArrays, grow_tree
from ..metrics import create_metrics
from ..objectives import create_objective
from ..ops.cuda_histogram import feature_groups
from ..ops.predict import add_tree_scores
from ..parallel.comm import SerialComm
from ..tree import Tree, tree_from_device_arrays
from ..utils.log import Log


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class GBDT:
    """Boosting driver (reference class GBDT, src/boosting/gbdt.h:25)."""

    def __init__(self, config: Config, train_set: ConstructedDataset):
        check_port_supported(config)
        self.config = config
        self.train_set = train_set
        self.device = resolve_device(config)
        self.objective = create_objective(config)
        if self.objective is None:
            Log.fatal("objective=none (custom gradients) is not ported to "
                      "lightgbm_tpu_torch yet (ROADMAP A6)")
        self.num_models = 1
        N = train_set.num_data
        F = train_set.num_features
        self.num_data = N
        self.objective.init(train_set.metadata, N)

        meta = train_set.feature_meta_arrays()
        num_leaves = config.max_leaves_by_depth
        Bpad = max(8, _round_up(train_set.max_num_bin, 8))
        slots = config.tpu_hist_slots or max(1, min(25, num_leaves - 1))
        slots = max(1, min(slots, num_leaves))
        wave = config.tpu_wave_size or slots
        self.spec = GrowerSpec(
            num_leaves=num_leaves,
            num_features=F,
            num_bins_padded=Bpad,
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
        )
        self.comm = SerialComm(F)

        dev = self.device
        if dev.type == "cuda":
            try:            # the histogram kernel's shared-memory limit
                feature_groups(F, Bpad)
            except ValueError as e:
                Log.fatal("max_bin=%d: %s; not ported to lightgbm_tpu_torch "
                          "yet (ROADMAP B1)", config.max_bin, e)
        codes = np.ascontiguousarray(train_set.X_binned)
        if codes.dtype == np.uint16:
            # PyTorch gathers int16 but not uint16. On the card every code is
            # below the kernel's bin limit (checked above), far below 2**15;
            # on the CPU the plain version refuses a code of 2**15 or more.
            codes = codes.view(np.int16)
        self.Xb = torch.as_tensor(codes, device=dev)
        md = train_set.metadata
        self.label = torch.as_tensor(md.label, dtype=torch.float32,
                                     device=dev)
        self.weight = None if md.weight is None else torch.as_tensor(
            md.weight, dtype=torch.float32, device=dev)
        self.pad_mask = torch.ones(N, dtype=torch.float32, device=dev)
        self.num_bins = torch.as_tensor(meta["num_bins"], device=dev)
        self.missing_code = torch.as_tensor(meta["missing_code"], device=dev)
        self.default_bin = torch.as_tensor(meta["default_bin"], device=dev)
        self.is_cat = torch.zeros(F, dtype=torch.bool, device=dev)
        self.feature_ok = torch.ones(F, dtype=torch.bool, device=dev)

        self.train_metrics = create_metrics(config, self.objective.name)
        for m in self.train_metrics:
            m.init(md, N)

        # ---- initial scores (boost_from_average, gbdt.cpp:357-377) ------
        self.init_score_value = 0.0
        has_init = md.init_score is not None
        if config.boost_from_average and not has_init:
            avg = self.objective.boost_from_average_score()
            if avg is not None and abs(avg) > 1e-15:
                self.init_score_value = float(avg)
        base = np.full((1, N), self.init_score_value, dtype=np.float32)
        if has_init:
            base += np.asarray(md.init_score, np.float32).reshape(1, N)
        self.score = torch.as_tensor(base, device=dev)

        self.models: List[List[TreeArrays]] = []
        self.iter_ = 0

    # ------------------------------------------------------------- training

    def _gradients(self, score):
        return self.objective.gradients(score, self.label, self.weight)

    def _shrink(self, tree: TreeArrays, shrinkage: float) -> TreeArrays:
        """Tree::Shrinkage (tree.h:137-142), internal values included."""
        s = torch.tensor(shrinkage, dtype=torch.float32, device=self.device)
        return tree._replace(leaf_value=tree.leaf_value * s,
                             internal_value=tree.internal_value * s)

    def train_one_iter(self) -> None:
        """One boosting iteration: gradients -> grow -> shrink -> score."""
        g, h = self._gradients(self.score)
        mask = self.pad_mask
        tree, leaf_ids = grow_tree(
            self.Xb, g[0] * mask, h[0] * mask, mask, self.feature_ok,
            self.is_cat, self.num_bins, self.missing_code, self.default_bin,
            self.spec, self.comm)
        tree = self._shrink(tree, self.config.learning_rate)
        self.score = torch.stack(
            [add_tree_scores(self.score[0], tree, leaf_ids)])
        self.models.append([tree])
        self.iter_ += 1

    def check_no_splits(self) -> bool:
        """Reference gbdt.cpp:465-471: drop trailing iterations whose trees
        could not split and report whether training should stop."""
        popped = False
        while self.models and all(int(t.num_leaves) <= 1
                                  for t in self.models[-1]):
            self.models.pop()
            self.iter_ -= 1
            popped = True
        if popped:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements.")
        return popped

    def eval_train(self):
        """Training metrics on the host over converted scores."""
        conv = self.objective.convert_output(self.score).cpu().numpy()
        out = []
        for m in self.train_metrics:
            for name, value, hib in m.eval(conv):
                out.append(("training", name, value, hib))
        return out

    # ---------------------------------------------------------------- model

    def finalize_model(self) -> List[List[Tree]]:
        """Fetch the device trees to host Trees; fold the boost-from-average
        bias into the first tree (gbdt.cpp:445-447)."""
        mappers = self.train_set.mappers
        rfi = self.train_set.real_feature_idx
        forest: List[List[Tree]] = []
        for it_trees in self.models:
            forest.append([tree_from_device_arrays(
                TreeArrays(*[f.cpu().numpy() for f in t]), mappers, rfi)
                for t in it_trees])
        if forest and abs(self.init_score_value) > 1e-15:
            forest[0][0].add_bias(self.init_score_value)
        return forest
