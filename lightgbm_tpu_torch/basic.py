"""User-facing Dataset and Booster — the slice's surface of
``lightgbm_tpu/basic.py`` (reference python-package basic.py: Dataset at
:556, Booster at :1234).

``Booster.predict`` walks the forest on the booster's device
(``ops/predict.py``) for large batches, one class at a time, like the JAX
package, and on the host for small ones (and for a forest holding a
categorical split, as the JAX package does); ``model_to_string`` /
``save_model`` and loading from model text use the copied
``io/model_text.py``, so a model trained by either package loads in the
other. The prediction device is the config's ``device`` (CUDA unless
``device=cpu``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import observability as obs
from .config import Config, resolve_device
from .dataset import ConstructedDataset, Metadata, construct_dataset
from .tree import Tree
from .utils.cache import LRUCache
from .utils.log import Log

# rows x trees at and above which Booster.predict walks on the device (the
# JAX package's threshold, basic.py:781)
DEVICE_PREDICT_MIN_WORK = 1_000_000


def _data_from_pandas(df, pandas_categorical=None):
    """DataFrame -> float64 matrix, mapping `category` dtype columns to their
    category codes (reference basic.py:226-268); a copy of the JAX package's
    (``lightgbm_tpu/basic.py:22-44``). At train time the per-column category
    lists are recorded; at predict time the recorded lists re-map so codes
    agree with training (unseen categories become NaN/missing).

    Returns (array, feature_names, cat_col_names, pandas_categorical).
    """
    cat_cols = [c for c in df.columns if str(df[c].dtype) == "category"]
    if pandas_categorical is None:                    # training
        pandas_categorical = [list(df[c].cat.categories) for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):
        raise ValueError("train and predict data have different categorical "
                         "columns")
    if cat_cols:
        df = df.copy()
        for c, cats in zip(cat_cols, pandas_categorical):
            codes = df[c].cat.set_categories(cats).cat.codes.astype(np.float64)
            df[c] = codes.where(codes >= 0, np.nan)   # unseen/NaN -> missing
    arr = df.values.astype(np.float64, copy=False)
    return arr, [str(c) for c in df.columns], [str(c) for c in cat_cols], \
        pandas_categorical


def _plain(obj):
    """Nested containers as builtins (``OrderedDict`` -> ``dict``): a
    checkpoint payload holds builtins and numpy only."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_plain(v) for v in obj)
    return obj


def _is_frame(data) -> bool:
    return hasattr(data, "values") and hasattr(data, "columns")


class Dataset:
    """Lazily constructed dataset (reference basic.py:556): a dense numpy
    matrix or a ``scipy.sparse`` one (CSR or CSC), numerical and
    categorical features binned on the host at first use, with optional
    query sizes (``group``). A set built with ``reference=`` (a validation
    set) is binned with the reference's mappers (the analog of
    LoadFromFileAlignWithOtherDataset). ``data`` may also be a file path:
    CSV, TSV or LibSVM text (``io/file_io.py``; ``two_round`` streams it
    in two passes) or a binary dataset file written by either package."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False, silent: bool = False):
        self._binary_path: Optional[str] = None
        self._stream_path: Optional[str] = None
        if isinstance(data, str):
            # a file (lightgbm_tpu/basic.py:74-140): a binary dataset file
            # (auto-detected, dataset_loader.cpp:265), a two-round load
            # deferred to construct(), or CSV / TSV / LibSVM text with its
            # label, side columns and side files
            from .config import _parse_bool, resolve_aliases
            from .io.file_io import is_binary_dataset, load_data_file
            resolved = resolve_aliases(dict(params or {}))
            if is_binary_dataset(data):
                self._binary_path = data
                data = np.zeros((0, 1))
            elif _parse_bool(resolved.get("use_two_round_loading", False),
                             "use_two_round_loading"):
                self._stream_path = data
                data = np.zeros((0, 1))
            else:
                data, file_label, side = load_data_file(data, resolved)
                if label is None:
                    label = file_label
                if weight is None:
                    weight = side.get("weight")
                if group is None:
                    group = side.get("group")
                if init_score is None:
                    init_score = side.get("init_score")
                if feature_name == "auto" and side.get("feature_names"):
                    feature_name = side["feature_names"]
        self.pandas_categorical = None
        inferred_names = None
        if _is_frame(data):
            # a valid set aligned to a training set encodes categories with
            # the TRAINING set's category lists (lightgbm_tpu/basic.py:98-104)
            ref_pc = getattr(reference, "pandas_categorical", None)
            arr, inferred_names, cat_cols, self.pandas_categorical = \
                _data_from_pandas(data, ref_pc)
            self.raw_data = arr
            if categorical_feature == "auto" and cat_cols:
                categorical_feature = cat_cols
        elif hasattr(data, "tocsr"):
            # kept sparse: binning reads it column by column and never
            # densifies the floats (lightgbm_tpu/basic.py:46-55)
            self.raw_data = data.tocsr()
        else:
            self.raw_data = np.asarray(data, dtype=np.float64)
            if self.raw_data.ndim == 1:
                self.raw_data = self.raw_data.reshape(1, -1)
        self.label = None if label is None else np.asarray(label).reshape(-1)
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = inferred_names if feature_name == "auto" \
            else feature_name
        self.categorical_feature = None if categorical_feature == "auto" \
            else categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._constructed: Optional[ConstructedDataset] = None
        self._binned_aligned: Optional[np.ndarray] = None
        self._metadata: Optional[Metadata] = None

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        """Bin the data (``construct_dataset``; a valid set with the
        training set's mappers) in a ``construct`` span holding
        ``construct.find_bins``, ``construct.defer`` and
        ``construct.bin``. The codes reach the device with the booster
        (``construct.place``)."""
        if self._constructed is not None or self._binned_aligned is not None:
            return self
        with obs.span("construct", reference=self.reference is not None):
            return self._construct(config)

    def _construct(self, config: Optional[Config]) -> "Dataset":
        if self._binary_path is not None:
            # host codes from the file: no ingest
            self._constructed = ConstructedDataset.load_binary(
                self._binary_path)
            self.label = self._constructed.metadata.label
            return self
        if self._stream_path is not None:
            from .io.file_io import stream_construct_dataset
            self._constructed = stream_construct_dataset(
                self._stream_path, config or Config.from_params(self.params),
                feature_names=None if self.feature_name in (None, "auto")
                else self.feature_name,
                categorical_features=self.categorical_feature)
            self.label = self._constructed.metadata.label
            return self
        if self.reference is not None:
            ref = self.reference
            ref.construct(config)
            with obs.span("construct.bin", rows=self.raw_data.shape[0]):
                self._binned_aligned = ref.constructed.bin_raw(
                    self.raw_data)
            meta = Metadata(self.raw_data.shape[0])
            if self.label is not None:
                meta.set_label(self.label)
            meta.set_weight(self.weight)
            meta.set_group(self.group)
            meta.set_init_score(self.init_score)
            self._metadata = meta
        else:
            cfg = config or Config.from_params(self.params)
            from .utils.timer import TIMERS
            with TIMERS("dataset_construct"):
                self._constructed = construct_dataset(
                    self.raw_data, self.label, cfg, weight=self.weight,
                    group=self.group, init_score=self.init_score,
                    feature_names=self.feature_name,
                    categorical_features=self.categorical_feature)
        if self.free_raw_data:
            self.raw_data = None
        return self

    @property
    def constructed(self) -> ConstructedDataset:
        if self._constructed is None:
            self.construct()
        return self._constructed

    def num_data(self) -> int:
        if self._constructed is None and (self._binary_path
                                          or self._stream_path):
            self.construct()
        if self._constructed is not None:
            return self._constructed.num_data
        return self.raw_data.shape[0]

    def num_feature(self) -> int:
        if self._constructed is None and (self._binary_path
                                          or self._stream_path):
            self.construct()
        if self._constructed is not None:
            return self._constructed.num_total_features
        return self.raw_data.shape[1]

    # -- fields (reference basic.py Dataset API) ------------------------------

    def _meta_sink(self) -> Optional[Metadata]:
        """The metadata live field updates write through to: a constructed
        training set's, or a reference-aligned valid set's."""
        if self._constructed is not None:
            return self._constructed.metadata
        return self._metadata

    def get_label(self):
        return self.label

    def set_label(self, label) -> "Dataset":
        self.label = None if label is None else np.asarray(label).reshape(-1)
        sink = self._meta_sink()
        if sink is not None and self.label is not None:
            sink.set_label(self.label)
        return self

    def get_weight(self):
        return self.weight

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        sink = self._meta_sink()
        if sink is not None:
            sink.set_weight(weight)
        return self

    def get_init_score(self):
        return self.init_score

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        sink = self._meta_sink()
        if sink is not None:
            sink.set_init_score(init_score)
        return self

    def get_group(self):
        return self.group

    def set_group(self, group) -> "Dataset":
        self.group = group
        sink = self._meta_sink()
        if sink is not None:
            sink.set_group(group)
        return self

    def get_field(self, name):
        return {"label": self.label, "weight": self.weight,
                "group": self.group, "init_score": self.init_score}[name]

    def set_field(self, name, data) -> "Dataset":
        """Generic field setter (reference basic.py Dataset.set_field)."""
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group,
                  "init_score": self.set_init_score}.get(name)
        if setter is None:
            raise ValueError(f"Unknown field name: {name}")
        return setter(data)

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this dataset with ``reference``'s mappers (reference
        basic.py set_reference). Must precede construction."""
        if self._constructed is not None or self._binned_aligned is not None:
            if self.reference is reference:
                return self
            raise ValueError(
                "Cannot set reference after the dataset was constructed")
        ref_pc = getattr(reference, "pandas_categorical", None) or None
        if (self.pandas_categorical or None) is not None and \
                self.pandas_categorical != ref_pc:
            # the category codes were fixed at __init__ against this frame's
            # category lists (lightgbm_tpu/basic.py:259-267)
            raise ValueError(
                "Cannot set_reference on a pandas-categorical dataset "
                "encoded against different category lists — rebuild the "
                "Dataset with reference= instead")
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100):
        """Set of datasets reachable through ``.reference`` links
        (reference basic.py:878)."""
        head, chain = self, set()
        while head is not None and len(chain) < ref_limit:
            if head in chain:
                break
            chain.add(head)
            head = head.reference
        return chain

    def set_feature_name(self, feature_name) -> "Dataset":
        """Rename the features (``lightgbm_tpu/basic.py:283-300``); the
        count must match, and a constructed set renames in place."""
        if feature_name is not None and feature_name != "auto":
            feature_name = list(feature_name)
            if self._constructed is not None:
                nf = self._constructed.num_total_features
            elif self.raw_data is not None and self.raw_data.shape[0] > 0:
                nf = self.raw_data.shape[1]
            else:           # a file's placeholder, before construction
                nf = None
            if nf is not None and len(feature_name) != nf:
                raise ValueError(
                    f"Length of feature_name ({len(feature_name)}) does "
                    f"not equal the number of features ({nf})")
            self.feature_name = feature_name
            if self._constructed is not None:
                self._constructed.feature_names = list(feature_name)
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Must precede construction, as binning depends on it
        (``lightgbm_tpu/basic.py:302-316``); ``"auto"`` keeps the setting."""
        if isinstance(categorical_feature, str) and \
                categorical_feature == "auto":
            return self
        old = self.categorical_feature
        same = (categorical_feature is old
                or (old is not None and categorical_feature is not None
                    and list(categorical_feature) == list(old)))
        if (self._constructed is not None
                or self._binned_aligned is not None) and not same:
            raise ValueError("Cannot change categorical_feature after the "
                             "dataset was constructed")
        self.categorical_feature = categorical_feature
        return self

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned set in the JAX package's binary format
        (``ConstructedDataset.save_binary``)."""
        self.constructed.save_binary(filename)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params)

    def subset(self, used_indices, params=None) -> "Dataset":
        idx = np.asarray(used_indices)
        init_score = None
        if self.init_score is not None:
            is_arr = np.asarray(self.init_score)
            init_score = is_arr[idx] if is_arr.ndim == 1 and \
                len(is_arr) == self.num_data() else is_arr
        group = None
        if self.group is not None:
            # whole queries only, in query order (the JAX package's rule,
            # basic.py:334-351): the subset's group array stays well formed
            sizes = np.asarray(self.group, dtype=np.int64)
            qid = np.repeat(np.arange(len(sizes)), sizes)
            if len(qid) != self.num_data():
                Log.fatal("group sizes do not sum to num_data")
            full = np.unique(qid[idx])
            if len(idx) != int(sizes[full].sum()) or \
                    np.any(np.diff(qid[idx]) < 0):
                Log.fatal("Cannot subset a grouped Dataset except by whole "
                          "queries in query order (ranking cv folds at "
                          "query granularity)")
            group = sizes[full]
        return Dataset(self.raw_data[idx],
                       label=None if self.label is None else self.label[idx],
                       weight=None if self.weight is None
                       else np.asarray(self.weight)[idx],
                       group=group, init_score=init_score,
                       params=params or self.params,
                       feature_name=self.feature_name or "auto",
                       categorical_feature=self.categorical_feature or "auto")


class Booster:
    """Trained model handle (reference basic.py:1234). The forest lives as
    host ``Tree`` objects for prediction and serialisation; training state
    stays on the device inside the GBDT driver."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent: bool = False):
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        if self.config.tpu_time_tag:
            from .utils.timer import TIMERS
            TIMERS.enabled = True
        self._gbdt = None
        self.trees: List[Tree] = []
        self._forest_rev = 0                 # bumped whenever trees change
        # the device walk's stacked forests of recent tree slices
        self._stacked_cache = LRUCache(capacity=4)
        self.num_model_per_iteration = 1
        self.best_iteration = 0
        self.best_score: Dict = {}
        self.eval_history: Dict = {}         # dataset -> metric -> [values]
        self.feature_names: List[str] = []
        self.num_total_features = 0
        self.mappers = []
        self.init_score_value = 0.0
        self.pandas_categorical = None
        self._prev_trees: List[Tree] = []
        self._synced_mutations = -1
        self._train_data_name = "training"
        self._valid_registry: List = []      # (Dataset, name) identity pairs
        self._attr: Dict[str, str] = {}
        if model_file is not None:
            from .io.model_text import load_model_file
            load_model_file(self, model_file)
        elif model_str is not None:
            from .io.model_text import load_model_string
            load_model_string(self, model_str)
        elif train_set is not None:
            self._setup_train(train_set)

    # -- training ------------------------------------------------------------

    def _setup_train(self, train_set: Dataset) -> None:
        from .boosting.gbdt import create_boosting
        from .parallel.comm import init_distributed
        # the reference's order: Network::Init before LoadData
        # (application.cpp:167-178), so that bin finding sees the world
        init_distributed(self.config)
        train_set.params.update(self.params)
        train_set.construct(self.config)
        cd = train_set.constructed
        self._gbdt = create_boosting(self.config, cd)
        # the booster may normalize fields to their effective values
        # (tpu_residency=stream forces tpu_row_compact=false): adopt them,
        # so that the checkpoint fingerprint covers what trains and a
        # streamed run resumes into a resident one (basic.py:415-420 there)
        self.config = self._gbdt.config
        self.train_dataset = train_set
        self.feature_names = cd.feature_names
        self.num_total_features = cd.num_total_features
        self.mappers = cd.mappers
        self._real_feature_idx = cd.real_feature_idx
        self.num_model_per_iteration = self._gbdt.num_models
        self.pandas_categorical = getattr(train_set, "pandas_categorical",
                                          None)

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Attach a validation set binned with the training set's mappers;
        after training, the forest so far is replayed into its scores (the
        reference's AddValidDataset)."""
        data.construct(self.config)
        if data.reference is None or data._binned_aligned is None:
            Log.fatal("Add valid data failed: valid set must reference the "
                      "training set")
        if any(nm == name for _ds, nm in self._valid_registry):
            Log.fatal("A validation set named %r is already attached; "
                      "names must be unique per booster", name)
        self._ensure_finalized()
        if self.trees and data.raw_data is None:
            Log.fatal("add_valid after training needs the valid set's "
                      "raw data to replay the forest — construct it "
                      "with free_raw_data=False")
        valid_raw = None
        if self.config.linear_tree:
            # linear-leaf score updates read the valid rows' raw values
            if data.raw_data is None:
                Log.fatal("linear_tree=true: add_valid needs the valid "
                          "set's raw data (construct it with "
                          "free_raw_data=False)")
            from .dataset import extract_raw_slice
            valid_raw = extract_raw_slice(
                data.raw_data,
                [int(r) for r in self.train_dataset.constructed
                 .real_feature_idx], data.raw_data.shape[0])
        gbdt = self._gbdt
        gbdt.add_valid(name, data._binned_aligned, data._metadata,
                       raw=valid_raw)
        self._valid_registry.append((data, name))
        if self.trees:
            # the fresh score holds init_score_value, which the finalised
            # trees also carry (bias folded into tree 0): take it out first
            K = max(self.num_model_per_iteration, 1)
            raw = np.asarray(self.predict(
                data.raw_data, raw_score=True,
                num_iteration=len(self.trees) // K), np.float32)
            raw = raw.T if raw.ndim == 2 else raw.reshape(1, -1)
            vs = gbdt.valid_sets[-1]
            vs.score = (vs.score - np.float32(gbdt.init_score_value)
                        + torch.as_tensor(raw.reshape(K, vs.num_data),
                                          device=gbdt.device))
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Reference LGBM_BoosterResetParameter — used by the
        reset_parameter callback for per-iteration schedules."""
        self.params.update(params)
        self.config = Config.from_params(self.params)
        if self._gbdt is not None:
            self._gbdt.reset_config(self.config)
        return self

    def rollback_one_iter(self) -> "Booster":
        """Reference GBDT::RollbackOneIter via LGBM_BoosterRollbackOneIter."""
        if self._gbdt is not None:
            self._gbdt.rollback_one_iter()
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration (reference LGBM_BoosterUpdateOneIter, or
        LGBM_BoosterUpdateOneIterCustom with ``fobj``). ``train_set`` swaps
        the training data under the existing model (reference
        LGBM_BoosterResetTrainingData): the new data's scores start from the
        current forest's raw predictions."""
        if train_set is not None and train_set is not getattr(
                self, "train_dataset", None):
            if self._gbdt is not None:
                self._finalize()
            prev = list(self.trees)
            X_new = train_set.raw_data      # before construct() may free it
            if prev and X_new is None:
                Log.fatal("update(train_set=...) on a trained booster needs "
                          "the new Dataset's raw data to seed scores — "
                          "construct it with free_raw_data=False")
            self._setup_train(train_set)
            if prev:
                gbdt = self._gbdt
                # seed from the model's predictions only: no
                # boost-from-average bias on a non-empty model
                if abs(gbdt.init_score_value) > 1e-15:
                    gbdt.score = gbdt.score - gbdt.init_score_value
                    gbdt.init_score_value = 0.0
                K = max(self.num_model_per_iteration, 1)
                raw = np.asarray(self.predict(X_new, raw_score=True,
                                              num_iteration=len(prev) // K))
                gbdt.add_base_score(raw.T if raw.ndim == 2 else raw)
                self._prev_trees = prev
        if self._gbdt is None:
            Log.fatal("Booster has no training data: it was freed (train() "
                      "without keep_training_booster=True) — pass train_set "
                      "to update() to attach data")
        if fobj is not None:
            self._gbdt.train_one_iter_custom(fobj)
        else:
            self._gbdt.train_one_iter()
        return False

    def _ensure_finalized(self) -> None:
        """Materialise host trees iff the device forest changed (the
        mutation counter, not the length, decides: a rollback and a retrain
        land on the same length with different trees)."""
        if self._gbdt is not None and \
                self._synced_mutations != self._gbdt.mutations_:
            self._finalize()

    def _finalize(self) -> None:
        self.trees = self._prev_trees + [
            t for it_trees in self._gbdt.finalize_model() for t in it_trees]
        self._forest_rev += 1
        self.init_score_value = self._gbdt.init_score_value
        self._synced_mutations = self._gbdt.mutations_

    # -- checkpoint/resume (robustness/checkpoint.py) -------------------------

    def save_checkpoint(self, directory: Optional[str] = None) -> str:
        """Write one atomic snapshot of the training state (the device
        forest, scores, bagging mask, threefry key, counters, eval history
        and the config fingerprint) to ``directory`` (default: the config's
        ``checkpoint_dir``), resumable by :meth:`resume` or
        ``train(resume_from=...)`` (``lightgbm_tpu/basic.py:573-625``).
        The payload holds builtins and numpy arrays only. In a world of
        more than one process (``robustness.distributed.gang_env``) every
        rank writes its shard and rank 0 commits the epoch manifest behind
        the commit barrier, so every rank calls this at the same boundary.
        Returns the written path (this rank's shard in a world)."""
        from .robustness.checkpoint import (CheckpointManager,
                                            config_fingerprint,
                                            fingerprinted_config)
        from .io.model_text import _tree_to_string
        if self._gbdt is None:
            Log.fatal("save_checkpoint needs live training state — the "
                      "booster was freed or loaded from a model file")
        if self.config.boosting_normalized == "dart":
            Log.fatal("checkpoint/resume does not support boosting=dart "
                      "(host-side drop state is not captured)")
        directory = directory or self.config.checkpoint_dir
        mgr = CheckpointManager(directory,
                                keep_last_n=self.config.checkpoint_keep_last_n)
        state = self._gbdt.checkpoint_state()
        payload = {
            "config_fingerprint": config_fingerprint(self.config),
            "config": fingerprinted_config(self.config),
            "iteration": state["iter"],
            "state": state,
            "eval_history": _plain(self.eval_history),
            "booster": {
                "prev_trees": [_tree_to_string(t) for t in self._prev_trees],
                "best_iteration": int(self.best_iteration),
                "best_score": _plain(self.best_score),
                "feature_names": list(self.feature_names),
            },
        }
        from .robustness import distributed as _dist
        gang = _dist.gang_env()
        if gang is not None:
            client, rank, world = gang
            coord = _dist.GangCheckpointCoordinator(
                directory, client=client, rank=rank, world=world,
                keep_last_n=self.config.checkpoint_keep_last_n,
                elastic=self.config.elastic)
            path = coord.save(payload)
            Log.info("gang checkpoint shard written: %s (rank %d/%d, "
                     "iteration %d)", path, rank, world, state["iter"])
            return path
        path = mgr.save(payload)
        Log.info("checkpoint written: %s (iteration %d)", path,
                 state["iter"])
        return path

    def resume(self, path_or_dir: Optional[str] = None) -> "Booster":
        """Replay a checkpoint into this booster's training state
        (``lightgbm_tpu/basic.py:627-680``): a snapshot file (a gang shard
        too), or a directory whose latest snapshot is used (default: the
        config's ``checkpoint_dir``); a gang directory resumes its newest
        epoch every rank verifies (``GangCheckpointCoordinator``). The booster must be built on the same dataset
        and training config: a config-fingerprint mismatch fails naming the
        fields. Training on is bit-identical to a run never interrupted."""
        from .robustness.checkpoint import (CheckpointError,
                                            CheckpointManager,
                                            config_fingerprint,
                                            config_mismatch_fields)
        from .io.model_text import _parse_tree_block
        if self._gbdt is None:
            Log.fatal("resume needs a constructed training setup — build "
                      "the Booster with the same train_set/params first")
        if self.config.boosting_normalized == "dart":
            Log.fatal("checkpoint/resume does not support boosting=dart "
                      "(host-side drop state is not captured)")
        target = path_or_dir or self.config.checkpoint_dir
        if not target:
            Log.fatal("resume: no checkpoint path given and checkpoint_dir "
                      "is empty")
        if os.path.isdir(target):
            from .robustness import distributed as _dist
            if _dist.list_manifests(target):
                gang = _dist.gang_env()
                client, rank, world = gang if gang is not None \
                    else (None, 0, 1)
                shard = _dist.GangCheckpointCoordinator(
                    target, client=client, rank=rank, world=world,
                    elastic=self.config.elastic).resolve_resume()
                if shard is None:
                    raise CheckpointError(f"no gang epoch under {target}")
                target = shard
        payload = CheckpointManager.load(target)
        if payload["config_fingerprint"] != config_fingerprint(self.config):
            fields = config_mismatch_fields(payload["config"], self.config)
            raise CheckpointError(
                f"config fingerprint mismatch resuming from {target}: the "
                f"snapshot was written under a config whose training "
                f"semantics differ in: {', '.join(fields) or '<unknown>'}. "
                f"Resume requires an identical training config (run-control "
                f"fields like num_iterations and paths are exempt).")
        self._gbdt.restore_checkpoint_state(payload["state"])
        b = payload.get("booster", {})
        self._prev_trees = [_parse_tree_block(dict(
            ln.split("=", 1) for ln in text.splitlines() if "=" in ln))
            for text in b.get("prev_trees", [])]
        self.best_iteration = int(b.get("best_iteration", 0))
        self.best_score = b.get("best_score", {}) or {}
        self.eval_history = payload.get("eval_history", {}) or {}
        self._finalize()
        Log.info("resumed from checkpoint (id %s) at iteration %d "
                 "(%d trees)", payload.get("checkpoint_id", "?"),
                 self._gbdt.iter_, len(self.trees))
        return self

    def free_dataset(self) -> "Booster":
        """Release device-side training state; predict/save keep working."""
        self._ensure_finalized()
        self._gbdt = None
        self.__dict__.pop("train_dataset", None)
        self._valid_registry = []
        return self

    # -- prediction ----------------------------------------------------------

    def num_trees(self) -> int:
        self._ensure_finalized()
        return len(self.trees)

    def current_iteration(self) -> int:
        return self.num_trees() // max(self.num_model_per_iteration, 1)

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        self._ensure_finalized()
        if _is_frame(data):
            data, _, _, _ = _data_from_pandas(data, self.pandas_categorical)
        if hasattr(data, "tocsr"):
            # densified in chunks of 2^24 / F rows, each predicted on its
            # own (lightgbm_tpu/basic.py:695-705)
            csr = data.tocsr()
            chunk = max(1, (1 << 24) // max(csr.shape[1], 1))
            if csr.shape[0] > chunk:
                return np.concatenate([
                    self.predict(csr[i:i + chunk],
                                 num_iteration=num_iteration,
                                 raw_score=raw_score, pred_leaf=pred_leaf,
                                 pred_contrib=pred_contrib, **kwargs)
                    for i in range(0, csr.shape[0], chunk)], axis=0)
            data = csr.toarray()
        X = np.asarray(data, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        K = max(self.num_model_per_iteration, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else len(self.trees) // K
        use_trees = self.trees[: num_iteration * K]
        N = X.shape[0]
        if pred_leaf:
            route = "leaf"
        elif pred_contrib:
            route = "contrib"
        else:
            early_stop = bool(kwargs.get("pred_early_stop",
                                         self.config.pred_early_stop))
            if early_stop:
                from .objectives import OBJECTIVE_ALIASES
                obj = OBJECTIVE_ALIASES.get(self.config.objective,
                                            self.config.objective)
                if obj not in ("binary", "multiclass", "multiclassova"):
                    # reference prediction_early_stop.cpp: binary/multiclass
                    # only
                    Log.fatal("Early stopping prediction is only supported "
                              "for binary and multiclass objectives")
            if early_stop and not raw_score and len(use_trees):
                route = "early_stop"
            elif N * max(len(use_trees), 1) >= DEVICE_PREDICT_MIN_WORK \
                    and not kwargs.get("force_host_predict", False):
                route = "device"
            else:
                route = "host"
        with obs.span("predict", rows=N, trees=len(use_trees), route=route):
            return self._predict_rows(X, use_trees, K, route, raw_score,
                                      kwargs)

    def _predict_rows(self, X: np.ndarray, use_trees, K: int, route: str,
                      raw_score: bool, kwargs) -> np.ndarray:
        """``predict``'s work on an f64 ``[N, F]`` matrix by ``route``:
        leaf indices, TreeSHAP contributions, the host early stop, the
        device walk (``ops/predict.forest_predict_raw``) or the host
        trees; then the output conversion in a ``predict.convert``
        span."""
        if route == "leaf":
            return np.stack([t.predict_leaf(X) for t in use_trees], axis=1)
        if route == "contrib":
            if any(t.is_linear for t in use_trees):
                # TreeSHAP attributes constant leaf outputs only
                # (lightgbm_tpu/basic.py:721-727)
                Log.fatal("pred_contrib is not supported for linear-tree "
                          "models (linear_tree=true): TreeSHAP "
                          "contributions are defined over constant leaf "
                          "outputs")
            F1 = self.num_total_features + 1
            out = np.zeros((K, X.shape[0], F1))
            for i, t in enumerate(use_trees):
                out[i % K] += t.predict_contrib(X, self.num_total_features)
            if self.config.boosting_normalized == "rf":
                out /= max(len(use_trees) // K, 1)   # rf averages trees
            return out[0] if K == 1 else np.concatenate(list(out), axis=1)
        N = X.shape[0]
        raw = np.zeros((K, N), dtype=np.float64)
        if route == "early_stop":
            # the reference's per-row margin early stop, on the host in
            # tree order (lightgbm_tpu/basic.py:742-775): a row leaves once
            # its margin (binary 2|raw|, multiclass top-1 minus top-2)
            # reaches pred_early_stop_margin at a check every
            # pred_early_stop_freq iterations
            freq = max(int(kwargs.get("pred_early_stop_freq",
                                      self.config.pred_early_stop_freq)), 1)
            margin_thr = float(kwargs.get("pred_early_stop_margin",
                                          self.config.pred_early_stop_margin))
            active = np.ones(N, dtype=bool)
            for it in range(len(use_trees) // K):
                rows = np.nonzero(active)[0]
                if len(rows) == 0:
                    break
                for k in range(K):
                    raw[k, rows] += use_trees[it * K + k].predict(X[rows])
                if (it + 1) % freq == 0:
                    if K == 1:
                        margin = 2.0 * np.abs(raw[0, rows])
                    else:
                        part = np.sort(raw[:, rows], axis=0)
                        margin = part[-1] - part[-2]
                    active[rows] = margin < margin_thr
        elif route == "device":
            # a forest with a categorical split takes the host route in
            # forest_predict_raw, said once
            from .ops.predict import forest_predict_raw
            forests = self._stacked_forests(use_trees, K)
            dev = resolve_device(self.config)
            for k in range(K):
                raw[k] = forest_predict_raw(
                    use_trees[k::K], X, self.num_total_features, dev,
                    forest=forests[k])
        else:
            for i, t in enumerate(use_trees):
                raw[i % K] += t.predict(X)
        if self.config.boosting_normalized == "rf":
            # the average of already-converted tree outputs (rf.hpp
            # average_output_)
            raw /= max(len(use_trees) // K, 1)
        elif not raw_score:
            with obs.span("predict.convert"):
                raw = self._convert_output(raw)
        return raw[0] if K == 1 else raw.T

    def _stacked_forests(self, use_trees, K: int):
        """Per-class ``StackedForest``s for the device walk, kept across
        calls (with their device tensors, ``StackedForest.to``) in a small
        LRU keyed by the tree slice, as the JAX package does
        (basic.py:803-827): a serving loop that alternates
        ``num_iteration`` keeps both entries. ``_forest_rev``, not the
        length, keys the content: a rollback and retrain land on the same
        length with other trees."""
        from .ops.predict import StackedForest
        key = (self._forest_rev, len(use_trees), K)
        forests = self._stacked_cache.get(key)
        if forests is None:
            forests = [StackedForest(use_trees[k::K], self.num_total_features)
                       for k in range(K)]
            self._stacked_cache.put(key, forests)
        return forests

    def _convert_output(self, raw: np.ndarray) -> np.ndarray:
        from .objectives import OBJECTIVE_ALIASES
        name = OBJECTIVE_ALIASES.get(self.config.objective,
                                     self.config.objective)
        if name in ("binary", "multiclassova"):
            return 1.0 / (1.0 + np.exp(-self.config.sigmoid * raw))
        if name == "multiclass":
            e = np.exp(raw - raw.max(axis=0, keepdims=True))
            return e / e.sum(axis=0, keepdims=True)
        if name == "poisson":
            return np.exp(raw)
        if name == "xentropy":
            return 1.0 / (1.0 + np.exp(-raw))
        if name == "xentlambda":
            return np.log1p(np.exp(raw))
        return raw

    # -- evaluation ----------------------------------------------------------

    def _feval_results(self, feval, dataset_name: str):
        """A custom eval callable on one attached dataset (reference
        __inner_eval's feval leg, basic.py:1612-1620)."""
        if feval is None:
            return []
        gbdt = self._gbdt
        if dataset_name == self._train_data_name:
            train_ds = getattr(self, "train_dataset", None)
            if train_ds is None:
                Log.fatal("eval_train with a custom feval needs the "
                          "training Dataset, which free_dataset() released")
            targets = [(train_ds, gbdt.score)]
        else:
            targets = [(vs, vs.score) for vs in gbdt.valid_sets
                       if vs.name == dataset_name]
        out = []
        for ds, score in targets:
            preds = gbdt._convert(score).cpu().numpy().reshape(-1)
            res = feval(preds, ds)
            res = [res] if isinstance(res, tuple) else res
            out.extend((dataset_name, n, v, h) for n, v, h in res)
        return out

    def _live_gbdt(self):
        if self._gbdt is None:
            Log.fatal("eval needs live training state — the booster was "
                      "freed or loaded from a model file")
        return self._gbdt

    def eval(self, data: Dataset, name: str, feval=None):
        """Evaluate the current model on ``data`` (reference basic.py:1543):
        the training set, an attached valid set, or a new Dataset (attached
        as a valid set first, like the reference's push)."""
        if not isinstance(data, Dataset):
            raise TypeError("Can only eval for Dataset instance")
        gbdt = self._live_gbdt()
        if data is getattr(self, "train_dataset", None):
            return self.eval_train(feval)
        for ds, nm in self._valid_registry:
            if data is ds:
                return gbdt.eval_all(only=nm) + self._feval_results(feval, nm)
        self.add_valid(data, name)
        return gbdt.eval_all(only=name) + self._feval_results(feval, name)

    def eval_train(self, feval=None):
        """Evaluate on the training data (reference basic.py:1577)."""
        res = [(self._train_data_name, n, v, h)
               for _d, n, v, h in self._live_gbdt().eval_all(
                   force_training=True, only="training")]
        return res + self._feval_results(feval, self._train_data_name)

    def eval_valid(self, feval=None):
        """Evaluate on every attached validation set (basic.py:1592)."""
        gbdt = self._live_gbdt()
        res = [r for r in gbdt.eval_all() if r[0] != "training"]
        if feval is not None:
            for vs in gbdt.valid_sets:
                res.extend(self._feval_results(feval, vs.name))
        return res

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    # -- attributes (reference basic.py:1932-1969: in-memory k/v store) ------

    def attr(self, key: str):
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        for k, v in kwargs.items():
            if v is None:
                self._attr.pop(k, None)
            else:
                self._attr[k] = str(v)
        return self

    # -- network (reference basic.py:1374-1399) ------------------------------

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Record the distributed wiring params (reference SetNetwork,
        ``basic.py:883-899`` there): the next training joins the world they
        describe (``parallel.comm.init_distributed``), one process per
        rank, each finding its rank by ``local_listen_port``."""
        if not isinstance(machines, str):
            machines = ",".join(machines)
        self.params.update(machines=machines,
                           local_listen_port=local_listen_port,
                           time_out=listen_time_out,
                           num_machines=num_machines)
        self.config = Config.from_params(self.params)
        if self._gbdt is not None:
            Log.warning("set_network after training setup applies to the "
                        "next training, not the current booster")
        return self

    def free_network(self) -> "Booster":
        for k in ("machines", "local_listen_port", "time_out",
                  "num_machines"):
            self.params.pop(k, None)
        self.config = Config.from_params(self.params)
        return self

    # -- model io ------------------------------------------------------------

    def dump_model(self, num_iteration: Optional[int] = None) -> Dict:
        """The JSON model dict (reference GBDT::DumpModel;
        ``io/model_json.py``)."""
        from .io.model_json import dump_model_dict
        self._ensure_finalized()
        return dump_model_dict(self, num_iteration)

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None) -> "Booster":
        from .io.model_text import save_model_file
        self._ensure_finalized()
        save_model_file(self, filename, num_iteration)
        return self

    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        from .io.model_text import model_to_string
        self._ensure_finalized()
        return model_to_string(self, num_iteration)

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Split counts or total gains per feature (reference boosting.h:216)."""
        self._ensure_finalized()
        imp = np.zeros(self.num_total_features, dtype=np.float64)
        for t in self.trees:
            for i in range(t.num_internal):
                if importance_type == "split":
                    imp[t.split_feature[i]] += 1
                else:
                    imp[t.split_feature[i]] += t.split_gain[i]
        if importance_type == "split":
            return imp.astype(np.int64)
        return imp

    def feature_name(self) -> List[str]:
        return list(self.feature_names)

    def num_feature(self) -> int:
        return int(self.num_total_features)

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """Output value of one leaf (reference basic.py:1746 /
        LGBM_BoosterGetLeafValue)."""
        self._ensure_finalized()
        return float(self.trees[tree_id].leaf_value[leaf_id])

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_gbdt", None)
        state.pop("train_dataset", None)
        # the stacked forests hold device tensors; the registry holds live
        # Datasets: both are rebuilt after unpickling
        state.pop("_stacked_cache", None)
        state["_valid_registry"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._gbdt = None
        self._stacked_cache = LRUCache(capacity=4)
