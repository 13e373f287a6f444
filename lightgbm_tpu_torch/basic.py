"""User-facing Dataset and Booster — the slice's surface of
``lightgbm_tpu/basic.py`` (reference python-package basic.py: Dataset at
:556, Booster at :1234).

``Booster.predict`` walks the forest on the booster's device
(``ops/predict.py``) for large batches, like the JAX package, and on the
host for small ones; ``model_to_string`` / ``save_model`` and loading from
model text use the copied ``io/model_text.py``, so a model trained by
either package loads in the other. The prediction device is the config's
``device`` (CUDA unless ``device=cpu``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config, resolve_device
from .dataset import ConstructedDataset, construct_dataset
from .tree import Tree
from .utils.log import Log

# rows x trees at and above which Booster.predict walks on the device (the
# JAX package's threshold, basic.py:781)
DEVICE_PREDICT_MIN_WORK = 1_000_000


class Dataset:
    """Lazily constructed training dataset (reference basic.py:556): dense
    numerical features binned on the host at first use."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False):
        if isinstance(data, str):
            Log.fatal("loading data files is not ported to "
                      "lightgbm_tpu_torch yet (ROADMAP A18)")
        if hasattr(data, "tocsr"):
            Log.fatal("sparse input is not ported to lightgbm_tpu_torch yet "
                      "(ROADMAP A1)")
        self.raw_data = np.asarray(data, dtype=np.float64)
        if self.raw_data.ndim == 1:
            self.raw_data = self.raw_data.reshape(1, -1)
        self.label = None if label is None else np.asarray(label).reshape(-1)
        self.weight = weight
        self.init_score = init_score
        self.feature_name = None if feature_name == "auto" else feature_name
        self.categorical_feature = None if categorical_feature == "auto" \
            else categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._constructed: Optional[ConstructedDataset] = None

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._constructed is None:
            cfg = config or Config.from_params(self.params)
            self._constructed = construct_dataset(
                self.raw_data, self.label, cfg, weight=self.weight,
                init_score=self.init_score, feature_names=self.feature_name,
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
        if self._constructed is not None:
            return self._constructed.num_data
        return self.raw_data.shape[0]

    def num_feature(self) -> int:
        if self._constructed is not None:
            return self._constructed.num_total_features
        return self.raw_data.shape[1]

    def get_label(self):
        return self.label


class Booster:
    """Trained model handle (reference basic.py:1234). The forest lives as
    host ``Tree`` objects for prediction and serialisation; training state
    stays on the device inside the GBDT driver."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        self._gbdt = None
        self.trees: List[Tree] = []
        self.num_model_per_iteration = 1
        self.best_iteration = 0
        self.feature_names: List[str] = []
        self.num_total_features = 0
        self.mappers = []
        self.init_score_value = 0.0
        self.pandas_categorical = None
        self._synced_iter = -1
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
        from .boosting.gbdt import GBDT
        train_set.params.update(self.params)
        train_set.construct(self.config)
        cd = train_set.constructed
        self._gbdt = GBDT(self.config, cd)
        self.train_dataset = train_set
        self.feature_names = cd.feature_names
        self.num_total_features = cd.num_total_features
        self.mappers = cd.mappers
        self._real_feature_idx = cd.real_feature_idx

    def update(self) -> bool:
        """One boosting iteration (reference LGBM_BoosterUpdateOneIter)."""
        if self._gbdt is None:
            Log.fatal("Booster has no training data")
        self._gbdt.train_one_iter()
        return False

    def _ensure_finalized(self) -> None:
        """Materialise host trees iff the device forest changed."""
        if self._gbdt is not None and self._synced_iter != self._gbdt.iter_:
            self.trees = [t for it_trees in self._gbdt.finalize_model()
                          for t in it_trees]
            self.init_score_value = self._gbdt.init_score_value
            self._synced_iter = self._gbdt.iter_

    def free_dataset(self) -> "Booster":
        """Release device-side training state; predict/save keep working."""
        self._ensure_finalized()
        self._gbdt = None
        self.__dict__.pop("train_dataset", None)
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
        if hasattr(data, "tocsr"):
            Log.fatal("sparse input is not ported to lightgbm_tpu_torch yet "
                      "(ROADMAP A1)")
        X = np.asarray(data, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        K = max(self.num_model_per_iteration, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else len(self.trees) // K
        use_trees = self.trees[: num_iteration * K]
        if pred_leaf:
            return np.stack([t.predict_leaf(X) for t in use_trees], axis=1)
        if pred_contrib:
            F1 = self.num_total_features + 1
            out = np.zeros((K, X.shape[0], F1))
            for i, t in enumerate(use_trees):
                out[i % K] += t.predict_contrib(X, self.num_total_features)
            return out[0] if K == 1 else np.concatenate(list(out), axis=1)
        N = X.shape[0]
        raw = np.zeros((K, N), dtype=np.float64)
        if K == 1 and N * max(len(use_trees), 1) >= DEVICE_PREDICT_MIN_WORK:
            from .ops.predict import forest_predict_raw
            raw[0] = forest_predict_raw(use_trees, X, self.num_total_features,
                                        resolve_device(self.config))
        else:
            for i, t in enumerate(use_trees):
                raw[i % K] += t.predict(X)
        if not raw_score:
            raw = self._convert_output(raw)
        return raw[0] if K == 1 else raw.T

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

    # -- model io ------------------------------------------------------------

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
