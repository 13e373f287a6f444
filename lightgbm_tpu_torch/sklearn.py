"""scikit-learn API wrappers (reference: python-package/lightgbm/sklearn.py:137-770);
port of ``lightgbm_tpu/sklearn.py``.

``LGBMRegressor``, ``LGBMClassifier`` (binary, or multiclass for more than
two classes) and ``LGBMRanker`` (lambdarank with ``group``) train through
this package's ``train`` (pass ``device="cpu"`` to run on the host).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as _train
from .utils.log import Log

# Inherit sklearn's base classes when available (the reference does the same
# through its compat shim, sklearn.py _LGBMModelBase): BaseEstimator supplies
# __sklearn_tags__/clone support for GridSearchCV & friends, the mixins set
# the estimator type. Without sklearn the wrappers still work standalone.
try:
    from sklearn.base import (BaseEstimator as _SKBase,
                              ClassifierMixin as _SKClassifier,
                              RegressorMixin as _SKRegressor)
except ImportError:                                       # pragma: no cover
    _SKBase = object

    class _SKClassifier:                                  # noqa: D401
        pass

    class _SKRegressor:
        pass


class LGBMModel(_SKBase):
    """Base estimator (reference sklearn.py:137 LGBMModel)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True, importance_type: str = "split",
                 linear_tree: bool = False, linear_lambda: float = 0.0,
                 linear_max_features: int = 8, **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        # piecewise-linear leaves (docs/Linear-Trees.md): first-class so
        # get_params/set_params round-trip them for GridSearchCV & clone
        self.linear_tree = linear_tree
        self.linear_lambda = linear_lambda
        self.linear_max_features = linear_max_features
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self._objective = objective

    # sklearn plumbing
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin, "objective": self.objective,
            "class_weight": self.class_weight, "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples, "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree, "reg_alpha": self.reg_alpha,
            "reg_lambda": self.reg_lambda, "random_state": self.random_state,
            "n_jobs": self.n_jobs, "silent": self.silent,
            "importance_type": self.importance_type,
            "linear_tree": self.linear_tree,
            "linear_lambda": self.linear_lambda,
            "linear_max_features": self.linear_max_features,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _lgb_params(self) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbose": 0 if self.silent else 1,
            "linear_tree": self.linear_tree,
            "linear_lambda": self.linear_lambda,
            "linear_max_features": self.linear_max_features,
        }
        if self._objective is not None:
            params["objective"] = self._objective
        if self.random_state is not None:
            params["seed"] = self.random_state
        params.update(self._other_params)
        return params

    # ---- input validation (sklearn estimator-check contract) -----------

    def _validate_fit_inputs(self, X, y):
        """Shape/finiteness checks with sklearn's expected error phrasing
        (check_estimator: fit1d, inconsistent lengths, empty data, complex
        data, y None, y NaN/inf, 2-D column-vector y warning). X NaN is
        ALLOWED — missing values are a modeled feature (tags allow_nan)."""
        if y is None:
            raise ValueError(
                f"This {type(self).__name__} estimator requires y to be "
                "passed, but the target y is None.")
        shape = getattr(X, "shape", None)
        if shape is None:
            X = np.asarray(X)
            shape = X.shape
        # complex check only on dtype-bearing containers: sklearn's
        # not-an-array inputs refuse __array_function__ dispatch
        x_cplx = getattr(X, "dtype", None) is not None and np.iscomplexobj(X)
        y_cplx = getattr(y, "dtype", None) is not None and np.iscomplexobj(y)
        if x_cplx or y_cplx:
            raise ValueError("Complex data not supported")
        if len(shape) != 2:
            raise ValueError(
                f"Expected 2D array, got {len(shape)}D array instead. "
                "Reshape your data either using array.reshape(-1, 1) or "
                "array.reshape(1, -1).")
        n_samples, n_feat = int(shape[0]), int(shape[1])
        if n_samples == 0:
            raise ValueError(
                f"Found array with 0 sample(s) (shape={tuple(shape)}) while "
                "a minimum of 1 is required.")
        if n_feat == 0:
            raise ValueError(
                f"Found array with 0 feature(s) (shape={tuple(shape)}) "
                "while a minimum of 1 is required.")
        if n_samples < 2:
            raise ValueError(
                f"Found array with {n_samples} sample(s) while a minimum "
                "of 2 is required: histogram split finding needs at least "
                "two rows.")
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            import warnings
            try:
                from sklearn.exceptions import DataConversionWarning
            except ImportError:                       # pragma: no cover
                DataConversionWarning = UserWarning
            warnings.warn(
                "A column-vector y was passed when a 1d array was "
                "expected. Please change the shape of y to "
                "(n_samples,), for example using ravel().",
                DataConversionWarning)
            y = y.ravel()
        if y.ndim != 1:
            raise ValueError(f"y must be 1d, got shape {y.shape}")
        if y.shape[0] != n_samples:
            raise ValueError(
                "Found input variables with inconsistent numbers of "
                f"samples: [{n_samples}, {y.shape[0]}]")
        if np.issubdtype(y.dtype, np.floating) and \
                not np.isfinite(y).all():
            raise ValueError(
                "Input y contains NaN or infinity; supervised targets "
                "must be finite.")
        return X, y, n_feat

    def _validate_predict_input(self, X) -> int:
        """Fitted/shape/width checks; returns X's row count."""
        if self._Booster is None and \
                getattr(self, "_single_class", None) is None:
            try:
                from sklearn.exceptions import NotFittedError
            except ImportError:                       # pragma: no cover
                NotFittedError = ValueError
            raise NotFittedError(
                f"This {type(self).__name__} instance is not fitted yet. "
                "Call 'fit' with appropriate arguments before using this "
                "estimator.")
        shape = getattr(X, "shape", None)
        if shape is None:
            # np.asarray goes through __array__, which sklearn's
            # not-an-array test containers allow (np.shape does not)
            shape = np.asarray(X).shape
        if len(shape) != 2:
            raise ValueError(
                f"Expected 2D array, got {len(shape)}D array instead. "
                "Reshape your data either using array.reshape(-1, 1) or "
                "array.reshape(1, -1).")
        if self._n_features is not None and int(shape[1]) != self._n_features:
            raise ValueError(
                f"X has {int(shape[1])} features, but "
                f"{type(self).__name__} is expecting {self._n_features} "
                "features as input.")
        return int(shape[0])

    def __sklearn_tags__(self):                       # sklearn >= 1.6
        tags = super().__sklearn_tags__()
        tags.input_tags.sparse = True      # CSR/CSC ingested natively
        tags.input_tags.allow_nan = True   # NaN in X = missing values
        return tags

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False, feature_name="auto",
            categorical_feature="auto", callbacks=None):
        if getattr(self, "_fit_prevalidated", False):
            # LGBMClassifier.fit already validated and label-encoded
            self._fit_prevalidated = False
        else:
            X, y, n_feat = self._validate_fit_inputs(X, y)
            self.n_features_in_ = n_feat
        params = self._lgb_params()
        params.update(self.__dict__.pop("_fit_params_extra", {}))
        # reference verbosity semantics: `silent`/`verbose` params reach
        # Log.set_level (utils/log.py) — silent=True estimators train at
        # warning level, verbose=-1 in **kwargs silences warnings too
        _v = params.get("verbose", params.get("verbosity"))
        if _v is not None:
            try:
                from .utils.log import Log
                Log.set_level(int(_v))
            except (TypeError, ValueError):
                pass
        # callable objective: the reference sklearn wrapper accepts
        # objective(y_true, y_pred) -> (grad, hess) and routes it as a
        # custom fobj (sklearn.py:137-213 _ObjectiveFunctionWrapper)
        fobj = None
        if callable(params.get("objective")):
            user_obj = params.pop("objective")

            def fobj(preds, dataset):
                return user_obj(dataset.get_label(), preds)

            params["objective"] = "none"
        self._used_custom_obj = fobj is not None
        if eval_metric is not None:
            params["metric"] = eval_metric
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights_to_sample_weight(y)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets = []
        valid_names = []
        if eval_set is not None:
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    vg = eval_group[i] if eval_group else None
                    vi = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(Dataset(vx, label=vy, reference=train_set,
                                              weight=vw, group=vg, init_score=vi))
                valid_names.append(eval_names[i] if eval_names else f"valid_{i}")
        self.evals_result_ = {}
        self._Booster = _train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self.evals_result_, fobj=fobj,
            verbose_eval=verbose, callbacks=callbacks)
        self._n_features = train_set.num_feature()
        self.best_iteration_ = self._Booster.best_iteration
        return self

    def _class_weights_to_sample_weight(self, y):
        y = np.asarray(y)
        classes, counts = np.unique(y, return_counts=True)
        if self.class_weight == "balanced":
            weights = {c: len(y) / (len(classes) * cnt) for c, cnt in zip(classes, counts)}
        else:
            weights = dict(self.class_weight)
        return np.asarray([weights.get(v, 1.0) for v in y], dtype=np.float32)

    def predict(self, X, raw_score: bool = False, num_iteration: Optional[int] = None,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        self._validate_predict_input(X)
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf, pred_contrib=pred_contrib)

    @property
    def booster_(self) -> Booster:
        return self._Booster

    @property
    def feature_importances_(self) -> np.ndarray:
        return self._Booster.feature_importance(self.importance_type)

    @property
    def n_features_(self):
        return self._n_features


class LGBMRegressor(_SKRegressor, LGBMModel):
    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "regression")
        super().__init__(**kwargs)
        self._objective = kwargs.get("objective", "regression")

    def fit(self, X, y, **kwargs):
        return super().fit(X, y, **kwargs)


class LGBMClassifier(_SKClassifier, LGBMModel):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def fit(self, X, y, **kwargs):
        # base-class shape/None/NaN validation FIRST — the label encoding
        # below would otherwise turn malformed y into confusing errors
        X, y, n_feat = self._validate_fit_inputs(X, y)
        if np.issubdtype(y.dtype, np.floating) and \
                not np.array_equal(y, np.round(y)):
            raise ValueError(
                f"Unknown label type: continuous targets are not supported "
                "by classifiers; use LGBMRegressor for regression.")
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        # classes that still carry training signal after sample_weight
        # zeroing (sklearn contract: a problem reduced to one class must
        # predict that class; the reference core faithfully emits no trees
        # there — gbdt.cpp:438-448 contributes nothing for 1-leaf trees —
        # so the constant-class answer lives in the wrapper)
        effective = self._classes
        sw = kwargs.get("sample_weight")
        if sw is not None:
            sw = np.asarray(sw, dtype=np.float64)
            effective = np.asarray(
                [c for c in self._classes if np.any((y == c) & (sw > 0))])
        if len(effective) < 2:
            self.n_features_in_ = n_feat
            self._n_features = n_feat
            self._Booster = None
            self._single_class = (effective[0] if len(effective)
                                  else self._classes[0])
            self._used_custom_obj = False
            self.evals_result_ = {}
            self.best_iteration_ = 0
            return self
        self._single_class = None
        self.n_features_in_ = n_feat
        self._fit_prevalidated = True
        # class_weight must be resolved against ORIGINAL labels, before
        # encoding remaps them to 0..k-1 (a dict keyed by user classes
        # would otherwise silently miss every row) — and it COMPOSES with a
        # user sample_weight multiplicatively (reference sklearn wrapper's
        # np.multiply of the two)
        if self.class_weight is not None:
            cw = self._class_weights_to_sample_weight(y)
            sw = kwargs.get("sample_weight")
            kwargs["sample_weight"] = cw if sw is None else \
                np.asarray(sw, dtype=np.float64) * cw
        # vectorized encode: _classes is sorted (np.unique), so the map
        # c -> index is exactly searchsorted — no per-row dict lookups
        y_enc = np.searchsorted(self._classes, y).astype(np.float64)
        # eval_set targets go through the SAME encoding (metrics compare
        # against the encoded training space); the (X, y) identity pair is
        # rewritten to (X, y_enc) so the base fit's train_set-reuse
        # shortcut still fires
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            enc_set = []
            for vx, vy in eval_set:
                if vx is X and vy is y:
                    enc_set.append((X, y_enc))
                    continue
                vy_arr = np.asarray(vy).ravel()
                unknown = ~np.isin(vy_arr, self._classes)
                if unknown.any():
                    raise ValueError(
                        "eval_set contains labels unseen in training: "
                        f"{np.unique(vy_arr[unknown])[:5]}")
                enc_set.append(
                    (vx, np.searchsorted(self._classes,
                                         vy_arr).astype(np.float64)))
            kwargs["eval_set"] = enc_set
        if self._n_classes > 2:
            self._objective = self.objective or "multiclass"
            self._other_params["num_class"] = self._n_classes
        else:
            self._objective = self.objective or "binary"
        return super().fit(X, y_enc, **kwargs)

    def predict_proba(self, X, raw_score=False, num_iteration=None, **kwargs):
        n_rows = self._validate_predict_input(X)
        if getattr(self, "_single_class", None) is not None:
            proba = np.zeros((n_rows, max(self._n_classes, 1)))
            proba[:, int(np.searchsorted(self._classes,
                                         self._single_class))] = 1.0
            return proba
        result = self._Booster.predict(X, raw_score=raw_score,
                                       num_iteration=num_iteration)
        if getattr(self, "_used_custom_obj", False) and not raw_score:
            # reference sklearn.py: class probabilities cannot be computed
            # under a customized objective — warn and return raw scores
            # (signed margins for binary, so argmax keeps the 0 boundary)
            Log.warning("Cannot compute class probabilities due to the "
                        "customized objective function; returning raw scores")
            # reference contract: the raw score array is returned UNCHANGED
            # (1-D for binary) — downstream code written against the
            # reference wrapper depends on that shape
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    def predict(self, X, raw_score=False, num_iteration=None, **kwargs):
        if getattr(self, "_single_class", None) is not None:
            n_rows = self._validate_predict_input(X)
            return np.full(n_rows, self._single_class)
        if raw_score:
            return self._Booster.predict(X, raw_score=True, num_iteration=num_iteration)
        proba = self.predict_proba(X, num_iteration=num_iteration)
        if proba.ndim == 1 or getattr(self, "_used_custom_obj", False):
            # custom objective: predict_proba returned raw margins (and
            # warned); the reference wrapper returns them unchanged from
            # predict() too — class labels cannot be derived without the
            # objective's link function (multiclass margins included: a
            # custom per-class link need not be argmax-preserving)
            return proba
        return self._classes[np.argmax(proba, axis=1)]

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "lambdarank")
        super().__init__(**kwargs)
        self._objective = kwargs.get("objective", "lambdarank")

    def fit(self, X, y, group=None, eval_at=None, **kwargs):
        if group is None:
            Log.fatal("Should set group for ranking task")
        # NDCG truncation positions (reference LGBMRanker.fit's eval_at ->
        # params['ndcg_eval_at']): fit-scoped, so that they stay out of
        # get_params()/clone
        if eval_at is not None:
            self._fit_params_extra = {"ndcg_eval_at": list(
                eval_at if hasattr(eval_at, "__iter__") else [eval_at])}
        return super().fit(X, y, group=group, **kwargs)
