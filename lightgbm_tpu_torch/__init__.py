"""lightgbm_tpu_torch — the PyTorch/CUDA port of ``lightgbm_tpu``.

The same ``Dataset`` / ``Booster`` / ``train`` / ``cv`` / callbacks /
sklearn surface, config keys and model text as the JAX package, running
eagerly in PyTorch on an NVIDIA Hopper card (``device=tpu|gpu|cuda``, the
default) or on the host (``device=cpu``). The gradient histogram — the JAX
package's one Pallas kernel — is a CUDA C++ kernel written for ``sm_90a``
(``csrc/histogram.cu``), built with ``nvcc`` at first use. This package
imports neither JAX nor ``lightgbm_tpu``.

Ported: ``boosting=gbdt|goss|dart|rf`` with every objective of the JAX
package (regression L2/L1/Huber/Fair/Poisson, binary, multiclass softmax
and one-vs-all, cross-entropy and its lambda form, lambdarank with query
groups) or custom gradients, bagging and feature_fraction with
``jax.random``'s bits, valid sets, early stopping, callbacks, ``cv``, the
sklearn wrappers, ``tree_learner=serial``, dense or ``scipy.sparse``
numerical and categorical features (NaN handling included), EFB
(``enable_bundle``), piecewise-linear leaves (``linear_tree``), data
resident on the device; CSV / TSV / LibSVM and binary dataset files, text,
proto and JSON model files, C++ and PMML export, plotting, the command line
(``python -m lightgbm_tpu_torch``) and the C API (``capi_impl.py`` behind
``csrc/lgbm_capi.c``). Everything else raises with its ROADMAP item.
"""

__version__ = "0.1.0"

from .basic import Booster, Dataset
from .callback import (early_stopping, log_evaluation, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import cv, train
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
from .utils.log import LightGBMError

_SKLEARN_NAMES = ("LGBMModel", "LGBMClassifier", "LGBMRegressor",
                  "LGBMRanker")


def __getattr__(name):
    # the sklearn wrappers load on first use, so importing the package does
    # not try scikit-learn
    if name in _SKLEARN_NAMES:
        from . import sklearn
        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "cv",
           "early_stopping", "log_evaluation", "print_evaluation",
           "record_evaluation", "reset_parameter", "train",
           "plot_importance", "plot_metric", "plot_tree",
           "create_tree_digraph", *_SKLEARN_NAMES]
