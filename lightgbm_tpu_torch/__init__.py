"""lightgbm_tpu_torch — the PyTorch/CUDA port of ``lightgbm_tpu``.

The same ``Dataset`` / ``Booster`` / ``train`` surface, config keys and
model text as the JAX package, running eagerly in PyTorch on an NVIDIA
Hopper card (``device=tpu|gpu|cuda``, the default) or on the host
(``device=cpu``). The gradient histogram — the JAX package's one Pallas
kernel — is a CUDA C++ kernel written for ``sm_90a``
(``csrc/histogram.cu``), built with ``nvcc`` at first use. This package
imports neither JAX nor ``lightgbm_tpu``.

First slice: ``boosting=gbdt`` with the binary or L2 objective,
``tree_learner=serial``, dense numerical features (NaN handling included),
data resident on the device. Everything else raises with its ROADMAP item.
"""

__version__ = "0.1.0"

from .basic import Booster, Dataset
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train"]
