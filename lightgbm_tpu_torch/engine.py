"""``train`` — the slice's training entry point (port of
``lightgbm_tpu/engine.py`` train; reference python-package engine.py).

Valid sets, early stopping, callbacks and ``cv`` are not in this slice
(ROADMAP A8): passing valid sets raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .basic import Booster, Dataset
from .config import Config
from .utils.log import Log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets: Optional[list] = None,
          keep_training_booster: bool = False) -> Booster:
    """Train a GBDT for ``num_boost_round`` iterations on the config's
    device (CUDA unless ``device=cpu``) and return the Booster."""
    params = dict(params or {})
    # num_iterations (or an alias) in params wins, as in the JAX package
    if "num_iterations" not in params and "num_boost_round" not in params:
        params["num_iterations"] = num_boost_round
    Log.set_level(Config.from_params(params).verbose)
    if valid_sets:
        Log.fatal("valid_sets are not ported to lightgbm_tpu_torch yet "
                  "(ROADMAP A8)")
    booster = Booster(params=params, train_set=train_set)
    gbdt = booster._gbdt
    config = booster.config
    freq = max(config.metric_freq, 1)
    for it in range(config.num_iterations):
        gbdt.train_one_iter()
        if config.is_training_metric and (it + 1) % freq == 0:
            for d, name, value, _ in gbdt.eval_train():
                Log.info("[%d] %s's %s: %g", it + 1, d, name, value)
            if gbdt.check_no_splits():
                break
    booster._ensure_finalized()
    if not keep_training_booster:
        booster.free_dataset()
    return booster
