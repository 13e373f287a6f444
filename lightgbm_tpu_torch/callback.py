"""Training callbacks (reference: python-package/lightgbm/callback.py:49-210);
a copy of ``lightgbm_tpu/callback.py``."""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

from .utils.log import Log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """print_evaluation in the reference. The period check is
    interval-CROSSING, not modulo: under fused multi-tree steps
    (tree_batch>1) callbacks only see batch-boundary iteration numbers,
    which may never hit an exact multiple of ``period`` (identical firing
    at tree_batch=1)."""
    state = {"last": 0}

    def _callback(env: CallbackEnv) -> None:
        if env.iteration + 1 < state["last"]:
            # the callback object was reused across train() calls (common
            # CV/fold loops): iterations restarted below the recorded
            # crossing point, so reset — otherwise every later run logs
            # nothing until it passes the previous run's last iteration
            state["last"] = 0
        if (period > 0 and env.evaluation_result_list
                and env.iteration + 1 - state["last"] >= period):
            state["last"] = env.iteration + 1
            result = "\t".join(
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


print_evaluation = log_evaluation


def record_evaluation(eval_result: Dict) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict()) \
                       .setdefault(metric, []).append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedules (reference callback.py reset_parameter).
    Supports learning_rate as list or callable(iteration)."""
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            elif isinstance(value, (list, tuple)):
                new_params[key] = value[env.iteration - env.begin_iteration]
            else:
                new_params[key] = value
        if new_params:
            env.model.reset_parameter(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            Log.fatal("For early stopping, at least one dataset and eval metric "
                      "is required for evaluation")
        for _name, _metric, _value, hib in env.evaluation_result_list:
            best_iter.append(0)
            if hib:
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)
            best_score_list.append(None)

    def _callback(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            return  # non-eval iteration (metric_freq > 1)
        if not best_score:
            _init(env)
        for i, (name, metric, value, _hib) in enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value, best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info("Early stopping, best iteration is: [%d]", best_iter[i] + 1)
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break
    _callback.order = 30
    return _callback
