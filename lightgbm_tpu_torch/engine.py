"""``train`` and ``cv`` — port of ``lightgbm_tpu/engine.py`` (reference
python-package engine.py:18, :310).

The training loop keeps the JAX package's order exactly (engine.py:347-394):
before-iteration callbacks, one batch of ``tree_batch`` boosting iterations
(``GBDT.train_batch``), metric eval when the batch crossed a
``metric_freq`` boundary (then the no-splits check), after-iteration
callbacks with the batch's last iteration; early stopping ends it through
``EarlyStopException``. A custom ``fobj`` and before-iteration callbacks
force batches of one, with the JAX package's warnings. Checkpoints
(``checkpoint_dir`` + ``checkpoint_interval``) are written by a callback
after the record callbacks, when a batch crosses an interval boundary, at
the JAX engine's iterations for the same ``tree_batch``; ``resume_from``
(a file, a directory, or ``"auto"``: the newest snapshot of
``checkpoint_dir`` that verifies) resumes before the loop
(``lightgbm_tpu/engine.py:160-226``). Left out (ROADMAP A17b): the hang
watchdog, the gang lease, the profiler window and telemetry.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation, reset_parameter)
from .config import Config
from .utils.log import Log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List] = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates=None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume_from: Optional[str] = None) -> Booster:
    """Mirror of reference engine.py:18 lgb.train, on the config's device
    (CUDA unless ``device=cpu``)."""
    params = dict(params or {})
    _v = params.get("verbose", params.get("verbosity"))
    if _v is not None:
        try:
            Log.set_level(int(_v))
        except (TypeError, ValueError):
            pass
    if "num_iterations" not in params and "num_boost_round" not in params:
        params["num_iterations"] = num_boost_round
    if early_stopping_rounds is not None:
        params["early_stopping_round"] = early_stopping_rounds
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    prev_booster: Optional[Booster] = None
    if init_model is not None:
        prev_booster = init_model if isinstance(init_model, Booster) \
            else Booster(params=params, model_file=init_model)

    booster = Booster(params=params, train_set=train_set)
    config = booster.config
    Log.set_level(config.verbose)
    n_rounds = config.num_iterations
    gbdt = booster._gbdt

    valid_sets = valid_sets or []
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            gbdt.config = gbdt.config.replace(is_training_metric=True)
            continue
        if vs.reference is None:
            vs.reference = train_set
        booster.add_valid(vs, valid_names[i] if valid_names
                          else f"valid_{i}")

    # continued training: scores start from the loaded model's raw
    # predictions (application.cpp:90-93), and its trees stay in the forest
    if prev_booster is not None and prev_booster.trees:
        Kp = max(prev_booster.num_model_per_iteration, 1)
        if Kp != gbdt.num_models:
            Log.fatal("init_model has %d models per iteration, training "
                      "config has %d", Kp, gbdt.num_models)
        # keep exactly the trees whose predictions seed the scores
        n_prev_iters = prev_booster.best_iteration \
            if prev_booster.best_iteration > 0 \
            else len(prev_booster.trees) // Kp
        # no boost-from-average bias on a non-empty model (gbdt.cpp:357-377)
        if abs(gbdt.init_score_value) > 1e-15:
            iv = gbdt.init_score_value
            gbdt.score = gbdt.score - iv
            for _vs in gbdt.valid_sets:
                _vs.score = _vs.score - iv
            gbdt.init_score_value = 0.0
        raw = np.asarray(prev_booster.predict(train_set.raw_data,
                                              raw_score=True))
        valid_raw = []
        for vs in valid_sets:
            if vs is train_set:
                continue
            vraw = np.asarray(prev_booster.predict(vs.raw_data,
                                                   raw_score=True))
            valid_raw.append(vraw.T if vraw.ndim == 2 else vraw)
        gbdt.add_base_score(raw.T if raw.ndim == 2 else raw, valid_raw)
        booster._prev_trees = list(prev_booster.trees[: n_prev_iters * Kp])

    # ---- checkpoint/resume (robustness/checkpoint.py) ----------------------
    resume_from = resume_from or config.resume_from or None
    start_iter = 0
    if resume_from:
        if prev_booster is not None:
            Log.fatal("resume_from cannot be combined with init_model — a "
                      "checkpoint already contains the full training state")
        resolved = resume_from
        if resume_from == "auto":
            # walk back to the newest snapshot that verifies, so a corrupt
            # latest costs one interval, not the run
            from .robustness.checkpoint import CheckpointManager
            resolved = CheckpointManager(config.checkpoint_dir) \
                .latest_verified() if config.checkpoint_dir else None
            if resolved is None:
                Log.info("resume_from=auto: no checkpoint under %r — "
                         "starting fresh", config.checkpoint_dir)
        if resolved:
            booster.resume(resolved)
            start_iter = gbdt.iter_
            if start_iter >= n_rounds:
                Log.warning("resumed checkpoint is already at iteration %d "
                            ">= num_iterations=%d — no further training",
                            start_iter, n_rounds)

    callbacks = list(callbacks or [])
    if config.checkpoint_dir and config.checkpoint_interval > 0:
        # interval-crossing, not modulo: under tree_batch > 1 the callback
        # runs at batch boundaries, which may skip an exact multiple
        ck_state = {"last": start_iter}

        def _checkpoint_cb(env):
            if env.iteration + 1 - ck_state["last"] >= \
                    config.checkpoint_interval:
                env.model.save_checkpoint()
                ck_state["last"] = env.iteration + 1
        _checkpoint_cb.order = 40     # after record_evaluation (order 20):
        callbacks.append(_checkpoint_cb)  # the snapshot sees this eval
    if learning_rates is not None:
        callbacks.append(reset_parameter(learning_rate=learning_rates))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        if not gbdt.valid_sets:
            Log.fatal("For early stopping, at least one validation dataset "
                      "is required")
        callbacks.append(early_stopping(early_stopping_rounds))
    if isinstance(verbose_eval, bool):
        if verbose_eval:
            callbacks.append(log_evaluation(1))
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.append(log_evaluation(verbose_eval))
    if evals_result is not None:
        callbacks.append(record_evaluation(evals_result))
    callbacks.append(record_evaluation(booster.eval_history))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    # batches of iterations (tree_batch, boosting/gbdt.py): eval,
    # callbacks and early stopping on batch boundaries
    tree_batch = gbdt.tree_batch
    if fobj is not None and tree_batch > 1:
        Log.warning("tree_batch=%d needs a built-in objective (fobj requires "
                    "a host round-trip per tree); falling back to "
                    "tree_batch=1", tree_batch)
        tree_batch = 1
    if before and tree_batch > 1:
        # before-iteration callbacks (reset_parameter, the learning_rates
        # schedule) retune every iteration; under batching they would fire
        # once per batch and train a different model
        Log.warning("tree_batch=%d is not supported with before-iteration "
                    "callbacks (learning_rates / reset_parameter retune "
                    "per iteration); falling back to tree_batch=1",
                    tree_batch)
        tree_batch = 1
    metric_freq = max(config.metric_freq, 1)
    best_iteration = 0
    try:
        it = start_iter
        while it < n_rounds:
            k = min(tree_batch, n_rounds - it)
            for cb in before:
                cb(CallbackEnv(booster, params, it, 0, n_rounds, None))
            if fobj is not None:
                gbdt.train_one_iter_custom(fobj)
            else:
                gbdt.train_batch(k)
            it_end = it + k
            eval_results = []
            if gbdt.valid_sets or gbdt.config.is_training_metric:
                # eval when the batch crossed a metric_freq boundary
                # (== (it+1) % freq == 0 at k=1)
                if it_end // metric_freq > it // metric_freq:
                    eval_results = gbdt.eval_all()
                    if feval is not None:
                        eval_results.extend(_run_feval(feval, gbdt))
                    if gbdt._check_no_splits():
                        break
            for cb in after:
                cb(CallbackEnv(booster, params, it_end - 1, 0, n_rounds,
                               eval_results))
            it = it_end
    except EarlyStopException as e:
        best_iteration = e.best_iteration + 1
        booster.best_score = e.best_score

    booster._finalize()
    if best_iteration:
        # best_iteration indexes the FULL forest (prev + new): predict()
        # slices self.trees from the front
        booster.best_iteration = best_iteration + \
            len(booster._prev_trees) // max(gbdt.num_models, 1)
    if not keep_training_booster:
        booster.free_dataset()
    return booster


def _run_feval(feval, gbdt):
    out = []
    for vs in gbdt.valid_sets:
        preds = gbdt._convert(vs.score).cpu().numpy().reshape(-1)
        res = feval(preds, vs)
        if isinstance(res, tuple):
            res = [res]
        for name, value, hib in res:
            out.append((vs.name, name, value, hib))
    return out


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None) -> Dict[str, List[float]]:
    """K-fold cross-validation (reference engine.py:310), with the JAX
    package's fold construction from ``seed``."""
    params = dict(params or {})
    if early_stopping_rounds:
        params["early_stopping_round"] = early_stopping_rounds
    if metrics:
        params["metric"] = metrics
    train_set.construct(Config.from_params(train_set.params | params))
    n = train_set.num_data()
    label = train_set.get_label()
    rng = np.random.default_rng(seed)
    group_sizes = None if train_set.group is None \
        else np.asarray(train_set.group, dtype=np.int64)
    if folds is None and group_sizes is not None:
        # ranking: folds of whole queries, so that each fold keeps its
        # group structure (the JAX package's engine.py:497-520)
        nq = len(group_sizes)
        if nfold > nq:
            raise ValueError(f"Cannot have number of folds={nfold} greater "
                             f"than the number of queries={nq}")
        q_order = np.arange(nq)
        if shuffle:
            rng.shuffle(q_order)
        bounds = np.concatenate([[0], np.cumsum(group_sizes)])
        q_chunks = np.array_split(q_order, nfold)

        def rows_of(queries):
            return np.concatenate(
                [np.arange(bounds[q], bounds[q + 1])
                 for q in np.sort(queries)]) if len(queries) \
                else np.array([], np.int64)

        folds = [(rows_of(np.concatenate([c for j, c in enumerate(q_chunks)
                                          if j != f])),
                  rows_of(q_chunks[f])) for f in range(nfold)]
    if folds is None:
        idx = np.arange(n)
        if stratified and label is not None and len(np.unique(label)) <= \
                max(32, int(params.get("num_class", 2))):
            folds_idx = [[] for _ in range(nfold)]
            for cls in np.unique(label):
                cls_idx = idx[label == cls]
                if shuffle:
                    rng.shuffle(cls_idx)
                for f in range(nfold):
                    folds_idx[f].extend(cls_idx[f::nfold])
            folds = [(np.setdiff1d(idx, np.array(te)), np.array(sorted(te)))
                     for te in folds_idx]
        else:
            if shuffle:
                rng.shuffle(idx)
            chunks = np.array_split(idx, nfold)
            folds = [(np.concatenate([c for j, c in enumerate(chunks)
                                      if j != f]), chunks[f])
                     for f in range(nfold)]

    fold_records = []
    qid = None if group_sizes is None else np.repeat(
        np.arange(len(group_sizes)), group_sizes)
    for tr_idx, te_idx in folds:
        tr = train_set.subset(tr_idx, params=dict(train_set.params))
        te = Dataset(train_set.raw_data[te_idx],
                     label=None if label is None else label[te_idx],
                     group=None if qid is None
                     else group_sizes[np.unique(qid[te_idx])],
                     reference=tr)
        evals_result: Dict = {}
        train(params, tr, num_boost_round=num_boost_round, valid_sets=[te],
              valid_names=["valid"], fobj=fobj, feval=feval,
              early_stopping_rounds=early_stopping_rounds,
              evals_result=evals_result, verbose_eval=False,
              callbacks=callbacks)
        fold_records.append(evals_result.get("valid", {}))

    results: Dict[str, List[float]] = collections.defaultdict(list)
    if fold_records:
        for metric in fold_records[0]:
            lengths = [len(fr[metric]) for fr in fold_records if metric in fr]
            for i in range(min(lengths)):
                vals = [fr[metric][i] for fr in fold_records]
                results[f"{metric}-mean"].append(float(np.mean(vals)))
                results[f"{metric}-stdv"].append(float(np.std(vals)))
    return dict(results)
