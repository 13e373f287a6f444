"""The command-line application — a copy of ``lightgbm_tpu/cli.py``.

Reference counterpart: src/application/application.cpp + src/main.cpp — the
`task=train|predict|convert_model` dispatcher driven by `key=value` argv
pairs and a `config=<file>` conf file (`key = value` lines, `#` comments),
compatible with the reference's example configs
(examples/*/train.conf, predict.conf).

Usage:  python -m lightgbm_tpu_torch config=train.conf [key=value ...]

Training and prediction run on the card unless ``device=cpu`` is given.
``data=`` may name a text file or a binary dataset file (``Dataset``'s own
detection), and ``two_round=true`` streams a text file in two passes.
The telemetry directory and ``dump_snapshot`` write the port's
observability registry at the end of training.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .engine import train as train_fn
from .io.file_io import load_data_file
from .utils.log import Log


# every task value main() dispatches on (bare-subcommand whitelist derives
# from this so the two can't drift)
TASK_TOKENS = ("train", "predict", "prediction", "test",
               "convert_model", "convert", "serve_bench")


def parse_args(argv: List[str]) -> Dict[str, str]:
    """argv `key=value` pairs + conf file merge; argv wins on conflict
    (reference Application::LoadParameters, application.cpp:48-81)."""
    cli: Dict[str, str] = {}
    for tok in argv:
        tok = tok.strip()
        if not tok or tok.startswith("#"):
            continue
        if tok.startswith("--"):
            # GNU-style convenience form: `--telemetry-dir=/x` ==
            # `telemetry_dir=/x` (the reference CLI is strictly key=value).
            # Only the KEY normalizes dashes to underscores — the value must
            # pass through untouched (`--data=/path/my-file.csv`)
            tok = tok[2:]
            if "=" in tok:
                k, v = tok.split("=", 1)
                tok = k.replace("-", "_") + "=" + v
            else:
                tok = tok.replace("-", "_")
        if "=" not in tok:
            if tok == "dump_snapshot":
                # bare `--dump-snapshot`: write observability.snapshot() to
                # the default file at train end (an explicit
                # `--dump-snapshot=FILE` names the destination instead)
                cli.setdefault("dump_snapshot", "observability_snapshot.json")
                continue
            # convenience subcommand form: `cli train config=...` ==
            # `cli task=train config=...` (the reference CLI is strictly
            # key=value, application.cpp:48-81; the bare form costs
            # nothing). Must cover exactly main()'s dispatch set incl.
            # aliases — see TASK_TOKENS.
            if tok in TASK_TOKENS:
                if cli.setdefault("task", tok) != tok:
                    Log.warning("task already set to %s; ignoring bare "
                                "subcommand %s", cli["task"], tok)
            else:
                Log.warning("Unknown argument %s (expected key=value)", tok)
            continue
        k, v = tok.split("=", 1)
        cli[k.strip()] = v.strip().strip('"')

    params: Dict[str, str] = {}
    conf_path = cli.get("config", cli.get("config_file", ""))
    if conf_path:
        with open(conf_path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                params[k.strip()] = v.strip().strip('"')
    params.update(cli)                  # argv has higher priority (:76-80)
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def run_train(params: Dict) -> None:
    config = Config.from_params(params)
    # reference verbosity semantics (utils/log.py): <0 fatal-only,
    # 0 warnings, 1 info, >1 debug
    Log.set_level(config.verbose)
    if config.telemetry_dir:
        # telemetry_dir=... / --telemetry-dir=...: JSONL + Perfetto trace
        # under this directory, flushed when training ends
        from . import observability as obs
        obs.configure(telemetry_dir=config.telemetry_dir)
    if not config.data:
        Log.fatal("No training data specified (data=...)")
    # through Dataset: binary files, two-round loading, and text with its
    # label, side columns and side files
    train_set = Dataset(config.data, params=params)
    valid_sets, valid_names = [], []
    for i, vf in enumerate(config.valid_data):
        valid_sets.append(Dataset(vf, params=params, reference=train_set))
        valid_names.append(f"valid_{i + 1}" if len(config.valid_data) > 1 else "valid_1")
    callbacks = []
    saved_handlers = []
    if config.checkpoint_dir:
        # preemption-friendly runs (docs/Fault-Tolerance.md): SIGTERM/SIGINT
        # request an on-demand atomic checkpoint at the next iteration
        # boundary, then exit 143 — restarting the identical command with
        # resume_from=auto continues bit-identically. A SECOND signal
        # escalates (KeyboardInterrupt) so a hung iteration — where the
        # boundary never arrives — stays interruptible without SIGKILL.
        import signal

        stop_signals: List[int] = []

        def _on_signal(signum, frame):
            stop_signals.append(signum)
            if len(stop_signals) > 1:
                Log.warning("signal %d received again before an iteration "
                            "boundary: aborting without a checkpoint", signum)
                raise KeyboardInterrupt
            Log.warning("signal %d received: writing a checkpoint at the "
                        "next iteration boundary, then exiting", signum)

        for _sig in (signal.SIGTERM, signal.SIGINT):
            try:
                saved_handlers.append((_sig, signal.signal(_sig, _on_signal)))
            except ValueError:       # non-main thread (embedded use)
                pass

        def _signal_checkpoint(env):
            if stop_signals:
                path = env.model.save_checkpoint()
                Log.warning("checkpoint %s written on signal %d; exiting",
                            path, stop_signals[0])
                raise SystemExit(143)
        _signal_checkpoint.order = 50
        callbacks.append(_signal_checkpoint)
    if config.snapshot_freq > 0:
        # reference: model.snapshot_iter_N every snapshot_freq iterations
        # during training (gbdt.cpp:349-353, config.h:103)
        def _snapshot(env):
            it = env.iteration + 1
            if it % config.snapshot_freq == 0:
                env.model._finalize()
                env.model.save_model(f"{config.output_model}.snapshot_iter_{it}")
        _snapshot.order = 30
        callbacks.append(_snapshot)
    try:
        # the JAX package maps stream-shard corruption and comm loss to
        # typed exits here; the port has neither (ROADMAP A14, A16)
        booster = train_fn(params, train_set,
                           num_boost_round=config.num_iterations,
                           valid_sets=valid_sets, valid_names=valid_names,
                           init_model=config.input_model or None,
                           early_stopping_rounds=(
                               config.early_stopping_round or None),
                           callbacks=callbacks)
    finally:
        if saved_handlers:
            # past the training loop nothing checks stop_signals — restore
            # the previous handlers so model save/predict stay interruptible
            import signal
            for _sig, _old in saved_handlers:
                signal.signal(_sig, _old)
    booster.save_model(config.output_model)
    Log.info("Finished training, model saved to %s", config.output_model)
    if config.telemetry_dir or config.dump_snapshot:
        from . import observability as obs
        obs.flush()
        if config.dump_snapshot:
            obs.write_snapshot(config.dump_snapshot)
        if config.telemetry_dir:
            obs.write_snapshot(os.path.join(config.telemetry_dir,
                                            f"snapshot_{os.getpid()}.json"))


def run_predict(params: Dict) -> None:
    config = Config.from_params(params)
    Log.set_level(config.verbose)
    if not config.input_model:
        Log.fatal("No input model specified for prediction (input_model=...)")
    if not config.data:
        Log.fatal("No prediction data specified (data=...)")
    booster = Booster(params=params, model_file=config.input_model)
    X, _, _ = load_data_file(config.data, params)
    niter = config.num_iteration_predict if config.num_iteration_predict > 0 else None
    preds = booster.predict(
        X, num_iteration=niter,
        raw_score=config.is_predict_raw_score,
        pred_leaf=config.is_predict_leaf_index,
        pred_contrib=config.is_predict_contrib)
    preds = np.atleast_2d(preds.T).T if preds.ndim == 1 else preds
    with open(config.output_result, "w") as fh:
        for row in (preds if preds.ndim == 2 else preds[:, None]):
            fh.write("\t".join(f"{v:.18g}" for v in np.atleast_1d(row)) + "\n")
    Log.info("Finished prediction, results saved to %s", config.output_result)


def run_serve_bench(params: Dict) -> None:
    """task=serve_bench: load a model (text/proto/JSON) into the serving
    engine, replay closed-loop load from `data=` at a few concurrency x
    batch-size shapes, and print one JSON report with p50/p99 latency and
    rows/s per shape (docs/Serving.md). The hermetic full-harness version
    — Poisson open loop, recompile pinning, ledger banking — is
    ``python bench.py --serve``; this task is the operator's quick probe
    against a real model artifact."""
    import json

    config = Config.from_params(params)
    Log.set_level(config.verbose)
    if not config.input_model:
        Log.fatal("No input model specified for serve_bench (input_model=...)")
    if not config.data:
        Log.fatal("No request data specified for serve_bench (data=...)")
    from .serving import ServingEngine
    from .serving.loadgen import run_closed_loop
    engine = ServingEngine(config.input_model, params=params)
    X, _, _ = load_data_file(config.data, params)
    X = np.asarray(X, np.float64)
    shapes = [(1, 1), (8, 4), (64, 4)]
    shapes = [(b, c) for b, c in shapes if b <= X.shape[0]] or [(X.shape[0], 1)]
    report = {"task": "serve_bench", "model": config.input_model,
              "engine": engine.describe(), "shapes": {}}
    for batch, conc in shapes:
        r = run_closed_loop(engine.predict, X, batch, conc,
                            requests_per_worker=max(200 // conc, 20))
        report["shapes"][f"b{batch}xc{conc}"] = r
    print(json.dumps(report))
    if config.dump_snapshot:
        from . import observability as obs
        obs.write_snapshot(config.dump_snapshot)
        Log.info("serving snapshot written to %s", config.dump_snapshot)


def run_convert_model(params: Dict) -> None:
    config = Config.from_params(params)
    Log.set_level(config.verbose)
    if not config.input_model:
        Log.fatal("No input model specified (input_model=...)")
    booster = Booster(params=params, model_file=config.input_model)
    from .io.codegen import model_to_cpp
    with open(config.convert_model, "w") as fh:
        fh.write(model_to_cpp(booster))
    Log.info("Model converted to C++ at %s", config.convert_model)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = parse_args(argv)
    task = params.get("task", "train")
    if task == "train":
        run_train(params)
    elif task in ("predict", "prediction", "test"):
        run_predict(params)
    elif task in ("convert_model", "convert"):
        run_convert_model(params)
    elif task == "serve_bench":
        run_serve_bench(params)
    else:
        Log.fatal("Unknown task %s", task)
    return 0


if __name__ == "__main__":
    sys.exit(main())
