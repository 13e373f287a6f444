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

Exit codes a supervisor (``robustness/supervisor.py``) reads: 142 the hang
watchdog's abort (``robustness/watchdog.py``), 143 a checkpoint written on
SIGTERM/SIGINT (in a world the ranks agree on the boundary through the
store and every rank writes its shard), 144 a corrupt stream shard, 145
comm loss (a peer rank died or stopped answering; ``PeerLostError`` names
it). In a world these leave through one ``os._exit`` (:func:`_leave`), so
the interpreter's teardown never waits on a dead peer's process group.
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
from .ops.stream import EXIT_SHARD_CORRUPT, ShardCorruptionError
from .robustness.retry import CommTimeoutError, PeerLostError
from .robustness.supervisor import EXIT_SIGTERM_CHECKPOINT
from .robustness.watchdog import EXIT_COMM_LOST
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
            if _world_agrees_to_stop(bool(stop_signals)):
                path = env.model.save_checkpoint()
                Log.warning("checkpoint %s written on signal %s; exiting",
                            path, stop_signals[0] if stop_signals
                            else "of a peer rank")
                raise SystemExit(EXIT_SIGTERM_CHECKPOINT)
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
        try:
            booster = train_fn(params, train_set,
                               num_boost_round=config.num_iterations,
                               valid_sets=valid_sets,
                               valid_names=valid_names,
                               init_model=config.input_model or None,
                               early_stopping_rounds=(
                                   config.early_stopping_round or None),
                               callbacks=callbacks)
        except ShardCorruptionError as e:
            # a restartable fault (lightgbm_tpu/cli.py:177-188): the shard
            # store is rebuilt from the dataset when training starts again,
            # so exit with the status a supervisor recognizes
            Log.warning("stream-shard corruption detected: %s — exiting %d "
                        "(a supervisor relaunch with resume_from=auto "
                        "self-heals)", e, EXIT_SHARD_CORRUPT)
            _leave(EXIT_SHARD_CORRUPT, e)
        except CommTimeoutError as e:
            # comm loss (lightgbm_tpu/cli.py:192-217): a peer rank died or
            # stopped answering; PeerLostError names it
            Log.warning("comm loss: %s — exiting %d (%s; the fleet "
                        "supervisor relaunches the gang from the newest "
                        "consistent manifest)", e, EXIT_COMM_LOST,
                        f"lost peer rank {e.rank}"
                        if isinstance(e, PeerLostError)
                        else "collective deadline expired")
            _leave(EXIT_COMM_LOST, e)
        except SystemExit as e:
            if e.code == EXIT_SIGTERM_CHECKPOINT:
                _leave(EXIT_SIGTERM_CHECKPOINT, e)
            raise
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


def _in_world() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _leave(code: int, exc: BaseException) -> None:
    """The one way the train task leaves with a supervisor's exit code: in
    a world through ``os._exit`` (the interpreter's teardown would wait on
    the process group, and a dead peer's never answers), else
    ``SystemExit``."""
    if _in_world():
        from . import observability as obs
        try:
            obs.flush()
        except Exception as e:                               # noqa: BLE001
            Log.warning("telemetry flush on exit failed: %s: %s",
                        type(e).__name__, e)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    raise SystemExit(code) from exc


def _world_agrees_to_stop(signalled: bool) -> bool:
    """Whether this batch boundary is where training stops on a signal.
    One process: whether it got one. In a world every rank must checkpoint
    at the same boundary (the checkpoint all-gathers the scores and the
    gang commits one epoch), so the ranks exchange their flags through the
    store at every boundary (host only, no device read) and stop when any
    rank got a signal."""
    if not _in_world():
        return signalled
    from .parallel.comm import host_allgather
    return any(host_allgather(signalled, "signal_stop", timeout_ms=120_000))


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
