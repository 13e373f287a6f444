"""The share of replayed waves that did work: 100 times the program's
``iteration.waves_needed`` over ``iteration.waves_run`` (the captured
iteration replays waves speculatively and reads ``done`` once per
round), from the process-wide registry, so it holds one run per
process. Nothing where no wave was replayed."""
from lightgbm_tpu_torch import observability as obs

UNIT = "%"
SOURCE = "program_counter"
LAYER = "iteration replay (boosting/gbdt._IterationGraphs)"
MOVES = "train_iter_ms"


def read(ctx):
    counters = obs.get_registry().snapshot()["counters"]
    run = counters.get("iteration.waves_run")
    needed = counters.get("iteration.waves_needed")
    if not run or needed is None:
        return None
    return 100.0 * needed / run
