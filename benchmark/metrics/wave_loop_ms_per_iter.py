"""Device milliseconds of the wave loop per timed iteration: the
program's ``iteration.device_ms.waves`` (the CUDA events around each
round of wave replays, B1 and the split scan inside; the idle wait of a
flag read left out) over ``iteration.timed``, from the registry of the
traced run. It reads the process-wide registry, so it holds one run
per process. Nothing where no captured iteration was timed."""
from lightgbm_tpu_torch import observability as obs

UNIT = "ms"
SOURCE = "program_span"
LAYER = ("wave loop and split scan (grower.py, ops/split_finder.py; "
         "B1 inside)")
MOVES = "train_iter_ms"


def read(ctx):
    snap = obs.get_registry().snapshot()
    timed = snap["counters"].get("iteration.timed")
    part = snap["histograms"].get("iteration.device_ms.waves")
    if not timed or part is None:
        return None
    return part["sum"] / timed
