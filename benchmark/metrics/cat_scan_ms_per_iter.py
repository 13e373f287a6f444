"""Device milliseconds of the categorical split scan per timed iteration:
the program's ``iteration.device_ms.cat_scan`` (the pair of CUDA events
the captured wave records around ``ops/categorical``'s scan, pointed at a
pair of each wave's own before its replay and summed over every wave at
the round's flag read) over ``iteration.timed``, from the registry of the
traced run. It reads the
process-wide registry, so it holds one run per process. Nothing where no
categorical scan was timed."""
from lightgbm_tpu_torch import observability as obs

UNIT = "ms"
SOURCE = "program_span"
LAYER = "categorical split scan (ops/categorical.py)"
MOVES = "train_iter_ms"


def read(ctx):
    snap = obs.get_registry().snapshot()
    timed = snap["counters"].get("iteration.timed")
    part = snap["histograms"].get("iteration.device_ms.cat_scan")
    if not timed or part is None:
        return None
    return part["sum"] / timed
