"""Device milliseconds of the objective per timed iteration: the
program's ``iteration.device_ms.start`` (the CUDA events around the
replay of ``_part_start``: gradients, and row sampling where the
configuration samples) over ``iteration.timed``, from the registry of the
traced run. It reads the process-wide registry, so it holds one run
per process. Nothing where no captured iteration was timed."""
from lightgbm_tpu_torch import observability as obs

UNIT = "ms"
SOURCE = "program_span"
LAYER = "objective (objectives.py, boosting/gbdt._part_start)"
MOVES = "train_iter_ms"


def read(ctx):
    snap = obs.get_registry().snapshot()
    timed = snap["counters"].get("iteration.timed")
    part = snap["histograms"].get("iteration.device_ms.start")
    if not timed or part is None:
        return None
    return part["sum"] / timed
