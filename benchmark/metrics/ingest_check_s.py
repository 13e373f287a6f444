"""Seconds of the device-ingest decision: the program's ``construct.defer``
spans (``dataset._maybe_defer``, whose scan of every row decides whether
the rows are f32-lossless and so binned on the device) recorded in the
traced run. It reads the process-wide tracer, so it holds one run per
process. Nothing where the program records no such span."""
from lightgbm_tpu_torch import observability as obs

UNIT = "s"
SOURCE = "program_span"
LAYER = "dataset and binning (dataset.py, binning.py, ops/ingest.py)"
MOVES = "setup_s"


def read(ctx):
    durs = [e["dur"] for e in obs.get_tracer().events()
            if e.get("name") == "construct.defer" and e.get("ph") == "X"]
    if not durs:
        return None
    return sum(durs) / 1e6
