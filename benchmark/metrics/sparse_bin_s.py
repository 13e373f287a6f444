"""Seconds of binning ``scipy.sparse`` input: the program's
``construct.bin`` spans marked ``sparse`` (the training set's column pass
over its CSC form and the valid set's, ``dataset.bin_sparse_host``)
recorded in the traced run. It reads the process-wide tracer, so it holds
one run per process. Nothing where no such span is marked."""
from lightgbm_tpu_torch import observability as obs

UNIT = "s"
SOURCE = "program_span"
LAYER = "dataset and binning (dataset.py, binning.py, ops/ingest.py)"
MOVES = "setup_s"


def read(ctx):
    durs = [e["dur"] for e in obs.get_tracer().events()
            if e.get("name") == "construct.bin" and e.get("ph") == "X"
            and (e.get("args") or {}).get("sparse")]
    if not durs:
        return None
    return sum(durs) / 1e6
