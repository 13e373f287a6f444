"""Seconds of EFB planning: the program's ``construct.plan_bundles`` spans
(``boosting/gbdt._plan_bundles``: the conflict search over the row
sample, the bundled codes' materialisation and the decode tables' upload)
recorded in the traced run. It reads the process-wide tracer, so it holds
one run per process. Nothing where the program records no such span."""
from lightgbm_tpu_torch import observability as obs

UNIT = "s"
SOURCE = "program_span"
LAYER = "EFB planning (efb.py, boosting/gbdt._plan_bundles)"
MOVES = "setup_s"


def read(ctx):
    durs = [e["dur"] for e in obs.get_tracer().events()
            if e.get("name") == "construct.plan_bundles"
            and e.get("ph") == "X"]
    if not durs:
        return None
    return sum(durs) / 1e6
