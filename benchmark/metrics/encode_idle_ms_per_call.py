"""Milliseconds per profiled scoring call in which the device sat idle
while the host encoded rows: the idle gaps the profiled window labels
with the program's ``predict.encode`` range (``StackedForest.encode_rows``),
over the profiled calls. Nothing where no gap carries that label."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "host encode (ops/predict.StackedForest.encode_rows)"
MOVES = "score_rows_per_s"


def read(ctx):
    prof = ctx["record"].get("profile")
    if not prof or not prof.get("calls"):
        return None
    idle = sum(s for name, s in prof["idle_gaps"] if name == "predict.encode")
    if idle <= 0:
        return None
    return idle / prof["calls"] * 1e3
