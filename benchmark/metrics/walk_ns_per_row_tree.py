"""Device nanoseconds per row and tree of the profiled scoring calls: the
profiler's busy device time over rows times trees."""
UNIT = "ns"
SOURCE = "device_trace"
LAYER = "forest walk B6 (ops/predict.py)"
MOVES = "score_rows_per_s"


def read(ctx):
    r = ctx["record"]
    prof = r.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    work = prof["calls"] * r["rows_per_call"] * r["num_trees"]
    return prof["busy_s"] / work * 1e9
