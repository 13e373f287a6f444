"""The share of the profiled window in which no operation ran on the
device: 100 (1 - busy / window), both from the profiler's trace."""
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "score_rows_per_s"


def read(ctx):
    prof = ctx["record"].get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
