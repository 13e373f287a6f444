"""The whole iteration's share of the card's peak: the least time of one
iteration's work (``roofline/counts.iteration_work`` over the profiled
batch's trees: B1's histograms, each row's codes and state once, the valid
rows, the objective's operations) over the window's measured
milliseconds per iteration. H100 SXM peaks at 700 W."""
from benchmark.roofline import counts

UNIT = "%"
SOURCE = "host_clock"
LAYER = "device (whole iteration)"
MOVES = "train_iter_ms"


def read(ctx):
    r = ctx["record"]
    if not r.get("profile") or r["profile"]["busy_s"] <= 0:
        return None
    data = ctx["config"]["data"]
    first, end = r["profiled_trees"]
    work = counts.iteration_work(r["trees"][first:end], {
        "rows": int(data["train_rows"]), "valid_rows": int(data["valid_rows"]),
        "features": int(data["features"]), "bins": int(data["levels"]) + 1,
        "pairs": r.get("pairs")})
    return counts.share_pct(counts.least_seconds(work["bytes"],
                                                 work["operations"]),
                            r["train_iter_ms"] / 1e3)
