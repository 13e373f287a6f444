"""The whole scoring call's share of the card's peak: the least time of
one call's work (its f64 input read once, one output per row written once,
the comparisons along each row's path in each tree, counted by the
reference's walk) over the window's measured seconds per call. H100 SXM
peaks at 700 W."""
from benchmark.roofline import counts

UNIT = "%"
SOURCE = "host_clock"
LAYER = "device (whole call)"
MOVES = "score_rows_per_s"


def read(ctx):
    r = ctx["record"]
    prof = r.get("profile")
    if r.get("comparisons_per_call") is None or not r.get("calls") \
            or not prof or prof["busy_s"] <= 0:
        return None
    work = counts.scoring_work(r["rows_per_call"], r["num_features"],
                               r["comparisons_per_call"])
    return counts.share_pct(counts.least_seconds(work["bytes"],
                                                 work["operations"]),
                            r["window_s"] / r["calls"])
