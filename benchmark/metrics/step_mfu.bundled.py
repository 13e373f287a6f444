"""The whole iteration's share of the card's peak for a bundled booster:
the least time of one iteration's work over the window's measured
milliseconds per iteration. The work, on average over the profiled batch's
trees: B1's histograms at the program's bundle counters (``efb.bundles``
columns of ``efb.hist_bins`` bins, ``efb.code_bytes`` a code); each
training row's bundled codes read once and its label, score and g / h
moved (``roofline/counts.ROW_STATE_BYTES``); each valid row's codes of
every feature (the valid set stays unbundled) and its score; the binary
objective's operations. H100 SXM peaks at 700 W. Nothing where the record
holds no bundle counters."""
from benchmark.roofline import counts

UNIT = "%"
SOURCE = "host_clock"
LAYER = "device (whole iteration)"
MOVES = "train_iter_ms"


def read(ctx):
    r = ctx["record"]
    efb = r.get("efb") or {}
    if not r.get("profile") or r["profile"]["busy_s"] <= 0 or not all(
            k in efb for k in ("features", "bundles", "hist_bins",
                               "code_bytes")):
        return None
    data = ctx["config"]["data"]
    n, nv = int(data["train_rows"]), int(data["valid_rows"])
    G, cb = int(efb["bundles"]), int(efb["code_bytes"])
    first, end = r["profiled_trees"]
    trees = r["trees"][first:end]
    b1 = counts.b1_work(trees, G, int(efb["hist_bins"]), cb)
    k = max(len(trees), 1)
    nbytes = (b1["bytes"] / k + n * G * cb + n * counts.ROW_STATE_BYTES
              + nv * int(efb["features"]) + nv * 8)
    ops = b1["operations"] / k + n * counts.BINARY_ROW_OPS
    return counts.share_pct(counts.least_seconds(nbytes, ops),
                            r["train_iter_ms"] / 1e3)
