"""Kernel B1's share of its roofline in the profiled batch: the least time
of the histograms its trees need (the root's rows and each split's
smaller child's, from the trees' own counts; ``roofline/counts.py``) over
the device time of ``hist_kernel`` and ``finalize_kernel``. H100 SXM peaks
at 700 W; the card's power limit is stated beside the number."""
from benchmark.roofline import counts

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernel B1 (ops/cuda_histogram.py, csrc/histogram.cu)"
MOVES = "train_iter_ms"
KERNELS = ("hist_kernel", "finalize_kernel")


def read(ctx):
    r = ctx["record"]
    prof = r.get("profile")
    if not prof:
        return None
    spent = sum(s for name, s in prof["device_s_by_name"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    first, end = r["profiled_trees"]
    data = ctx["config"]["data"]
    work = counts.b1_work(r["trees"][first:end], int(data["features"]),
                          int(data["levels"]) + 1)
    return counts.share_pct(counts.least_seconds(work["bytes"],
                                                 work["operations"]), spent)
