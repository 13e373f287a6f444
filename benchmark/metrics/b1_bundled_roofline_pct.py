"""Kernel B1's share of its roofline in the profiled batch of a bundled
booster: the least time of the histograms its trees need (the root's rows
and each split's smaller child's, from the trees' own counts) at the
program's bundle counters, ``efb.bundles`` columns of ``efb.hist_bins``
bins and ``efb.code_bytes`` a code (``roofline/counts.py``), over the
device time of ``hist_kernel`` and ``finalize_kernel``. H100 SXM peaks at
700 W; the card's power limit is stated beside the number. Nothing where
the record holds no bundle counters."""
from benchmark.roofline import counts

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernel B1 (ops/cuda_histogram.py, csrc/histogram.cu)"
MOVES = "train_iter_ms"
KERNELS = ("hist_kernel", "finalize_kernel")


def read(ctx):
    r = ctx["record"]
    prof, efb = r.get("profile"), r.get("efb") or {}
    if not prof or not all(k in efb for k in ("bundles", "hist_bins",
                                              "code_bytes")):
        return None
    spent = sum(s for name, s in prof["device_s_by_name"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    first, end = r["profiled_trees"]
    work = counts.b1_work(r["trees"][first:end], int(efb["bundles"]),
                          int(efb["hist_bins"]), int(efb["code_bytes"]))
    return counts.share_pct(counts.least_seconds(work["bytes"],
                                                 work["operations"]), spent)
