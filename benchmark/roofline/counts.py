"""The least time of the work these inputs need, from shapes and counts.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its full 700 W power
limit: 3.35 TB/s of HBM bandwidth and 67 TFLOP/s in float32 outside the
tensor cores (nothing here runs on them). A share of a roofline is this
least time over a measured time, stated beside the card's power limit.

Counts are of the work the inputs need, whatever implements it: each
input byte read once, each output byte written once, the operations the
arithmetic needs.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# per row: the label, the score read, g and h written and read again, the
# score written (f32)
ROW_STATE_BYTES = 4 + 4 + 8 + 8 + 4
# per row, binary logloss's gradient and hessian: exp, add, divide,
# multiply, abs, subtract, multiply
BINARY_ROW_OPS = 7
# per pair of one query with different labels, LambdaRank's work: score
# gap (1), |gap| + 0.01 and the divide (3), gain gap times discount gap
# times inverse max DCG (3, the discounts' gap 2 more), the sigmoid 2 /
# (1 + exp(2 s x)) (4), the hessian p (2 - p) and its scale (4), and the
# four sums into both documents' g and h (4): 21
LAMBDARANK_PAIR_OPS = 21


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bandwidth and the compute bound."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def histogram_pass_cost(n_rows: int, num_features: int, num_bins: int,
                        num_slots: int, code_bytes: int = 1,
                        derived_positions: bool = False,
                        total_rows: Optional[int] = None,
                        slot_table: int = 256) -> Dict[str, int]:
    """A frozen copy of the port's ``ops/cuda_histogram.histogram_pass_cost``
    (as of this benchmark's first version): what one pass over ``n_rows``
    rows must move and do. ``bytes`` reads each row's codes and g / h /
    count once, plus where each row goes (its position and the ``[S]``
    segment tables), and writes the ``[S, F, B, 3]`` f32 output once;
    ``operations`` are the three adds of each row and feature."""
    row_bytes = num_features * code_bytes + 3 * 4
    if derived_positions:
        where = (n_rows if total_rows is None else total_rows) * 4 \
            + slot_table * 4
    else:
        where = n_rows * 4 + 2 * num_slots * 4
    out = num_slots * num_features * num_bins * 3 * 4
    return {"bytes": n_rows * row_bytes + where + out,
            "operations": 3 * n_rows * num_features,
            "output_bytes": out}


def histogram_rows(tree: Dict) -> Iterable[int]:
    """The rows of each histogram a tree needs with the subtraction trick:
    the root's, then the smaller child's of every split."""
    if tree["num_leaves"] <= 1:
        yield int(tree["leaf_count"][0])
        return
    yield int(tree["internal_count"][0])

    def count(c):
        return int(tree["internal_count"][c] if c >= 0
                   else tree["leaf_count"][~c])
    for i in range(len(tree["split_feature"])):
        yield min(count(tree["left_child"][i]), count(tree["right_child"][i]))


def b1_work(trees: Iterable[Dict], num_features: int, num_bins: int,
            code_bytes: int = 1) -> Dict[str, int]:
    """Bytes and operations of the histograms these trees need: one pass
    per histogram at the rows :func:`histogram_rows` gives."""
    nbytes = ops = 0
    for t in trees:
        for rows in histogram_rows(t):
            c = histogram_pass_cost(rows, num_features, num_bins, 1,
                                    code_bytes)
            nbytes += c["bytes"]
            ops += c["operations"]
    return {"bytes": nbytes, "operations": ops}


def iteration_work(trees: Iterable[Dict], shape: Dict) -> Dict[str, float]:
    """Bytes and operations of one boosting iteration, on average over
    ``trees`` (one per iteration): B1's work; each training row's codes
    read once and its label, score and g / h moved as
    :data:`ROW_STATE_BYTES`; each valid row's codes read once and its
    score read and written; the objective's operations (``pairs``: the
    ranking pairs, else one gradient per row)."""
    trees = list(trees)
    n, nv, F = shape["rows"], shape["valid_rows"], shape["features"]
    b1 = b1_work(trees, F, shape["bins"], shape.get("code_bytes", 1))
    k = max(len(trees), 1)
    nbytes = b1["bytes"] / k + n * F + n * ROW_STATE_BYTES + nv * F + nv * 8
    if shape.get("pairs") is not None:
        obj_ops = shape["pairs"] * LAMBDARANK_PAIR_OPS
    else:
        obj_ops = n * BINARY_ROW_OPS
    return {"bytes": nbytes, "operations": b1["operations"] / k + obj_ops}


def scoring_work(rows: int, features: int, comparisons: int,
                 input_bytes: int = 8, output_bytes: int = 8
                 ) -> Dict[str, float]:
    """One scoring call: the input rows read once (f64, as handed in), one
    output per row written once, and the comparisons along each row's
    actual path in each tree."""
    return {"bytes": rows * features * input_bytes + rows * output_bytes,
            "operations": float(comparisons)}


def share_pct(least_s: float, measured_s: float) -> Optional[float]:
    """``100 * least / measured``; None where nothing was measured."""
    if not measured_s or measured_s <= 0 or not np.isfinite(measured_s):
        return None
    return 100.0 * least_s / measured_s
