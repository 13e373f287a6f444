"""Device memory budget and the port's own residency estimate.

The counterparts of ``lightgbm_tpu/observability/memory.py:85-105``
(``hbm_budget_bytes``) and of its pre-flight. The JAX package prices a
TPU step (bf16 hi/lo channels, one-hot matmul operands, packed gather
rows); the port has none of those, so :func:`estimate_residency` prices
the buffers the port itself keeps on the card for a training run:

- ``codes``: the ``[N, G]`` code matrix, or under ``tpu_residency=stream``
  the prefetcher's two shard buffers (``ops/stream.ShardPrefetcher``);
- ``unpack``: the ``[shard_rows, G]`` buffer ``u4`` / ``u6`` shards
  unpack into (stream only);
- ``per_row``: the booster's and the grower's per-row tensors, ``4 * N``
  bytes each (``boosting/gbdt.GBDT``: the labels, weights, padding and
  bagging masks, scores, masked gradients and hessians ``[K, N]``, the
  scores an iteration may be rolled back to; ``grower.TreeGrower``: the
  tree's g / h / count mask, the leaf ids, and resident only the
  partition ``perm`` and its initial order);
- ``hist``: the ``[L+1, G, B, 3]`` f32 histogram cache, B1's ``[S, G, B]``
  integer accumulators (20 bytes a bin) and its ``[S, G, B, 3]`` output;
- ``scan``: the split scan's working set over the ``2S`` touched leaves'
  histograms (:data:`SCAN_COPIES` copies of ``[2S, G, B, 3]`` f32);
- ``wave_rows``: the temporaries of one wave's routing, partition and
  positions, :data:`WAVE_BYTES_PER_ROW` bytes per row of the pass: over
  ``N`` rows resident, over one shard's rows streamed.

The residency is decided when the booster is built, before any valid set
is attached, so the valid sets (resident in either residency) are not
priced.

``chip_smoke.py`` phase 17 prints the estimate beside the peak the card
reports (``torch.cuda.max_memory_allocated``), which is what checks the
constants above. Pure host arithmetic.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# temporaries of one wave per row of the pass: the routing table gathered
# per row ([rows, 6] i32 and its i64 index), the decision, the partition's
# prefix sums (i64) and scatter, or a streamed shard's positions (sort)
WAVE_BYTES_PER_ROW = 128
# f32 copies of the scanned histograms the split scan holds at once
# (cumulative sums, gains, masks)
SCAN_COPIES = 8


def hbm_budget_bytes(config=None, device=None) -> Optional[int]:
    """The device memory budget the residency decision judges against:
    env ``LGBM_TPU_HBM_BUDGET``, then config ``tpu_hbm_budget_bytes``, then
    the card's total memory (``torch.cuda.mem_get_info``); None on the CPU
    when neither knob is set."""
    env = os.environ.get("LGBM_TPU_HBM_BUDGET", "")
    if env:
        try:
            return int(float(env))
        except ValueError:
            from ..utils.log import Log
            Log.warning("LGBM_TPU_HBM_BUDGET=%r is not a byte count — "
                        "ignoring it (use plain bytes, e.g. 17179869184)",
                        env)
    if config is not None and getattr(config, "tpu_hbm_budget_bytes", 0) > 0:
        return int(config.tpu_hbm_budget_bytes)
    if device is not None and getattr(device, "type", "cpu") == "cuda":
        import torch
        return int(torch.cuda.mem_get_info(device)[1])
    return None


def estimate_residency(*, rows: int, cols: int, code_itemsize: int,
                       num_models: int, num_leaves: int, hist_bins: int,
                       slots: int, has_weight: bool = False,
                       shard_rows: int = 0, shard_bytes: int = 0,
                       unpack: bool = False) -> Dict:
    """Device bytes of a training run by component (module docstring).
    ``shard_rows`` > 0 prices ``tpu_residency=stream`` with shards of
    ``shard_bytes`` packed bytes; ``unpack`` when they are ``u4`` / ``u6``.
    """
    f32 = 4
    stream = shard_rows > 0
    comp = {}
    comp["codes"] = 2 * shard_bytes if stream else rows * cols * code_itemsize
    comp["unpack"] = shard_rows * cols if stream and unpack else 0
    # label, padding mask, bagging mask (+ weight); scores, masked g / h and
    # the rolled-back scores [K, N]; the grower's g, h, count mask, leaf ids
    # and, resident, its partition and initial order
    tensors = (3 + int(has_weight) + 4 * num_models + 4
               + (0 if stream else 2))
    comp["per_row"] = tensors * rows * f32
    bins = cols * hist_bins
    comp["hist"] = ((num_leaves + 1) * bins * 3 * f32
                    + slots * bins * (20 + 3 * f32))
    comp["scan"] = SCAN_COPIES * 2 * slots * bins * 3 * f32
    comp["wave_rows"] = WAVE_BYTES_PER_ROW * (shard_rows if stream else rows)
    total = int(sum(comp.values()))
    return {"residency": "stream" if stream else "device",
            "components": {k: int(v) for k, v in comp.items()},
            "total_bytes": total}
