"""Device memory: the card's stats, the budget, and the port's own
residency estimate with its pre-flight line.

The counterparts of ``lightgbm_tpu/observability/memory.py``:
:func:`device_memory` (``:37-105``) reads ``torch.cuda.memory_stats()`` /
``mem_get_info()`` under the JAX package's keys, and returns ``{}`` while
CUDA is not initialized in the process (a serving ``snapshot()`` must never
initialize it); :func:`hbm_budget_bytes`; :func:`hbm_preflight`
(``:184-275``) over :func:`estimate_residency`, with the attached valid
sets priced, publishing ``memory.preflight.*`` gauges; and
:func:`log_budget` (``:276-325``), the ``engine.train`` budget line. The
JAX package prices a
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
  ``N`` rows resident, over one shard's rows streamed;
- ``valid``: the attached valid sets (resident in either residency):
  codes, the scores ``[K, n]`` three times (live, bound to the captured
  graphs, and kept for a rollback), labels and routed leaf ids.

The residency is decided when the booster is built, before any valid set
is attached, so that decision prices ``valid`` at 0; the pre-flight
(:func:`hbm_preflight`) runs after the valid sets are attached.

``chip_smoke.py`` phase 17 prints the estimate beside the peak the card
reports (``torch.cuda.max_memory_allocated``), which is what checks the
constants above. Pure host arithmetic.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

_GB = float(1 << 30)

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


def _cuda_initialized() -> bool:
    """True iff CUDA is already initialized in this process: the probe
    that keeps :func:`device_memory` from initializing it (the JAX
    package's ``_backend_initialized``)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:                                        # noqa: BLE001
        return False


def device_memory(device=None) -> Dict:
    """Memory stats of one card (default: the current one), under the JAX
    package's keys: ``platform``; ``bytes_in_use`` and
    ``peak_bytes_in_use`` (the caching allocator's allocated bytes, now
    and at their peak, ``torch.cuda.memory_stats``), ``bytes_reserved``,
    ``bytes_limit`` (the card's total memory, ``mem_get_info``); then
    ``peak_bytes`` (peak -> in use -> None) and ``capacity_bytes``
    (``bytes_limit`` or None). Host reads only, no device sync. Returns
    ``{}`` while CUDA is not initialized (on the CPU, and before the first
    CUDA call), so that ``snapshot()`` never initializes it."""
    if device is None and not _cuda_initialized():
        return {}
    try:
        import torch
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        if dev.type != "cuda":
            return {}
        out: Dict = {"platform": "gpu"}
        stats = torch.cuda.memory_stats(dev)
    except Exception:                                        # noqa: BLE001
        return {}
    for key, name in (("bytes_in_use", "allocated_bytes.all.current"),
                      ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                      ("bytes_reserved", "reserved_bytes.all.current")):
        if stats.get(name) is not None:
            out[key] = int(stats[name])
    try:
        out["bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
    except Exception as e:                                   # noqa: BLE001
        from ..utils.log import Log
        Log.debug("device_memory: no bytes_limit (%s)", e)
    out["peak_bytes"] = out.get("peak_bytes_in_use",
                                out.get("bytes_in_use"))
    out["capacity_bytes"] = out.get("bytes_limit")
    return out


def estimate_residency(*, rows: int, cols: int, code_itemsize: int,
                       num_models: int, num_leaves: int, hist_bins: int,
                       slots: int, has_weight: bool = False,
                       shard_rows: int = 0, shard_bytes: int = 0,
                       unpack: bool = False, valid_bytes: int = 0) -> Dict:
    """Device bytes of a training run by component (module docstring).
    ``shard_rows`` > 0 prices ``tpu_residency=stream`` with shards of
    ``shard_bytes`` packed bytes; ``unpack`` when they are ``u4`` / ``u6``;
    ``valid_bytes`` the attached valid sets (:func:`valid_set_bytes`).
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
    comp["valid"] = valid_bytes
    total = int(sum(comp.values()))
    return {"residency": "stream" if stream else "device",
            "components": {k: int(v) for k, v in comp.items()},
            "total_bytes": total}


def valid_set_bytes(valid_sets, num_models: int) -> int:
    """Device bytes of attached valid sets: codes, three ``[K, n]`` f32
    score buffers (live, bound to the captured graphs, kept for a
    rollback), the f32 label and i32 routed leaf ids, and under linear
    leaves the raw f32 values and their missing plane."""
    total = 0
    for vs in valid_sets:
        n = int(vs.Xb.shape[0])
        total += int(vs.Xb.numel()) * vs.Xb.element_size()
        total += n * 4 * (3 * num_models + 2)
        if getattr(vs, "raw", None) is not None:
            total += int(vs.raw[0].numel()) * 5
    return total


def hbm_preflight(gbdt) -> Dict:
    """The pre-flight of a constructed booster with its valid sets
    attached: :func:`estimate_residency` of the residency it resolved,
    from the shapes it holds (no device traffic), plus the dims it used
    and, streamed, the shard store's description. Publishes
    ``memory.preflight.total_bytes`` and ``memory.preflight.<component>
    _bytes`` gauges."""
    import numpy as np
    from ..ops.histogram import code_bytes_total
    spec = gbdt.spec
    store = getattr(gbdt, "_stream_store", None)
    if store is not None:
        cols = int(store.num_cols)
        itemsize = int(np.dtype(store.dtype).itemsize)
    else:
        cols = int(gbdt.Xb.shape[1])
        itemsize = gbdt.Xb.element_size()
    dims = dict(rows=int(gbdt.num_rows), cols=cols, code_itemsize=itemsize,
                num_models=int(gbdt.num_models),
                num_leaves=int(spec.num_leaves),
                hist_bins=int(spec.hist_bins or spec.num_bins_padded),
                slots=int(spec.hist_slots),
                has_weight=gbdt.weight is not None,
                valid_bytes=valid_set_bytes(gbdt.valid_sets,
                                            gbdt.num_models))
    if store is not None:
        geo = gbdt._stream_geo
        dims.update(shard_rows=int(geo["shard_rows"]),
                    shard_bytes=int(geo["shard_rows"]) * code_bytes_total(
                        cols, geo["code_mode"]),
                    unpack=geo["code_mode"] in ("u4", "u6"))
    est = estimate_residency(**dims)
    est["dims"] = dims
    est["total_gb"] = round(est["total_bytes"] / _GB, 3)
    if store is not None:
        est["stream"] = store.describe()
    from . import get_registry
    reg = get_registry()
    reg.gauge("memory.preflight.total_bytes").set(est["total_bytes"])
    for k, v in est["components"].items():
        reg.gauge(f"memory.preflight.{k}_bytes").set(v)
    return est


def log_budget(estimate: Dict, devmem: Optional[Dict] = None,
               budget: Optional[int] = None) -> bool:
    """The ``engine.train`` budget line: one INFO line with the largest
    components, and a WARNING when the estimate exceeds the budget
    (``tpu_hbm_budget_bytes`` / ``LGBM_TPU_HBM_BUDGET`` / the card's
    memory). Returns True when the estimate fits or no budget is known.
    Under ``tpu_residency=stream`` the estimate counts the two shard
    buffers only, the line says so, and the warning fires only when even
    the streamed state does not fit."""
    from ..utils.log import Log

    comp = estimate["components"]
    top = sorted(comp.items(), key=lambda kv: -kv[1])[:4]
    detail = ", ".join(f"{k} {v / _GB:.2f}" for k, v in top if v)
    devmem = devmem if devmem is not None else device_memory()
    cap = budget if budget is not None else devmem.get("capacity_bytes")
    cap_s = f" / {cap / _GB:.2f} GB budget" if cap else ""
    residency = estimate.get("residency", "device")
    stream = estimate.get("stream")
    stream_s = ""
    if residency == "stream" and stream:
        stream_s = (f" [tpu_residency=stream: codes in {stream['n_shards']} "
                    f"host shards x {stream['shard_bytes'] / _GB:.3f} GB, "
                    f"{stream['code_mode']} packed]")
    Log.info("HBM pre-flight: %.2f GB estimated per device (%s)%s%s",
             estimate["total_bytes"] / _GB, detail, cap_s, stream_s)
    if cap and estimate["total_bytes"] > cap:
        if residency == "stream":
            Log.warning(
                "HBM pre-flight: even the STREAMED training state (%.2f "
                "GB — gradients/scores/partition + two shard buffers) "
                "exceeds the %.2f GB budget (platform=%s): shrink "
                "tpu_stream_shard_rows or shard rows across cards "
                "(tree_learner=data)", estimate["total_bytes"] / _GB,
                cap / _GB, devmem.get("platform"))
        else:
            Log.warning(
                "HBM pre-flight: estimated residency %.2f GB EXCEEDS the "
                "%.2f GB budget (platform=%s) — expect an out-of-memory "
                "error at the first iteration; set tpu_residency=stream "
                "(host-resident code shards) or shard the rows across "
                "cards (tree_learner=data)", estimate["total_bytes"] / _GB,
                cap / _GB, devmem.get("platform"))
        return False
    return True
