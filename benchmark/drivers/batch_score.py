"""Traffic ``batch_score``: a closed loop of one caller scoring batches
with ``lightgbm_tpu_torch.Booster.predict``.

Set-up makes a pool of ``pool_batches`` batches of ``batch_rows`` raw rows
of the configuration's generator (f64 on the host, as a caller hands them
in) and the configuration's forest as model text, and loads it with
``Booster(model_str=...)``. The
caller scores ``warm_calls`` batches, then, inside the window, batch after
batch in an order drawn from the seed until a call ends past ``--seconds``;
each call ends in host results. Under ``--trace 1`` ``profile_calls`` more
calls run under the profiler, outside the window. The reference walks the
model text over the rows of ``check_calls`` window calls (the last, and
the rest drawn from the seed) and compares each row's probability.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np

from benchmark.harness import data as datagen
from benchmark.harness import forest as forestgen
from benchmark.harness.profiling import DeviceWindow
from benchmark.reference import walk


def run(job) -> Dict:
    import torch
    import lightgbm_tpu_torch as lgt
    cfg, mix = job.config, job.traffic
    cuda = job.device.type == "cuda"
    spec = dict(cfg["data"], **job.data_overrides)
    fspec = dict(cfg["forest"], **job.param_overrides)
    B, P = int(spec.get("batch_rows", mix["batch_rows"])), \
        int(mix["pool_batches"])
    gen = datagen.generator(job.seed, job.device)
    pool = datagen.rows(spec, B * P, gen, job.device, job.bench_dir)[0]
    text, trees = forestgen.make(fspec, spec.get("nan_columns", []), pool,
                                 gen, B)
    batches = [np.ascontiguousarray(b) for b in
               pool.double().cpu().numpy().reshape(P, B, -1)]
    del pool
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = {"verbose": -1, "device": "cuda" if cuda else "cpu"}
    bst = lgt.Booster(params=params, model_str=text)
    for i in range(int(mix["warm_calls"])):
        bst.predict(batches[i % P])
    rng = np.random.default_rng(int(job.seed) & ((1 << 63) - 1))
    outputs = []
    t_open = time.perf_counter()
    setup_s = t_open - job.t_start
    while True:
        b = int(rng.integers(P))
        outputs.append((b, bst.predict(batches[b])))
        now = time.perf_counter()
        if now - t_open >= job.seconds:
            break
    window_s = now - t_open
    calls = len(outputs)
    profile = None
    if job.trace:
        profile = DeviceWindow(cuda)
        profile.start()
        for i in range(int(mix["profile_calls"])):
            bst.predict(batches[i % P])
        profile.stop()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del bst
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record = {
        "setup_s": setup_s, "window_s": window_s,
        "score_rows_per_s": calls * B / window_s,
        "calls": calls, "rows_per_call": B, "trees": trees,
        "num_trees": len(trees), "num_features": batches[0].shape[1],
        "memory_peak_bytes": int(memory_peak),
        "profile": None if profile is None else dict(
            profile.result, host_s=profile.host_s,
            calls=int(mix["profile_calls"])),
        "attempted": calls, "failed": 0,
    }
    # the calls the reference checks: the window's last and more from the
    # seed, each compared row by row
    picks = {calls - 1, *rng.choice(calls, size=min(calls, int(
        mix["check_calls"])) - 1, replace=False).tolist()}
    t_check = time.perf_counter()
    gap = control_gap = 0.0
    for c in sorted(picks):
        b, out = outputs[c]
        X = torch.as_tensor(batches[b], device=job.device)
        ref = torch.sigmoid(walk.raw_scores(trees, X)).cpu().numpy()
        gap = max(gap, float(np.max(np.abs(out - ref))))
        if job.control:
            low = torch.sigmoid(walk.raw_scores(trees, X.float(),
                                                dtype=torch.float32))
            control_gap = max(control_gap, float(np.max(np.abs(
                low.double().cpu().numpy() - ref))))
    record["numbers"] = {"prob_gap": gap}
    record["checked_calls"] = sorted(picks)
    record["check_s"] = time.perf_counter() - t_check
    if job.control:
        record["control"] = {"control_f32": {"prob_gap": control_gap}}
    if job.trace:
        n = int(mix["profile_calls"])
        record["comparisons_per_call"] = sum(
            walk.path_comparisons(trees, torch.as_tensor(
                batches[i % P], device=job.device)) for i in range(n)) / n
    return record
