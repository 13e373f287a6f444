"""Traffic ``train_loop``: one ``lightgbm_tpu_torch.train`` call on the
configuration's data, measured between batch boundaries.

The call trains in batches of the configuration's ``tree_batch``, with
the valid set's metric every ``metric_freq`` iterations. A callback at the
end of every batch (after the batch's eval, behind a device synchronize)
opens the window once the mix's ``warm_batches`` have run (the eager first
iteration and the graph capture among them), and closes it at the first
boundary past ``--seconds``; there it keeps the valid set's metric values
and raw scores of that boundary. Under ``--trace 1`` the next batch runs
under the profiler and the capture guard, outside the window. The call
then stops (an early stop at that iteration, so that every tree is kept).

The reference judges ``check_trees`` trees of the window (the last, and
the rest drawn from the seed), walks the model text's trees up to the
window's close over the valid rows in f64 and compares the program's
valid raw scores with that walk (``valid_score_gap``), and works out the
configuration's metrics from the program's valid scores and compares the
values the program reported (``valid_metric_gap``).

Mix parameters: ``warm_batches``, ``profile_batches``, ``check_trees``.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from benchmark.harness import data as datagen
from benchmark.harness.profiling import DeviceWindow
from benchmark.reference import gbdt as ref
from benchmark.reference import metrics as refmetrics
from benchmark.reference import modeltext, walk

MAX_ROUNDS = 1_000_000


class _Window:
    """The callback that opens, closes and profiles the window."""

    order = 5                       # before the engine's record callbacks

    def __init__(self, seconds: float, warm_batches: int, trace: bool,
                 profile_batches: int, cuda: bool):
        self.seconds = seconds
        self.warm = warm_batches
        self.trace = trace
        self.profile_batches = profile_batches
        self.cuda = cuda
        self.batches = 0
        self.state = "warm"
        self.t_open = self.t_close = None
        self.it_open = self.it_close = self.it_end = None
        self.cursor_open = self.cursor_close = 0
        self.profile = None
        self.guard = None
        self.profiled = 0
        self.valid_metrics = None
        self.valid_score = None

    def __call__(self, env) -> None:
        import torch
        from lightgbm_tpu_torch import observability as obs
        from lightgbm_tpu_torch.callback import EarlyStopException
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.batches += 1
        it_end = env.iteration + 1
        if self.state == "warm":
            if self.batches >= self.warm:
                self.state = "open"
                self.t_open, self.it_open = now, it_end
                self.cursor_open = len(obs.get_tracer().events())
            return
        if self.state == "open":
            if now - self.t_open < self.seconds:
                return
            self.t_close, self.it_close = now, it_end
            self.cursor_close = len(obs.get_tracer().events())
            # what the program reported and holds at the close: judged
            # after the run
            self.valid_metrics = {
                m: float(v) for d, m, v, _ in env.evaluation_result_list
                or [] if d == "valid"}
            valid = env.model._gbdt.valid_sets
            self.valid_score = valid[0].score[0].detach().cpu().clone() \
                if valid else None
            if not self.trace:
                self.it_end = it_end
                raise EarlyStopException(env.iteration, None)
            self.state = "profiling"
            gbdt = env.model._gbdt
            if self.cuda:
                from lightgbm_tpu_torch.analysis import CaptureGuard
                self.guard = CaptureGuard("benchmark", fail=False,
                                          device="cuda")
                if gbdt._graphs is not None:
                    self.guard.register(gbdt._graphs, "iteration")
                self.guard.__enter__()
                self.guard.mark_warm()
            self.profile = DeviceWindow(self.cuda)
            self.profile.start()
            return
        self.profiled += 1
        if self.profiled < self.profile_batches:
            return
        self.profile.stop()
        if self.guard is not None:
            self.guard.__exit__(None, None, None)
        self.it_end = it_end
        raise EarlyStopException(env.iteration, None)


def _datasets(lgt, d: Dict, params: Dict):
    group = d.get("group")
    ds = lgt.Dataset(d["X_np"], label=d["y_np"], group=group)
    ds.construct(lgt.Config.from_params(params))
    dv = lgt.Dataset(d["Xv_np"], label=d["yv_np"], group=d.get("group_v"),
                     reference=ds).construct()
    return ds, dv


def run(job) -> Dict:
    """One run; returns the record the report is made from."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import observability as obs
    cfg, mix = job.config, job.traffic
    cuda = job.device.type == "cuda"
    params = dict(cfg["params"], **job.param_overrides)
    if not cuda:
        params["device"] = "cpu"
    if job.trace:
        obs.configure(enabled=True)
    d = datagen.training_data(cfg["data"], job.seed, job.device,
                              job.data_overrides, job.bench_dir)
    for k in ("X", "y", "Xv", "yv"):
        d[k + "_np"] = d.pop(k).cpu().numpy()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ds, dv = _datasets(lgt, d, params)
    construct_s = time.perf_counter() - t0

    win = _Window(job.seconds, int(mix["warm_batches"]), job.trace,
                  int(mix["profile_batches"]), cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bst = lgt.train(params, ds, num_boost_round=MAX_ROUNDS,
                    valid_sets=[dv], valid_names=["valid"],
                    callbacks=[win], verbose_eval=False,
                    keep_training_booster=True)
    if win.t_close is None:
        raise RuntimeError("the training call ended before the window "
                           "closed")
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    gbdt = bst._gbdt
    graphs = gbdt._graphs
    capture_s = None if graphs is None else \
        graphs.capture_s + graphs.instantiate_s
    events = obs.get_tracer().events()[win.cursor_open:win.cursor_close]
    eval_s = sum(e["dur"] for e in events
                 if e.get("name") == "eval" and e.get("ph") == "X") / 1e6
    text = bst.model_to_string()
    iters = win.it_close - win.it_open
    record = {
        "setup_s": win.t_open - job.t_start,
        "window_s": win.t_close - win.t_open,
        "iterations": iters,
        "train_iter_ms": (win.t_close - win.t_open) / iters * 1e3,
        "memory_peak_bytes": int(memory_peak),
        "construct_s": construct_s,
        "capture_s": capture_s,
        "eval_s": eval_s if job.trace else None,
        "profile": None if win.profile is None else dict(
            win.profile.result, host_s=win.profile.host_s,
            iterations=win.it_end - win.it_close),
        "host_syncs": None if win.guard is None else win.guard.host_syncs,
        "window_trees": (win.it_open, win.it_close),
        "profiled_trees": (win.it_close, win.it_end),
        "attempted": iters, "failed": 0,
        "pairs": ref.ordered_pairs(d["y_np"], d["group"])
        if "group" in d else None,
        "valid_metrics": win.valid_metrics,
        "valid_score": win.valid_score,
    }
    del bst, gbdt, graphs, ds, dv, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for k in ("X", "y", "Xv", "yv"):
        d[k] = torch.as_tensor(d[k + "_np"], device=job.device)
    t0 = time.perf_counter()
    model = modeltext.parse(text)
    record["trees"] = model["trees"]
    checked = _check(job, d, model["trees"], record, params)
    valid = _check_valid(job, d, model["trees"], record, params)
    checked["numbers"].update(valid.pop("numbers"))
    for name, readings in valid.pop("control", {}).items():
        checked["control"].setdefault(name, {}).update(readings)
    record.update(checked, **valid)
    record["check_s"] = time.perf_counter() - t0
    return record


def checked_trees(first: int, end: int, count: int, seed: int) -> List[int]:
    """The window's last tree and ``count - 1`` more drawn from the seed."""
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    others = list(range(first, end - 1))
    pick = rng.choice(len(others), size=min(count - 1, len(others)),
                      replace=False) if others else []
    return sorted({end - 1, *(others[int(i)] for i in pick)})


def _check(job, d: Dict, trees: List[Dict], record: Dict,
           params: Dict) -> Dict:
    """The reference's verdict on the checked trees; under ``--control``
    also the readings of the control and of the planted faults."""
    import torch
    objective = params["objective"]
    rule = ref.SplitRule(params)
    lr = float(params["learning_rate"])
    wave = ref.wave_size(params)
    bins = ref.Bins(d["X"])
    label = d["y"]
    group = d.get("group")
    first, end = record["window_trees"]
    check = checked_trees(first, end, int(job.traffic["check_trees"]),
                          job.seed)
    X = d["X"]
    score = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
    numbers: Dict[str, float] = {}
    details: List[Dict] = []
    control: Dict[str, Dict[str, float]] = {}
    done = 0
    for t in check:
        prev = None
        for i in range(done, t):
            if job.control and i == t - 1:
                prev = score.clone()
            score += torch.as_tensor(trees[i]["leaf_value"],
                                     device=X.device)[walk.leaves(trees[i],
                                                                  X)]
        done = t
        g, h = ref.gradients(objective, score, label, group, params)
        verdict = ref.judge(trees[t], bins, g, h, rule, lr, wave)
        details.append(dict(verdict.pop("detail"), tree=t))
        for k, v in verdict.items():
            numbers[k] = max(numbers.get(k, 0), v)
        if job.control:
            for name, tree in _control_trees(job, bins, prev, g, h, label,
                                             group, params, rule,
                                             lr).items():
                v = ref.judge(tree, bins, g, h, rule, lr, wave)
                v.pop("detail")
                for k, x in v.items():
                    c = control.setdefault(name, {})
                    c[k] = max(c.get(k, 0), x)
    out = {"numbers": numbers, "checked_trees": check,
           "judge_detail": details}
    if job.control:
        out["control"] = control
    return out


def _control_trees(job, bins, prev, g, h, label, group, params, rule,
                   lr) -> Dict[str, Dict]:
    """The control (the reference in bfloat16) and the planted faults in
    the reference put in the program's place: a step on the scores before
    the previous tree (a state left unchanged), half of the rows left out
    with the rest counted double, and one leaf's value negated."""
    import torch
    L = int(params["num_leaves"])
    W = ref.wave_size(params)
    out = {"control_bf16": ref.grow(bins, g, h, rule, L, lr, W,
                                    precision=torch.bfloat16)}
    gs, hs = ref.gradients(params["objective"], prev, label, group, params)
    out["fault_state_unchanged"] = ref.grow(bins, gs, hs, rule, L, lr, W)
    gen = datagen.generator(job.seed + 1, g.device)
    keep = (torch.rand(g.shape[0], generator=gen, device=g.device) < 0.5)
    out["fault_half_rows"] = ref.grow(bins, 2.0 * g * keep, 2.0 * h * keep,
                                      rule, L, lr, W)
    tree = out["reference_f64"] = ref.grow(bins, g, h, rule, L, lr, W)
    altered = dict(tree, leaf_value=tree["leaf_value"].copy())
    altered["leaf_value"][0] = -altered["leaf_value"][0]
    out["fault_answer_altered"] = altered
    return out


def _check_valid(job, d: Dict, trees: List[Dict], record: Dict,
                 params: Dict) -> Dict:
    """The valid set at the window's close: the program's raw scores
    against the reference's f64 walk of the trees up to there, and the
    program's metric values against the reference's metrics of those
    scores (a metric the program did not report reads 1, the widest gap a
    metric in [0, 1] can have). Under ``--control`` also the control (the
    walk summed in bfloat16) and the planted faults: scores one batch
    stale, the metric of half the valid rows, one leaf negated."""
    import torch
    Xv, yv, group_v = d["Xv"], d["yv"], d.get("group_v")
    close = record["window_trees"][1]
    reference = walk.raw_scores(trees[:close], Xv)
    program = record["valid_score"]
    numbers = {"valid_score_gap": 1.0, "valid_metric_gap": 1.0}
    out = {"numbers": numbers, "valid": {"program": record["valid_metrics"]}}
    if program is None:
        return out
    program = program.to(Xv.device).double()
    numbers["valid_score_gap"] = _widest(program, reference)
    expected = refmetrics.evaluate(params, program, yv, group_v)
    out["valid"]["reference"] = expected
    got = record["valid_metrics"] or {}
    numbers["valid_metric_gap"] = max(
        abs(got[k] - v) if k in got else 1.0 for k, v in expected.items())
    if job.control:
        batch = int(params["tree_batch"])
        last = trees[close - 1]
        altered = reference.clone()
        rows = walk.leaves(last, Xv) == 0
        altered[rows] -= 2.0 * float(last["leaf_value"][0])
        half_rows = yv.shape[0] // 2
        half_queries = None
        if group_v is not None:
            half_queries = group_v[:len(group_v) // 2]
            half_rows = int(np.sum(half_queries))
        half = refmetrics.evaluate(params, reference[:half_rows],
                                   yv[:half_rows], half_queries)
        full = refmetrics.evaluate(params, reference, yv, group_v)
        out["control"] = {
            "control_bf16": {"valid_score_gap": _widest(walk.raw_scores(
                trees[:close], Xv, dtype=torch.bfloat16), reference)},
            "fault_state_unchanged": {"valid_score_gap": _widest(
                walk.raw_scores(trees[:close - batch], Xv), reference)},
            "fault_half_rows": {"valid_metric_gap": max(
                abs(half[k] - full[k]) for k in full)},
            "fault_answer_altered": {"valid_score_gap": _widest(
                altered, reference)}}
    return out


def _widest(a, b) -> float:
    return float((a.double() - b.double()).abs().max())
