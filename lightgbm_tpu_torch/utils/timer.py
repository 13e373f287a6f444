"""Per-phase wall-clock accumulators: the reference's compile-time TIMETAG
profiling (serial_tree_learner.cpp:10-37, gbdt.cpp TIMETAG blocks, dumped
at destruction), as ``lightgbm_tpu/utils/timer.py`` has them.

The phases the port times are dataset construction (binning, EFB; host),
the training step (``train_step``), metric eval (``metric_eval``) and the
model finalize (``finalize_fetch``: the device trees to host ``Tree``s).
These are **host** seconds. On the card the captured iteration is
asynchronous: ``train_step`` times the enqueue of its graph replays plus
the one flag read per tree (the wave loop's only host sync), not the
device work, which ``torch.profiler`` (``tpu_profile_dir`` /
``tpu_profile_iters``) attributes.

Enable with config ``tpu_time_tag=true`` (or env ``LGBM_TPU_TIMETAG=1``);
the summary prints through ``Log.info`` when training ends, like the
reference's destructor dump. ``tpu_profile_dir`` alone wraps the whole
training loop in one ``torch.profiler`` trace (:func:`maybe_torch_trace`).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

from .log import Log


class Timers:
    def __init__(self):
        self.enabled = bool(os.environ.get("LGBM_TPU_TIMETAG"))
        self.acc: Dict[str, float] = defaultdict(float)
        self.cnt: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[phase] += time.perf_counter() - t0
            self.cnt[phase] += 1

    def reset(self) -> None:
        self.acc.clear()
        self.cnt.clear()

    def summary(self) -> str:
        if not self.acc:
            return "TIMETAG: (no phases recorded)"
        width = max(len(k) for k in self.acc)
        lines = ["TIMETAG phase summary (seconds):"]
        for k in sorted(self.acc, key=self.acc.get, reverse=True):
            lines.append(f"  {k:<{width}}  {self.acc[k]:9.3f}s"
                         f"  x{self.cnt[k]}")
        return "\n".join(lines)

    def dump(self) -> None:
        if self.enabled and self.acc:
            Log.info("%s", self.summary())


TIMERS = Timers()


# PhaseBreakdown lives in the observability subsystem (its numbers feed the
# process-wide registry); re-exported here as the JAX package does.
from ..observability.phases import PhaseBreakdown  # noqa: E402,F401


@contextlib.contextmanager
def maybe_torch_trace(profile_dir: str):
    """A whole-run ``torch.profiler`` trace (CPU and CUDA activity) into
    ``profile_dir`` as a Chrome trace, gated on a non-empty directory
    (config ``tpu_profile_dir``): the counterpart of the JAX package's
    ``maybe_xla_trace``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import profile
    from ..observability.export import trace_file_name
    from ..observability.profiler import activities
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities())
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(profile_dir, trace_file_name("torch_trace"))
        prof.export_chrome_trace(path)
        Log.info("tpu_profile_dir: torch.profiler trace of the run -> %s",
                 path)
