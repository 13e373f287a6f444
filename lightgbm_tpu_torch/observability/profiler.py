"""Optional ``torch.profiler`` capture window over a boosting-iteration range.

The port's counterpart of ``lightgbm_tpu/observability/profiler.py``:
``tpu_profile_iters=start:stop`` profiles exactly the iterations
``[start, stop)`` (CPU and CUDA activity: the kernels, memsets and copies
on the card, the graph replays' kernels included) instead of the whole run
(``tpu_profile_dir`` alone wraps the full training loop in one trace,
``utils/timer.maybe_torch_trace``). Host spans (tracer.py) attribute batch
boundaries; the window attributes the device work of the chosen iterations
only, keeping the profile's volume bounded at full width.

Window edges land on batch boundaries: under ``tree_batch=K`` the profiler
starts at the first batch whose iterations overlap the window and stops at
the first batch boundary at or past ``stop``; a batch is never split. The
profiler is started and stopped, never paused, so iterations outside the
window pay none of its host cost. A run resumed past the window skips it.

CUDA graphs: the booster captures its iteration's graphs in its first
replayed iteration (its second). The profiler may be active across that
capture: on an H100 a window over it (``chip_smoke.py`` phase 20's
``0:3``) gives the same trees and counts the same B1 passes as one after
it (``3:6``). The window never turns capture off.

On stop the trace is exported as Chrome trace JSON into the output
directory, ``torch_profile_<pid>.json`` (``_r<rank>`` appended in a world
of more than one process); ``profiler_window_start`` / ``_stop`` events
mark the edges in the span trace. Open it in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``. ``torch`` is imported
at the start edge.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from ..utils.log import Log


def parse_profile_iters(spec: str) -> Optional[Tuple[int, int]]:
    """``"start:stop"`` -> (start, stop); None for empty. Raises ValueError
    on malformed input (config validation surfaces it as Log.fatal)."""
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"tpu_profile_iters must be 'start:stop', got {spec!r}")
    try:
        start, stop = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"tpu_profile_iters must be two integers 'start:stop', "
            f"got {spec!r}") from None
    if start < 0 or stop <= start:
        raise ValueError(
            f"tpu_profile_iters needs 0 <= start < stop, got {spec!r}")
    return start, stop


def activities():
    """CPU activity, and CUDA's once CUDA is initialized in the process."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    return acts


class ProfileWindow:
    """Start/stop ``torch.profiler`` when the training loop crosses the
    configured iteration window (``engine.train`` calls ``before_step`` /
    ``after_step`` at batch boundaries and ``close`` on exit)."""

    def __init__(self, spec: str, out_dir: str):
        window = parse_profile_iters(spec)
        if window and not out_dir:
            Log.warning("tpu_profile_iters=%s has no output directory "
                        "(set tpu_profile_dir or telemetry_dir) — "
                        "profiling window disabled", spec)
            window = None
        self.start_iter, self.stop_iter = window or (0, 0)
        self.enabled = window is not None
        self.out_dir = out_dir
        self.active = False
        self.started_at = self.stopped_at = None
        self.trace_path = None
        self._prof = None
        self._done = False

    def before_step(self, it: int, batch: int = 1) -> None:
        """Called with the first iteration of the batch about to run and
        the batch's iteration count. The profiler starts at the first batch
        that OVERLAPS the window ([it, it+batch) ∩ [start, stop)
        non-empty), so a window that begins mid-batch, or sits inside one
        batch, still profiles it."""
        if not self.enabled or self.active or self._done:
            return
        if it >= self.stop_iter:        # resumed run already past the window
            self._done = True
            return
        if it + max(batch, 1) > self.start_iter:
            self._start(it)

    def after_step(self, it_end: int) -> None:
        """Called with the first iteration AFTER the batch that finished."""
        if self.active and it_end >= self.stop_iter:
            self._stop(it_end)

    def close(self) -> None:
        """Stop an in-flight profiler at training exit (early stop,
        errors)."""
        if self.active:
            self._stop(-1)

    def _start(self, it: int) -> None:
        import torch.profiler
        os.makedirs(self.out_dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=activities())
        self._prof.start()
        self.active = True
        self.started_at = it
        Log.info("tpu_profile_iters: torch.profiler started at iteration %d "
                 "(window %d:%d) -> %s", it, self.start_iter, self.stop_iter,
                 self.out_dir)
        from . import get_tracer
        get_tracer().event("profiler_window_start", iteration=it,
                           out_dir=self.out_dir)

    def _stop(self, it_end: int) -> None:
        from .export import trace_file_name
        prof, self._prof = self._prof, None
        try:
            prof.stop()
        finally:
            self.active = False
            self._done = True
            self.stopped_at = it_end
        self.trace_path = os.path.join(self.out_dir,
                                       trace_file_name("torch_profile"))
        prof.export_chrome_trace(self.trace_path)
        Log.info("tpu_profile_iters: torch.profiler stopped (%s) -> %s",
                 f"iteration {it_end}" if it_end >= 0 else "training exit",
                 self.trace_path)
        from . import get_tracer
        get_tracer().event("profiler_window_stop", iteration=it_end,
                           out_dir=self.out_dir, trace=self.trace_path)
