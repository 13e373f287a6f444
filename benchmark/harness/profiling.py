"""A ``torch.profiler`` window read into device time, idle gaps and the
host's activity in them. No Chrome trace is written.

``busy_s`` is the length of the union of the device's operation intervals
(kernels, copies, sets) inside the window; ``window_s`` the window's own
length, both on the profiler's clock, between the ends of the range
``bench.window`` that the window opens and closes.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW_RANGE = "bench.window"
LABELLED_GAPS = 200
NAME_CHARS = 160


def _span(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        s = int(ev.start_ns())
        return s, s + int(ev.duration_ns())
    s = int(ev.start_us()) * 1000
    return s, s + int(ev.duration_us()) * 1000


def _is_device_op(ev) -> bool:
    """A kernel, copy or set on the device; not a host event, and not a
    host range's annotation that the profiler mirrors on the device's
    timeline."""
    if str(ev.device_type()).split(".")[-1] == "CPU":
        return False
    if getattr(ev, "is_user_annotation", None) and ev.is_user_annotation():
        return False
    kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
    return "annotation" not in kind


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events, top: int = 10) -> Dict:
    """``busy_s``, ``window_s``, device seconds by operation name, and the
    idle gaps by the innermost host operation open at each gap's middle,
    from profiler events ``(name, is_device, start_ns, end_ns)``."""
    win = [(s, e) for name, dev, s, e in events
           if name == WINDOW_RANGE and not dev]
    if not win:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = win[0]
    dev_iv, by_name = [], collections.Counter()
    host = []
    for name, dev, s, e in events:
        if dev and name != WINDOW_RANGE:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                dev_iv.append((s, e))
                by_name[name] += (e - s) / 1e9
        elif name != WINDOW_RANGE:
            host.append((s, e, name))
    busy = merge(dev_iv)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    cursor = w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    # the longest gaps by the host operation open at their middle; the
    # many short ones between device operations together
    by_host = collections.Counter()
    gaps.sort(key=lambda g: g[0] - g[1])
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    for s, e in gaps[:LABELLED_GAPS]:
        mid = (s + e) // 2
        open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = host[open_[np.argmin(he[open_] - hs[open_])]][2] \
            if len(open_) else "host outside any profiled op"
        by_host[label] += (e - s) / 1e9
    rest = gaps[LABELLED_GAPS:]
    if rest:
        longest = (rest[0][1] - rest[0][0]) / 1e3
        by_host[f"{len(rest)} gaps of at most {longest:.1f} us"] += \
            sum(e - s for s, e in rest) / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_s_by_name": dict(by_name),
            "device_ops": [[n[:NAME_CHARS], s]
                           for n, s in by_name.most_common(top)],
            "idle_gaps": [[n[:NAME_CHARS], s]
                          for n, s in by_host.most_common(top)]}


class DeviceWindow:
    """``start()`` / ``stop()`` a profiler window; ``result`` then holds
    :func:`summarize`'s reading, and ``host_s`` the host clock's length."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.result: Optional[Dict] = None
        self.host_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._range = record_function(WINDOW_RANGE)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = []
        for ev in self._prof.profiler.kineto_results.events():
            on_host = str(ev.device_type()).split(".")[-1] == "CPU"
            if on_host or _is_device_op(ev):
                events.append((ev.name(), not on_host, *_span(ev)))
        self.result = summarize(events)
        del self._prof
