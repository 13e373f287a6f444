"""Hang watchdog: detect a wedged training loop, dump why, and optionally
abort back to the last checkpoint.

Port of ``lightgbm_tpu/robustness/watchdog.py``, with the same threshold,
grace, dumps and exit codes:

- ``HangWatchdog.beat(iteration)`` is called at the engine's batch
  boundaries (host only: no device read, nothing inside a captured CUDA
  graph). The intervals between beats feed a trailing median of the last
  32 iteration times.
- A monitor thread (or an explicit ``check()``; the tests drive a fake
  clock through it) fires when the time since the last beat exceeds
  ``max(hang_timeout_s, hang_median_factor * trailing median)``, the
  median only once three intervals are known.
- Until the first interval the threshold is at least
  ``startup_grace_s`` (default ``max(300 s, hang_timeout_s)``): the first
  batch of a fresh or resumed process builds B1 with ``nvcc`` on its first
  use and captures the iteration's CUDA graphs, with no boundary to beat
  from.
- Firing dumps every thread's stack and ``observability.snapshot()`` to
  ``watchdog_dump_<pid>_<n>.json`` (at most ``max_dumps``; telemetry dir >
  checkpoint dir > cwd), counts ``fault.hangs`` and records a
  ``watchdog_dump`` span. The monitor never touches the card: a wedged
  stream would wedge a ``torch.cuda.synchronize`` or a memory query too.
- ``action="abort"`` then leaves with ``os._exit`` and :data:`EXIT_HANG`
  (142), or :data:`EXIT_COMM_LOST` (145) when the attribution hook (the
  heartbeat leases, ``robustness/distributed.py``) names a lost peer. A
  wedged collective cannot be cancelled from Python, and the interpreter's
  teardown could wait on it; the checkpoint on disk is the state that
  matters, and the supervisor relaunches with ``resume_from=auto``.

The clock is ``observability.clock()``, read through the module at call
time, so tests run on a fake one.
"""
from __future__ import annotations

import os
import statistics
import sys
import threading
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils.log import Log

# exit status of an abort to the last checkpoint: apart from SIGTERM's 143
# (checkpoint, then exit) and from crashes, so a supervisor names the
# failure it recovers from
EXIT_HANG = 142

# exit status when the failure is a lost peer rank (PeerLostError or
# CommTimeoutError at the top, or a firing whose lease attribution names a
# lost peer): the fleet supervisor restarts the gang and does not count
# the reporting rank as the culprit
EXIT_COMM_LOST = 145


class HangWatchdog:
    """Heartbeat-fed hang detector over the training loop's batch
    boundaries. ``beat`` is called from the training thread, ``check`` from
    the monitor thread (or a test)."""

    def __init__(self, timeout_s: float,
                 median_factor: float = 8.0,
                 action: str = "dump",
                 dump_dir: str = "",
                 max_dumps: int = 3,
                 poll_interval_s: Optional[float] = None,
                 startup_grace_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 abort_fn: Optional[Callable[[], None]] = None,
                 attribution_fn: Optional[Callable[[], Dict]] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        if action not in ("dump", "abort"):
            raise ValueError(f"unknown watchdog action {action!r} "
                             f"(dump|abort)")
        self.timeout_s = float(timeout_s)
        self.median_factor = float(median_factor)
        self.startup_grace_s = (max(300.0, self.timeout_s)
                                if startup_grace_s is None
                                else float(startup_grace_s))
        self.action = action
        self.dump_dir = dump_dir or "."
        self.max_dumps = max_dumps
        self.poll_interval_s = (poll_interval_s if poll_interval_s
                                else min(1.0, self.timeout_s / 4.0))
        self._clock = clock
        self._abort_fn = abort_fn
        # called at firing time: names a dead peer (lease ages in the log
        # and the dump) and turns the exit into EXIT_COMM_LOST
        self.attribution_fn = attribution_fn
        self._lock = threading.Lock()
        self._intervals: deque = deque(maxlen=32)
        self._last_beat: Optional[float] = None
        self._iteration: Optional[int] = None
        self._fired = False          # one firing per stall; beat() re-arms
        self.dumps: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock()
        from .. import observability as _obs
        return _obs.clock()

    # ------------------------------------------------------------ heartbeat

    def beat(self, iteration: Optional[int] = None) -> None:
        """Mark one live boundary; re-arms the watchdog after a firing."""
        now = self._now()
        with self._lock:
            if self._last_beat is not None:
                self._intervals.append(max(now - self._last_beat, 0.0))
            self._last_beat = now
            if iteration is not None:
                self._iteration = iteration
            self._fired = False

    def threshold_s(self) -> float:
        """The firing threshold: the startup grace until the first interval
        lands, then the fixed floor, raised to ``median_factor`` trailing
        medians once three intervals are known."""
        with self._lock:
            intervals = list(self._intervals)
        if not intervals:
            return max(self.timeout_s, self.startup_grace_s)
        if self.median_factor > 0 and len(intervals) >= 3:
            return max(self.timeout_s,
                       self.median_factor * statistics.median(intervals))
        return self.timeout_s

    # ------------------------------------------------------------ detection

    def check(self, now: Optional[float] = None) -> bool:
        """One detection pass; True when a hang fired."""
        with self._lock:
            last, fired = self._last_beat, self._fired
            iteration = self._iteration
        if last is None or fired:
            return False
        now = self._now() if now is None else now
        stalled_s = now - last
        threshold = self.threshold_s()
        if stalled_s <= threshold:
            return False
        with self._lock:
            if self._fired:          # another checker won the race
                return False
            self._fired = True
        self._on_hang(stalled_s, threshold, iteration)
        return True

    def _on_hang(self, stalled_s: float, threshold: float,
                 iteration: Optional[int]) -> None:
        from .. import observability as _obs
        _obs.inc("fault.hangs")
        _obs.get_registry().gauge("fault.last_hang_stall_seconds").set(
            round(stalled_s, 3))
        Log.warning(
            "watchdog: no batch boundary for %.1fs (threshold %.1fs, last "
            "iteration %s) — the training loop looks wedged (a collective "
            "waiting on a peer? a stuck copy?)", stalled_s, threshold,
            iteration)
        attribution = None
        if self.attribution_fn is not None:
            try:
                attribution = self.attribution_fn()
            except Exception as e:                           # noqa: BLE001
                Log.warning("watchdog: peer attribution probe failed: "
                            "%s: %s", type(e).__name__, e)
        lost_rank = (attribution or {}).get("peer_lost")
        if lost_rank is not None:
            Log.warning(
                "watchdog: the stall is attributed to LOST PEER rank %s — "
                "its heartbeat lease stopped advancing (%s) — treating it "
                "as comm loss, not a local hang", lost_rank,
                (attribution or {}).get("peer_lease_ages_s"))
        elif attribution and attribution.get("slowest_rank") is not None:
            Log.warning("watchdog: every peer lease still advances; the "
                        "slowest peer is rank %s (lease ages %s)",
                        attribution["slowest_rank"],
                        attribution.get("peer_lease_ages_s"))
        path = None
        if len(self.dumps) < self.max_dumps:
            with _obs.span("watchdog_dump", stalled_s=round(stalled_s, 3),
                           iteration=iteration):
                path = self._dump(stalled_s, threshold, iteration,
                                  attribution)
        if self.action == "abort":
            self._abort(path, lost_rank=lost_rank)

    def _dump(self, stalled_s: float, threshold: float,
              iteration: Optional[int],
              attribution: Optional[Dict] = None) -> Optional[str]:
        """Every thread's stack plus the observability snapshot, written
        atomically. Host only; never raises (a failed dump must not mask
        the hang handling)."""
        from .. import observability as _obs
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks: Dict[str, List[str]] = {}
        for tid, frame in frames.items():
            label = f"{names.get(tid, 'unknown')} (tid {tid})"
            stacks[label] = [ln.rstrip("\n") for ln in
                             traceback.format_stack(frame)]
        payload = {
            "kind": "watchdog_hang_dump",
            "pid": os.getpid(),
            "iteration": iteration,
            "stalled_seconds": round(stalled_s, 3),
            "threshold_seconds": round(threshold, 3),
            "action": self.action,
            "peer_attribution": attribution,
            "thread_stacks": stacks,
            "snapshot": _obs.snapshot(),
        }
        path = os.path.join(
            self.dump_dir,
            f"watchdog_dump_{os.getpid()}_{len(self.dumps)}.json")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            from ..observability.export import atomic_write_json
            atomic_write_json(path, payload, indent=1, default=str,
                              trailing_newline=True)
        except Exception as e:                               # noqa: BLE001
            Log.warning("watchdog: cannot write diagnostic dump %s: %s: %s",
                        path, type(e).__name__, e)
            return None
        self.dumps.append(path)
        _obs.inc("fault.watchdog_dumps")
        Log.warning("watchdog: diagnostic dump written to %s", path)
        return path

    def _abort(self, dump_path: Optional[str],
               lost_rank: Optional[int] = None) -> None:
        from .. import observability as _obs
        _obs.inc("fault.hang_aborts")
        exit_code = EXIT_HANG if lost_rank is None else EXIT_COMM_LOST
        Log.warning(
            "watchdog: aborting to the last checkpoint (exit %d%s) — "
            "restart with resume_from=auto, or run under `python -m "
            "lightgbm_tpu_torch.robustness.supervisor`, which does so%s",
            exit_code,
            "" if lost_rank is None
            else f", comm loss attributed to peer rank {lost_rank}",
            f" (diagnostics: {dump_path})" if dump_path else "")
        try:
            _obs.flush()
        except Exception as e:                               # noqa: BLE001
            Log.warning("watchdog: telemetry flush on abort failed: %s: %s",
                        type(e).__name__, e)
        if self._abort_fn is not None:
            self._abort_fn()
            return
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(exit_code)

    # -------------------------------------------------------------- monitor

    def start(self) -> "HangWatchdog":
        """Start the daemon monitor thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._monitor_loop, name="lgbm-torch-watchdog",
            daemon=True)
        self._thread.start()
        return self

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check()
            except Exception as e:                           # noqa: BLE001
                Log.warning("watchdog check failed: %s: %s",
                            type(e).__name__, e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
