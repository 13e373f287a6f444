"""The port's hang watchdog (``lightgbm_tpu_torch/robustness/watchdog.py``)
held against the JAX package's (``lightgbm_tpu/robustness/watchdog.py``).

Each boundary test of ``tests/test_watchdog.py`` has a counterpart here on
a fake clock (no real sleeps, no monitor thread), and the same beat
sequences drive both packages' watchdogs: the thresholds and the firing
instants must be equal. The engine's wiring is tested through
``lgt.train``: ``hang_timeout_s`` arms it (a hang injected through
``LGBM_TPU_CHAOS_HANG`` leaves a dump with every thread's stack),
``hang_median_factor`` sets its threshold, and ``hang_action=abort`` makes
a training process exit 142 (a child process).

Alone this file takes about 13 s on the CPU (CHANGES.md).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu import observability as jobs
from lightgbm_tpu.robustness.watchdog import HangWatchdog as JaxWatchdog

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.robustness import watchdog as twd
from lightgbm_tpu_torch.robustness.watchdog import (EXIT_COMM_LOST,
                                                    EXIT_HANG, HangWatchdog)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.reset_for_tests()
    jobs.reset_for_tests()
    yield
    obs.reset_for_tests()
    jobs.reset_for_tests()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _wd(clock, tmp_path, timeout=10.0, factor=0.0, action="dump", cls=None,
        **kw):
    kw.setdefault("startup_grace_s", 0.0)
    return (cls or HangWatchdog)(timeout_s=timeout, median_factor=factor,
                                 action=action, dump_dir=str(tmp_path),
                                 clock=clock, **kw)


# ------------------------------------------------------------ fire boundary

def test_does_not_fire_without_any_beat(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path)
    clock.advance(1e6)
    assert wd.check() is False


def test_fires_strictly_past_the_fixed_timeout(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=10.0)
    wd.beat(0)
    clock.advance(10.0)
    assert wd.check() is False
    clock.advance(0.001)
    assert wd.check() is True
    assert obs.snapshot()["counters"]["fault.hangs"] == 1


def test_fires_once_per_stall_and_rearms_on_beat(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=1.0)
    wd.beat(0)
    clock.advance(5.0)
    assert wd.check() is True
    assert wd.check() is False
    wd.beat(1)
    clock.advance(0.5)
    assert wd.check() is False
    clock.advance(1.0)
    assert wd.check() is True
    assert obs.snapshot()["counters"]["fault.hangs"] == 2


def test_median_factor_raises_the_threshold(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=1.0, factor=8.0)
    for i in range(5):
        wd.beat(i)
        clock.advance(2.0)
    assert wd.threshold_s() == pytest.approx(16.0)
    clock.advance(10.0)
    assert wd.check() is False
    clock.advance(4.5)
    assert wd.check() is True


def test_startup_grace_covers_the_first_batch(tmp_path):
    """The first batch of a process builds B1 and captures the iteration's
    graphs with no boundary to beat from: until one interval is known the
    threshold is the grace."""
    clock = FakeClock()
    wd = HangWatchdog(timeout_s=1.0, median_factor=0.0,
                      dump_dir=str(tmp_path), startup_grace_s=120.0,
                      clock=clock)
    wd.beat(0)
    assert wd.threshold_s() == pytest.approx(120.0)
    clock.advance(60.0)
    assert wd.check() is False
    clock.advance(61.0)
    assert wd.check() is True
    wd.beat(1)
    clock.advance(0.5)
    wd.beat(2)
    assert wd.threshold_s() == pytest.approx(1.0)
    clock.advance(1.1)
    assert wd.check() is True


def test_startup_grace_defaults_to_at_least_300s(tmp_path):
    assert HangWatchdog(timeout_s=1.5).startup_grace_s == 300.0
    assert HangWatchdog(timeout_s=900.0).startup_grace_s == 900.0


def test_median_needs_three_intervals_before_it_applies(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=5.0, factor=100.0)
    wd.beat(0)
    clock.advance(1.0)
    wd.beat(1)
    assert wd.threshold_s() == pytest.approx(5.0)
    clock.advance(5.1)
    assert wd.check() is True


# --------------------------------------------------- against the JAX package

BEAT_SEQUENCES = {
    # (timeout, factor, grace, [(advance, beat?), ...])
    "steady": (2.0, 8.0, 0.0, [(0.5, True)] * 6 + [(3.0, False)] * 3),
    "adaptive": (1.0, 8.0, 0.0, [(2.0, True)] * 5 + [(4.0, False)] * 5),
    "grace": (1.0, 0.0, 30.0, [(0.0, True), (20.0, False), (15.0, False),
                                (0.0, True), (0.4, True), (0.7, False),
                                (0.7, False)]),
    "jitter": (1.5, 3.0, 5.0, [(0.1 * (1 + i % 4), True) for i in range(12)]
               + [(1.0, False)] * 4 + [(0.2, True), (9.0, False)]),
    "no_median": (3.0, 0.0, 0.0, [(1.0, True)] * 4 + [(2.5, False)] * 2),
}


def _trace(cls, timeout, factor, grace, seq, tmp_path):
    clock = FakeClock()
    wd = cls(timeout_s=timeout, median_factor=factor, dump_dir=str(tmp_path),
             startup_grace_s=grace, clock=clock)
    out = []
    for i, (dt, beat) in enumerate(seq):
        clock.advance(dt)
        if beat:
            wd.beat(i)
        out.append((round(clock.t, 9), wd.threshold_s(), wd.check()))
    return out


@pytest.mark.parametrize("name", sorted(BEAT_SEQUENCES))
def test_thresholds_and_firing_instants_equal_the_jax_watchdog(name,
                                                               tmp_path):
    timeout, factor, grace, seq = BEAT_SEQUENCES[name]
    ours = _trace(HangWatchdog, timeout, factor, grace, seq,
                  tmp_path / "port")
    theirs = _trace(JaxWatchdog, timeout, factor, grace, seq,
                    tmp_path / "jax")
    assert ours == theirs
    assert any(fired for _, _, fired in ours) or name == "steady"


# ------------------------------------------------------------------- dumps

def test_dump_contains_thread_stacks_and_snapshot(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=1.0)
    obs.get_registry().inc("fault.shard_corrupt")
    wd.beat(7)
    clock.advance(2.0)
    assert wd.check() is True
    assert len(wd.dumps) == 1
    payload = json.load(open(wd.dumps[0]))
    assert payload["kind"] == "watchdog_hang_dump"
    assert payload["iteration"] == 7
    assert payload["stalled_seconds"] == pytest.approx(2.0)
    stacks = payload["thread_stacks"]
    assert stacks and any("check" in "".join(frames)
                          for frames in stacks.values())
    assert payload["snapshot"]["counters"]["fault.shard_corrupt"] == 1
    assert obs.snapshot()["counters"]["fault.watchdog_dumps"] == 1


def test_dump_count_is_bounded(tmp_path):
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=1.0, max_dumps=2)
    for i in range(4):
        wd.beat(i)
        clock.advance(5.0)
        assert wd.check() is True
    assert len(wd.dumps) == 2
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("watchdog_dump_")]) == 2


def test_dump_never_touches_the_card(tmp_path, monkeypatch):
    """The monitor thread's dump reads host state only: a wedged stream
    would wedge a synchronize or a memory query too."""
    def boom(*a, **k):
        raise AssertionError("the watchdog touched the card")
    for name in ("synchronize", "memory_stats", "memory_allocated",
                 "max_memory_allocated", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, boom)
    clock = FakeClock()
    wd = _wd(clock, tmp_path, timeout=1.0)
    wd.beat(0)
    clock.advance(2.0)
    assert wd.check() is True and wd.dumps


# ------------------------------------------------------------------- abort

def test_abort_action_calls_abort_fn_after_dumping(tmp_path):
    clock = FakeClock()
    aborted = []
    wd = _wd(clock, tmp_path, timeout=1.0, action="abort",
             abort_fn=lambda: aborted.append(True))
    wd.beat(0)
    clock.advance(3.0)
    assert wd.check() is True
    assert aborted == [True]
    assert wd.dumps
    assert obs.snapshot()["counters"]["fault.hang_aborts"] == 1
    assert (EXIT_HANG, EXIT_COMM_LOST) == (142, 145)


def test_abort_exit_code_follows_the_attribution(tmp_path, monkeypatch):
    """A firing whose lease attribution names a lost peer leaves with 145,
    a local hang with 142 (``os._exit``, replaced here)."""
    codes = []

    class Exit(Exception):
        pass

    def fake_exit(code):
        codes.append(code)
        raise Exit

    monkeypatch.setattr(twd.os, "_exit", fake_exit)
    for att, want in (({"peer_lost": 1, "slowest_rank": 1}, 145),
                      ({"peer_lost": None, "slowest_rank": 1}, 142),
                      (None, 142)):
        clock = FakeClock()
        wd = _wd(clock, tmp_path, timeout=1.0, action="abort",
                 attribution_fn=(lambda a=att: a) if att else None)
        wd.beat(0)
        clock.advance(2.0)
        with pytest.raises(Exit):
            wd.check()
        assert codes[-1] == want


def test_dump_action_does_not_abort(tmp_path):
    clock = FakeClock()
    aborted = []
    wd = _wd(clock, tmp_path, timeout=1.0, action="dump",
             abort_fn=lambda: aborted.append(True))
    wd.beat(0)
    clock.advance(3.0)
    assert wd.check() is True
    assert aborted == []


def test_rejects_bad_configuration():
    with pytest.raises(ValueError, match="timeout_s"):
        HangWatchdog(timeout_s=0.0)
    with pytest.raises(ValueError, match="action"):
        HangWatchdog(timeout_s=1.0, action="explode")


def test_clock_defaults_to_observability_clock(tmp_path, monkeypatch):
    t = {"now": 100.0}
    monkeypatch.setattr(obs, "clock", lambda: t["now"])
    wd = HangWatchdog(timeout_s=1.0, dump_dir=str(tmp_path),
                      startup_grace_s=0.0)
    wd.beat(0)
    t["now"] += 5.0
    assert wd.check() is True


# ------------------------------------------------------ the engine's wiring

def _data(n=600, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 5)
    return X, X[:, 0] * 2 + rng.rand(n) * 0.1


BASE = dict(objective="regression", num_leaves=7, min_data_in_leaf=5,
            device="cpu", verbose=-1)


def test_hang_timeout_arms_the_watchdog_with_its_keys(tmp_path, monkeypatch):
    """``hang_timeout_s`` > 0 arms a watchdog with ``hang_median_factor``
    and ``hang_action``, beaten once per batch and stopped at the end;
    0 arms none."""
    made = []

    class Recording(HangWatchdog):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.beats = 0
            made.append(self)

        def beat(self, iteration=None):
            self.beats += 1
            super().beat(iteration)

    monkeypatch.setattr(twd, "HangWatchdog", Recording)
    X, y = _data()
    lgt.train(BASE, lgt.Dataset(X, label=y), num_boost_round=3)
    assert made == []
    lgt.train(dict(BASE, hang_timeout_s=50.0, hang_median_factor=3.5,
                   hang_action="dump", checkpoint_dir=str(tmp_path)),
              lgt.Dataset(X, label=y), num_boost_round=3)
    (wd,) = made
    assert (wd.timeout_s, wd.median_factor, wd.action) == (50.0, 3.5, "dump")
    assert wd.dump_dir == str(tmp_path)
    assert wd.beats == 4                  # armed, then after each batch
    assert wd._thread is None             # stopped


def test_injected_hang_leaves_a_dump_and_training_goes_on(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("LGBM_TPU_CHAOS_HANG", "2:3")
    made = []
    orig = twd.HangWatchdog

    def make(**kw):
        wd = orig(poll_interval_s=0.05, **kw)        # a fast poll
        made.append(wd)
        return wd

    monkeypatch.setattr(twd, "HangWatchdog", make)
    X, y = _data()
    bst = lgt.train(dict(BASE, hang_timeout_s=1.0, hang_median_factor=0.0,
                         checkpoint_dir=str(tmp_path)),
                    lgt.Dataset(X, label=y), num_boost_round=4)
    assert bst.num_trees() == 4
    (wd,) = made
    assert len(wd.dumps) == 1
    payload = json.load(open(wd.dumps[0]))
    assert any("time.sleep" in "".join(f) or "_hang" in "".join(f)
               for f in payload["thread_stacks"].values())
    assert obs.snapshot()["counters"]["fault.hangs"] == 1


CHILD = r'''
import sys
import numpy as np, torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.robustness import watchdog as twd
orig = twd.HangWatchdog
twd.HangWatchdog = lambda **kw: orig(poll_interval_s=0.05, **kw)
rng = np.random.RandomState(3)
X = rng.rand(600, 5)
y = X[:, 0] * 2
lgt.train(dict(objective="regression", num_leaves=7, device="cpu",
               verbose=-1, hang_timeout_s=2.0, hang_median_factor=0.0,
               hang_action="abort", checkpoint_dir=sys.argv[1]),
          lgt.Dataset(X, label=y), num_boost_round=6)
print("trained through")
'''


def test_hang_action_abort_exits_142_with_a_dump(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               LGBM_TPU_CHAOS_HANG="2:60")
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == EXIT_HANG, r.stderr[-2000:]
    assert "trained through" not in r.stdout
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("watchdog_dump_")]
    assert len(dumps) == 1
    payload = json.load(open(os.path.join(tmp_path, dumps[0])))
    assert payload["action"] == "abort" and payload["thread_stacks"]
