"""The port's crash and fleet supervisors
(``lightgbm_tpu_torch/robustness/supervisor.py``) held against the JAX
package's (``lightgbm_tpu/robustness/supervisor.py``).

With the fakes of ``tests/test_supervisor.py`` and
``test_distributed.py:325-470`` (scripted children, a fake clock and
sleep), the port's exit-code labels, its backoff schedule under one seed
and the argv of every relaunch (``resume_from=auto`` appended exactly
once) must equal the JAX supervisor's. Then the port's own parts: MTTR
from the next checkpoint or manifest, the fleet's ``{port}`` placeholder
and machine list, the worst code when out of restarts, and one real
supervised run of ``python -m lightgbm_tpu_torch`` killed after its second
checkpoint and relaunched to the uninterrupted run's model text.

Alone this file takes about 21 s on the CPU (CHANGES.md).
"""
import itertools
import os
import subprocess
import sys

import pytest
import torch

from lightgbm_tpu import observability as jobs
from lightgbm_tpu.robustness import supervisor as jsup

from lightgbm_tpu_torch import observability as obs
from lightgbm_tpu_torch.robustness import supervisor as tsup
from lightgbm_tpu_torch.robustness.checkpoint import CheckpointManager
from lightgbm_tpu_torch.robustness.supervisor import (
    EXIT_SHARD_CORRUPT, FleetSupervisor, Supervisor, _train_args_dict,
    describe_exit)
from lightgbm_tpu_torch.robustness.watchdog import EXIT_COMM_LOST

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
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeProc:
    """A scripted child: ``polls_alive`` polls of None, then ``rc``."""

    def __init__(self, rc, polls_alive=0, on_poll=None):
        self.rc = rc
        self.polls_alive = polls_alive
        self.on_poll = on_poll
        self.polls = 0

    def poll(self):
        self.polls += 1
        if self.on_poll:
            self.on_poll(self.polls)
        if self.polls <= self.polls_alive:
            return None
        return self.rc


def _supervisor(cls, rcs, args, clock=None, **kw):
    procs = [FakeProc(rc) for rc in rcs]
    spawned, sleeps = [], []

    def spawn(argv):
        spawned.append(list(argv))
        return procs[len(spawned) - 1]

    sup = cls(args, spawn_fn=spawn, sleep=sleeps.append,
              clock=clock or FakeClock(), poll_interval_s=0.0, **kw)
    return sup, spawned, sleeps


BASE_ARGS = ["config=train.conf", "checkpoint_dir=/ck",
             "checkpoint_interval=2"]


# ------------------------------------------------- against the JAX package

@pytest.mark.parametrize("rc", [-9, -15, -6, -11, -2, 0, 1, 7, 142, 143,
                                144, 145])
def test_describe_exit_equals_the_jax_supervisor(rc):
    assert describe_exit(rc) == jsup.describe_exit(rc)


def test_exit_codes_are_the_jax_packages():
    assert (tsup.EXIT_SHARD_CORRUPT, tsup.EXIT_SIGTERM_CHECKPOINT) == \
        (jsup.EXIT_SHARD_CORRUPT, jsup.EXIT_SIGTERM_CHECKPOINT)
    assert (tsup.EXIT_HANG, tsup.EXIT_COMM_LOST) == \
        (jsup.EXIT_HANG, jsup.EXIT_COMM_LOST)


@pytest.mark.parametrize("case", [
    dict(rcs=[-9, 1, 0], kw=dict(seed=3)),
    dict(rcs=[1] * 5, kw=dict(max_restarts=4, backoff_base_s=1.0,
                              backoff_max_s=4.0, jitter=0.25, seed=42)),
    dict(rcs=[142, 143, 145, 0], kw=dict(seed=9, jitter=0.5)),
    dict(rcs=[-9, 0], kw=dict(seed=1), args=BASE_ARGS + ["resume_from=auto"]),
], ids=["mixed", "budget", "typed", "already_auto"])
def test_backoff_and_relaunch_argv_equal_the_jax_supervisor(case):
    args = case.get("args", BASE_ARGS)
    ours, o_argv, o_sleep = _supervisor(Supervisor, case["rcs"], args,
                                        **case["kw"])
    theirs, j_argv, j_sleep = _supervisor(jsup.Supervisor, case["rcs"], args,
                                          **case["kw"])
    o_rc, j_rc = ours.run(), theirs.run()
    assert o_argv == j_argv and o_sleep == j_sleep
    assert ours.restarts == theirs.restarts
    assert ours.exit_codes == theirs.exit_codes
    for argv in o_argv[1:]:
        assert argv.count("resume_from=auto") == 1
    assert o_rc == (j_rc if len(set(ours.exit_codes)) <= 1 or o_rc == 0
                    else o_rc)


def test_train_args_dict_equals_the_jax_supervisors():
    toks = ["--checkpoint-dir=/x", "task=train", "--hang-timeout-s=5",
            'data="a b.csv"', "bare"]
    assert _train_args_dict(toks) == jsup._train_args_dict(toks)


# ---------------------------------------------------------- restart policy

def test_clean_exit_needs_no_restart():
    sup, spawned, _ = _supervisor(Supervisor, [0], BASE_ARGS)
    assert sup.run() == 0
    assert sup.restarts == 0 and spawned == [BASE_ARGS]


def test_restart_budget_returns_the_worst_child_code():
    """Out of restarts, the worst code the children gave: a signal death
    over any exit code."""
    sup, spawned, _ = _supervisor(Supervisor, [7, -9, 1], BASE_ARGS,
                                  max_restarts=2, seed=0)
    assert sup.run() == -9
    assert len(spawned) == 3 and sup.exit_codes == [7, -9, 1]
    snap = obs.snapshot()["counters"]
    assert snap["fault.restarts"] == 2 and snap["fault.child_failures"] == 3


def test_mttr_measured_from_failure_to_next_checkpoint(tmp_path):
    clock = FakeClock()
    ck = str(tmp_path)
    mgr = CheckpointManager(ck, keep_last_n=0)
    payload = {"config_fingerprint": "f", "config": {}, "iteration": 1,
               "state": {}}
    mgr.save(payload)

    def child2_poll(n):
        clock.t += 10.0
        if n == 2:
            mgr.save(payload)

    procs = [FakeProc(-9), FakeProc(0, polls_alive=3, on_poll=child2_poll)]
    spawned = []

    def spawn(argv):
        spawned.append(argv)
        return procs[len(spawned) - 1]

    sup = Supervisor([f"checkpoint_dir={ck}"], spawn_fn=spawn,
                     sleep=lambda s: None, clock=clock, poll_interval_s=0.0,
                     seed=1, backoff_base_s=0.0, jitter=0.0)
    assert sup.run() == 0
    assert sup.recovery_seconds == [pytest.approx(20.0)]
    hist = obs.snapshot()["histograms"]["fault.recovery_seconds"]
    assert hist["count"] == 1 and hist["max"] == pytest.approx(20.0)


def test_missing_checkpoint_dir_warns_but_supervises(caplog):
    import logging
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        sup, _, _ = _supervisor(Supervisor, [0], ["config=t.conf"])
    assert any("FROM SCRATCH" in r.getMessage() for r in caplog.records)
    assert sup.run() == 0


def test_describe_exit_labels_the_failure_classes():
    assert "SIGKILL" in describe_exit(-9)
    assert "hang" in describe_exit(142)
    assert "SIGTERM" in describe_exit(143)
    assert "corruption" in describe_exit(EXIT_SHARD_CORRUPT)
    assert "comm loss" in describe_exit(145)
    assert describe_exit(1) == "exit 1"


def test_main_parses_the_supervisors_options(monkeypatch):
    assert tsup.main([]) == 2
    seen = []

    def fake_run(self):
        seen.append(self)
        return 0

    monkeypatch.setattr(Supervisor, "run", fake_run)
    monkeypatch.setattr(FleetSupervisor, "run", fake_run)
    assert tsup.main(["--max-restarts=2", "--seed=5", "--",
                      "checkpoint_dir=/c", "data=x"]) == 0
    assert isinstance(seen[-1], Supervisor) and seen[-1].max_restarts == 2
    assert seen[-1].train_args == ["checkpoint_dir=/c", "data=x"]
    assert tsup.main(["--fleet=3", "--elastic", "--rank-dead-after=4", "--",
                      "checkpoint_dir=/c"]) == 0
    fs = seen[-1]
    assert isinstance(fs, FleetSupervisor)
    assert (fs.world, fs.elastic, fs.rank_dead_after) == (3, True, 4)


# -------------------------------------------------------- fleet supervisor

class PlanProc:
    """``poll()`` walks a plan: None = running, the final int = the exit
    code; ``terminate()``/``kill()`` end an unfinished plan with -15/-9."""

    def __init__(self, plan):
        self._plan = iter(plan)
        self._rc = None

    def poll(self):
        if self._rc is None:
            try:
                nxt = next(self._plan)
            except StopIteration:
                nxt = None
            self._rc = nxt
        return self._rc

    def terminate(self):
        if self._rc is None:
            self._rc = -15

    def kill(self):
        if self._rc is None:
            self._rc = -9


class PlanSpawner:
    def __init__(self, plans, world):
        self.plans, self.world = plans, world
        self.argvs = []

    def __call__(self, argv):
        n = len(self.argvs)
        self.argvs.append(list(argv))
        gen, rank = self._where(n)
        return PlanProc(self.plans[gen][rank])

    def _where(self, n):
        g = 0
        for plan in self.plans:
            if n < len(plan):
                return g, n
            n -= len(plan)
            g += 1
        raise AssertionError("more spawns than planned")


def _fleet(cls, plans, template=("checkpoint_dir=",), world=2, **kw):
    ticks = itertools.count()
    sp = PlanSpawner(plans, world)
    fs = cls(list(template), world, seed=1, backoff_base_s=0.0,
             backoff_max_s=0.0, jitter=0.0, spawn_fn=sp,
             sleep=lambda s: None, clock=lambda: next(ticks) * 0.1, **kw)
    return fs, sp


FLEET_CASES = {
    "kill9": ([[[None, None, 145], [None, -9]], [[None, 0], [0]]],
              dict(max_restarts=3)),
    "refuse_shrink": ([[[None, 145], [-9]], [[None, 145], [-9]]],
                      dict(max_restarts=5, rank_dead_after=2)),
    "elastic_shrink": ([[[None, 145], [-9]], [[None, 145], [-9]], [[0]]],
                       dict(max_restarts=5, rank_dead_after=2,
                            elastic=True)),
    "budget": ([[[7], [0]], [[7], [0]]], dict(max_restarts=1,
                                              rank_dead_after=5)),
}


@pytest.mark.parametrize("name", sorted(FLEET_CASES))
def test_fleet_policy_and_argv_equal_the_jax_fleet(name):
    plans, kw = FLEET_CASES[name]
    template = ("checkpoint_dir=", "rank={rank}", "world={world}")
    ours, o_sp = _fleet(FleetSupervisor, plans, template, **kw)
    theirs, j_sp = _fleet(jsup.FleetSupervisor, plans, template, **kw)
    assert ours.run() == theirs.run()
    assert o_sp.argvs == j_sp.argvs
    assert ours.gang_exit_codes == theirs.gang_exit_codes
    assert (ours.world, ours.shrinks, ours.restarts) == \
        (theirs.world, theirs.shrinks, theirs.restarts)
    for argv in o_sp.argvs[2:]:
        assert argv.count("resume_from=auto") == 1


def test_fleet_kill9_attribution_and_relaunch():
    fs, sp = _fleet(FleetSupervisor, *FLEET_CASES["kill9"])
    assert fs.run() == 0
    assert fs.gang_exit_codes == [{0: 145, 1: -9}]
    assert fs._consecutive_fails == {0: 0, 1: 1}


def test_fleet_refuses_shrink_without_elastic():
    fs, _ = _fleet(FleetSupervisor, *FLEET_CASES["refuse_shrink"])
    assert fs.run() == EXIT_COMM_LOST
    assert fs.world == 2 and fs.shrinks == 0


def test_fleet_port_placeholder_and_machine_list_follow_the_world():
    """``{port}`` is the rank's port in the machine list; an elastic
    shrink keeps the list's first entries and ``num_machines`` as written
    (it is in the checkpoint's config fingerprint)."""
    plans = [[[None, 145], [-9]], [[None, 145], [-9]], [[0]]]
    template = ["checkpoint_dir=/c", "num_machines=2",
                "machines=127.0.0.1:5000,127.0.0.1:5001",
                "local_listen_port={port}"]
    fs, sp = _fleet(FleetSupervisor, plans, template, max_restarts=5,
                    rank_dead_after=2, elastic=True)
    assert fs.run() == 0
    assert sp.argvs[0][3] == "local_listen_port=5000"
    assert sp.argvs[1][3] == "local_listen_port=5001"
    last = sp.argvs[-1]
    assert "machines=127.0.0.1:5000" in last and "num_machines=2" in last
    assert "local_listen_port=5000" in last
    assert "elastic=true" in last and "tpu_reshard_on_resume=true" in last


def test_fleet_mttr_measured_from_new_manifest(tmp_path):
    from lightgbm_tpu_torch.robustness import distributed as gdist
    d = str(tmp_path / "ck")
    solo = gdist.GangCheckpointCoordinator(d, client=None, rank=0, world=1)
    payload = {"iteration": 2, "config_fingerprint": "f", "config": {},
               "state": {}}
    solo.save(payload)

    class Banking(PlanSpawner):
        def __call__(self, argv):
            if len(self.argvs) == 2:
                solo.save(dict(payload, iteration=4))
            return super().__call__(argv)

    ticks = itertools.count()
    sp = Banking([[[None, -9], [None, 145]],
                  [[None, None, None, 0], [None, None, None, 0]]], 2)
    fs = FleetSupervisor([f"checkpoint_dir={d}"], 2, seed=1,
                         backoff_base_s=0.0, backoff_max_s=0.0, jitter=0.0,
                         spawn_fn=sp, sleep=lambda s: None,
                         clock=lambda: next(ticks) * 0.1, max_restarts=3)
    assert fs.run() == 0
    assert len(fs.recovery_seconds) == 1 and fs.recovery_seconds[0] > 0


# ------------------------------------------------- a real supervised child

CHILD_FILE = r'''
import os, signal, sys
import numpy as np
rng = np.random.RandomState(11)
X = rng.rand(800, 6)
y = X[:, 0] * 2 + X[:, 1] ** 2 + rng.rand(800) * 0.1
np.savetxt(sys.argv[1], np.column_stack([y, X]), delimiter="\t",
           fmt="%.10g")
'''


def test_supervised_cli_kill_ends_with_the_uninterrupted_text(tmp_path):
    """``Supervisor`` over ``python -m lightgbm_tpu_torch``: the first child
    parks after its second checkpoint (``LGBM_TPU_CHAOS_HANG``, one-shot
    through its marker) and a watcher SIGKILLs it there; the relaunch
    resumes with ``resume_from=auto`` and ends with the text of a run
    never interrupted."""
    data = str(tmp_path / "train.tsv")
    subprocess.run([sys.executable, "-c", CHILD_FILE, data], check=True)
    common = ["task=train", f"data={data}", "objective=regression",
              "num_leaves=7", "min_data_in_leaf=5", "device=cpu",
              "verbose=-1", "num_iterations=12"]
    want = str(tmp_path / "want.txt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch", *common,
                    f"output_model={want}"], env=env, check=True,
                   timeout=120)
    ck = str(tmp_path / "ck")
    got = str(tmp_path / "got.txt")
    from lightgbm_tpu_torch.robustness.chaos import kill_after_checkpoints
    env = dict(env, LGBM_TPU_CHAOS_HANG="4:60",
               LGBM_TPU_CHAOS_HANG_MARKER=str(tmp_path / "hang.marker"))
    children = []

    def spawn(argv):
        p = subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch",
                              *argv], env=env)
        if not children:
            kill_after_checkpoints(p, ck, n=2, poll_s=0.01, timeout_s=120)
        children.append(argv)
        return p

    sup = Supervisor([*common, f"checkpoint_dir={ck}",
                      "checkpoint_interval=2", "checkpoint_keep_last_n=0",
                      f"output_model={got}"], spawn_fn=spawn, seed=0,
                     backoff_base_s=0.0, jitter=0.0)
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.exit_codes == [-9]
    assert children[1][-1] == "resume_from=auto"
    assert len(sup.recovery_seconds) == 1
    assert open(got).read() == open(want).read()
